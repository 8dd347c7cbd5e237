"""The port's job and tile parallelism (``smcdet_tpu_torch/parallel``,
``smcdet_tpu_torch/utils/devices.py``) against the JAX package's, on the
CPU.

- ``host_shard`` / ``initialize_distributed`` against
  ``smcdet_tpu/parallel/distributed.py``'s rules: an explicit shard wins,
  a single process is its own shard, ``require=True`` with nothing to join
  raises.
- A real two-process gloo run of ``run_experiment.py --distributed`` on the
  CPU (2 images, batch size 1): each process writes the batches of its
  rank, disjoint, whose union is the single-process run's; each batch file
  holds the single-process run's arrays exactly (a batch's draws depend
  only on the seed and the batch).
- ``devices=["cpu"]`` bit-equal to ``devices=None`` for
  ``SMCSampler.run``, ``run_csmc_streaming`` and ``Aggregate.run`` on one
  generator, and ``SMCSampler.run`` to its chunked run on that generator;
  a shard off the generator's device (``"cpu:1"``, a second CPU device
  index standing in for a second card) draws a new stream at every call
  and every aggregation level; ``devices=["cpu", "cpu"]``: each tile range is the unsharded
  run of those tiles on the generator's draws in turn (so equal in law to
  the unsharded run tile by tile), with the right shapes, finite log Z and
  weights summing to 1; a tile count not divisible by the devices
  raises.
- ``level_split`` against ``Aggregate._level_sharding``'s mesh on the
  virtual 8-device CPU mesh.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu.inference.aggregate import Aggregate as JAggregate
from smcdet_tpu.parallel import distributed as jdist
from smcdet_tpu.utils import devices as jdevices
from smcdet_tpu_torch.config import (
    build_image_model,
    build_kernel,
    build_prior,
    load_config,
    save_config,
)
from smcdet_tpu_torch.inference.aggregate import Aggregate
from smcdet_tpu_torch.inference.smc import (
    SMCConfig,
    SMCSampler,
    run_csmc_chunked,
)
from smcdet_tpu_torch.inference.streaming import run_csmc_streaming
from smcdet_tpu_torch.parallel import distributed, sharding
from smcdet_tpu_torch.runner import load_results
from smcdet_tpu_torch.utils import devices

REPO = Path(__file__).resolve().parents[1]
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture
def no_group(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("job,jobs", [(0, 1), (2, 3), (0, 4), (3, 4)])
def test_host_shard_single_process_matches_jax(no_group, job, jobs):
    assert distributed.host_shard(job, jobs) == jdist.host_shard(job, jobs)
    assert not distributed.is_distributed()


def test_initialize_without_a_group(no_group):
    assert distributed.initialize_distributed() is False
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.initialize_distributed(require=True)
    assert not torch.distributed.is_initialized()


def test_initialize_with_part_of_a_group_raises(no_group, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(ValueError, match="rank"):
        distributed.initialize_distributed()


def _tiny_config(path, out):
    cfg = load_config(REPO / "experiments" / "basic" / "config.yaml")
    cfg.name = "dist_smoke"
    cfg.num_images, cfg.batch_size = 2, 1
    cfg.output_dir = str(out)
    cfg.sampler.num_catalogs = 16
    cfg.sampler.max_smc_iters = 3
    cfg.kernel.num_iters = 2
    save_config(cfg, path)
    return cfg


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_split_the_batches(tmp_path):
    cfg_path = tmp_path / "config.yaml"
    _tiny_config(cfg_path, tmp_path / "dist")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "smcdet_tpu_torch.run_experiment",
             str(cfg_path), "--distributed", "--device", "cpu"],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    out = tmp_path / "dist" / "dist_smoke"
    by_job = {}
    for rank in range(2):
        manifest = (out / f"smc_manifest_job{rank}.json").read_text()
        by_job[rank] = {b["batch"] for b in json.loads(manifest)["batches"]}
    assert by_job == {0: {0}, 1: {1}}, by_job

    single = _tiny_config(cfg_path, tmp_path / "single")
    from smcdet_tpu_torch.runner import run_experiment

    run_experiment(single, device="cpu", verbose=False)
    ref = tmp_path / "single" / "dist_smoke"
    assert (sorted(p.name for p in ref.glob("smc_batch*.npz"))
            == sorted(p.name for p in out.glob("smc_batch*.npz")))
    for p in ref.glob("smc_batch*.npz"):
        with np.load(p) as a, np.load(out / p.name) as b:
            for k in a.files:
                if k != "runtime":
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got, want = load_results(out), load_results(ref)
    np.testing.assert_array_equal(got["image_index"], want["image_index"])


def _problem(N=32, sweeps=3):
    cfg = load_config(REPO / "experiments" / "divideandconquer"
                      / "config.yaml")
    cfg.kernel.num_iters = sweeps
    with np.load(REPO / "tests" / "data" /
                 "divideandconquer_tiles.npz") as t:
        image = torch.as_tensor(t["images"][0], dtype=torch.float32)
    from smcdet_tpu_torch.inference.aggregate import expand_prior

    td = cfg.sampler.tile_dim
    prior = build_prior(cfg.prior, "cpu")
    model = build_image_model(cfg.image_model, "cpu")
    tile_prior = expand_prior(prior, td, td, prior.max_objects)
    sampler = SMCSampler(image, td, tile_prior, model.with_shape(td, td),
                         build_kernel(cfg.kernel, "cpu"), num_catalogs=N,
                         max_smc_iters=20)
    return sampler, cfg


def _same(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
        else:
            assert x == y, f


def test_one_device_is_the_unsharded_run():
    sampler, cfg = _problem()
    runs = []
    for devs in (None, ["cpu"]):
        runs.append(sampler.run(torch.Generator().manual_seed(4),
                                devices=devs))
    _same(*runs)
    _same(runs[0], run_csmc_chunked(
        torch.Generator().manual_seed(4), sampler.tiled_image, sampler.prior,
        sampler.image_model, sampler.kernel, sampler.config,
        budget_bytes=sampler.budget_bytes, sort_tiles=True))
    runs = []
    for devs in (None, ["cpu"]):
        runs.append(sampler.run(torch.Generator().manual_seed(4),
                                streaming=True, devices=devs))
    _same(*runs)
    aggs = []
    for devs in (None, ["cpu"]):
        agg = Aggregate.from_smc(sampler, max_smc_iters=20,
                                 relocate_sweeps=1)
        agg.run(torch.Generator().manual_seed(9), devices=devs)
        aggs.append(agg)
    _same(aggs[0].state, aggs[1].state)
    for f in ("pruned_counts", "pruned_locs", "pruned_fluxes"):
        assert torch.equal(getattr(aggs[0], f), getattr(aggs[1], f)), f
    for d0, d1 in zip(aggs[0].diagnostics, aggs[1].diagnostics):
        assert d0["iterations"] == d1["iterations"]
        assert torch.equal(d0["temperature"], d1["temperature"])


def _check(res, T, N):
    assert res.weights.shape == (T, N * res.log_normalizing_constant.shape[1])
    assert ((res.temperature > 0) & (res.temperature <= 1)).all()
    assert torch.isfinite(res.log_normalizing_constant).all()
    torch.testing.assert_close(res.weights.sum(-1), torch.ones(T),
                               rtol=0, atol=1e-5)


def test_two_devices_run_each_range_in_turn():
    sampler, cfg = _problem()
    T = sampler.tiled_image.shape[0]
    res = sampler.run(torch.Generator().manual_seed(6),
                      devices=["cpu", "cpu"])
    _check(res, T, 32)
    gen = torch.Generator().manual_seed(6)
    parts = [run_csmc_chunked(gen, sampler.tiled_image[sl], sampler.prior,
                              sampler.image_model, sampler.kernel,
                              sampler.config, sort_tiles=True)
             for sl in (slice(0, T // 2), slice(T // 2, T))]
    for f in ("counts", "locs", "fluxes", "weights", "temperature"):
        torch.testing.assert_close(
            getattr(res, f), torch.cat([getattr(p, f) for p in parts]),
            rtol=0, atol=0, msg=f)

    res_s, info = run_csmc_streaming(
        torch.Generator().manual_seed(6), sampler.tiled_image, sampler.prior,
        sampler.image_model, sampler.kernel, sampler.config, pool=2,
        return_info=True, devices=["cpu", "cpu"])
    _check(res_s, T, 32)
    assert info["pool"] == 2 and len(info["shards"]) == 2
    assert info["per_tile_iters"].shape == (T,)

    agg = Aggregate.from_smc(sampler, max_smc_iters=20, relocate_sweeps=1)
    agg.run(torch.Generator().manual_seed(9), devices=["cpu", "cpu"])
    assert agg.state.counts.shape[:2] == (1, 1)
    assert agg.pruned_counts.shape == agg.state.counts.shape
    level0 = agg.diagnostics[0]["temperature"]
    assert level0.shape == (1, 2)
    torch.testing.assert_close(agg.state.weights.sum(-1),
                               torch.ones(1, 1), rtol=0, atol=1e-5)


def test_tiles_not_divisible_by_the_devices_raise():
    sampler, _ = _problem()
    with pytest.raises(ValueError, match="divisible"):
        sampler.run(torch.Generator().manual_seed(1), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="divisible"):
        run_csmc_streaming(torch.Generator().manual_seed(1),
                           sampler.tiled_image, sampler.prior,
                           sampler.image_model, sampler.kernel,
                           SMCConfig(num_catalogs=8), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="divisible"):
        sharding.tile_shards(["cpu"] * 2, 5)


@pytest.mark.parametrize("n,th,tw", [(1, 2, 2), (2, 1, 2), (2, 2, 1),
                                     (4, 2, 2), (8, 4, 2), (3, 2, 2),
                                     (6, 4, 4), (8, 1, 1)])
def test_level_split_is_jax_level_sharding(n, th, tw):
    mesh = JAggregate._level_sharding(jax.devices()[:n], th, tw).mesh
    assert sharding.level_split(n, th, tw) == (mesh.shape["th"],
                                               mesh.shape["tw"])


def test_shard_generator_and_to_device():
    g = torch.Generator().manual_seed(3)
    assert sharding.shard_generator(g, "cpu", 5) is g
    sampler, _ = _problem()
    for obj in (sampler.prior, sampler.image_model, sampler.kernel):
        assert sharding.to_device(obj, "cpu") is obj
    state = torch.Generator().manual_seed(3).get_state()
    assert torch.equal(g.get_state(), state)


def _stream(gen):
    return torch.rand(8, generator=gen)


def test_off_device_shards_draw_a_new_stream_each_call_and_level():
    # the fork is seeded from a draw of the caller's generator, salted
    # with the shard's index and level
    g = torch.Generator().manual_seed(3)
    streams = [_stream(sharding.shard_generator(g, "cpu:1", 1, level))
               for level in (0, 0, 1)]
    assert not torch.equal(streams[0], streams[1])
    assert not torch.equal(streams[0], streams[2])
    same = [_stream(sharding.shard_generator(
        torch.Generator().manual_seed(3), "cpu:1", 1, level))
        for level in (0, 1)]
    assert torch.equal(same[0], streams[0])
    assert not torch.equal(same[0], same[1])
    assert not torch.equal(g.get_state(),
                           torch.Generator().manual_seed(3).get_state())

    # repeated runs on one advancing generator: the second range, off the
    # generator's device, is not replayed
    sampler, _ = _problem()
    g = torch.Generator().manual_seed(6)
    runs = [sampler.run(g, devices=["cpu", "cpu:1"]) for _ in range(2)]
    T = sampler.tiled_image.shape[0]
    for res in runs:
        _check(res, T, 32)
    assert not torch.equal(runs[0].locs[T // 2:], runs[1].locs[T // 2:])


def test_off_device_block_streams_differ_between_levels(monkeypatch):
    from smcdet_tpu_torch.inference import aggregate

    g = torch.Generator().manual_seed(5)
    seen = {}

    def level_stub(gen, sub, prior, model, kernel, cfg, axis, dims):
        # the block on the caller's generator's device draws from it
        seen.setdefault(gen is g, []).append(_stream(gen))
        rows, cols = sub.data.shape[:2]
        return sub, {"temperature": torch.ones(rows, cols), "iterations": 1,
                     "acc_rate": torch.zeros(rows, cols)}

    monkeypatch.setattr(aggregate, "_run_level", level_stub)
    rng = np.random.default_rng(0)
    state = aggregate.AggregateState(*(
        torch.as_tensor(rng.random((2, 2) + tail, dtype=np.float32))
        for tail in ((4, 4), (3,), (3, 2, 2), (3, 2), (3,), (3,))))
    for level in range(2):
        out, diag = aggregate._run_level_split(
            g, state, None, None, None, None, 0, (2, 2, 4, 4),
            ["cpu", "cpu:1"], level)
        _same(out, state)
        assert diag["temperature"].shape == (2, 2)
    assert len(seen[True]) == len(seen[False]) == 2
    assert not torch.equal(seen[False][0], seen[False][1])


def test_select_device_matches_jax():
    assert devices.select_device("cpu").type == jdevices.select_device(
        "cpu").platform
    # the default is the card; without one it raises, never the CPU
    if torch.cuda.is_available():
        assert devices.select_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            devices.select_device()
    for missing in ("tpu", "cuda") if not torch.cuda.is_available() else (
            "tpu",):
        with pytest.raises(RuntimeError):
            jdevices.select_device(missing)
        with pytest.raises(RuntimeError):
            devices.select_device(missing)


def test_describe_devices_one_line_a_device():
    got = devices.describe_devices().splitlines()
    want = jdevices.describe_devices().splitlines()
    if not torch.cuda.is_available():
        assert got == ["cpu id=0"]
        assert want[0].startswith("cpu id=0")
    else:
        assert len(got) == torch.cuda.device_count()
