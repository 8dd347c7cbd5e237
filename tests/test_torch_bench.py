"""The port's bench (smcdet_tpu_torch/bench.py) against bench.py: its
committed tiles against a fresh draw of ``bench.py``'s, its problem against
``bench.py``'s ``build_problem``, the billing arithmetic and the JSON keys
of a tiny CPU run, and the command line's sizes."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bench_tiles import bench_tiles
from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread,
    port_kernel,
    port_model,
    port_prior,
    t,
)

import bench as jax_bench
from smcdet_tpu_torch import bench
from smcdet_tpu_torch.inference.kernels import TargetContext, init_kernel_state

REPO = Path(__file__).resolve().parents[1]
# the keys of bench.py's JSON line (BENCH_r05.json "parsed")
PARSED_KEYS = sorted(json.loads((REPO / "BENCH_r05.json").read_text())
                     ["parsed"])


def test_committed_tiles_equal_the_jax_draw():
    """``bench_tiles.npz`` holds ``bench.py``'s draw (``generate_images``
    with key 7) at 16 and 332 tiles, bit for bit; the 16-tile draw is the
    332-tile draw's first 16 tiles, which ``load_tiles`` relies on."""
    fresh = bench_tiles()
    with np.load(bench.TILES_PATH) as data:
        assert sorted(data.files) == sorted(fresh)
        for k, v in fresh.items():
            assert data[k].dtype == v.dtype, k
            np.testing.assert_array_equal(data[k], v, err_msg=k)
    np.testing.assert_array_equal(fresh["images_16"],
                                  fresh["images_332"][:16])
    np.testing.assert_array_equal(fresh["pruned_counts_16"],
                                  fresh["pruned_counts_332"][:16])
    images, _, _, _, _ = jax_bench.build_problem(num_tiles=16)
    np.testing.assert_array_equal(np.asarray(images), fresh["images_16"])


def test_load_tiles_takes_a_prefix_and_never_another_draw(monkeypatch,
                                                          tmp_path):
    tiles = bench.load_tiles(4)
    assert tiles.images.shape == (4, 8, 8)
    assert tiles.images.dtype == torch.float32
    full = bench.load_tiles(332)
    assert torch.equal(full.images[:4], tiles.images)
    assert torch.equal(full.pruned_counts[:4], tiles.pruned_counts)
    with pytest.raises(ValueError, match="332"):
        bench.load_tiles(333)
    monkeypatch.setattr(bench, "TILES_PATH", tmp_path / "missing.npz")
    with pytest.raises(FileNotFoundError, match="torch_bench_tiles"):
        bench.build_problem("cpu")
    # the simulated tiles ([main]'s) need no file
    sim = bench.build_problem("cpu", tiles="simulate")[0]
    assert sim.images.shape == (16, 8, 8)


def test_build_problem_is_the_jax_bench_problem():
    """The prior, image model, kernel and SMC settings equal
    ``bench.py``'s: the configs field by field, the kernel's scales, and
    the prior's log density and the log-likelihood of the same catalogs on
    the bench's tiles to f32 tolerance (rtol 1e-5) against the port's
    objects converted from JAX's."""
    images, jprior, jmodel, jkernel, jcfg = jax_bench.build_problem(
        num_tiles=4)
    tiles, prior, model, kernel, cfg = bench.build_problem("cpu", 4)
    for f in ("num_catalogs", "ess_threshold_prop", "resample_method",
              "max_smc_iters", "flux_detection_threshold"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert kernel.num_iters == jkernel.num_iters
    ref = port_kernel(jkernel)
    for f in ("locs_stdev", "fluxes_stdev", "fluxes_min", "fluxes_max"):
        assert float(getattr(kernel, f)) == float(getattr(ref, f)), f
    rprior, rmodel = port_prior(jprior), port_model(jmodel)
    gen = torch.Generator().manual_seed(0)
    strata, locs, fluxes = prior.sample_stratified(gen, 16, (4,))
    counts = strata[None, :, None].expand(4, prior.num_counts, 16)
    temp = torch.full((4, 1, 1), 0.7)
    img = t(images)[:, None, None]
    got = init_kernel_state(TargetContext(prior, model, img, temp), counts,
                            locs, fluxes)
    want = init_kernel_state(TargetContext(rprior, rmodel, img, temp),
                             counts, locs, fluxes)
    torch.testing.assert_close(got.parent_ll, want.parent_ll, rtol=1e-5,
                               atol=1e-3)
    torch.testing.assert_close(got.logprior, want.logprior, rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(tiles.images, t(images))


@pytest.fixture
def easy_tiles(monkeypatch):
    """Tiles 7-10 of the bench's draw (0, 0, 1 and 1 stars), which reach
    temperature 1 at N = 64 in a few iterations; the first four need
    ~80 iterations at that width."""
    sixteen = bench.load_tiles(16)
    monkeypatch.setattr(bench, "load_tiles", lambda n: bench.BenchTiles(
        sixteen.images[7:7 + n], sixteen.pruned_counts[7:7 + n]))


def test_sorted_chunks_bills_real_tiles_and_prints_the_keys(easy_tiles,
                                                            capsys):
    """4 tiles, N = 64, 5 sweeps, chunks of 3 (the last one padded): the
    updates are the real tiles x strata x N x sweeps x each chunk's
    iterations, the rates that over the wall, and the JSON line has
    ``bench.py``'s keys."""
    record, info = bench.sorted_chunks("cpu", 4, 64, 5, chunk=3)
    print(json.dumps(record))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line) == PARSED_KEYS
    assert info["chunks"] == 2 and len(info["num_iters"]) == 2
    C = 7
    updates = (3 * info["num_iters"][0] + 1 * info["num_iters"][1]) * (
        C * 64 * 5)
    assert info["updates"] == updates
    assert record["value"] == pytest.approx(updates / info["elapsed"])
    assert record["vs_baseline"] == pytest.approx(
        record["value"] / bench.REFERENCE_UPDATES_PER_SEC)
    assert record["tiles_per_sec_to_target_ess"] == pytest.approx(
        4 / info["elapsed"])
    assert record["reference_tiles_per_sec"] == 1.0 / 40.0
    assert 0.0 < record["min_final_ess_prop"] <= 1.0
    assert "cpu" in record["metric"]
    assert info["mean_count"].shape == (4,)


def test_streaming_bills_slot_steps_and_prints_the_keys(easy_tiles,
                                                        capsys):
    """The pool of 2 on the same 4 tiles: billed by executed slot-steps
    (steps x pool x strata x N x sweeps), with ``bench.py``'s keys plus
    ``mean_tile_iters`` and ``slot_steps``."""
    record, info = bench.streaming("cpu", 4, 64, 5, pool=2)
    print(json.dumps(record))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line) == sorted(PARSED_KEYS + ["mean_tile_iters",
                                                 "slot_steps"])
    assert info["pool"] == 2
    assert record["slot_steps"] == info["steps"] * 2
    assert info["updates"] == info["steps"] * 2 * 7 * 64 * 5
    assert record["value"] == pytest.approx(info["updates"]
                                            / info["elapsed"])
    assert record["mean_tile_iters"] == pytest.approx(
        float(np.mean(info["per_tile_iters"])))
    assert "pool=2" in record["metric"]


def test_command_line_sizes(monkeypatch, capsys):
    """``--quick`` is 16 tiles at N = 2048 (chunk 16, pool at most 16),
    the default the 332-tile frame at N = 4096 (chunk 14, pool 28); without
    a card the default device raises."""
    calls = []

    def fake(kind):
        def run(*args):
            calls.append((kind,) + args)
            return {"metric": kind}, {}
        return run

    monkeypatch.setattr(bench, "sorted_chunks", fake("chunks"))
    monkeypatch.setattr(bench, "streaming", fake("stream"))
    bench.main(["--device", "cpu"])
    bench.main(["--quick", "--device", "cpu"])
    bench.main(["--streaming", "--device", "cpu"])
    bench.main(["--quick", "--streaming", "--pool=40", "--device", "cpu"])
    bench.main(["--streaming", "--pool=20", "--device", "cpu"])
    assert calls == [("chunks", "cpu", 332, 4096, 100, 14),
                     ("chunks", "cpu", 16, 2048, 100, 16),
                     ("stream", "cpu", 332, 4096, 100, 28),
                     ("stream", "cpu", 16, 2048, 100, 16),
                     ("stream", "cpu", 332, 4096, 100, 20)]
    assert len(capsys.readouterr().out.strip().splitlines()) == 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench._device("cuda")


def test_jax_bench_sorts_like_the_port():
    """The chunk order: ``bench.py`` sorts by ``jnp.argsort`` of the summed
    pixel values, the port by a stable ``torch.argsort``; on the frame's
    332 tiles the two orders are the same."""
    images = bench.load_tiles(332).images
    want = np.asarray(jnp.argsort(jnp.sum(jnp.asarray(images.numpy()),
                                          axis=(1, 2))))
    got = torch.argsort(images.sum((1, 2)), stable=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert jax.devices()[0].platform == "cpu"
