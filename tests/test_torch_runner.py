"""The port's experiment entry point (smcdet_tpu_torch/runner.py and
run_experiment.py) against smcdet_tpu/runner.py at a tiny size: the same
tiles in, the same files, keys, shapes and dtypes out, each package's
``load_results`` reading the other's output; for the chunked CS-SMC path
and for the per-image aggregation pipeline."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu import config as jcfg
from smcdet_tpu import runner as jrunner
from smcdet_tpu_torch import config as tcfg
from smcdet_tpu_torch import runner as trunner
from smcdet_tpu_torch.run_experiment import main as cli_main

REPO = Path(__file__).resolve().parents[1]


def _tiny_basic(tmp_path, out="out_torch"):
    """The basic suite at a tiny size: 3 images in batches of 2 (a ragged
    last batch), N = 32, 3 sweeps and 2 relocations per mutation, at most
    4 SMC iterations; tiles from the port's simulator in ``tiles.npz``."""
    cfg = tcfg.load_config(REPO / "experiments" / "basic" / "config.yaml")
    cfg.num_images = 3
    cfg.batch_size = 2
    cfg.output_dir = str(tmp_path / out)
    cfg.sampler.num_catalogs = 32
    cfg.sampler.max_smc_iters = 4
    cfg.sampler.relocate_sweeps = 2
    cfg.kernel.num_iters = 3
    tiles = tmp_path / "tiles.npz"
    if not tiles.exists():
        np.savez_compressed(tiles, **trunner.simulate_tiles(cfg))
    cfg.data_path = str(tiles)
    return cfg


def _both_runs(tmp_path):
    cfg = _tiny_basic(tmp_path)
    tdir = trunner.run_experiment(cfg, device="cpu", verbose=False)
    # the JAX runner reads the port's config from YAML, like a user would
    path = tmp_path / "cfg.yaml"
    tcfg.save_config(dataclasses.replace(cfg, output_dir=str(
        tmp_path / "out_jax")), path)
    jdir = jrunner.run_experiment(jcfg.load_config(path), verbose=False)
    return tdir, jdir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _both_runs(tmp_path_factory.mktemp("runner"))


def test_runner_writes_the_jax_runners_files(runs):
    tdir, jdir = runs
    names = sorted(p.name for p in Path(tdir).iterdir())
    assert names == sorted(p.name for p in Path(jdir).iterdir())
    assert names == ["smc_batch0000.npz", "smc_batch0001.npz",
                     "smc_manifest_job0.json"]
    for name in names[:2]:
        t, j = np.load(Path(tdir) / name), np.load(Path(jdir) / name)
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].shape == j[k].shape, (name, k)
            assert t[k].dtype == j[k].dtype, (name, k, t[k].dtype)
    t_man = json.loads((Path(tdir) / names[2]).read_text())
    j_man = json.loads((Path(jdir) / names[2]).read_text())
    for m in (t_man, j_man):
        for b in m["batches"]:
            del b["runtime_s"]
    assert t_man == j_man


def test_runner_outputs_are_a_posterior(runs):
    tdir, _ = runs
    res = trunner.load_results(tdir)
    assert res["image_index"].tolist() == [0, 1, 2]
    assert res["counts"].dtype == np.int32
    np.testing.assert_allclose(res["weights"].sum(-1), 1.0, rtol=1e-5)
    assert np.isfinite(res["log_normalizing_constant"]).all()
    assert res["num_iters"].shape == (2,)
    assert (res["num_iters"] >= 1).all() and (res["num_iters"] <= 4).all()


@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_each_load_results_reads_the_others_output(runs, reader):
    load = trunner.load_results if reader == "torch" else \
        jrunner.load_results
    tdir, jdir = runs
    a, b = load(tdir), load(jdir)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


def test_runner_resumes_and_shards_reproducibly(tmp_path):
    cfg = _tiny_basic(tmp_path)
    cfg.sampler.max_smc_iters = 2
    full = trunner.run_experiment(cfg, device="cpu", verbose=False)
    before = (full / "smc_batch0001.npz").read_bytes()
    # resume: an existing batch file is skipped
    trunner.run_experiment(cfg, device="cpu", verbose=False)
    assert (full / "smc_batch0001.npz").read_bytes() == before
    # job 1 of 2 runs only batch 1, and reproduces it from (seed, batch)
    sharded = _tiny_basic(tmp_path, out="out_shard")
    sharded.sampler.max_smc_iters = 2
    out = trunner.run_experiment(sharded, job_index=1, num_jobs=2,
                                 device="cpu", verbose=False)
    assert sorted(p.name for p in out.glob("*.npz")) == ["smc_batch0001.npz"]
    a, b = np.load(full / "smc_batch0001.npz"), np.load(
        out / "smc_batch0001.npz")
    for k in a.files:
        if k != "runtime":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_runner_rejects_unported_paths(tmp_path):
    """``sampler.streaming`` is ported (the streaming pool: the JAX
    runner's ``tests/test_runner.py`` streaming case): the streaming
    runner's outputs have the chunked runner's files, keys and shapes.
    Method "mcmc" is ported too (test_torch_mcmc.py); an unknown method
    raises."""
    chunked = trunner.load_results(trunner.run_experiment(
        _tiny_basic(tmp_path), device="cpu", verbose=False))
    cfg = _tiny_basic(tmp_path, out="out_stream")
    cfg.sampler.streaming = True
    cfg.sampler.streaming_pool = 1
    out = trunner.run_experiment(cfg, device="cpu", verbose=False)
    assert sorted(p.name for p in out.glob("smc_batch*.npz")) == [
        "smc_batch0000.npz", "smc_batch0001.npz"]
    stream = trunner.load_results(out)
    assert sorted(stream) == sorted(chunked)
    for k in chunked:
        assert stream[k].shape == chunked[k].shape, k
        assert stream[k].dtype == chunked[k].dtype, k
    assert np.isfinite(stream["log_normalizing_constant"]).all()
    np.testing.assert_allclose(stream["weights"].sum(-1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown method 'sampler'"):
        trunner.run_experiment(_tiny_basic(tmp_path), method="sampler",
                               device="cpu")


def test_aggregation_runner_runs_pair_sweeps(tmp_path, monkeypatch):
    """``aggregation.pair_sweeps: 8`` on the tiny divideandconquer batch,
    with room for every stage to finish: each bridge iteration runs the
    pair move and every level ends at temperature 1."""
    from smcdet_tpu_torch.inference import aggregate as tagg

    cfg = _tiny_dnc(tmp_path)
    cfg.sampler.max_smc_iters = 100
    cfg.aggregation.max_smc_iters = 100
    cfg.aggregation.pair_sweeps = 8
    calls, levels = [], []
    pair, run = tagg.pair_redistribute_sweeps, tagg.Aggregate.run

    def counted(*args, **kwargs):
        calls.append(args[4])
        return pair(*args, **kwargs)

    def recorded(agg, *args, **kwargs):
        out = run(agg, *args, **kwargs)
        levels.extend(agg.diagnostics)
        return out

    monkeypatch.setattr(tagg, "pair_redistribute_sweeps", counted)
    monkeypatch.setattr(tagg.Aggregate, "run", recorded)
    out = trunner.run_experiment(cfg, device="cpu", verbose=False)
    assert len(levels) == 2
    assert len(calls) == sum(d["iterations"] for d in levels) > 0
    assert set(calls) == {8}
    for d in levels:
        assert torch.all(d["temperature"] == 1.0), d
    res = trunner.load_results(out)
    np.testing.assert_allclose(res["weights"].sum(-1), 1.0, rtol=1e-5)
    assert np.isfinite(res["log_normalizing_constant"].max(-1)).all()


def test_batch_generator_is_a_function_of_seed_and_batch():
    def draw(seed, batch):
        return torch.rand(4, generator=trunner.batch_generator(seed, batch,
                                                               "cpu"))

    assert torch.equal(draw(7, 3), draw(7, 3))
    assert not torch.equal(draw(7, 3), draw(7, 4))
    assert not torch.equal(draw(7, 3), draw(8, 3))


def test_simulate_tiles_is_seeded_with_the_jax_layout(tmp_path):
    cfg = _tiny_basic(tmp_path)
    a, b = trunner.simulate_tiles(cfg), trunner.simulate_tiles(cfg)
    j = jrunner.simulate_tiles(
        jcfg._from_dict(jcfg.ExperimentConfig, tcfg._to_dict(cfg)))
    assert sorted(a) == sorted(j)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].shape == j[k].shape and a[k].dtype == j[k].dtype, k


def test_cli_generates_and_runs_on_the_cpu(tmp_path, capsys):
    cfg = _tiny_basic(tmp_path, out="out_cli")
    cfg.data_path = None
    cfg.sampler.max_smc_iters = 2
    suite = tmp_path / "suite"
    tcfg.save_config(cfg, suite / "config.yaml")
    cli_main([str(suite), "--generate", "--num-images", "2"])
    tiles = Path(cfg.output_dir) / cfg.name / "tiles.npz"
    assert np.load(tiles)["images"].shape == (2, 8, 8)
    cli_main([str(suite / "config.yaml"), "--num-images", "2", "--device",
              "cpu"])
    assert "results in" in capsys.readouterr().out
    assert (Path(cfg.output_dir) / cfg.name / "smc_batch0000.npz").exists()


def test_cli_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_basic(tmp_path)
    tcfg.save_config(cfg, tmp_path / "c.yaml")
    with pytest.raises(SystemExit, match="CUDA"):
        cli_main([str(tmp_path / "c.yaml")])
    assert not (Path(cfg.output_dir) / cfg.name).exists()


def test_simulate_tiles_draws_the_jax_distribution():
    """The port's simulator draws what the JAX package's does for the cells
    suite (the suites' scores compare the two on different draws): KS over
    1500 tiles on the pruned and unpruned counts and the total flux."""
    from scipy.stats import ks_2samp

    cfg = tcfg.load_config(REPO / "experiments" / "cells" / "config.yaml")
    cfg.num_images = 1500
    a = trunner.simulate_tiles(cfg)
    b = jrunner.simulate_tiles(
        jcfg._from_dict(jcfg.ExperimentConfig, tcfg._to_dict(cfg)))
    for key in ("true_counts", "unpruned_counts"):
        assert ks_2samp(a[key], b[key]).pvalue > 1e-3, key
    assert ks_2samp(a["true_fluxes"].sum(-1),
                    b["true_fluxes"].sum(-1)).pvalue > 1e-3
    assert ks_2samp(a["images"].reshape(1500, -1).sum(-1),
                    b["images"].reshape(1500, -1).sum(-1)).pvalue > 1e-3


# ----------------------------------------------------------------------
# The per-image aggregation pipeline
# ----------------------------------------------------------------------
def _tiny_dnc(tmp_path, out="out_torch"):
    """The divideandconquer suite at a tiny size: one batch of one 16x16
    image (a 2x2 grid of 8x8 tiles), N = 16, 2 sweeps, 2 relocations, at
    most 3 tile and 3 bridge iterations. (The JAX runner compiles its
    pipeline on its first image: about 25 s on the CPU.)"""
    cfg = tcfg.load_config(REPO / "experiments" / "divideandconquer"
                           / "config.yaml")
    cfg.num_images = 1
    cfg.batch_size = 1
    cfg.output_dir = str(tmp_path / out)
    cfg.sampler.num_catalogs = 16
    cfg.sampler.max_smc_iters = 3
    cfg.kernel.num_iters = 2
    cfg.aggregation.max_smc_iters = 3
    cfg.aggregation.relocate_sweeps = 2
    tiles = tmp_path / "tiles.npz"
    if not tiles.exists():
        np.savez_compressed(tiles, **trunner.simulate_tiles(cfg))
    cfg.data_path = str(tiles)
    return cfg


@pytest.fixture(scope="module")
def agg_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("agg_runner")
    cfg = _tiny_dnc(tmp)
    with pytest.warns(UserWarning, match="max_smc_iters"):
        tdir = trunner.run_experiment(cfg, device="cpu", verbose=False)
    path = tmp / "cfg.yaml"
    tcfg.save_config(dataclasses.replace(cfg, output_dir=str(
        tmp / "out_jax")), path)
    with pytest.warns(UserWarning, match="max_smc_iters"):
        jdir = jrunner.run_experiment(jcfg.load_config(path), verbose=False)
    return tdir, jdir


_AGG_KEYS = ["counts", "fluxes", "image_index", "locs",
             "log_normalizing_constant", "pruned_counts", "pruned_fluxes",
             "pruned_locs", "runtime", "runtime_per_image", "weights"]


def test_aggregation_runner_writes_the_jax_runners_files(agg_runs):
    tdir, jdir = agg_runs
    names = sorted(p.name for p in Path(tdir).iterdir())
    assert names == sorted(p.name for p in Path(jdir).iterdir())
    assert names == ["smc_batch0000.npz", "smc_manifest_job0.json"]
    for name in names[:1]:
        t, j = np.load(Path(tdir) / name), np.load(Path(jdir) / name)
        assert sorted(t.files) == sorted(j.files) == _AGG_KEYS
        for k in j.files:
            assert t[k].shape == j[k].shape, (name, k)
            assert t[k].dtype == j[k].dtype, (name, k, t[k].dtype)
    res = trunner.load_results(tdir)
    assert res["image_index"].tolist() == [0]
    # C = 9 x N = 16 flat particles per tile and merged tile, 8 -> 16 ->
    # 32 slots
    assert res["locs"].shape == (1, 9 * 16, 32, 2)
    np.testing.assert_allclose(res["weights"].sum(-1), 1.0, rtol=1e-5)
    assert np.isfinite(res["log_normalizing_constant"].max(-1)).all()
    assert (res["runtime_per_image"] > 0).all()


@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_each_load_results_reads_the_others_aggregation_output(agg_runs,
                                                                reader):
    load = trunner.load_results if reader == "torch" else \
        jrunner.load_results
    tdir, jdir = agg_runs
    a, b = load(tdir), load(jdir)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


def test_aggregation_runner_replicates_pool(tmp_path):
    cfg = _tiny_dnc(tmp_path)
    cfg.sampler.replicates = 2
    with pytest.warns(UserWarning):
        out = trunner.run_experiment(cfg, device="cpu", verbose=False)
    res = trunner.load_results(out)
    assert res["counts"].shape == (1, 2 * 9 * 16)
    np.testing.assert_allclose(res["weights"].sum(-1), 1.0, rtol=1e-5)


def test_m71_fixture_with_tile_backgrounds_runs(tmp_path, capsys):
    """The real-data suite through the CLI: the fitted-params overlay, the
    data path read from the suite directory, per-tile background maps, no
    aggregation level (8x8 images of one tile)."""
    cfg = tcfg.load_config(REPO / "experiments" / "m71" / "config.yaml")
    assert cfg.use_tile_backgrounds and cfg.aggregation.enabled
    cfg.num_images = 2
    cfg.batch_size = 2
    cfg.output_dir = str(tmp_path / "out")
    cfg.sampler.num_catalogs = 16
    cfg.sampler.max_smc_iters = 3
    cfg.kernel.num_iters = 2
    # a suite directory beside the real one's data: the relative data and
    # params paths resolve from the suite directory
    data = REPO / "experiments" / "m71" / "data"
    suite = tmp_path / "suite"
    suite.mkdir()
    (suite / "data").symlink_to(data, target_is_directory=True)
    tcfg.save_config(cfg, suite / "config.yaml")
    assert cfg.data_path == "data/m71/tiles.npz"
    cli_main([str(suite), "--device", "cpu"])
    assert "results in" in capsys.readouterr().out
    res = trunner.load_results(Path(cfg.output_dir) / "m71")
    assert res["image_index"].tolist() == [0, 1]
    assert res["counts"].shape == (2, 11 * 16)
    assert np.isfinite(res["log_normalizing_constant"]).all()
    # the tiles' own background maps, not the config's scalar
    tiles = np.load(data / "m71" / "tiles.npz")
    assert not np.allclose(tiles["background"][0], cfg.image_model.background)
