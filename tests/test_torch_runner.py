"""The port's experiment entry point (smcdet_tpu_torch/runner.py and
run_experiment.py) against smcdet_tpu/runner.py at a tiny size: the same
tiles in, the same files, keys, shapes and dtypes out, each package's
``load_results`` reading the other's output."""

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


@pytest.mark.parametrize("change,match", [
    (lambda c: setattr(c.aggregation, "enabled", True), "item 9"),
    (lambda c: setattr(c.sampler, "streaming", True), "item 11"),
])
def test_runner_rejects_unported_paths(tmp_path, change, match):
    cfg = _tiny_basic(tmp_path)
    change(cfg)
    with pytest.raises(NotImplementedError, match=match):
        trunner.run_experiment(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        trunner.run_experiment(_tiny_basic(tmp_path), method="mcmc",
                               device="cpu")


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
