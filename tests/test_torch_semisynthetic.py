"""The m71semisynthetic generate step of the port
(smcdet_tpu_torch/semisynthetic.py, ``run_experiment --generate``) against
experiments/m71semisynthetic/generate_images.py: the noiseless rate of the
fixture's catalogs elementwise equal to the JAX package's M71 model's, the
sampled noise standard normal, the file's keys, and the suite through the
port's runner on the CPU."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu import config as jcfg
from smcdet_tpu_torch import config as tcfg, semisynthetic
from smcdet_tpu_torch.run_experiment import load_suite_config
from smcdet_tpu_torch.run_experiment import main as cli_main

REPO = Path(__file__).resolve().parents[1]
SUITE = REPO / "experiments" / "m71semisynthetic"
FIXTURE = REPO / "experiments" / "m71" / "data" / "m71" / "tiles.npz"
CONFIGS = {"padded": "config.yaml", "intile": "config_nospill.yaml",
           "reach": "config_reach.yaml"}
# generate_images.py:91-103
JAX_KEYS = {"images", "background", "checkerboard", "true_counts",
            "true_locs", "true_fluxes", "padded_counts", "padded_locs",
            "padded_fluxes", "tile_index"}


def test_suites_render_the_fixture_beside_their_params():
    for config in CONFIGS.values():
        cfg = load_suite_config(str(SUITE), config)
        assert semisynthetic.renders_fixture(cfg)
        assert semisynthetic.fixture_path(cfg).resolve() == FIXTURE
    for suite in ("m71", "basic", "m71synthetic"):
        assert not semisynthetic.renders_fixture(
            load_suite_config(str(REPO / "experiments" / suite)))


@pytest.mark.parametrize("catalog", list(CONFIGS))
def test_noiseless_rate_matches_jax(catalog):
    """The first 16 fixture tiles: the port's fitted M71 model over each
    tile's background map renders the ``catalog`` stars as the JAX
    package's does, elementwise to f32 rounding (rtol 1e-5 of ~900 ADU)."""
    config = CONFIGS[catalog]
    src = semisynthetic.CATALOGS[catalog]
    n = 16
    with np.load(FIXTURE) as m71:
        bg, locs, fluxes = (m71[k][:n].astype(np.float32) for k in (
            "background", f"{src}_locs", f"{src}_fluxes"))
    jmodel = jcfg.build_image_model(
        jcfg.load_config(SUITE / config).image_model)
    want = np.asarray(jmodel.replace(background=jnp.asarray(bg)).render(
        jnp.asarray(locs), jnp.asarray(fluxes)))
    cfg = load_suite_config(str(SUITE), config)
    tmodel = tcfg.build_image_model(cfg.image_model, "cpu")
    got = tmodel.with_background(torch.from_numpy(bg)).render(
        torch.from_numpy(locs), torch.from_numpy(fluxes)).numpy()
    assert got.shape == want.shape == (n, 8, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    assert (got - bg).max() > 100.0  # the stars are there


@pytest.fixture(scope="module")
def rendered():
    cfg = load_suite_config(str(SUITE))
    return cfg, semisynthetic.render_tiles(cfg, device="cpu")


def test_render_keeps_the_jax_keys(rendered):
    cfg, tiles = rendered
    assert set(tiles) == JAX_KEYS
    with np.load(FIXTURE) as m71:
        n = m71["images"].shape[0]
        for k in JAX_KEYS - {"images", "background"}:
            np.testing.assert_array_equal(tiles[k], m71[k][:n], err_msg=k)
        # float32, as the JAX script writes it
        np.testing.assert_array_equal(
            tiles["background"], m71["background"].astype(np.float32))
    assert tiles["images"].shape == (n, 8, 8)
    assert tiles["images"].dtype == np.float32
    # the same seed gives the same tiles; another catalog other tiles
    again = semisynthetic.render_tiles(cfg, num_images=4, device="cpu")
    np.testing.assert_array_equal(again["images"], tiles["images"][:4])
    other = semisynthetic.render_tiles(cfg, "reach", 4, device="cpu")
    assert not np.array_equal(other["images"], again["images"])
    with pytest.raises(ValueError, match="catalog"):
        semisynthetic.render_tiles(cfg, "nope", device="cpu")


def test_residuals_are_standard_normal(rendered):
    """Standardised residuals ``(image - rate) / sqrt(var)`` of all 688
    tiles (44,032 pixels) are N(0, 1): mean and standard deviation within
    4 standard errors, KS p above 1e-3."""
    cfg, tiles = rendered
    model = tcfg.build_image_model(cfg.image_model, "cpu").with_background(
        torch.from_numpy(tiles["background"]))
    with np.load(FIXTURE) as m71:
        rate = model.render(torch.from_numpy(m71["padded_locs"]),
                            torch.from_numpy(m71["padded_fluxes"]))
    var = model.noise_additive + model.noise_multiplicative * rate
    z = ((torch.from_numpy(tiles["images"]) - rate) / var.sqrt()).ravel()
    z = z.double().numpy()
    n = z.size
    assert abs(z.mean()) < 4 / np.sqrt(n)
    assert abs(z.std() - 1.0) < 4 / np.sqrt(2 * n)
    assert stats.kstest(z, "norm").pvalue > 1e-3


def test_cli_generates_and_the_runner_reads_it(tmp_path, monkeypatch,
                                               capsys):
    """``run_experiment --generate --catalog reach`` writes the suite's
    tiles; the runner then runs them with their background maps (a cut
    of the suite on the CPU); ``--catalog`` on another suite and a run
    before the tiles exist fail with a message."""
    from smcdet_tpu_torch import runner

    monkeypatch.chdir(tmp_path)
    cfg = load_suite_config(str(SUITE), "config_reach.yaml")
    with pytest.raises(FileNotFoundError, match="--generate"):
        runner.run_experiment(cfg, device="cpu")
    cli_main([str(SUITE), "--config", "config_reach.yaml", "--generate",
              "--catalog", "reach", "--num-images", "3", "--device", "cpu"])
    path = tmp_path / "output" / "m71ss_reach" / "tiles.npz"
    assert "saved 3 tiles" in capsys.readouterr().out
    with np.load(path) as written:
        want = semisynthetic.render_tiles(cfg, "reach", 3, device="cpu")
        for k in JAX_KEYS:
            np.testing.assert_array_equal(written[k], want[k], err_msg=k)
    with pytest.raises(SystemExit, match="m71semisynthetic"):
        cli_main([str(REPO / "experiments" / "basic"), "--generate",
                  "--catalog", "reach", "--num-images", "2"])

    cfg.num_images = cfg.batch_size = 2
    cfg.sampler.num_catalogs = 16
    cfg.sampler.max_smc_iters = 3
    cfg.kernel.num_iters = 2
    out = runner.run_experiment(cfg, device="cpu", verbose=False)
    res = runner.load_results(out)
    assert res["pruned_counts"].shape == (2, 16 * 11)
    np.testing.assert_allclose(res["weights"].sum(-1), 1.0, rtol=1e-5)
    manifest = json.loads((out / "smc_manifest_job0.json").read_text())
    assert manifest["batches"][0]["images"] == [0, 2]
