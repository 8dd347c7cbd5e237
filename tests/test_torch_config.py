"""smcdet_tpu_torch/config.py against smcdet_tpu/config.py: every shipped
experiment config loads to the same tree, and ``build_prior``,
``build_image_model`` and ``build_kernel`` give the same priors, image
models and kernels (f32, rtol = atol = 1e-5 unless stated)."""

import glob
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread, t  # noqa: F401  (autouse)

from smcdet_tpu import config as jcfg
from smcdet_tpu_torch import config as tcfg

RTOL = ATOL = 1e-5
REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(
    str(Path(p).relative_to(REPO))
    for p in glob.glob(str(REPO / "experiments" / "**" / "config*.yaml"),
                       recursive=True)
)


def test_every_suite_has_a_config():
    assert "experiments/basic/config.yaml" in CONFIGS
    assert "experiments/cells/config.yaml" in CONFIGS
    assert len(CONFIGS) >= 16


@pytest.mark.parametrize("path", CONFIGS)
def test_shipped_config_loads_like_jax(path):
    """The dataclass tree, the ``params_path`` overlay included."""
    full = REPO / path
    got = tcfg._to_dict(tcfg.load_config(full))
    assert got == jcfg._to_dict(jcfg.load_config(full))
    raw = tcfg._to_dict(tcfg.load_config(full, apply_params=False))
    assert raw == jcfg._to_dict(jcfg.load_config(full, apply_params=False))


def test_params_overlay_applies():
    full = REPO / "experiments" / "m71" / "config.yaml"
    cfg = tcfg.load_config(full)
    assert cfg.params_path is not None
    assert tcfg._to_dict(cfg) != tcfg._to_dict(
        tcfg.load_config(full, apply_params=False))


def test_save_config_round_trips_through_both_packages(tmp_path):
    cfg = tcfg.load_config(REPO / "experiments" / "cells" / "config.yaml")
    cfg.sampler.num_catalogs = 64
    path = tmp_path / "cfg.yaml"
    tcfg.save_config(cfg, path)
    assert tcfg._to_dict(tcfg.load_config(path)) == tcfg._to_dict(cfg)
    assert jcfg._to_dict(jcfg.load_config(path)) == tcfg._to_dict(cfg)


# ----------------------------------------------------------------------
# build_prior, build_image_model, build_kernel
# ----------------------------------------------------------------------
_FAMILIES = {
    "m71": dict(max_objects=6),
    "pareto_star": dict(max_objects=8, pad=2.0, flux_scale=345.84,
                        flux_alpha=2.0),
    "star": dict(max_objects=3, flux_mean=2000.0, flux_stdev=300.0),
    "poisson": dict(max_objects=5, counts_rate=0.05),
    "geometric": dict(max_objects=4, image_height=16, image_width=16),
}


@pytest.mark.parametrize("family", list(_FAMILIES))
def test_build_prior_matches_jax(family):
    pc = dict(family=family, **_FAMILIES[family])
    jp = jcfg.build_prior(jcfg.PriorConfig(**pc))
    tp = tcfg.build_prior(tcfg.PriorConfig(**pc), device="cpu")
    M = jp.max_objects
    assert tp.num_counts == jp.num_counts and tp.max_objects == M
    assert (tp.flux is None) == (jp.flux is None)
    np.testing.assert_array_equal(tp.loc_high.numpy(),
                                  np.asarray(jp.loc_high))
    rng = np.random.default_rng(0)
    counts = rng.integers(0, M + 1, (40,)).astype(np.int32)
    locs = rng.uniform(-1.0, 17.0, (40, M, 2)).astype(np.float32)
    fluxes = rng.uniform(400.0, 1800.0, (40, M)).astype(np.float32)
    np.testing.assert_allclose(
        tp.log_prob(torch.from_numpy(counts), t(locs), t(fluxes)).numpy(),
        np.asarray(jp.log_prob(counts, locs, fluxes)), rtol=RTOL, atol=1e-4)
    support = np.arange(0, M + 1, dtype=np.int32)
    np.testing.assert_allclose(
        tp.count_log_prob_truncated(torch.from_numpy(support)).numpy(),
        np.asarray(jp.count_log_prob_truncated(support)), rtol=RTOL,
        atol=ATOL)


def test_build_prior_unknown_family():
    with pytest.raises(ValueError, match="family"):
        tcfg.build_prior(tcfg.PriorConfig(family="nope"))


_IMAGE_KINDS = {
    "m71": dict(),
    "gaussian": dict(image_height=16, image_width=16, background=50.0,
                     psf_radius=6, psf_stdev=1.4),
}


@pytest.mark.parametrize("kind", list(_IMAGE_KINDS))
def test_build_image_model_matches_jax(kind):
    ic = dict(kind=kind, **_IMAGE_KINDS[kind])
    jm = jcfg.build_image_model(jcfg.ImageModelConfig(**ic))
    tm = tcfg.build_image_model(tcfg.ImageModelConfig(**ic), device="cpu")
    # kind "gaussian" names the PSF: its noise is Poisson
    assert tm.noise == jm.noise == ("poisson" if kind == "gaussian"
                                    else "gaussian")
    assert type(tm.psf).__name__ == type(jm.psf).__name__
    assert (tm.height, tm.width, tm.psf_radius) == (
        jm.height, jm.width, jm.psf_radius)
    H = jm.height
    rng = np.random.default_rng(1)
    locs = rng.uniform(-1.0, H + 1.0, (3, 5, 4, 2)).astype(np.float32)
    fluxes = rng.uniform(1.0, 900.0, (3, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(tm.star_image_flat(t(locs)).numpy(),
                               np.asarray(jm.star_image_flat(locs)),
                               rtol=RTOL, atol=ATOL)
    rate = np.asarray(jm.render(locs, fluxes))
    np.testing.assert_allclose(tm.render(t(locs), t(fluxes)).numpy(), rate,
                               rtol=RTOL, atol=1e-3)
    image = np.round(rate * rng.uniform(0.8, 1.2, rate.shape)).astype(
        np.float32)
    # sums of H*W terms of up to ~1e3 nats
    np.testing.assert_allclose(
        tm.loglikelihood(t(image), t(locs), t(fluxes)).numpy(),
        np.asarray(jm.loglikelihood(image, locs, fluxes)), rtol=RTOL,
        atol=1e-3)


def test_build_kernel_matches_jax():
    kc = dict(num_iters=200, locs_stdev=0.3, fluxes_stdev=40.0,
              fluxes_min=50.0, fluxes_max=1e5)
    jk = jcfg.build_kernel(jcfg.KernelConfig(**kc))
    tk = tcfg.build_kernel(tcfg.KernelConfig(**kc), device="cpu")
    assert tk.num_iters == jk.num_iters == 200
    for name in ("locs_stdev", "fluxes_stdev", "fluxes_min", "fluxes_max"):
        assert float(getattr(tk, name)) == float(getattr(jk, name)), name
    assert tk.backend == "auto"


def test_build_kernel_mala_names_missing_kernel():
    """``kind: mala`` builds the port's SingleComponentMALA with the JAX
    package's field mapping (step sizes from ``locs_stdev`` /
    ``fluxes_stdev``); an unknown kind still raises."""
    from smcdet_tpu_torch.inference.kernels import SingleComponentMALA

    kc = dict(kind="mala", num_iters=60, locs_stdev=0.05, fluxes_stdev=20.0,
              fluxes_min=345.84, fluxes_max=1e6)
    jk = jcfg.build_kernel(jcfg.KernelConfig(**kc))
    tk = tcfg.build_kernel(tcfg.KernelConfig(**kc), device="cpu")
    assert type(jk).__name__ == "SingleComponentMALA"
    assert isinstance(tk, SingleComponentMALA)
    assert tk.num_iters == jk.num_iters == 60
    for name in ("locs_step", "fluxes_step", "fluxes_min", "fluxes_max"):
        assert float(getattr(tk, name)) == float(getattr(jk, name)), name
    assert tk.backend == "auto"
    with pytest.raises(NotImplementedError, match="sqjumpdist"):
        tcfg.build_kernel(tcfg.KernelConfig(sqjumpdist_tol=1e-3, **kc),
                          device="cpu")
    with pytest.raises(ValueError, match="kernel kind"):
        tcfg.build_kernel(tcfg.KernelConfig(kind="nope"))


def test_dispatch_iters_is_accepted():
    cfg = tcfg.load_config(REPO / "experiments" / "cells" / "config.yaml")
    assert cfg.sampler.dispatch_iters == 25
    assert cfg.sampler.relocate_sweeps == 16
