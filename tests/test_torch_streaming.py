"""The streaming tile pool (smcdet_tpu_torch/inference/streaming.py)
against smcdet_tpu/inference/streaming.py: the non-sharded cases of
``tests/test_streaming.py`` on the port, and both pools on the same 6
JAX-made tiles.

The problem is ``tests/test_streaming.py``'s: 8x8 tiles holding 0-3 bright
stars (tile i holds i mod 4), Poisson noise, a Gaussian PSF, Normal fluxes,
N = 256, 30 MH sweeps, at most 60 SMC iterations; the port's objects are
converted from the JAX ones and the images made by JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_streaming import _problem
from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread,
    port_kernel,
    port_model,
    port_prior,
)

from smcdet_tpu.inference.streaming import (
    run_csmc_streaming as jax_streaming,
)
from smcdet_tpu_torch.inference import smc as tsmc
from smcdet_tpu_torch.inference.streaming import run_csmc_streaming

# The per-tile count pmf's TVD between the JAX pool and the port's (both
# pool 2, 6 tiles). The spread between JAX seeds 1-4 on these tiles is at
# most 0.0061 (the port's seeds 1-4 against JAX's at most 0.0060); the
# bound is three times the JAX spread.
PMF_TVD_BOUND = 0.02


def _port(num_tiles, key=11):
    images, truth, prior, model, kernel, cfg = _problem(num_tiles, key)
    tcfg = tsmc.SMCConfig(
        num_catalogs=cfg.num_catalogs,
        ess_threshold_prop=cfg.ess_threshold_prop,
        resample_method=cfg.resample_method,
        max_smc_iters=cfg.max_smc_iters,
        flux_detection_threshold=cfg.flux_detection_threshold)
    return (torch.as_tensor(np.array(images)), truth, port_prior(prior),
            port_model(model), port_kernel(kernel), tcfg)


def _pmf(log_z):
    return torch.softmax(torch.as_tensor(np.asarray(log_z)), -1).numpy()


@pytest.fixture(scope="module")
def swapped():
    """6 tiles through the port's pool of 2 (seed 1) and JAX's (key 1)."""
    images, truth, prior, model, kernel, cfg = _problem(6)
    jres = jax_streaming(jax.random.key(1), images, prior, model, kernel,
                         cfg, pool=2)
    timages, _, tprior, tmodel, tkernel, tcfg = _port(6)
    tres, info = run_csmc_streaming(torch.Generator().manual_seed(1),
                                    timages, tprior, tmodel, tkernel, tcfg,
                                    pool=2, return_info=True)
    return truth, jres, tres, info


def test_stepping_a_done_tile_is_bitwise_identity():
    """The pool's speculative steps are exact only because ``csmc_step``
    freezes tiles at temperature 1: their particles, weights, log Z, ESS,
    acceptance and log-likelihoods pass through bit for bit."""
    images, _, prior, model, kernel, cfg = _port(3)
    gen = torch.Generator().manual_seed(7)
    state = tsmc.csmc_init(gen, images, prior, model, cfg)
    for _ in range(cfg.max_smc_iters):
        state = tsmc.csmc_step(images, prior, model, kernel, cfg, state)
        if float(state.temperature.max()) >= 1.0:
            break
    done = state.temperature >= 1.0
    assert done.any()
    after = tsmc.csmc_step(images, prior, model, kernel, cfg, state)
    for field in ("locs", "fluxes", "weights", "log_z", "ess", "acc_rate",
                  "temperature", "loglik"):
        assert torch.equal(getattr(state, field)[done],
                           getattr(after, field)[done]), field


def test_pool_covering_batch_matches_run_csmc():
    """With ``pool >= T`` there is no swap, and a finalize draws from a
    generator of its own, so the pool runs ``run_csmc``'s steps draw for
    draw: temperature, log Z, weights and ESS equal to 1e-6."""
    images, _, prior, model, kernel, cfg = _port(3)
    gold = tsmc.run_csmc(torch.Generator().manual_seed(0), images, prior,
                         model, kernel, cfg)
    got, info = run_csmc_streaming(torch.Generator().manual_seed(0), images,
                                   prior, model, kernel, cfg, pool=8,
                                   return_info=True)
    assert info["pool"] == 3
    for field in ("temperature", "log_normalizing_constant", "weights",
                  "ess"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   getattr(gold, field).numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=field)
    assert got.num_iters == gold.num_iters
    assert got.locs.shape == gold.locs.shape


def test_swapping_pool_returns_each_tile_exact(swapped):
    """pool 2 of 6 tiles forces swaps; every row is the posterior of its
    own tile: the count mode is the tile's star count."""
    truth, _, res, info = swapped
    assert info["pool"] == 2
    assert (info["per_tile_iters"] >= 1).all()
    assert res.num_iters == int(info["per_tile_iters"].max())
    assert info["steps"] > info["per_tile_iters"].sum() / 2
    assert torch.all(res.temperature == 1.0)
    assert torch.isfinite(res.log_normalizing_constant).all()
    np.testing.assert_array_equal(
        _pmf(res.log_normalizing_constant).argmax(-1), truth)
    np.testing.assert_allclose(res.weights.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_pool_matches_the_jax_pool(swapped):
    """The same 6 tiles through JAX's pool and the port's: both count modes
    equal the truth, and the per-tile count pmf's TVD stays within
    ``PMF_TVD_BOUND``."""
    truth, jres, tres, _ = swapped
    jpmf = _pmf(jres.log_normalizing_constant)
    tpmf = _pmf(tres.log_normalizing_constant)
    np.testing.assert_array_equal(jpmf.argmax(-1), truth)
    np.testing.assert_array_equal(tpmf.argmax(-1), truth)
    tvd = 0.5 * np.abs(jpmf - tpmf).sum(-1)
    assert tvd.max() <= PMF_TVD_BOUND, tvd
    assert tres.locs.shape == np.asarray(jres.locs).shape


def test_per_tile_background_rides_the_swaps():
    """A ``[T, 1, 1, h, w]`` background map follows its tile through the
    swaps: the tiles carry backgrounds 400 apart, so a slot using a stale
    one would push that tile's posterior to no star or to the most stars
    (a 400-ADU error over 64 pixels dwarfs a star's 800). Held: the count
    pmf within TVD 0.5 of the single-batch sampler's on the same map, and
    the posterior mean count within +-1 of the truth. The JAX test's bound
    is 0.2; on the port's draws the last tile (one star under a 2100 sky)
    splits between one and two stars from seed to seed: ``run_csmc`` alone
    on it moves its pmf by TVD 0.31 between seeds 2 and 3."""
    images, truth, prior, model, kernel, cfg = _problem(6)
    T, M = images.shape[0], 3
    levels = 100.0 + 400.0 * jnp.arange(T, dtype=jnp.float32)
    all_locs = jnp.asarray([[2.0, 2.0], [5.5, 5.5], [2.0, 6.0]],
                           dtype=jnp.float32)
    imgs = []
    for i in range(T):
        c = int(truth[i])
        locs = jnp.where((jnp.arange(M) < c)[:, None], all_locs,
                         jnp.zeros((M, 2)))
        fluxes = jnp.where(jnp.arange(M) < c, 800.0, 0.0)
        imgs.append(model.replace(background=levels[i]).sample(
            jax.random.fold_in(jax.random.key(5), i), locs, fluxes))
    images = torch.as_tensor(np.array(jnp.stack(imgs)))
    _, _, tprior, tmodel, tkernel, tcfg = _port(1)
    bg = torch.as_tensor(np.asarray(levels))[:, None, None, None, None]
    model_map = tmodel.with_background(bg.expand(T, 1, 1, 8, 8))
    res = run_csmc_streaming(torch.Generator().manual_seed(2), images,
                             tprior, model_map, tkernel, tcfg, pool=2)
    assert torch.all(res.temperature == 1.0)
    gold = tsmc.run_csmc(torch.Generator().manual_seed(2), images, tprior,
                         model_map, tkernel, tcfg)
    pmf = _pmf(res.log_normalizing_constant)
    tvd = 0.5 * np.abs(pmf - _pmf(gold.log_normalizing_constant)).sum(-1)
    assert tvd.max() < 0.5, tvd
    mean = pmf @ np.arange(pmf.shape[-1])
    assert (np.abs(mean - truth) <= 1.0).all(), (mean, truth)


def test_capped_tile_finalizes_at_exactly_the_cap():
    """A tile at ``max_smc_iters`` below temperature 1 is finalized from
    the state at the cap, not from the speculative steps its slot rides on:
    with pool >= T the result is ``run_csmc``'s at the same cap."""
    images, _, prior, model, kernel, cfg = _port(2)
    cfg = tsmc.SMCConfig(**{**cfg.__dict__, "max_smc_iters": 3})
    gold = tsmc.run_csmc(torch.Generator().manual_seed(9), images, prior,
                         model, kernel, cfg)
    got, info = run_csmc_streaming(torch.Generator().manual_seed(9), images,
                                   prior, model, kernel, cfg, pool=2,
                                   return_info=True)
    assert (info["per_tile_iters"] == 3).all()
    assert float(gold.temperature.max()) < 1.0
    np.testing.assert_allclose(got.temperature.numpy(),
                               gold.temperature.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got.log_normalizing_constant.numpy(),
                               gold.log_normalizing_constant.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_rejects_global_iteration_configs_and_devices():
    """``record_history`` and ``fixed_schedule`` raise ``ValueError``, as
    in JAX; ``devices=`` naming a CUDA device without a card raises
    ``RuntimeError`` (the tile split never runs a device's share
    elsewhere)."""
    images, _, prior, model, kernel, cfg = _port(2)
    gen = torch.Generator().manual_seed(0)
    for change in ({"record_history": True},
                   {"fixed_schedule": (0.5, 1.0)}):
        bad = tsmc.SMCConfig(**{**cfg.__dict__, **change})
        with pytest.raises(ValueError, match="adaptive tempering"):
            run_csmc_streaming(gen, images, prior, model, kernel, bad,
                               pool=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            run_csmc_streaming(gen, images, prior, model, kernel, cfg,
                               pool=2, devices=["cuda:0"])
