"""The CS-SMC loop (smcdet_tpu_torch/inference/smc.py) against
smcdet_tpu/inference/smc.py: the deterministic reweighting step on the
same inputs, and the whole slice (``run_csmc``) statistically."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    m71_problem,
    one_torch_thread,
    port_kernel,
    port_model,
    port_prior,
    t,
)

from smcdet_tpu.inference import smc as jsmc
from smcdet_tpu_torch.inference import smc as tsmc
from smcdet_tpu_torch.inference.kernels import SingleComponentMH

# two 8x8 M71 tiles: three and two bright, well-separated stars
_LOCS = [[[1.8, 2.0], [6.2, 2.5], [4.0, 6.3]],
         [[2.3, 5.6], [5.9, 2.4], [0.0, 0.0]]]
_FLUXES = [[80.0, 120.0, 100.0], [90.0, 150.0, 0.0]]


def _slice_problem():
    prior, model, kernel = m71_problem(max_objects=3)
    images = jax.jit(model.sample)(jax.random.key(3),
                                   jnp.asarray(_LOCS, jnp.float32),
                                   jnp.asarray(_FLUXES, jnp.float32))
    return prior, model, kernel.replace(num_iters=20), images


def _summary(log_z, weights, fluxes):
    pmf = np.asarray(jax.nn.softmax(np.asarray(log_z), -1))
    flux = (np.asarray(weights) * np.asarray(fluxes).sum(-1)).sum(-1)
    return pmf, flux


def test_run_csmc_matches_jax():
    """N = 256 per stratum, C = 4, 20 sweeps, systematic resampling.

    Tolerances from the JAX run's own seed-to-seed spread (max pairwise
    difference over seeds 0-7 of jit(run_csmc) on these tiles, CPU):
    posterior mean total flux 3.51 / 2.94 nmgy -> 10.5 (3x the larger);
    count pmf TV 0.0 on tile 0 -> 0.01. On tile 1 the evidence estimator
    splits its mass between 2 and 3 stars from seed to seed (TV spread
    0.91, the mode flips), so there the check is that no mass falls below
    the true count.
    """
    prior, model, kernel, images = _slice_problem()
    cfg = jsmc.SMCConfig(num_catalogs=256, resample_method="systematic",
                         flux_detection_threshold=0.7)
    jr = jax.jit(jsmc.run_csmc, static_argnums=5)(
        jax.random.key(0), images, prior, model, kernel, cfg)
    tcfg = tsmc.SMCConfig(num_catalogs=256, resample_method="systematic",
                          flux_detection_threshold=0.7)
    tr = tsmc.run_csmc(torch.Generator().manual_seed(0), t(images),
                       port_prior(prior), port_model(model),
                       port_kernel(kernel), tcfg)

    assert np.all(np.asarray(jr.temperature) == 1.0)
    assert torch.all(tr.temperature == 1.0)
    assert tr.pruned_counts.shape == jr.pruned_counts.shape
    assert tr.locs.shape == jr.locs.shape
    jpmf, jflux = _summary(jr.log_normalizing_constant, jr.weights,
                           jr.fluxes)
    tpmf, tflux = _summary(tr.log_normalizing_constant, tr.weights,
                           tr.fluxes)
    assert tpmf[0].argmax() == jpmf[0].argmax() == 3
    assert 0.5 * np.abs(tpmf[0] - jpmf[0]).sum() <= 0.01
    assert tpmf[1, :2].sum() < 0.01 and jpmf[1, :2].sum() < 0.01
    np.testing.assert_allclose(tflux, jflux, atol=10.5)
    np.testing.assert_allclose(tr.weights.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_temper_and_reweight_matches_jax():
    rng = np.random.default_rng(0)
    T, C, N = 3, 4, 128
    loglik = (rng.normal(size=(T, C, N)) * 20 - 500).astype(np.float32)
    temp = np.asarray([0.0, 0.4, 1.0], np.float32)
    log_z = rng.normal(size=(T, C)).astype(np.float32)
    weights = rng.dirichlet(np.ones(N), (T, C)).astype(np.float32)
    ess = np.full((T, C), 50.0, np.float32)
    prev = rng.normal(size=(T, C, N)).astype(np.float32)
    jstate = jsmc.SMCState(
        key=jax.random.key(0), locs=None, fluxes=None,
        temperature=jnp.asarray(temp), temperature_prev=jnp.asarray(temp),
        loglik=jnp.asarray(prev), weights=jnp.asarray(weights),
        log_z=jnp.asarray(log_z), ess=jnp.asarray(ess),
        acc_rate=jnp.zeros(T), iteration=jnp.int32(1),
    )
    cfg = jsmc.SMCConfig(num_catalogs=N)
    want = jsmc._temper_and_reweight(None, None, None, cfg, jstate,
                                     loglik=jnp.asarray(loglik))
    tstate = tsmc.SMCState(
        generator=None, locs=None, fluxes=None, temperature=t(temp),
        temperature_prev=t(temp), loglik=t(prev), weights=t(weights),
        log_z=t(log_z), ess=t(ess), acc_rate=torch.zeros(T), iteration=1,
    )
    got = tsmc._temper_and_reweight(tsmc.SMCConfig(num_catalogs=N), tstate,
                                    t(loglik))
    for name in ("temperature", "loglik", "weights", "log_z", "ess"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_tile_image_matches_jax():
    img = np.arange(20 * 17, dtype=np.float32).reshape(20, 17)
    np.testing.assert_array_equal(
        tsmc.tile_image(t(img), 2, 2, 8).numpy(),
        np.asarray(jsmc.tile_image(img, 2, 2, 8)),
    )


def test_csmc_step_freezes_finished_tiles():
    prior, model, kernel, images = _slice_problem()
    tp, tm = port_prior(prior), port_model(model)
    tk = port_kernel(kernel.replace(num_iters=2))
    cfg = tsmc.SMCConfig(num_catalogs=32, resample_method="multinomial")
    state = tsmc.csmc_init(torch.Generator().manual_seed(1), t(images), tp,
                           tm, cfg)
    state = state._replace(temperature=torch.tensor([1.0, 0.5]))
    new = tsmc.csmc_step(t(images), tp, tm, tk, cfg, state)
    for name in ("locs", "fluxes", "weights", "loglik", "ess", "log_z"):
        assert torch.equal(getattr(new, name)[0], getattr(state, name)[0])
    assert not torch.equal(new.locs[1], state.locs[1])
    assert new.iteration == 1 and float(new.temperature[1]) > 0.5


def test_run_csmc_chunked_sorts_and_restores_tile_order():
    prior, model, kernel, images = _slice_problem()
    tp, tm = port_prior(prior), port_model(model)
    tk = port_kernel(kernel.replace(num_iters=10))
    # tile 1 empty (background only), tile 0 and 2 bright
    imgs = torch.stack([t(images[0]), t(images[0]) * 0 + 179.0,
                        t(images[1])])
    cfg = tsmc.SMCConfig(num_catalogs=64, resample_method="systematic",
                         flux_detection_threshold=0.7)
    per_tile = tsmc.max_tiles_per_chunk(tp, 64, 64, 2**40)
    budget = 2 * (2**40 // per_tile)  # two tiles per chunk -> 2 chunks
    r = tsmc.run_csmc_chunked(torch.Generator().manual_seed(2), imgs, tp,
                              tm, tk, cfg, budget_bytes=budget,
                              sort_tiles=True)
    assert r.temperature.shape == (3,) and torch.all(r.temperature == 1.0)
    assert r.locs.shape == (3, 4 * 64, 3, 2)
    flux = (r.weights * r.fluxes.sum(-1)).sum(-1)
    mean_count = (r.weights * r.pruned_counts).sum(-1)
    # results are back in the caller's order
    assert float(flux[0]) > 250 and float(flux[2]) > 200
    assert float(flux[1]) < 30 and float(mean_count[1]) < 0.5
    assert isinstance(r.num_iters, int) and r.num_iters > 0


def test_max_tiles_per_chunk_formula_matches_jax():
    """The port's formula is the JAX package's with ``RATE_COPIES`` copies
    of the rate cache where JAX counts 5: the port's eager step holds more
    at its peak (measured on the card), so each tile is budgeted that many
    more rate copies, whatever moves the step runs."""
    prior, _, _, _ = _slice_problem()
    p = port_prior(prior)
    assert tsmc.RATE_COPIES > 5
    for N, hw in ((2048, 64), (512, 64), (4096, 256)):
        jax_tile = (tsmc.chunk_bytes_per_tile(p, N, hw)
                    - (tsmc.RATE_COPIES - 5) * p.num_counts * N * hw * 4)
        for k in (1, 7, 100):
            assert jsmc.max_tiles_per_chunk(prior, N, hw, k * jax_tile) == k
            assert jsmc.max_tiles_per_chunk(prior, N, hw,
                                            k * jax_tile - 1) == max(1, k - 1)
    for budget in (2**30, 12 * 2**30):
        assert tsmc.max_tiles_per_chunk(p, 2048, 64, budget) <= (
            jsmc.max_tiles_per_chunk(prior, 2048, 64, budget))
    assert tsmc.default_budget_bytes("cpu") > 0


def test_chunk_estimate_fits_k_tiles():
    """``k`` tiles' estimate fits ``k`` tiles and a byte less fits
    ``k - 1``, at 8x8 and 16x16."""
    prior, _, _, _ = _slice_problem()
    p = port_prior(prior)
    for N, hw in ((512, 64), (4096, 256)):
        tile = tsmc.chunk_bytes_per_tile(p, N, hw)
        assert tile == p.num_counts * N * (
            tsmc.RATE_COPIES * hw + 8 * p.max_objects + 32) * 4
        for k in (1, 10, 100):
            assert tsmc.max_tiles_per_chunk(p, N, hw, k * tile) == k
            assert tsmc.max_tiles_per_chunk(p, N, hw, k * tile - 1) == max(
                1, k - 1)


def test_smc_sampler_end_to_end():
    prior, model, kernel, images = _slice_problem()
    frame = np.concatenate([np.asarray(images[0]), np.asarray(images[1])], 1)
    s = tsmc.SMCSampler(frame, 8, port_prior(prior), port_model(model),
                        port_kernel(kernel.replace(num_iters=10)),
                        num_catalogs=64, resample_method="systematic",
                        flux_detection_threshold=0.7)
    r = s.run(torch.Generator().manual_seed(0))
    assert s.has_run and torch.all(r.temperature == 1.0)
    count = s.posterior_mean_count()
    assert count.shape == (2,) and float(count[0]) > 2.0
    assert s.posterior_mean_total_flux().shape == (2,)
    obs = s.posterior_predictive_total_observed_flux(
        torch.Generator().manual_seed(1))
    assert obs.shape == (2, 4 * 64)


def test_unported_options_raise():
    # relocate_sweeps and pair_sweeps are ported (tests/test_torch_relocate.py,
    # tests/test_torch_pair.py), and so are sqjumpdist_tol, record_history
    # and fixed_schedule (tests/test_torch_early_stop.py,
    # tests/test_torch_history.py)
    assert tsmc.SMCConfig(num_catalogs=8, relocate_sweeps=4).relocate_sweeps
    assert tsmc.SMCConfig(num_catalogs=8, pair_sweeps=4).pair_sweeps == 4
    assert SingleComponentMH(num_iters=10, sqjumpdist_tol=1e-2,
                             device="cpu").sqjumpdist_tol == 1e-2
    cfg = tsmc.SMCConfig(num_catalogs=8, record_history=True,
                         fixed_schedule=(0.5, 1.0))
    assert cfg.record_history and cfg.fixed_schedule == (0.5, 1.0)
    # the streaming tile pool is ported (tests/test_torch_streaming.py):
    # SMCSampler.run(streaming=True) runs it, at the budget of
    # memory_budget_bytes where the sampler has it (one tile a slot here)
    prior, model, kernel, images = _slice_problem()
    s = tsmc.SMCSampler(np.concatenate(np.asarray(images), axis=1), 8,
                        port_prior(prior), port_model(model),
                        port_kernel(kernel.replace(num_iters=5)),
                        num_catalogs=32, resample_method="systematic",
                        flux_detection_threshold=0.7)
    s.memory_budget_bytes = tsmc.chunk_bytes_per_tile(s.prior, 32, 64)
    r = s.run(torch.Generator().manual_seed(0), streaming=True)
    assert s.result is r and torch.all(r.temperature == 1.0)
    assert r.locs.shape == (2, 4 * 32, 3, 2)
    assert torch.isfinite(r.log_normalizing_constant).all()


def test_smc_sampler_takes_the_jax_signature(capsys):
    """``SMCSampler`` takes every argument of the JAX one: relocation
    sweeps run, ``print_every`` prints, ``dispatch_iters`` is accepted and
    ignored, pair sweeps run; a per-tile background map
    ``[T, 1, 1, h, w]`` and a bare ``[h, w]`` map both give the scalar
    background's posterior when they hold the same value."""
    import inspect

    jparams = set(inspect.signature(jsmc.SMCSampler).parameters)
    assert jparams <= set(inspect.signature(tsmc.SMCSampler).parameters)
    prior, model, kernel, images = _slice_problem()
    frame = np.concatenate([np.asarray(images[0]), np.asarray(images[1])], 1)
    pmodel = port_model(model)
    pkernel = port_kernel(kernel.replace(num_iters=4))

    def run(mdl, **kw):
        s = tsmc.SMCSampler(frame, 8, port_prior(prior), mdl, pkernel,
                            num_catalogs=32, resample_method="systematic",
                            max_smc_iters=6, **kw)
        return s.run(torch.Generator().manual_seed(0))

    base = run(pmodel)
    bg = float(pmodel.background)
    for bmap in (torch.full((2, 1, 1, 8, 8), bg), torch.full((8, 8), bg)):
        r = run(pmodel.with_background(bmap))
        assert torch.equal(r.log_normalizing_constant,
                           base.log_normalizing_constant)
    r = run(pmodel, relocate_sweeps=2, print_every=1, dispatch_iters=3)
    assert "iteration 1: temperature in" in capsys.readouterr().out
    assert not torch.equal(r.locs, base.locs)
    pair = run(pmodel, pair_sweeps=2)
    assert not torch.equal(pair.locs, base.locs)
    assert torch.all((pair.acc_rate > 0) & (pair.acc_rate < 1))
