"""Prior-draw relocation sweeps (smcdet_tpu_torch/inference/kernels.py)
against smcdet_tpu/inference/kernels.py:relocate_sweeps, fed the draws the
JAX version makes, and their place in the CS-SMC step."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread, t  # noqa: F401  (autouse)

from smcdet_tpu import config as jcfg
from smcdet_tpu.inference.kernels import (
    TargetContext as JaxCtx,
    init_kernel_state as jax_init_state,
    relocate_sweeps as jax_relocate,
)
from smcdet_tpu_torch import config as tcfg
from smcdet_tpu_torch.inference.kernels import (
    KernelState,
    TargetContext,
    init_kernel_state,
    relocate_sweep,
    relocate_sweeps,
)

# (prior, image model) configurations: the basic and cells suites' targets
# at a small size, a Normal-flux prior and a prior with no flux mark
_TARGETS = {
    "basic": (dict(family="pareto_star", max_objects=8, pad=2.0,
                   flux_scale=345.84, flux_alpha=2.0),
              dict(kind="gaussian", background=200.0, psf_stdev=0.93)),
    "cells": (dict(family="m71", max_objects=6, image_height=16,
                   image_width=16, counts_rate=0.02, flux_alpha=0.5,
                   flux_lower=100.0, flux_upper=1e5),
              dict(kind="gaussian", image_height=16, image_width=16,
                   background=50.0, psf_radius=6, psf_stdev=1.4)),
    "star": (dict(family="star", max_objects=4, flux_mean=2000.0,
                  flux_stdev=300.0), dict(kind="m71")),
    "noflux": (dict(family="poisson", max_objects=4, counts_rate=0.05),
               dict(kind="m71")),
}


def _problem(name, T=2, N=64, temperature=0.3):
    pc, ic = _TARGETS[name]
    jprior = jcfg.build_prior(jcfg.PriorConfig(**pc))
    jmodel = jcfg.build_image_model(jcfg.ImageModelConfig(**ic))
    C = jprior.num_counts

    @jax.jit
    def draw(k):
        k1, k2 = jax.random.split(k)
        strata, locs, fluxes = jprior.sample_stratified(k1, N, (T,))
        if fluxes is None:  # no flux mark: flux 800 on active slots
            fluxes = 800.0 * jprior.slot_mask(
                jax.numpy.broadcast_to(strata[None, :, None], (T, C, N)))
        img = jax.numpy.abs(jmodel.sample(k2, locs[:, -1, 0],
                                          fluxes[:, -1, 0]))
        return strata, locs, fluxes, img

    strata, locs, fluxes, images = draw(jax.random.key(3))
    counts = np.broadcast_to(np.asarray(strata)[None, :, None], (T, C, N))
    jctx = JaxCtx(prior=jprior, model=jmodel, image=images[:, None, None],
                  temperature=jax.numpy.full((T, 1, 1), temperature))
    pctx = TargetContext(tcfg.build_prior(tcfg.PriorConfig(**pc), "cpu"),
                         tcfg.build_image_model(tcfg.ImageModelConfig(**ic),
                                                "cpu"),
                         t(images)[:, None, None],
                         torch.full((T, 1, 1), temperature))
    return jctx, pctx, counts, locs, fluxes


def _jax_draws(key, prior, shape):
    """The draws of one JAX relocation sweep (kernels.py:554-577) under
    ``relocate_sweeps(key, ..., num_sweeps=1)``."""
    k = jax.random.split(key, 1)[0]
    k_j, k_loc, k_flux, k_acc = jax.random.split(k, 4)
    f_prop = (prior.flux.sample(k_flux, shape) if prior.flux is not None
              else None)
    return (jax.random.uniform(k_j, shape),
            jax.random.uniform(k_loc, shape + (2,)), f_prop,
            jax.random.uniform(k_acc, shape))


@pytest.mark.parametrize("name", list(_TARGETS))
def test_one_relocation_matches_jax(name):
    jctx, pctx, counts, locs, fluxes = _problem(name)
    jcounts = jax.numpy.asarray(counts)
    state = jax.jit(jax_init_state)(jctx, jcounts, locs, fluxes)
    key = jax.random.key(17)
    jst, jacc = jax.jit(
        lambda k, st: jax_relocate(k, jctx, jcounts, st, 1))(key, state)
    draws = jax.jit(lambda k: _jax_draws(k, jctx.prior, counts.shape))(key)
    u_j, u_loc, f_prop, u_acc = (None if d is None else t(d) for d in draws)

    pcounts = torch.from_numpy(np.ascontiguousarray(counts))
    pstate = KernelState(t(state.locs), t(state.fluxes), t(state.rate),
                         t(state.parent_ll), t(state.logprior))
    pst, applied = relocate_sweep(pctx, pcounts, pstate, u_j, u_loc, f_prop,
                                  u_acc)
    # every finite active proposal accepted (u_acc = 0): its log alpha
    ast, _ = relocate_sweep(pctx, pcounts, pstate, u_j, u_loc, f_prop,
                            torch.zeros_like(u_acc))
    tau = pctx.temperature
    log_alpha = tau * (ast.parent_ll - pstate.parent_ll)
    margin = (torch.log(u_acc) - torch.clamp(log_alpha, max=0.0)).abs()

    japplied = np.asarray(jst.locs != state.locs).any((-1, -2))
    flips = japplied != applied.numpy()
    # a flip is allowed only where u sits on the acceptance boundary
    assert (margin.numpy()[flips] < 1e-4).all(), margin.numpy()[flips]
    assert flips.mean() < 0.01
    assert applied.float().mean() > 0.01  # relocations do happen
    np.testing.assert_allclose(float(jacc.mean()),
                               float(applied.float().mean()), atol=0.01)
    same = ~flips
    # rtol 1e-4: f32 exp/log rounding and the pixel-sum order
    for name_, tol in (("locs", 1e-5), ("fluxes", 1e-5), ("rate", 1e-4),
                       ("parent_ll", 1e-4), ("logprior", 1e-4)):
        np.testing.assert_allclose(
            getattr(pst, name_).numpy()[same],
            np.asarray(getattr(jst, name_))[same], rtol=tol, atol=1e-4,
            err_msg=name_)


def test_relocation_keeps_caches_and_inactive_slots():
    """Many sweeps from the generator: the incremental caches equal a
    fresh render, counts never change, inactive slots are never touched."""
    _, pctx, counts, locs, fluxes = _problem("cells", N=32)
    pcounts = torch.from_numpy(np.ascontiguousarray(counts))
    st0 = init_kernel_state(pctx, pcounts, t(locs), t(fluxes))
    st, acc = relocate_sweeps(torch.Generator().manual_seed(0), pctx,
                              pcounts, st0, 40)
    assert acc.shape == counts.shape[:-1]
    assert 0.0 < float(acc.mean()) < 1.0
    fresh = init_kernel_state(pctx, pcounts, st.locs, st.fluxes)
    scale = fresh.rate.abs().clamp(min=1.0)
    assert float(((st.rate - fresh.rate).abs() / scale).max()) < 1e-4
    np.testing.assert_allclose(st.parent_ll.numpy(), fresh.parent_ll.numpy(),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(st.logprior.numpy(), fresh.logprior.numpy(),
                               rtol=1e-5, atol=1e-3)
    M = locs.shape[-2]
    inactive = ~(torch.arange(M) < pcounts[..., None])
    assert torch.equal(st.fluxes[inactive], t(fluxes)[inactive])
    assert torch.equal(st.locs[inactive], t(locs)[inactive])


def test_csmc_step_runs_relocation_and_blends_acceptance():
    from smcdet_tpu_torch.inference.smc import SMCConfig, csmc_init, csmc_step

    _, pctx, *_ = _problem("basic")
    images = pctx.image[:, 0, 0]
    kernel = tcfg.build_kernel(tcfg.KernelConfig(
        num_iters=2, locs_stdev=0.1, fluxes_stdev=100.0, fluxes_min=345.84,
        fluxes_max=1e6), "cpu")
    cfg = SMCConfig(num_catalogs=32, resample_method="systematic",
                    relocate_sweeps=3)
    state = csmc_init(torch.Generator().manual_seed(0), images, pctx.prior,
                      pctx.model, cfg)
    with torch.profiler.profile() as prof:
        state = csmc_step(images, pctx.prior, pctx.model, kernel, cfg, state)
    names = {e.key for e in prof.key_averages()}
    assert {"smc.mutate", "smc.relocate"} <= names
    assert state.iteration == 1
    assert torch.all((state.acc_rate >= 0) & (state.acc_rate <= 1))
    # the pair move runs after the relocation (tests/test_torch_pair.py)
    cfg = SMCConfig(num_catalogs=32, resample_method="systematic",
                    relocate_sweeps=3, pair_sweeps=8)
    with torch.profiler.profile() as prof:
        csmc_step(images, pctx.prior, pctx.model, kernel, cfg, state)
    names = {e.key for e in prof.key_averages()}
    assert {"smc.mutate", "smc.relocate", "smc.pair"} <= names
