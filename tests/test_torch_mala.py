"""Single-component MALA in the port (the eager ``SingleComponentMALA`` of
smcdet_tpu_torch/inference/kernels.py and the plain version of kernel K4 in
ops/mala_sweep.py) against the JAX package's ``SingleComponentMALA``.

On the CPU, JAX's MALA takes its XLA sweep (``backend="xla"``: the fused
Pallas kernel needs a TPU), whose gradient is ``jax.grad`` of the slot
target. The tile targets are those of tests/test_torch_mh_sweep.py, the
bridge targets those of tests/test_torch_aggregate.py. The CUDA kernel
itself runs only on the card: see tests/test_torch_gpu.py.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_lane_variant
from test_torch_aggregate import _bridge, _port_state
from test_torch_aggregate import _jax_setup as _bridge_setup
from test_torch_mh_sweep import (
    _SWEEP_TARGETS,
    _jax_setup,
    _jax_sweep_uniforms,
    _port,
)
from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread,
    port_kernel,
    port_model,
    port_prior,
    t,
)

from smcdet_tpu.inference import aggregate as jagg
from smcdet_tpu.inference.kernels import (
    SingleComponentMALA as JaxMALA,
    TargetContext as JaxCtx,
    _take_slot,
    init_kernel_state as jax_init_state,
    relocate_sweeps as jax_relocate,
)
from smcdet_tpu_torch.distributions import truncated_normal_log_prob
from smcdet_tpu_torch.inference import aggregate as tagg
from smcdet_tpu_torch.inference.kernels import (
    KernelState,
    SingleComponentMALA,
    TargetContext,
    init_kernel_state,
    relocate_sweeps,
)
from smcdet_tpu_torch.ops import mala_sweep, mh_sweep

# MALA's steps on each target: location steps of compare_kernels.py's size
# (0.05 px; 0.02 where the catalogs' brightest stars sit on 16x16 tiles) and
# flux steps that keep the acceptance of one sweep between 0.4 and 0.95, so
# that few drifted means leave the box (see test_one_sweep_matches_jax)
_STEPS = {"gaussian": (0.05, 0.2), "poisson": (0.05, 20.0),
          "cells": (0.05, 5.0), "wing": (0.05, 0.2),
          "gauss16": (0.02, 20.0), "bridge": (0.02, 20.0)}


def _mala(mh, target, num_iters=1):
    """JAX MALA with the MH kernel's flux bounds and the target's steps."""
    ls, fs = _STEPS[target]
    return JaxMALA(num_iters=num_iters, locs_step=jnp.float32(ls),
                   fluxes_step=jnp.float32(fs), fluxes_min=mh.fluxes_min,
                   fluxes_max=mh.fluxes_max, backend="xla")


def _tile(target):
    prior, model, mh, ctx, counts, locs, fluxes = _jax_setup(
        target, **_SWEEP_TARGETS[target])
    kernel = _mala(mh, target)
    state = jax.jit(jax_init_state)(ctx, counts, locs, fluxes)
    p_prior, p_model, p_kernel, p_ctx = _port(prior, model, kernel, ctx)
    pstate = KernelState(t(state.locs), t(state.fluxes), t(state.rate),
                         t(state.parent_ll), t(state.logprior))
    return kernel, ctx, counts, state, p_kernel, p_ctx, pstate


def _bridge_problem(mode):
    jctx, pctx, counts, locs, fluxes = _bridge(mode)
    _, _, mh = _bridge_setup(num_iters=1)
    kernel = _mala(mh, "bridge")
    state = jax.jit(jax_init_state)(jctx, counts, locs, fluxes)
    return kernel, jctx, counts, state, port_kernel(kernel), pctx, \
        _port_state(state)


@functools.cache
def _problem(target):
    """The target's JAX and port problem, shared by the tests that only
    read it (the others build their own with ``_tile``)."""
    if target.startswith("bridge"):
        return _bridge_problem(target.split("_")[1])
    return _tile(target)


@functools.cache
def _jax_sweep(target):
    """JAX's one sweep of ``_problem(target)`` with key 11: its state and
    applied moves as numpy arrays, and its uniforms as port tensors (one
    JAX run per target, shared by the eager and the closed-form tests)."""
    kernel, jctx, counts, state, *_ = _problem(target)
    key = jax.random.key(11)
    jst, japplied = jax.jit(
        lambda k, st: kernel.sweep(k, jctx, counts, st))(key, state)
    u = [t(x) for x in jax.jit(_jax_sweep_uniforms, static_argnums=1)(
        key, counts.shape)]
    jst = {name: None if getattr(jst, name) is None
           else np.asarray(getattr(jst, name)) for name in _STATE}
    return jst, np.asarray(japplied), u


def test_port_kernel_is_mala():
    kernel, *_, p_kernel, _, _ = _problem("gaussian")
    assert isinstance(p_kernel, SingleComponentMALA)
    assert float(p_kernel.locs_step) == float(kernel.locs_step)
    assert float(p_kernel.fluxes_step) == float(kernel.fluxes_step)


# ----------------------------------------------------------------------
# One sweep against JAX given the same uniforms
# ----------------------------------------------------------------------
def _port_sweep(version, kernel, ctx, counts, state, u):
    """One sweep of the eager version, or of the plain version of K4, and
    its proposals (``MALAProposal``)."""
    if version == "eager":
        st, applied = kernel.sweep(None, ctx, counts, state, uniforms=u)
        return st, applied, kernel.propose(ctx, counts, state, *u[:3])
    kw = dict(prior=ctx.prior, model=ctx.model,
              proposal=kernel.proposal(ctx.prior),
              image_flat=ctx.image_flat, temperature=ctx.temperature,
              counts=counts, locs=state.locs, fluxes=state.fluxes,
              rate=state.rate, pll=state.parent_ll, lp=state.logprior,
              child=ctx.child_term(state, counts.shape))
    out = mala_sweep.mala_sweep_with_uniforms(*u, **kw)
    q = mala_sweep.mala_proposal(*u[:3], **kw)
    return KernelState(*out[:5], *out[6:]), out[5], q


_STATE = ("locs", "fluxes", "rate", "parent_ll", "logprior", "child_rate",
          "child_ll")


@pytest.mark.parametrize("version", ["eager", "closed_form"])
@pytest.mark.parametrize("target", list(_SWEEP_TARGETS)
                         + ["bridge_tag", "bridge_location"])
def test_one_sweep_matches_jax(target, version):
    """One sweep given JAX's uniforms (``k_j, k_loc, k_flux, k_acc``): the
    same proposals and decisions. rtol 1e-4: f32 ndtri/exp/log rounding,
    the pixel-sum order and, here, the gradient's sum order inside the
    drifted means. A particle may disagree in two ways only: an accept flip
    with u on the boundary, within the f32 rounding of the two targets
    (margin under 2e-5 (|target| + |target'|) + 1e-4, the bound of
    chip_smoke.py's flips: on the cells tiles a target near 1e5 rounds to
    1/32 of a nat), or a drifted mean so far outside the box that
    one of its six truncation masses is below 1e-3
    (``mala_sweep.smallest_box_mass``): that mass is a difference of two f32
    values of Phi near 1, which the two packages round differently (one
    ulp, 6e-8, moves its log by 6e-5 or more and the inverse CDF's sample
    by sigma 6e-8 / phi(z)), so the proposal and the ratio differ.
    Together under 1% of the particles."""
    _, _, counts, _, p_kernel, p_ctx, pstate = _problem(target)
    jst, japplied, u = _jax_sweep(target)
    pcounts = t(counts, torch.int32)
    pst, papplied, q = _port_sweep(version, p_kernel, p_ctx, pcounts, pstate,
                                   u)
    tail = (mala_sweep.smallest_box_mass(q, p_kernel.proposal(p_ctx.prior),
                                         p_ctx.prior) < 1e-3).numpy()
    close = np.ones(counts.shape, dtype=bool)
    for name in _STATE:
        got = getattr(pst, name)
        if got is None:
            continue
        atol = 1e-3 if "rate" in name or "ll" in name else 1e-4
        ok = np.isclose(got.numpy(), jst[name], rtol=1e-4, atol=atol)
        close &= ok.reshape(counts.shape + (-1,)).all(-1)
    flips = japplied != papplied.numpy()
    margin = (torch.log(u[3]) - torch.clamp(q.log_alpha, max=0.0)).abs()
    targets = (p_ctx.combine(pstate.logprior, pstate.parent_ll,
                             pstate.child_ll).abs()
               + p_ctx.combine(q.lp, q.pll, q.cll).abs())
    boundary = (margin < 2e-5 * targets + 1e-4).numpy()
    off = ~close & ~(flips & boundary)
    assert tail[off].all(), (margin.numpy()[off & ~tail], flips[off & ~tail])
    assert (~close).mean() < 0.01, ((~close).mean(), flips.mean())
    assert 0.05 < papplied.float().mean() < 0.98  # the sweep does move


# ----------------------------------------------------------------------
# The slot gradient three ways
# ----------------------------------------------------------------------
def _slot_base(ctx, state, counts, onehot, active, loc_j, f_j, side_j):
    """JAX's slot-removed caches (kernels.py:994-1021)."""
    eff = jnp.asarray(ctx.model.adu_per_nmgy)
    old, old_child = ctx.star_images(loc_j, side_j)
    a = active[..., None]
    rate_wo = state.rate - jnp.where(a, eff * f_j[..., None] * old, 0.0)
    child_wo = None if state.child_rate is None else (
        state.child_rate - jnp.where(a, eff * f_j[..., None] * old_child,
                                     0.0))
    safe = jnp.where(active, f_j, ctx.prior.flux.reference_point)
    lp_wo = state.logprior - jnp.where(active,
                                       ctx.prior.flux.log_prob(safe), 0.0)
    return rate_wo, child_wo, lp_wo


@pytest.mark.parametrize("target", list(_SWEEP_TARGETS)
                         + ["bridge_tag", "bridge_location"])
def test_slot_gradient_three_ways(target):
    """The closed-form gradient of K4's plain version, the eager version's
    ``torch.autograd.grad`` and ``jax.grad`` of JAX's ``_slot_target``, at
    every particle's slot 0 (the tolerance of test_pallas.py:327-337)."""
    kernel, jctx, counts, state, p_kernel, p_ctx, pstate = _problem(target)
    M = state.fluxes.shape[-1]
    active = counts > 0
    onehot = (jnp.arange(M) == 0) & active[..., None]
    loc_j, f_j = _take_slot(state.locs, onehot), _take_slot(state.fluxes,
                                                            onehot)
    side_j = None if jctx.child_slot_side is None else _take_slot(
        jnp.broadcast_to(jctx.child_slot_side, onehot.shape), onehot)

    @jax.jit
    def jax_grad(state):
        base = _slot_base(jctx, state, counts, onehot, active, loc_j, f_j,
                          side_j)
        (gl, gf), _ = jax.grad(kernel._slot_target, argnums=(3, 4),
                               has_aux=True)(jctx, base, active, loc_j, f_j,
                                             side_j)
        return gl, gf

    jgl, jgf = (np.asarray(g) for g in jax_grad(state))
    pactive = t(active, torch.bool)
    ploc, pf = t(loc_j), t(f_j)
    pside = None if side_j is None else t(side_j)
    base = [None if b is None else t(b)
            for b in _slot_base(jctx, state, counts, onehot, active, loc_j,
                                f_j, side_j)]
    agl, agf, _, _ = p_kernel.slot_grad(p_ctx, base, pactive, ploc, pf, pside)

    child = p_ctx.child_term(pstate, pactive.shape)
    window = None
    if child is not None:
        window = (mh_sweep.side_window(child, p_ctx.model, pside)
                  if pside is not None else mh_sweep.location_window(
                      child.axis, child.boundary, p_ctx.model, ploc))
    prop = p_kernel.proposal(p_ctx.prior)
    cgl, cgf = mala_sweep.slot_gradient(
        p_ctx.prior, p_ctx.model, p_ctx.image_flat, p_ctx.temperature,
        pactive, torch.where(pactive, pf, prop.flux_lo),
        mala_sweep.psf_and_deriv(p_ctx.model, ploc), pstate.rate,
        pstate.fluxes.shape[-1], None if child is None else child.rate,
        window)
    assert float(np.abs(jgl).max()) > 1.0  # the likelihood does pull
    for got in ((agl, agf), (cgl, cgf)):
        np.testing.assert_allclose(got[0].numpy(), jgl, rtol=2e-2, atol=2e-4)
        np.testing.assert_allclose(got[1].numpy(), jgf, rtol=2e-2, atol=2e-4)


def test_gradients_finite_on_zero_counts_and_low_rates():
    """Zero-count particles and Poisson pixels below the Normal tail: the
    unselected branches of ``torch.where`` must not leak ``0 * inf`` into
    the eager gradient, and the closed form stays finite too."""
    kernel, jctx, counts, state, p_kernel, p_ctx, pstate = _tile("poisson")
    assert float(pstate.rate.max()) < p_ctx.model.normal_tail_threshold
    pcounts = t(counts, torch.int32)
    pcounts[..., ::2] = 0  # every other particle has no occupied slot
    st = init_kernel_state(p_ctx, pcounts, pstate.locs, pstate.fluxes)
    u = [torch.full(pcounts.shape, 0.3)]
    onehot, active, loc_j, f_j = mh_sweep.select_slot(u[0], pcounts, st.locs,
                                                      st.fluxes)
    assert not bool(active.all()) and bool(active.any())
    base = (st.rate, None, st.logprior)  # the point itself: any base works
    gl, gf, target, _ = p_kernel.slot_grad(p_ctx, base, active, loc_j, f_j)
    assert torch.isfinite(gl).all() and torch.isfinite(gf).all()
    assert torch.isfinite(target).all()
    assert float(gl[~active].abs().max()) == 0.0
    assert float(gf[~active].abs().max()) == 0.0
    prop = p_kernel.proposal(p_ctx.prior)
    cgl, cgf = mala_sweep.slot_gradient(
        p_ctx.prior, p_ctx.model, p_ctx.image_flat, p_ctx.temperature,
        active, torch.where(active, f_j, prop.flux_lo),
        mala_sweep.psf_and_deriv(p_ctx.model, loc_j), st.rate,
        st.fluxes.shape[-1])
    assert torch.isfinite(cgl).all() and torch.isfinite(cgf).all()
    out, applied = p_kernel.sweep(torch.Generator().manual_seed(0), p_ctx,
                                  pcounts, st)
    assert not bool(applied[~active].any())
    assert all(torch.isfinite(x).all() for x in out[:5])


# ----------------------------------------------------------------------
# The plain Philox loop
# ----------------------------------------------------------------------
def test_zero_count_passthrough_is_exact():
    _, _, counts, state, p_kernel, p_ctx, _ = _tile("gaussian")
    zc = torch.zeros(counts.shape, dtype=torch.int32)
    st = init_kernel_state(p_ctx, zc, t(state.locs), t(state.fluxes))
    p_kernel.num_iters = 5
    out, acc = p_kernel.run_from_state(torch.Generator().manual_seed(0),
                                       p_ctx, zc, st)
    for a, b in zip(out[:5], st[:5]):  # the tile target's fields
        assert torch.equal(a, b)
    assert float(acc.max()) == 0.0


def test_plain_sweep_loop_matches_jax_equilibrium():
    """Different random streams, so the comparison is at equilibrium: 800
    sweeps of JAX's MALA and of the plain version of K4 on K1's M71 target,
    the tempered-target quantiles q50/q75 within 5% + 5 nats and the
    acceptance within 0.02 (the bounds and size of
    tests/test_pallas.py:107-154), and the caches equal a fresh render."""
    prior, model, mh, ctx, counts, locs, fluxes = _jax_setup()
    kernel = _mala(mh, "gaussian", num_iters=800)
    stx, accx = jax.jit(lambda k: kernel.run(k, ctx, counts, locs, fluxes))(
        jax.random.key(5))
    p_prior, p_model, p_kernel, p_ctx = _port(prior, model, kernel, ctx)
    assert isinstance(p_kernel, SingleComponentMALA)
    pcounts = t(counts, torch.int32)
    stp, accp = p_kernel.run(torch.Generator().manual_seed(5), p_ctx,
                             pcounts, t(locs), t(fluxes))

    ltx = np.asarray(stx.logprior + 0.8 * stx.parent_ll).ravel()
    ltp = (stp.logprior + 0.8 * stp.parent_ll).numpy().ravel()
    for q in (50, 75):
        a, b = np.percentile(ltx, q), np.percentile(ltp, q)
        assert abs(a - b) <= 0.05 * abs(a) + 5.0, (q, a, b)
    assert 0.05 < float(accx.mean()) < 0.95
    assert abs(float(accp.mean()) - float(accx.mean())) < 0.02

    fresh = init_kernel_state(p_ctx, pcounts, stp.locs, stp.fluxes)
    scale = fresh.rate.abs().clamp(min=1.0)
    # f32 incremental accumulation over the accepted sweeps
    assert float(((stp.rate - fresh.rate).abs() / scale).max()) < 2e-3
    scale = fresh.parent_ll.abs().clamp(min=1.0)
    assert float(((stp.parent_ll - fresh.parent_ll).abs() / scale).max()) \
        < 2e-3
    assert float((stp.logprior - fresh.logprior).abs().max()) < 0.01
    inactive = ~(torch.arange(fluxes.shape[-1]) < pcounts[..., None])
    assert torch.equal(stp.fluxes[inactive], t(fluxes)[inactive])


@pytest.mark.parametrize("mode", ["tag", "location"])
def test_plain_bridge_loop_keeps_both_caches(mode):
    """200 plain K4 sweeps on the bridge: both incremental caches and
    likelihoods equal a fresh render (the bounds of the MH bridge loop's
    test in test_torch_aggregate.py)."""
    _, pctx, counts, locs, fluxes = _bridge(mode)
    _, _, mh = _bridge_setup(num_iters=200)
    pkernel = port_kernel(_mala(mh, "bridge", num_iters=200))
    pcounts = t(counts, torch.int32)
    st0 = init_kernel_state(pctx, pcounts, t(locs), t(fluxes))
    st, acc = pkernel.run_from_state(torch.Generator().manual_seed(4), pctx,
                                     pcounts, st0)
    assert 0.05 < float(acc.mean()) < 0.95
    fresh = init_kernel_state(pctx, pcounts, st.locs, st.fluxes)
    for name in ("rate", "child_rate"):
        a, b = getattr(st, name), getattr(fresh, name)
        assert float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) < 2e-4
    for name in ("parent_ll", "child_ll"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   getattr(fresh, name).numpy(), rtol=1e-4,
                                   atol=1e-2)
    np.testing.assert_allclose(st.logprior.numpy(), fresh.logprior.numpy(),
                               rtol=1e-5, atol=1e-3)


# divideandconquer's MALA steps: its shipped kernel's locs_stdev and
# fluxes_stdev (chip_smoke.py: MALA_DNC_STEPS)
_DNC_STEPS = (0.25, 5.0)


def _ks_distance(a, b):
    """The two-sample Kolmogorov-Smirnov distance of samples ``a`` and
    ``b`` and its critical value at level 0.001 for their sizes."""
    a, b = np.sort(np.ravel(a)), np.sort(np.ravel(b))
    grid = np.concatenate([a, b])
    d = np.abs(np.searchsorted(a, grid, side="right") / a.size
               - np.searchsorted(b, grid, side="right") / b.size).max()
    return d, math.sqrt(-math.log(0.001 / 2) / 2 * (a.size + b.size)
                        / (a.size * b.size))


def _bridge_samples(counts, tau, logprior, pll, cll, locs, fluxes):
    """The particles' tempered bridge targets, and the occupied slots'
    locations and fluxes."""
    active = np.arange(fluxes.shape[-1]) < np.asarray(counts)[..., None]
    locs, fluxes = np.asarray(locs), np.asarray(fluxes)
    return {"target": np.asarray(logprior + tau * pll + (1.0 - tau) * cll),
            "y": locs[..., 0][active], "x": locs[..., 1][active],
            "flux": fluxes[active]}


@pytest.mark.parametrize("relocate", [0, 8])
@pytest.mark.parametrize("mode", ["tag", "location"])
def test_plain_bridge_loop_matches_jax_equilibrium(mode, relocate):
    """Different random streams, so the comparison is at equilibrium: 400
    MALA sweeps at divideandconquer's steps (0.25 / 5.0) of JAX and of the
    plain version of K4 on the level-0 bridge of test_torch_aggregate.py
    (tau 0.4, counts fixed), then ``relocate`` prior-draw relocation sweeps
    (the aggregation's 8, inference/aggregate.py's bridge step). The
    acceptance within 0.025 (the tile test's 0.02 above, and the spread of
    JAX's and the port's seeds here), and the two-sample KS distance of the
    particles' tempered targets and of the occupied slots' y, x and flux
    below its 0.1% critical value. (On this pure-noise image the posterior
    is diffuse and bimodal near the box's edges: the tile test's target
    quantiles move by 300 nats, and the location quartiles by 2 px, from
    one JAX seed to the next; the distributions agree to a KS distance
    under 0.09 over seeds 1, 2 and 5 of both.)"""
    jctx, pctx, counts, locs, fluxes = _bridge(mode)
    _, _, mh = _bridge_setup(num_iters=400)
    kernel = JaxMALA(num_iters=400, locs_step=jnp.float32(_DNC_STEPS[0]),
                     fluxes_step=jnp.float32(_DNC_STEPS[1]),
                     fluxes_min=mh.fluxes_min, fluxes_max=mh.fluxes_max,
                     backend="xla")

    def jax_run(key):
        k_mut, k_rel = jax.random.split(key)
        st, acc = kernel.run(k_mut, jctx, counts, locs, fluxes)
        if relocate:
            st, _ = jax_relocate(k_rel, jctx, counts, st, relocate)
        return st, acc

    stx, accx = jax.jit(jax_run)(jax.random.key(5))
    pkernel = port_kernel(kernel)
    pcounts = t(counts, torch.int32)
    g = torch.Generator().manual_seed(5)
    stp, accp = pkernel.run(g, pctx, pcounts, t(locs), t(fluxes))
    if relocate:
        stp, _ = relocate_sweeps(g, pctx, pcounts, stp, relocate)

    tau = float(np.asarray(jctx.temperature).ravel()[0])
    want = _bridge_samples(counts, tau, stx.logprior, stx.parent_ll,
                           stx.child_ll, stx.locs, stx.fluxes)
    got = _bridge_samples(counts, tau, stp.logprior.numpy(),
                          stp.parent_ll.numpy(), stp.child_ll.numpy(),
                          stp.locs, stp.fluxes)
    for name in ("target", "y", "x", "flux"):
        d, bound = _ks_distance(want[name], got[name])
        assert d < bound, (name, d, bound)
    assert 0.05 < float(accx.mean()) < 0.95
    assert abs(float(accp.mean()) - float(accx.mean())) < 0.025


@functools.cache
def _dnc_bridge(mode):
    """A level-0 bridge of divideandconquer's model and prior (its SDSS PSF,
    Gaussian noise, truncated-Pareto flux; JAX objects): a 16x8 joined tile
    holding four bright stars, two of them by the far edges of the image,
    and 256 particles of four stars near them, two from each child (origin
    tags in "tag" mode), at tau 0.5. Returns the JAX and the port contexts,
    counts, locs and fluxes (numpy), and the JAX MALA kernel of the suite's
    flux bounds at its steps."""
    from pathlib import Path

    from smcdet_tpu import config as jcfg

    cfg = jcfg.load_config(Path(__file__).resolve().parents[1]
                           / "experiments" / "divideandconquer"
                           / "config.yaml")
    tile = jagg.expand_prior(jcfg.build_prior(cfg.prior), 8, 8,
                             cfg.prior.max_objects)
    H, W, M = 16, 8, 8
    prior = jagg.expand_prior(tile, H, W, M)
    model = jcfg.build_image_model(cfg.image_model).replace(height=H,
                                                            width=W)
    rng = np.random.default_rng(0)
    true_locs = np.array([[2.2, 6.8], [6.6, 1.1], [11.0, 3.3], [15.4, 7.2]],
                         np.float32)
    true_fluxes = np.array([400.0, 150.0, 900.0, 300.0], np.float32)
    bare = JaxCtx(prior=prior, model=model, image=jnp.zeros((H, W)),
                  temperature=jnp.float32(1.0))
    rate = np.asarray(bare.init_rates(jnp.asarray(true_locs),
                                      jnp.asarray(true_fluxes))[0])
    sd = np.sqrt(float(model.noise_additive)
                 + float(model.noise_multiplicative) * rate)
    image = (rate + sd * rng.standard_normal(rate.shape)).reshape(H, W)
    image = image.astype(np.float32)
    N = 256
    counts = np.full(N, 4, np.int32)
    locs = np.zeros((N, M, 2), np.float32)
    fluxes = np.zeros((N, M), np.float32)
    locs[:, :4] = true_locs + rng.normal(0.0, 0.2, (N, 4, 2))
    fluxes[:, :4] = true_fluxes * rng.uniform(0.9, 1.1, (N, 4))
    side = np.broadcast_to(np.arange(M) < 2, (N, M)).astype(np.float32)
    tag = mode == "tag"
    jctx = JaxCtx(prior=prior, model=model, image=jnp.asarray(image),
                  temperature=jnp.float32(0.5), child_model=model,
                  child_side_mask=jagg._side_mask_fn(0, 8, H, W),
                  child_slot_side=jnp.asarray(side) if tag else None)
    pmodel = port_model(model)
    pctx = TargetContext(port_prior(prior), pmodel, t(image),
                         torch.tensor(0.5), child_model=pmodel,
                         child_side_mask=tagg.SideMask(0, 8, H, W),
                         child_slot_side=t(side) if tag else None)
    kernel = JaxMALA(num_iters=300, locs_step=jnp.float32(_DNC_STEPS[0]),
                     fluxes_step=jnp.float32(_DNC_STEPS[1]),
                     fluxes_min=jnp.float32(cfg.kernel.fluxes_min),
                     fluxes_max=jnp.float32(cfg.kernel.fluxes_max),
                     backend="xla")
    return jctx, pctx, counts, locs, fluxes, kernel


@pytest.mark.parametrize("mode", ["tag", "location"])
def test_proposal_densities_match_jax_far_outside_the_box(mode):
    """The fault behind the MALA under-count on divideandconquer: at its
    steps, on a bridge near bright stars, MALA's drifted means lie far
    outside the box for most particles. Where a mean lies more than 5.4
    sigma above the box, its truncation mass is a difference of two values
    of Phi in the lower tail, which torch.special.ndtr's f32 flushed to 0
    (log mass 0) and JAX's ndtr keeps (log mass -17 to -88): the port's
    proposal densities were off by that much, and it accepted moves JAX
    rejects. After 300 plain K4 sweeps, every forward and reverse proposal
    log-density of the next sweep's proposals equals JAX's
    ``truncated_normal_log_prob`` of the same values (rtol 1e-5), but
    where a mass is a difference of two values of Phi near 1 (a mean far
    below the box), which each package rounds its own way."""
    from smcdet_tpu import distributions as jd

    _, pctx, counts, locs, fluxes, kernel = _dnc_bridge(mode)
    pkernel = port_kernel(kernel)
    pcounts = t(counts, torch.int32)
    st0 = init_kernel_state(pctx, pcounts, t(locs), t(fluxes))
    st, _ = pkernel.run_from_state(torch.Generator().manual_seed(1), pctx,
                                   pcounts, st0)
    g = torch.Generator().manual_seed(2)
    u = [torch.rand(s, generator=g)
         for s in (pcounts.shape, pcounts.shape + (2,), pcounts.shape)]
    prop = pkernel.proposal(pctx.prior)
    q = mala_sweep.mala_proposal(
        *u, prior=pctx.prior, model=pctx.model, proposal=prop,
        image_flat=pctx.image_flat, temperature=pctx.temperature,
        counts=pcounts, locs=st.locs, fluxes=st.fluxes, rate=st.rate,
        pll=st.parent_ll, lp=st.logprior,
        child=pctx.child_term(st, pcounts.shape))
    lo, hi = pctx.prior.loc_low, pctx.prior.loc_high
    boxes = ((q.loc_prop, q.mu_loc, q.loc, q.mu_loc_rev, prop.locs_stdev,
              lo, hi),
             (q.f_prop, q.mu_f, q.f, q.mu_f_rev, prop.fluxes_stdev,
              prop.flux_lo, prop.flux_hi))
    far_above = 0
    for x_new, mu, x_old, mu_rev, sigma, lb, ub in boxes:
        for value, mean in ((x_new, mu), (x_old, mu_rev)):
            args = [np.broadcast_to(np.asarray(v, np.float32), mean.shape)
                    for v in (value, mean, sigma, lb, ub)]
            want = np.asarray(jd.truncated_normal_log_prob(*args))
            got = truncated_normal_log_prob(*(torch.from_numpy(a.copy())
                                              for a in args)).numpy()
            z_lb = (args[3] - args[1]) / args[2]
            z_ub = (args[4] - args[1]) / args[2]
            near_one = (z_lb > 0.0) & (np.asarray(jd.ndtr(z_ub))
                                       - np.asarray(jd.ndtr(z_lb)) < 1e-3)
            far_above += int((z_ub < -5.5).sum())
            np.testing.assert_allclose(got[~near_one], want[~near_one],
                                       rtol=1e-5, atol=1e-3)
    # the regime is this sweep's common case, not a corner
    assert far_above >= pcounts.numel() // 4, far_above


# ----------------------------------------------------------------------
# Dispatch
# ----------------------------------------------------------------------
def test_auto_backend_on_cpu_runs_plain_version():
    """A CPU tensor takes the plain version of K4 and never counts a
    launch; the same key through ``backend="torch"`` gives the same
    state."""
    kernel, _, counts, state, p_kernel, p_ctx, _ = _tile("poisson")
    before = (mala_sweep.mala_sweeps.launches,
              mala_sweep.mala_sweeps.bridge_launches)
    pcounts = t(counts, torch.int32)
    p_kernel.num_iters = 3
    out, acc = p_kernel.run(torch.Generator().manual_seed(1), p_ctx, pcounts,
                            t(state.locs), t(state.fluxes))
    assert (mala_sweep.mala_sweeps.launches,
            mala_sweep.mala_sweeps.bridge_launches) == before
    ref_kernel = port_kernel(kernel, backend="torch")
    ref_kernel.num_iters = 3
    ref, _ = ref_kernel.run(torch.Generator().manual_seed(1), p_ctx, pcounts,
                            t(state.locs), t(state.fluxes))
    for a, b in zip(out[:5], ref[:5]):
        assert torch.equal(a, b)
    assert 0.0 < float(acc.mean()) < 1.0


def test_mala_kernel_routes_and_names_missing_shapes():
    """K4 covers K2's tile shapes and K3's joined tiles, K4g every other
    shape and slot count; a shape whose block needs more shared memory than
    the card has raises, naming the limit."""
    from smcdet_tpu_torch.models.imaging import ImageModel
    from smcdet_tpu_torch.models.psf import GaussianPSF

    for target in ("gaussian", "poisson", "wing"):
        prior, model, *_ = _jax_setup(target)
        pp, pm = port_prior(prior), port_model(model)
        assert mala_sweep.mala_kernel(pp, pm, 8) == "K4"
        assert mala_sweep.mala_kernel(pp, pm.with_shape(16, 16), 16) == "K4"
        assert mala_sweep.mala_kernel(pp, pm, 17) == "K4g"
        for (h, w), m in (((16, 8), 16), ((16, 16), 32)):
            joined = pm.with_shape(h, w)
            assert mala_sweep.mala_kernel(pp, joined, m, child=True) == "K4"
            assert mala_sweep.mala_kernel(pp, joined, m + 1,
                                          child=True) == "K4g"
        for h, w in ((8, 8), (32, 16), (32, 32)):
            assert mala_sweep.mala_kernel(pp, pm.with_shape(h, w), 4,
                                          child=True) == "K4g"
    big = ImageModel(32, 32, 6, GaussianPSF(1.4, device="cpu"), device="cpu")
    assert mala_sweep.mala_kernel(pp, big, 4) == "K4g"
    with pytest.raises(NotImplementedError,
                       match="MALA bridge kernel for 32x32 tiles with "
                             "M=5000: .* 232448-byte"):
        mala_sweep.mala_kernel(pp, big, 5000, child=True)
    with pytest.raises(NotImplementedError, match="PSF"):
        mala_sweep.mala_kernel(pp, ImageModel(8, 8, 4, object(),
                                              device="cpu"), 4)


# ----------------------------------------------------------------------
# run_csmc with MALA
# ----------------------------------------------------------------------
@functools.cache
def _two_star():
    """JAX's two-star MALA problem (tests/test_smc.py:207-233)."""
    from test_smc import two_star_image

    image, prior, model, _ = two_star_image()
    kernel = JaxMALA(num_iters=15, locs_step=jnp.float32(0.15),
                     fluxes_step=jnp.float32(30.0),
                     fluxes_min=jnp.float32(100.0),
                     fluxes_max=jnp.float32(5000.0), backend="xla")
    return image, prior, model, kernel


def test_run_csmc_with_mala_matches_jax():
    """``run_csmc`` with MALA on the two-star tile (N = 96, systematic
    resampling): temperature 1, count-pmf argmax 2, acceptance in (0.01, 1]
    for both, and the count pmfs within Monte Carlo error of each other."""
    from smcdet_tpu.inference import smc as jsmc
    from smcdet_tpu_torch.inference import smc as tsmc

    image, prior, model, kernel = _two_star()
    cfg = dict(num_catalogs=96, resample_method="systematic",
               max_smc_iters=40, flux_detection_threshold=200.0)
    jr = jax.jit(jsmc.run_csmc, static_argnums=5)(
        jax.random.key(2), image[None], prior, model, kernel,
        jsmc.SMCConfig(**cfg))
    tr = tsmc.run_csmc(torch.Generator().manual_seed(2), t(image)[None],
                       port_prior(prior), port_model(model),
                       port_kernel(kernel), tsmc.SMCConfig(**cfg))
    pmfs = []
    for r in (jr, tr):
        np.testing.assert_allclose(np.asarray(r.temperature), 1.0)
        assert 0.01 < float(np.asarray(r.acc_rate)[0]) <= 1.0
        lz = np.asarray(r.log_normalizing_constant[0], dtype=np.float64)
        pmf = np.exp(lz - lz.max())
        pmfs.append(pmf / pmf.sum())
        assert pmfs[-1].argmax() == 2, pmfs[-1]
    # the evidence of each stratum is a mean over 96 particles: its Monte
    # Carlo error moves the pmf by a few percent
    assert 0.5 * np.abs(pmfs[0] - pmfs[1]).sum() <= 0.05, pmfs


# K4g's targets beside K4's: ((height, width), bridge, slots), a tile of
# each pixel class of both targets (40x40 a ragged one in the 2048 class)
_K4G_TARGETS = [(shape, bridge, 16) for bridge, shapes in (
    (False, ((4, 16), (16, 8), (32, 8), (32, 16), (32, 32), (40, 40),
             (64, 64))),
    (True, ((8, 8), (8, 16), (32, 8), (32, 16), (32, 32), (48, 32),
            (64, 64)))) for shape in shapes]


@pytest.mark.parametrize("target",
                         sorted(mala_sweep.K4_LANES) + _K4G_TARGETS)
def test_lane_sum_adds_in_the_kernels_order(target):
    """``lane_sum`` is K4's and K4g's sum, bit for bit, at the lane count
    each takes on each target (``K4_LANES``; K4g's ``GENERIC_CLASS_LANES`` by
    pixel class): each of L lanes adds its pixels ``lane + L k`` in turn
    from 0 (0 past a ragged tile's last pixel), then every lane adds its
    ``__shfl_xor_sync`` partner's total at offsets L/2, L/4, ..., 1 (all
    lanes end with the same bits). ``K4_LANES`` repeats
    ``csrc/mala_sweep_k4.cu``'s ``kLanes*`` constants,
    ``GENERIC_CLASS_LANES`` ``csrc/mh_sweep_classes.cuh``'s."""
    (h, w), bridge, *slots = target
    hw = h * w
    if slots:
        cap = mh_sweep.generic_class(h, w, slots[0], bridge)
        L = mh_sweep.GENERIC_CLASS_LANES[cap, bridge]
        assert torch_lane_variant.generic_source_lanes()[cap, bridge] == L
    else:
        L = mala_sweep.K4_LANES[target]
        assert torch_lane_variant.k4_source_lanes()[target] == L
    rng = np.random.default_rng(hw + L)
    x = (rng.standard_normal(hw) * 10.0 ** rng.uniform(-3, 3, hw)).astype(
        np.float32)
    lanes = [np.float32(0.0)] * L
    for k in range(-(-hw // L)):
        lanes = [lanes[i] + (x[i + L * k] if i + L * k < hw
                             else np.float32(0.0)) for i in range(L)]
    off = L // 2
    while off:
        lanes = [lanes[i] + lanes[i ^ off] for i in range(L)]
        off //= 2
    assert len(set(v.tobytes() for v in lanes)) == 1
    got = mala_sweep.lane_sum(torch.from_numpy(x), L)
    assert got.numpy().tobytes() == lanes[0].tobytes()
    from smcdet_tpu_torch.models.imaging import ImageModel
    from smcdet_tpu_torch.models.psf import GaussianPSF

    model = ImageModel(h, w, 4, GaussianPSF(1.0, device="cpu"), device="cpu")
    assert mala_sweep.k4_lanes(model, bridge, 16) == L
