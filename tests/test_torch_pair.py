"""The pair-redistribute move (smcdet_tpu_torch/inference/kernels.py:
pair_redistribute_sweep(s)) against smcdet_tpu/inference/kernels.py:
pair_redistribute_sweeps, fed the draws the JAX version makes; the three
exactness checks of tests/test_pair_moves.py on the port's move; the
generator-driven Beta draw; and the move's place in the CS-SMC step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from test_torch_aggregate import _bridge, _port_state
from test_torch_relocate import _problem
from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread,
    port_kernel,
    port_model,
    port_prior,
    t,
)

from smcdet_tpu.inference import smc as jsmc
from smcdet_tpu.inference.kernels import (
    init_kernel_state as jax_init_state,
    pair_redistribute_sweeps as jax_pair,
)
from smcdet_tpu_torch import convert
from smcdet_tpu_torch import distributions as td
from smcdet_tpu_torch.inference import smc as tsmc
from smcdet_tpu_torch.inference.aggregate import SideMask
from smcdet_tpu_torch.inference.kernels import (
    KernelState,
    TargetContext,
    init_kernel_state,
    pair_propose,
    pair_redistribute_sweep,
    pair_redistribute_sweeps,
)

_SCALES = dict(select_scale=2.0, displace_scale=1.5, flux_conc=1.0)
_STATE = ("locs", "fluxes", "rate", "parent_ll", "logprior", "child_rate",
          "child_ll")


def _jax_draws(key, shape, M, displace_scale, flux_conc):
    """The draws of one JAX pair sweep (kernels.py:733-884) under
    ``pair_redistribute_sweeps(key, ..., num_sweeps=1)``."""
    k = jax.random.split(key, 1)[0]
    k_i, k_j, k_u, k_d, k_acc = jax.random.split(k, 5)
    return (jax.random.uniform(k_i, shape),
            jax.random.gumbel(k_j, shape + (M,)),
            jax.random.beta(k_u, flux_conc, flux_conc, shape),
            displace_scale * jax.random.normal(k_d, shape + (2,)),
            jax.random.uniform(k_acc, shape))


def _one_sweep_against_jax(jctx, pctx, counts, state, pstate, seed):
    """One JAX pair sweep and the port's on JAX's draws; returns the two
    states, the acceptance flips and the port's proposal."""
    jcounts = jnp.asarray(counts)
    key = jax.random.key(seed)
    jst, _ = jax.jit(lambda k, st: jax_pair(k, jctx, jcounts, st, 1,
                                            **_SCALES))(key, state)
    M = state.fluxes.shape[-1]
    draws = [t(x) for x in jax.jit(
        _jax_draws, static_argnums=(1, 2, 3, 4))(
        key, tuple(counts.shape), M, _SCALES["displace_scale"],
        _SCALES["flux_conc"])]
    pcounts = torch.from_numpy(np.array(counts, np.int32))
    pst, applied = pair_redistribute_sweep(pctx, pcounts, pstate, *draws,
                                           **_SCALES)
    q = pair_propose(pctx, pcounts, pstate, *draws[:4], **_SCALES)
    # the particles JAX moved (a move keeps both slots' count)
    japplied = np.asarray((jst.locs != state.locs).any((-1, -2))
                          | (jst.fluxes != state.fluxes).any(-1))
    flips = japplied != applied.numpy()
    margin = (torch.log(draws[4]) - torch.clamp(q.log_alpha, max=0.0)).abs()
    # a flip is allowed only where u_acc sits on the acceptance boundary
    assert (margin.numpy()[flips] < 1e-3).all(), margin.numpy()[flips]
    assert flips.mean() < 0.01
    assert 0.02 < applied.float().mean() < 0.98, applied.float().mean()
    return pst, jst, flips


def _check(pst, jst, flips, names):
    same = ~flips
    for name in names:
        # rtol 1e-4, atol 1e-3: f32 exp/log rounding of the renders and
        # likelihoods, the pixel-sum order, and the centroid's division
        np.testing.assert_allclose(
            getattr(pst, name).numpy()[same],
            np.asarray(getattr(jst, name))[same], rtol=1e-4, atol=1e-3,
            err_msg=name)


@pytest.mark.parametrize("name", ["cells", "star", "noflux"])
def test_one_pair_sweep_matches_jax_on_the_tile_target(name):
    """Poisson noise with a Pareto flux (cells), Gaussian noise with a
    Normal flux (star) and a prior with no flux mark."""
    jctx, pctx, counts, locs, fluxes = _problem(name, N=128)
    state = jax.jit(jax_init_state)(jctx, jnp.asarray(counts), locs, fluxes)
    pstate = KernelState(t(state.locs), t(state.fluxes), t(state.rate),
                         t(state.parent_ll), t(state.logprior))
    pst, jst, flips = _one_sweep_against_jax(jctx, pctx, counts, state,
                                             pstate, 31)
    _check(pst, jst, flips, _STATE[:5])


@pytest.mark.parametrize("mode", ["tag", "location"])
def test_one_pair_sweep_matches_jax_on_the_bridge(mode):
    jctx, pctx, counts, locs, fluxes = _bridge(mode)
    state = jax.jit(jax_init_state)(jctx, counts, locs, fluxes)
    pst, jst, flips = _one_sweep_against_jax(
        jctx, pctx, np.asarray(counts), state, _port_state(state), 37)
    _check(pst, jst, flips, _STATE)


# ----------------------------------------------------------------------
# the exactness checks of tests/test_pair_moves.py on the port's move
# ----------------------------------------------------------------------
def _fixed_count_problem(count=3, M=4, N=2048, tile=8, seed=0):
    """tests/test_pair_moves.py's problem: uniform counts, truncated-Pareto
    fluxes, a Poisson 8x8 tile with a Gaussian PSF, every particle holding
    ``count`` stars drawn from the prior."""
    prior = convert.prior_from_params(dict(
        min_objects=0, max_objects=M, image_height=tile, image_width=tile,
        pad=1.0, counts={"kind": "uniform", "low": 0, "high": M},
        flux={"kind": "truncated_pareto", "alpha": 0.6, "lower": 1.0,
              "upper": 1000.0}), "cpu")
    model = convert.image_model_from_params(dict(
        height=tile, width=tile, psf_radius=4, noise="poisson",
        background=100.0, adu_per_nmgy=1.0, noise_additive=0.0,
        noise_multiplicative=1.0, normal_tail_threshold=50000.0,
        psf={"kind": "gaussian", "stdev": 1.0}), "cpu")
    gen = torch.Generator().manual_seed(seed)
    counts = torch.full((1, N), count, dtype=torch.int32)
    occ = torch.arange(M) < counts[..., None]
    locs = prior.loc_low + (prior.loc_high - prior.loc_low) * torch.rand(
        (1, N, M, 2), generator=gen)
    fluxes = prior.flux.sample((1, N, M), gen)
    locs = torch.where(occ[..., None], locs, 0.0)
    fluxes = torch.where(occ, fluxes, 0.0)
    image = torch.full((1, 1, tile, tile), 100.0)
    return prior, model, image, counts, locs, fluxes


def _pairwise_dists(locs, counts):
    """Distances between all active slot pairs, pooled."""
    M = locs.shape[-2]
    occ = torch.arange(M) < counts[..., None]
    d = (locs[..., :, None, :] - locs[..., None, :, :]).norm(dim=-1)
    upper = torch.triu(torch.ones(M, M, dtype=torch.bool), diagonal=1)
    both = occ[..., :, None] & occ[..., None, :] & upper
    return d[both].numpy()


def test_prior_invariance_at_temperature_zero():
    """128 sweeps at temperature 0 (the target is the prior) leave the
    flux, location and pair-separation marginals at the prior's (KS
    against the starting prior draws, p > 1e-3, as
    tests/test_pair_moves.py)."""
    prior, model, image, counts, locs, fluxes = _fixed_count_problem()
    ctx = TargetContext(prior, model, image, torch.zeros((1, 1)))
    state = init_kernel_state(ctx, counts, locs, fluxes)
    state, acc = pair_redistribute_sweeps(
        torch.Generator().manual_seed(1), ctx, counts, state, 128,
        select_scale=2.0, displace_scale=1.5)
    assert float(acc.mean()) > 0.05, acc
    occ = torch.arange(fluxes.shape[-1]) < counts[..., None]
    ks_flux = stats.ks_2samp(np.log(fluxes[occ].numpy()),
                             np.log(state.fluxes[occ].numpy()))
    assert ks_flux.pvalue > 1e-3, ks_flux
    for axis in (0, 1):
        ks_loc = stats.ks_2samp(locs[occ][:, axis].numpy(),
                                state.locs[occ][:, axis].numpy())
        assert ks_loc.pvalue > 1e-3, (axis, ks_loc)
    ks_sep = stats.ks_2samp(_pairwise_dists(locs, counts),
                            _pairwise_dists(state.locs, counts))
    assert ks_sep.pvalue > 1e-3, ks_sep
    act = state.locs[occ]
    assert bool(((act >= prior.loc_low) & (act <= prior.loc_high)).all())


def test_conservation_and_slot_locality():
    """One sweep at temperature 0.5: every particle keeps its total flux
    and flux-weighted centroid, and at most two slots change."""
    prior, model, image, counts, locs, fluxes = _fixed_count_problem(N=256)
    ctx = TargetContext(prior, model, image, torch.full((1, 1), 0.5))
    state0 = init_kernel_state(ctx, counts, locs, fluxes)
    state, acc = pair_redistribute_sweeps(torch.Generator().manual_seed(2),
                                          ctx, counts, state0, 1)
    assert float(acc.mean()) > 0.02
    np.testing.assert_allclose(state.fluxes.sum(-1).numpy(),
                               fluxes.sum(-1).numpy(), rtol=2e-5)
    cent = (state.fluxes[..., None] * state.locs).sum(-2)
    np.testing.assert_allclose(cent.numpy(),
                               (fluxes[..., None] * locs).sum(-2).numpy(),
                               rtol=1e-3, atol=5e-3)
    changed = ((state.fluxes != fluxes)
               | (state.locs != locs).any(-1)).sum(-1)
    assert int(changed.max()) == 2


@pytest.mark.parametrize("bridge", [False, True])
def test_cache_consistency(bridge):
    """After 32 sweeps the carried rates, log-likelihoods and log prior
    equal a fresh render, on the tile target and on the bridge (origin
    tags, a zero ghost rate)."""
    prior, model, image, counts, locs, fluxes = _fixed_count_problem(N=128)
    kw = {}
    if bridge:
        M = fluxes.shape[-1]
        sides = torch.broadcast_to((torch.arange(M) % 2).float(),
                                   fluxes.shape)
        kw = dict(child_model=model, child_side_mask=SideMask(1, 4, 8, 8),
                  child_slot_side=sides,
                  child_ghost_rate=torch.zeros(fluxes.shape[:-1] + (64,)))
    ctx = TargetContext(prior, model, image, torch.full((1, 1), 0.7), **kw)
    state = init_kernel_state(ctx, counts, locs, fluxes)
    state, acc = pair_redistribute_sweeps(torch.Generator().manual_seed(3),
                                          ctx, counts, state, 32)
    assert float(acc.mean()) > 0.02
    fresh = init_kernel_state(ctx, counts, state.locs, state.fluxes)
    tol = dict(rtol=1e-4, atol=1e-3)
    ll_tol = dict(rtol=1e-4, atol=5e-2)
    np.testing.assert_allclose(state.rate, fresh.rate, **tol)
    np.testing.assert_allclose(state.parent_ll, fresh.parent_ll, **ll_tol)
    np.testing.assert_allclose(state.logprior, fresh.logprior, **tol)
    if bridge:
        np.testing.assert_allclose(state.child_rate, fresh.child_rate, **tol)
        np.testing.assert_allclose(state.child_ll, fresh.child_ll, **ll_tol)
        assert float((state.child_rate - state.rate).abs().max()) > 1.0


def test_noop_below_two_stars():
    """Particles with fewer than two stars pass through bit-exactly, with
    no move applied."""
    prior, model, image, _, locs, fluxes = _fixed_count_problem(count=1,
                                                                N=64)
    counts = torch.cat([torch.zeros((1, 32), dtype=torch.int32),
                        torch.ones((1, 32), dtype=torch.int32)], dim=1)
    occ = torch.arange(fluxes.shape[-1]) < counts[..., None]
    locs = torch.where(occ[..., None], locs, 0.0)
    fluxes = torch.where(occ, fluxes, 0.0)
    ctx = TargetContext(prior, model, image, torch.full((1, 1), 0.5))
    state = init_kernel_state(ctx, counts, locs, fluxes)
    out, acc = pair_redistribute_sweeps(torch.Generator().manual_seed(4),
                                        ctx, counts, state, 8)
    assert float(acc.max()) == 0.0
    for name in KernelState._fields[:5]:
        assert torch.equal(getattr(out, name), getattr(state, name)), name


@pytest.mark.parametrize("a", [0.5, 2.0])
def test_beta_sample_matches_scipy(a):
    """The generator-driven Beta(a, a) (gamma ratio) against scipy's CDF,
    and its log-density against scipy's."""
    u = td.beta_sample(a, (20000,), torch.Generator().manual_seed(5), "cpu")
    # f32 rounds the ends of Beta(0.5, 0.5) to 0 and 1; the move rejects
    # such a split (its flux leaves the support)
    assert bool(((u >= 0) & (u <= 1)).all())
    ks = stats.kstest(u.double().numpy(), stats.beta(a, a).cdf)
    assert ks.pvalue > 1e-3, ks
    x = torch.linspace(0.01, 0.99, 99)
    np.testing.assert_allclose(td.beta_log_prob(x, a).numpy(),
                               stats.beta(a, a).logpdf(x.double().numpy()),
                               rtol=1e-5, atol=1e-5)
    # a == 1 is a uniform draw and a zero log-density
    g = torch.Generator().manual_seed(6)
    assert torch.equal(td.beta_sample(1.0, (8,), g, "cpu"),
                       torch.rand(8, generator=torch.Generator().manual_seed(
                           6)))
    assert torch.equal(td.beta_log_prob(x, 1.0), torch.zeros_like(x))


def test_gumbel_sample_matches_scipy():
    g = td.gumbel_sample((20000,), torch.Generator().manual_seed(7), "cpu")
    assert bool(torch.isfinite(g).all())
    assert stats.kstest(g.double().numpy(), stats.gumbel_r.cdf).pvalue > 1e-3


# ----------------------------------------------------------------------
# the move in the CS-SMC step and in run_csmc
# ----------------------------------------------------------------------
def _step_problem():
    _, pctx, *_ = _problem("basic")
    images = pctx.image[:, 0, 0]
    kernel = convert.mh_kernel_from_params(dict(
        num_iters=2, locs_stdev=0.1, fluxes_stdev=100.0, fluxes_min=345.84,
        fluxes_max=1e6), "cpu")
    return pctx, images, kernel


def test_csmc_step_runs_the_pair_range_and_blends_acceptance(monkeypatch):
    """``smc.pair`` runs after ``smc.relocate`` and counts its call and
    applied share; the step's acceptance is JAX's blend (smc.py:363-373):
    mutation, relocation and pair acceptance weighted by their sweep
    counts."""
    pctx, images, kernel = _step_problem()
    cfg = tsmc.SMCConfig(num_catalogs=32, resample_method="systematic",
                         relocate_sweeps=3, pair_sweeps=5)
    state = tsmc.csmc_init(torch.Generator().manual_seed(0), images,
                           pctx.prior, pctx.model, cfg)
    counter = tsmc.pair_redistribute_sweeps
    counter.calls, counter.applied = 0, 0.0
    with torch.profiler.profile() as prof:
        step = tsmc.csmc_step(images, pctx.prior, pctx.model, kernel, cfg,
                              state)
    names = [e.name for e in prof.events()
             if e.name.startswith("smc.")]
    assert names.index("smc.relocate") < names.index("smc.pair")
    assert counter.calls == 1 and 0.0 < float(counter.applied) < 1.0
    assert step.iteration == 1
    assert torch.all((step.acc_rate >= 0) & (step.acc_rate <= 1))

    def fixed(value, run):
        def wrapped(*args, **kwargs):
            st, acc = run(*args, **kwargs)
            return st, torch.full_like(acc, value)
        return wrapped

    monkeypatch.setattr(kernel, "run_from_state",
                        fixed(0.2, kernel.run_from_state))
    monkeypatch.setattr(tsmc, "relocate_sweeps",
                        fixed(0.5, tsmc.relocate_sweeps))
    monkeypatch.setattr(tsmc, "pair_redistribute_sweeps",
                        fixed(0.9, tsmc.pair_redistribute_sweeps))
    step = tsmc.csmc_step(images, pctx.prior, pctx.model, kernel, cfg, state)
    want = (0.2 * 2 + 0.5 * 3 + 0.9 * 5) / (2 + 3 + 5)
    np.testing.assert_allclose(step.acc_rate.numpy(), want, rtol=1e-6)
    no_reloc = tsmc.SMCConfig(num_catalogs=32, resample_method="systematic",
                              pair_sweeps=5)
    step = tsmc.csmc_step(images, pctx.prior, pctx.model, kernel, no_reloc,
                          state)
    np.testing.assert_allclose(step.acc_rate.numpy(),
                               (0.2 * 2 + 0.9 * 5) / 7, rtol=1e-6)


def test_run_csmc_with_pair_sweeps_matches_jax():
    """The cells_pair mutation (MH + relocation + pair sweeps) at a small
    size: tests/test_torch_smc.py's two M71 tiles (three and two bright
    stars), N = 256 per stratum, 10 MH + 2 relocation + 4 pair sweeps.

    Tolerances from the JAX run's own seed-to-seed spread (seeds 0-7 of
    jit(run_csmc) on these tiles, CPU): tile 0's count pmf is 1.0 on 3
    stars at every seed (TV spread 0.0 -> 0.01); posterior mean total flux
    max pairwise difference 6.04 / 3.78 nmgy -> 18.1 (3x the larger); on
    tile 1 the evidence splits between 2 and 3 stars from seed to seed
    (mass on 2 from 0.016 to 0.685), so there the check is that no mass
    falls below the true count.
    """
    from test_torch_smc import _slice_problem, _summary

    prior, model, kernel, images = _slice_problem()
    kernel = kernel.replace(num_iters=10)
    kw = dict(num_catalogs=256, resample_method="systematic",
              flux_detection_threshold=0.7, relocate_sweeps=2,
              pair_sweeps=4)
    jr = jax.jit(jsmc.run_csmc, static_argnums=5)(
        jax.random.key(0), images, prior, model, kernel,
        jsmc.SMCConfig(**kw))
    tr = tsmc.run_csmc(torch.Generator().manual_seed(0), t(images),
                       port_prior(prior), port_model(model),
                       port_kernel(kernel), tsmc.SMCConfig(**kw))
    assert np.all(np.asarray(jr.temperature) == 1.0)
    assert torch.all(tr.temperature == 1.0)
    jpmf, jflux = _summary(jr.log_normalizing_constant, jr.weights,
                           jr.fluxes)
    tpmf, tflux = _summary(tr.log_normalizing_constant, tr.weights,
                           tr.fluxes)
    assert tpmf[0].argmax() == jpmf[0].argmax() == 3
    assert 0.5 * np.abs(tpmf[0] - jpmf[0]).sum() <= 0.01
    assert tpmf[1, :2].sum() < 0.01 and jpmf[1, :2].sum() < 0.01
    np.testing.assert_allclose(tflux, jflux, atol=18.1)
    assert 0.0 < float(tr.acc_rate.min()) < 1.0
