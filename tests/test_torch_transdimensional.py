"""The port's reversible-jump kernel and transdimensional samplers
(smcdet_tpu_torch/inference/transdimensional.py, ``mcmc.run_rjmh``) against
the JAX package's, on the CPU.

One ``BirthDeathMH`` sweep is held to JAX's given JAX's own draws, kind by
kind (move, birth, death, split, merge), to float32 tolerance, and so are
the split and merge proposals' log acceptance ratios. The chains
and the SMC population are held to JAX's in law on test_smc.py's two-star
tile, whose count posterior sits at 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.test_smc import make_setup, two_star_image
from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread,
    port_kernel,
    port_model,
    port_prior,
    t,
)

from smcdet_tpu.inference import transdimensional as jtd
from smcdet_tpu.inference.kernels import TargetContext as JContext
from smcdet_tpu.inference.kernels import init_kernel_state as jinit
from smcdet_tpu_torch.inference import mcmc as tmcmc
from smcdet_tpu_torch.inference import transdimensional as ttd
from smcdet_tpu_torch.inference.kernels import KernelState, TargetContext

PROBS = dict(prob_birth=0.2, prob_death=0.2, prob_split=0.15,
             prob_merge=0.15)


def jax_draws(key, kernel, prior, counts, M):
    """The draws JAX's ``_sweep`` makes from ``key``
    (transdimensional.py:353-364, :384-388, :437, :492, and
    ``_split_merge``'s :126-169, :246-254), as a ``TDDraws``."""
    k_kind, k_move, k_loc, k_flux, k_death, k_acc, k_sm = jax.random.split(
        key, 7)
    shape = counts.shape
    eps = 1e-6
    k_j, k_mloc, k_mflux, k_macc = jax.random.split(k_move, 4)
    move = (jax.random.uniform(k_j, shape),
            jax.random.uniform(k_mloc, shape + (2,), minval=eps,
                               maxval=1 - eps),
            jax.random.uniform(k_mflux, shape, minval=eps, maxval=1 - eps),
            jax.random.uniform(k_macc, shape))
    k_pick, k_u, k_d, k_mi, k_mj = jax.random.split(k_sm, 5)
    a = kernel.split_flux_conc
    arrays = dict(
        u_kind=jax.random.uniform(k_kind, shape), move=move,
        birth_u_loc=jax.random.uniform(k_loc, shape + (2,)),
        birth_flux=prior.flux.sample(k_flux, shape),
        death_u=jax.random.uniform(k_death, shape),
        u_acc=jax.random.uniform(k_acc, shape),
        split_u_pick=jax.random.uniform(k_pick, shape),
        split_u=jax.random.beta(k_u, a, a, shape),
        split_d=kernel.split_scale * jax.random.normal(k_d, shape + (2,)),
        merge_u_pick=jax.random.uniform(k_mi, shape),
        merge_g=jax.random.gumbel(k_mj, shape + (M,)))
    conv = {k: tuple(t(x) for x in v) if isinstance(v, tuple) else t(v)
            for k, v in arrays.items()}
    return ttd.TDDraws(**conv)


TEMPERATURES = (0.0, 0.6)


@pytest.fixture(scope="module")
def one_sweep():
    """JAX's sweep and split/merge proposals and the port's, on JAX's
    draws, from states with every count 0..M on the two-star tile (N =
    2048), at each of ``TEMPERATURES``: at 0 the likelihood drops out and
    the jumps' acceptance ratios are moderate, so an accept decision
    moves with any error in their bookkeeping."""
    image, prior, model, move = two_star_image()
    move = move.replace(num_iters=1, backend="xla")
    kernel = jtd.BirthDeathMH(num_iters=1, move=move, split_flux_conc=2.0,
                              **PROBS)
    M, N = prior.max_objects, 2048
    rng = np.random.default_rng(3)
    counts = jnp.asarray(rng.integers(0, M + 1, (1, N)), jnp.int32)
    occupied = np.arange(M) < np.asarray(counts)[..., None]
    locs = jnp.asarray(np.where(occupied[..., None],
                                rng.uniform(-1, 9, (1, N, M, 2)), 0.0),
                       jnp.float32)
    fluxes = jnp.asarray(np.where(occupied,
                                  rng.uniform(800, 2600, (1, N, M)), 0.0),
                         jnp.float32)
    key = jax.random.key(5)
    k_sm = jax.random.split(key, 7)[6]

    @jax.jit
    def run(key, ctx, state):
        return (kernel._sweep(key, ctx, state),
                kernel._split_merge(k_sm, ctx, state))

    pprior, pmodel = port_prior(prior), port_model(model)
    pkernel = ttd.BirthDeathMH(1, port_kernel(move), split_flux_conc=2.0,
                               **PROBS)
    draws = jax_draws(key, kernel, prior, counts, M)
    u = draws.u_kind.numpy()[0]
    kinds = np.select([u < 0.2, u < 0.4, u < 0.55, u < 0.7],
                      ["birth", "death", "split", "merge"], "move")
    out = {}
    for tau in TEMPERATURES:
        ctx = JContext(prior=prior, model=model, image=image[None][:, None],
                       temperature=jnp.full((1, 1), tau))
        state = jtd.TDKernelState(counts=counts,
                                  inner=jinit(ctx, counts, locs, fluxes))
        (jst, japplied), jsm = run(key, ctx, state)
        pctx = TargetContext(pprior, pmodel, t(ctx.image),
                             t(ctx.temperature))
        inner = state.inner
        pstate = ttd.TDKernelState(
            t(counts, torch.int32),
            KernelState(t(inner.locs), t(inner.fluxes), t(inner.rate),
                        t(inner.parent_ll), t(inner.logprior)))
        pst, papplied = pkernel.sweep(None, pctx, pstate, draws)
        psm = pkernel._split_merge(pctx, pstate, draws)
        out[tau] = (jst, np.asarray(japplied)[0], pst, papplied.numpy()[0],
                    {k: np.asarray(v)[0] for k, v in jsm.items()},
                    {k: v.numpy()[0] for k, v in psm.items()})
    return out, kinds


@pytest.mark.parametrize("tau", TEMPERATURES)
@pytest.mark.parametrize("kind", ["move", "birth", "death", "split",
                                  "merge"])
def test_one_sweep_matches_jax_given_its_draws(one_sweep, kind, tau):
    out, kinds = one_sweep
    jst, japplied, pst, papplied, _, _ = out[tau]
    sel = kinds == kind
    assert sel.sum() > 200
    np.testing.assert_array_equal(papplied[sel], japplied[sel])
    assert papplied[sel].sum() < sel.sum()  # some are rejected
    np.testing.assert_array_equal(pst.counts.numpy()[0][sel],
                                  np.asarray(jst.counts)[0][sel])
    pairs = [(pst.inner.locs, jst.inner.locs, 0, 1e-4),
             (pst.inner.fluxes, jst.inner.fluxes, 1e-5, 1e-3),
             (pst.inner.rate, jst.inner.rate, 1e-5, 1e-3),
             (pst.inner.parent_ll, jst.inner.parent_ll, 1e-5, 1e-2),
             (pst.inner.logprior, jst.inner.logprior, 1e-5, 1e-4)]
    for got, want, rtol, atol in pairs:
        np.testing.assert_allclose(got.numpy()[0][sel],
                                   np.asarray(want)[0][sel], rtol=rtol,
                                   atol=atol)


def test_every_kind_is_accepted_at_some_temperature(one_sweep):
    out, kinds = one_sweep
    for kind in ("move", "birth", "death", "split", "merge"):
        assert sum(out[tau][3][kinds == kind].sum()
                   for tau in TEMPERATURES) > 0, kind


@pytest.mark.parametrize("tau", TEMPERATURES)
@pytest.mark.parametrize("move", ["split", "merge"])
def test_split_merge_proposals_match_jax(one_sweep, move, tau):
    """Both proposals of every particle (not only the ones its kind picks):
    the validity, the proposed state's caches and the log acceptance ratio
    with its selection, auxiliary and Jacobian terms."""
    out, _ = one_sweep
    *_, want, got = out[tau]
    valid = want[f"valid_{move}"]
    np.testing.assert_array_equal(got[f"valid_{move}"], valid)
    assert 0 < valid.sum() < valid.size
    tag = move[0]
    # the log ratio differences targets of a few thousand nats: 1e-2 is
    # some 20 float32 ulps of them
    for name, rtol, atol in ((f"la_{move}", 1e-5, 1e-2),
                             (f"rate_{tag}", 1e-5, 1e-3),
                             (f"ll_{tag}", 1e-5, 1e-2),
                             (f"lp_{tag}", 1e-5, 1e-4)):
        np.testing.assert_allclose(got[name][valid], want[name][valid],
                                   rtol=rtol, atol=atol, err_msg=name)


def test_split_merge_cache_stays_consistent():
    """rate, log-likelihood and log-prior caches track the particle state
    through 800 sweeps of all five kinds, from JAX test_transdimensional's
    split state (one star explained as two halves)."""
    prior, model, move = make_setup()
    image = model.sample(jax.random.key(1),
                         jnp.asarray([[3.5, 3.5], [0, 0], [0, 0]],
                                     jnp.float32),
                         jnp.asarray([2000.0, 0, 0], jnp.float32))
    pprior, pmodel = port_prior(prior), port_model(model)
    kernel = ttd.BirthDeathMH(
        1, port_kernel(move.replace(num_iters=1)), prob_birth=0.15,
        prob_death=0.15, prob_split=0.1, prob_merge=0.1)
    M, N = prior.max_objects, 64
    counts = torch.full((1, N), 2, dtype=torch.int32)
    locs = torch.zeros((1, N, M, 2))
    locs[:, :, 0] = torch.tensor([3.2, 3.5])
    locs[:, :, 1] = torch.tensor([3.8, 3.5])
    fluxes = torch.zeros((1, N, M))
    fluxes[:, :, :2] = 1000.0
    ctx = TargetContext(pprior, pmodel, t(image)[None, None],
                        torch.ones((1, 1)))
    from smcdet_tpu_torch.inference.kernels import init_kernel_state

    st = ttd.TDKernelState(counts,
                           init_kernel_state(ctx, counts, locs, fluxes))
    gen = torch.Generator().manual_seed(3)
    applied = torch.zeros(())
    for _ in range(800):
        st, a = kernel.sweep(gen, ctx, st)
        applied = applied + a.float().mean()
    fresh = init_kernel_state(ctx, st.counts, st.inner.locs, st.inner.fluxes)
    np.testing.assert_allclose(st.inner.parent_ll, fresh.parent_ll, rtol=0,
                               atol=0.5)
    np.testing.assert_allclose(st.inner.logprior, fresh.logprior, rtol=0,
                               atol=0.1)
    assert float((st.inner.rate - fresh.rate).abs().max()) < 0.1
    # the merge rescues the split state, as in JAX's test
    assert float((st.counts == 1).float().mean()) > 0.8
    assert 0.0 < float(applied) / 800 < 1.0


@pytest.fixture(scope="module")
def rjmh():
    image, prior, model, move = two_star_image()
    jmove = move.replace(num_iters=1, locs_stdev=jnp.float32(0.1),
                         fluxes_stdev=jnp.float32(40.0))
    from smcdet_tpu.inference.mcmc import MCMCConfig, run_rjmh

    cfg = dict(num_samples_total=2400, num_samples_burnin=1200,
               keep_every_k=2, flux_detection_threshold=500.0)
    want = jax.jit(lambda k, im: run_rjmh(
        k, im, prior, model, jtd.BirthDeathMH(num_iters=1, move=jmove),
        MCMCConfig(**cfg)))(jax.random.key(0), image[None])
    got = tmcmc.run_rjmh(
        torch.Generator().manual_seed(0), t(image)[None], port_prior(prior),
        port_model(model), ttd.BirthDeathMH(1, port_kernel(jmove)),
        tmcmc.MCMCConfig(**cfg))
    return want, got


def test_run_rjmh_count_posterior_matches_jax(rjmh):
    want, got = rjmh
    for pc, flux in ((np.asarray(want.pruned_counts[0]),
                      np.asarray(want.pruned_fluxes[0]).sum(-1)),
                     (got.pruned_counts[0].numpy(),
                      got.pruned_fluxes[0].sum(-1).numpy())):
        assert np.mean(pc == 2) > 0.9, np.bincount(pc)
        med = np.median(flux[pc == 2])
        assert abs(med - 4100.0) / 4100.0 < 0.1, med
    assert got.counts.shape == want.counts.shape == (1, 600)
    assert got.locs.shape == want.locs.shape
    assert 0.0 < float(got.acc_rate[0]) < 1.0


@pytest.mark.parametrize("split_merge", [False, True])
def test_run_tdsmc_count_posterior_matches_jax(split_merge):
    image, prior, model, move = two_star_image()
    probs = (dict(prob_birth=0.15, prob_death=0.15, prob_split=0.1,
                  prob_merge=0.1) if split_merge else {})
    jmove = move.replace(num_iters=1, backend="xla")
    cfg = dict(num_particles=256, resample_method="systematic",
               max_smc_iters=60, flux_detection_threshold=200.0)
    want = jax.jit(jtd.run_tdsmc)(
        jax.random.key(0), image[None], prior, model,
        jtd.BirthDeathMH(num_iters=20, move=jmove, **probs),
        jtd.TDSMCConfig(**cfg))
    got = ttd.run_tdsmc(
        torch.Generator().manual_seed(0), t(image)[None], port_prior(prior),
        port_model(model),
        ttd.BirthDeathMH(20, port_kernel(jmove), **probs),
        ttd.TDSMCConfig(**cfg))
    assert float(got.temperature[0]) == 1.0
    assert got.num_iters < 60
    assert abs(got.num_iters - int(want.num_iters)) <= 4
    assert np.isfinite(float(got.log_normalizing_constant[0]))
    assert abs(float(got.log_normalizing_constant[0])
               - float(want.log_normalizing_constant[0])) < 5.0
    for pc, flux in ((np.asarray(want.pruned_counts[0]),
                      np.asarray(want.pruned_fluxes[0]).sum(-1)),
                     (got.pruned_counts[0].numpy(),
                      got.pruned_fluxes[0].sum(-1).numpy())):
        assert np.mean(pc == 2) > 0.5, np.bincount(pc)
        med = np.median(flux[pc == 2])
        assert abs(med - 4100.0) / 4100.0 < 0.15, med
    assert got.counts.min() >= 0 and got.counts.max() <= 3
