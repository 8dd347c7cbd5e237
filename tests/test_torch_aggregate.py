"""The port's aggregation stage (smcdet_tpu_torch/inference/aggregate.py,
the bridge target in inference/kernels.py and ops/mh_sweep.py, and
``stratified_indices``) against smcdet_tpu/inference/aggregate.py on the
same inputs.

The setup is tests/test_aggregate.py's: 8x8 tiles in a 2x2 grid, uniform
counts 0..3, Normal fluxes, a Gaussian PSF and Poisson noise. Inputs are
made with numpy or JAX and handed to both packages. On the CPU, JAX's
``SingleComponentMH`` takes its XLA sweep (the Pallas kernel needs a TPU).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread,
    port_kernel,
    port_model,
    port_prior,
    t,
)

from smcdet_tpu.inference import aggregate as jagg
from smcdet_tpu.inference.kernels import (
    SingleComponentMH as JaxMH,
    TargetContext as JaxCtx,
    init_kernel_state as jax_init_state,
    relocate_sweeps as jax_relocate,
)
from smcdet_tpu.models.imaging import ImageModel as JaxImageModel
from smcdet_tpu.models.priors import (
    NormalFlux as JaxNormalFlux,
    PointProcessPrior as JaxPrior,
    PoissonProcessPrior as JaxPoissonPrior,
    UniformCounts as JaxUniformCounts,
)
from smcdet_tpu.models.psf import GaussianPSF as JaxGaussianPSF
from smcdet_tpu.ops.resampling import stratified_indices as jax_stratified
from smcdet_tpu_torch.inference import aggregate as tagg
from smcdet_tpu_torch.inference.kernels import (
    KernelState,
    TargetContext,
    init_kernel_state,
    relocate_sweep,
)
from smcdet_tpu_torch.ops import mh_sweep
from smcdet_tpu_torch.ops.resampling import stratified_indices

RTOL = 1e-5  # f32 arithmetic done in the same order in both packages


def _jax_setup(num_iters=20):
    """tests/test_aggregate.py's prior, tile model and MH kernel (JAX)."""
    prior = JaxPrior(
        min_objects=0, max_objects=3, image_height=8, image_width=8, pad=1.0,
        counts=JaxUniformCounts(low=0, high=3),
        flux=JaxNormalFlux(mean=jnp.float32(2000.0),
                           stdev=jnp.float32(300.0)))
    model = JaxImageModel(height=8, width=8, psf_radius=4, noise="poisson",
                          background=jnp.float32(100.0),
                          psf=JaxGaussianPSF(stdev=jnp.float32(1.0)))
    kernel = JaxMH(num_iters=num_iters, locs_stdev=jnp.float32(0.25),
                   fluxes_stdev=jnp.float32(60.0),
                   fluxes_min=jnp.float32(500.0),
                   fluxes_max=jnp.float32(5000.0))
    return prior, model, kernel


TRUE_LOCS = np.asarray([[3.0, 3.5], [12.5, 4.0], [8.0, 11.5]])
TRUE_FLUXES = np.asarray([2000.0, 2200.0, 2400.0])


# ----------------------------------------------------------------------
# expand_prior
# ----------------------------------------------------------------------
@pytest.mark.parametrize("counts", ["poisson", "uniform"])
def test_expand_prior_matches_jax(counts):
    if counts == "poisson":
        jp = JaxPoissonPrior(min_objects=0, max_objects=4, counts_rate=0.03,
                             image_height=8, image_width=8, pad=1.0)
    else:
        jp, _, _ = _jax_setup()
    tp = port_prior(jp)
    for h, w, m in ((16, 8, 8), (16, 16, 16)):
        je, te = jagg.expand_prior(jp, h, w, m), tagg.expand_prior(tp, h, w, m)
        assert (te.image_height, te.image_width, te.max_objects,
                te.min_objects, te.pad) == (je.image_height, je.image_width,
                                            je.max_objects, je.min_objects,
                                            je.pad)
        np.testing.assert_array_equal(te.loc_high.numpy(),
                                      np.asarray(je.loc_high))
        if counts == "poisson":
            assert float(te.counts.rate) == float(je.counts.rate)
        else:
            assert (te.counts.low, te.counts.high) == (je.counts.low,
                                                       je.counts.high)
        # the fields above are exact; the log-pmf differs by lgamma's ulps
        support = np.arange(0, m + 1, dtype=np.int32)
        np.testing.assert_allclose(
            te.counts.log_prob(torch.from_numpy(support)).numpy(),
            np.asarray(je.counts.log_prob(support)), rtol=RTOL)


# ----------------------------------------------------------------------
# stratified_indices
# ----------------------------------------------------------------------
def _strata_table(seed, B=3, N=40, C=6):
    """Weights and strata with stratum 4 empty and stratum 2's weights all
    zero."""
    rng = np.random.default_rng(seed)
    strata = rng.choice([0, 1, 2, 3, 5], size=(B, N)).astype(np.int32)
    weights = rng.exponential(size=(B, N)).astype(np.float32)
    weights[strata == 2] = 0.0
    return weights, strata, C


@pytest.mark.parametrize("method", ["multinomial", "systematic"])
@pytest.mark.parametrize("seed", [0, 1])
def test_stratified_indices_given_jax_draws(method, seed):
    weights, strata, C = _strata_table(seed)
    key = jax.random.key(seed + 10)
    want = np.asarray(jax_stratified(key, jnp.asarray(weights),
                                     jnp.asarray(strata), C, method))
    B, N = weights.shape
    if method == "multinomial":
        draws = {"u": t(jax.random.uniform(key, (B, C, N)))}
    else:
        draws = {"offset": t(jax.random.uniform(key, (B, C)))}
    got = stratified_indices(t(weights), torch.from_numpy(strata), C, method,
                             **draws)
    np.testing.assert_array_equal(got.numpy(), want)
    # every ancestor lies in its particle's stratum, the all-zero stratum
    # included (uniform over its members)
    np.testing.assert_array_equal(np.take_along_axis(strata, want, -1),
                                  strata)


@pytest.mark.parametrize("method", ["multinomial", "systematic"])
def test_stratified_indices_from_generator_stay_in_stratum(method):
    weights, strata, C = _strata_table(2, B=2, N=300)
    idx = stratified_indices(t(weights), torch.from_numpy(strata), C, method,
                             generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        np.take_along_axis(strata, idx.numpy(), -1), strata)
    # within stratum 0 the heaviest particle is drawn most often
    w0 = np.where(strata[0] == 0, weights[0], 0.0)
    picks = np.bincount(idx[0].numpy(), minlength=strata.shape[1])
    assert picks[np.argmax(w0)] >= picks[strata[0] == 0].mean()


# ----------------------------------------------------------------------
# _merge with fixed resample indices
# ----------------------------------------------------------------------
def _grid_state(Th, Tw, H, W, N, M, seed):
    """A random particle system on a ``Th x Tw`` grid of ``H x W`` tiles,
    with sources spilling over the tile edges (so the merge drops some)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, M + 1, (Th, Tw, N)).astype(np.int32)
    active = np.arange(M) < counts[..., None]
    locs = np.stack([rng.uniform(-1.0, H + 1.0, (Th, Tw, N, M)),
                     rng.uniform(-1.0, W + 1.0, (Th, Tw, N, M))], -1)
    locs = (locs * active[..., None]).astype(np.float32)
    fluxes = (rng.uniform(1500.0, 2500.0, (Th, Tw, N, M))
              * active).astype(np.float32)
    weights = rng.exponential(size=(Th, Tw, N)).astype(np.float32)
    weights /= weights.sum(-1, keepdims=True)
    log_z = rng.normal(-300.0, 20.0, (Th, Tw, M + 1)).astype(np.float32)
    data = rng.poisson(150.0, (Th, Tw, H, W)).astype(np.float32)
    return jagg.AggregateState(
        data=jnp.asarray(data), counts=jnp.asarray(counts),
        locs=jnp.asarray(locs), fluxes=jnp.asarray(fluxes),
        weights=jnp.asarray(weights), log_z=jnp.asarray(log_z))


def _to_port_state(js):
    return tagg.AggregateState(
        data=t(js.data), counts=t(js.counts, torch.int32), locs=t(js.locs),
        fluxes=t(js.fluxes), weights=t(js.weights), log_z=t(js.log_z))


@functools.cache
def _merged(axis):
    """JAX's merge of a level: axis 0 merges a 2x2 grid of 8x8 tiles, axis
    1 the resulting 1x2 grid of 16x8 tiles."""
    _, model, _ = _jax_setup()
    dims = (2, 2, 8, 8) if axis == 0 else (1, 2, 16, 8)
    M = 3 if axis == 0 else 6
    js = _grid_state(*dims, N=48, M=M, seed=axis)
    H_new, W_new = (16, 8) if axis == 0 else (16, 16)
    model_new = model.replace(height=H_new, width=W_new)
    cfg = jagg.AggregateConfig(resample_method="multinomial")
    key = jax.random.key(3 + axis)
    merged = jax.jit(lambda k, s: jagg._merge(
        k, s, axis, dims, 2 * M, cfg, model_new=model_new))(key, js)
    # the resample draw _merge makes with this key
    idx = jagg.resample_indices(key, js.weights, js.counts.shape[-1],
                                "multinomial")
    return js, dims, M, model_new, idx, merged


@pytest.mark.parametrize("axis", [0, 1])
def test_merge_matches_jax(axis):
    js, dims, M, jmodel_new, idx, (jm, jside, jghost) = _merged(axis)
    model_new = port_model(jmodel_new)
    cfg = tagg.AggregateConfig(resample_method="multinomial")
    pm, pside, pghost = tagg._merge(None, _to_port_state(js), axis, dims,
                                    2 * M, cfg, model_new,
                                    idx=t(idx, torch.int64))
    assert int(np.asarray(jm.counts).max()) >= 2  # pairs do join
    for name in ("data", "counts", "locs", "fluxes"):
        np.testing.assert_array_equal(getattr(pm, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    np.testing.assert_array_equal(pside.numpy(), np.asarray(jside))
    assert float(np.abs(np.asarray(jghost)).max()) > 0.0  # stars dropped
    np.testing.assert_allclose(pghost.numpy(), np.asarray(jghost), rtol=RTOL,
                               atol=1e-3)
    np.testing.assert_allclose(pm.log_z.numpy(), np.asarray(jm.log_z),
                               rtol=RTOL)
    np.testing.assert_array_equal(pm.weights.numpy(), np.asarray(jm.weights))


@functools.cache
def _merged_4x4(level):
    """JAX's merge at level 2 (axis 0: the 2x2 grid of 16x16 tiles, 32
    slots, into 32x16 tiles with 64) or 3 (axis 1: the 1x2 grid of 32x16
    tiles into the 32x32 image with 128 slots) of a 4x4 grid of 8x8
    tiles."""
    _, model, _ = _jax_setup()
    axis, dims, M = {2: (0, (2, 2, 16, 16), 32), 3: (1, (1, 2, 32, 16), 64)}[
        level]
    js = _grid_state(*dims, N=24, M=M, seed=10 + level)
    model_new = model.replace(height=32, width=16 if level == 2 else 32)
    cfg = jagg.AggregateConfig(resample_method="multinomial")
    key = jax.random.key(7 + level)
    merged = jax.jit(lambda k, s: jagg._merge(
        k, s, axis, dims, 2 * M, cfg, model_new=model_new))(key, js)
    idx = jagg.resample_indices(key, js.weights, js.counts.shape[-1],
                                "multinomial")
    return js, axis, dims, M, model_new, idx, merged


@pytest.mark.parametrize("level", [2, 3])
def test_merge_matches_jax_at_the_upper_levels_of_a_4x4_grid(level):
    """Levels 2 and 3 of a 4x4 grid, given JAX's resample indices: the
    joined data, counts, catalogs, origin tags (one per slot, past the 32
    a bit mask holds) and normalising constants equal JAX's; the ghost
    rate to rtol 1e-5 (f32 renders summed in the same order)."""
    js, axis, dims, M, jmodel_new, idx, (jm, jside, jghost) = _merged_4x4(
        level)
    model_new = port_model(jmodel_new)
    cfg = tagg.AggregateConfig(resample_method="multinomial")
    pm, pside, pghost = tagg._merge(None, _to_port_state(js), axis, dims,
                                    2 * M, cfg, model_new,
                                    idx=t(idx, torch.int64))
    assert pm.locs.shape[-2] == pside.shape[-1] == 2 * M
    assert int(np.asarray(jm.counts).max()) > 32  # tags past a 32-bit mask
    # level 3's even member holds up to 64 stars: even tags past slot 32
    assert float(np.asarray(jside)[..., 32:].max()) == float(level == 3)
    for name in ("data", "counts", "locs", "fluxes"):
        np.testing.assert_array_equal(getattr(pm, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    np.testing.assert_array_equal(pside.numpy(), np.asarray(jside))
    assert float(np.abs(np.asarray(jghost)).max()) > 0.0  # stars dropped
    np.testing.assert_allclose(pghost.numpy(), np.asarray(jghost), rtol=RTOL,
                               atol=1e-3)
    np.testing.assert_allclose(pm.log_z.numpy(), np.asarray(jm.log_z),
                               rtol=RTOL)
    np.testing.assert_array_equal(pm.weights.numpy(), np.asarray(jm.weights))


# ----------------------------------------------------------------------
# _temper_reweight
# ----------------------------------------------------------------------
@pytest.mark.parametrize("done", [False, True])
def test_temper_reweight_matches_jax(done):
    rng = np.random.default_rng(7)
    Th, Tw, N, C = 1, 2, 64, 7
    counts = rng.integers(0, C - 1, (Th, Tw, N)).astype(np.int32)  # C-1 empty
    ld = rng.normal(0.0, 40.0, (Th, Tw, N)).astype(np.float32)
    w = rng.exponential(size=(Th, Tw, N)).astype(np.float32)
    log_z = rng.normal(-50.0, 5.0, (Th, Tw, C)).astype(np.float32)
    temp = np.asarray([[1.0 if done else 0.2, 0.35]], np.float32)
    smask = jagg._stratum_mask(jnp.asarray(counts), C)
    n_strat = smask.sum(-1).astype(jnp.float32)
    jc = jagg._BridgeCarry(
        key=None, locs=None, fluxes=None, slot_side=None, ghost_rate=None,
        loglik_diff=jnp.asarray(ld), weights_ic=jnp.asarray(w),
        log_z=jnp.asarray(log_z), temperature=jnp.asarray(temp),
        acc_rate=None, iteration=0)
    cfg = jagg.AggregateConfig(ess_threshold_prop=0.5)
    jr = jagg._temper_reweight(jc, jnp.asarray(counts), smask, n_strat, cfg)

    pc = tagg._Bridge(locs=None, fluxes=None, slot_side=None,
                      ghost_rate=None, loglik_diff=t(ld), weights_ic=t(w),
                      log_z=t(log_z), temperature=t(temp), acc_rate=None,
                      iteration=0)
    pcounts = torch.from_numpy(counts).long()
    psmask = tagg._stratum_mask(pcounts, C)
    pr = tagg._temper_reweight(pc, pcounts, psmask,
                               psmask.sum(-1).to(torch.float32),
                               tagg.AggregateConfig(ess_threshold_prop=0.5))
    # rtol 1e-5 on the step (40 bisection halvings on f32 ESS sums taken
    # in another order), and on the weights and log Z that follow from it
    np.testing.assert_allclose(pr.temperature.numpy(),
                               np.asarray(jr.temperature), rtol=RTOL)
    assert float(pr.temperature.min()) > float(temp.min())
    np.testing.assert_allclose(pr.weights_ic.numpy(),
                               np.asarray(jr.weights_ic), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(pr.log_z.numpy(), np.asarray(jr.log_z),
                               rtol=RTOL)


# ----------------------------------------------------------------------
# The bridge target
# ----------------------------------------------------------------------
@functools.cache
def _bridge(mode, ghost=True, N=64):
    """A level-0 bridge problem from the JAX merge: the JAX and the port
    contexts at temperature 0.4 (``mode`` "tag": origin tags; "location":
    the side of each star's location), counts, locs and fluxes."""
    js, dims, M, jmodel_new, idx, (jm, jside, jghost) = _merged(0)
    prior, _, _ = _jax_setup()
    jprior_new = jagg.expand_prior(prior, 16, 8, 2 * M)
    side = jagg._side_mask_fn(0, 8, 16, 8)
    rng = np.random.default_rng(11)
    image = rng.poisson(160.0, (1, 2, 16, 8)).astype(np.float32)
    temp = np.full((1, 2, 1), 0.4, np.float32)
    jctx = JaxCtx(prior=jprior_new, model=jmodel_new,
                  image=jnp.asarray(image)[:, :, None],
                  temperature=jnp.asarray(temp), child_model=jmodel_new,
                  child_side_mask=side,
                  child_slot_side=jside if mode == "tag" else None,
                  child_ghost_rate=jghost if ghost else None)
    pmodel = port_model(jmodel_new)
    pctx = TargetContext(
        tagg.expand_prior(port_prior(prior), 16, 8, 2 * M), pmodel,
        t(image)[:, :, None], t(temp), child_model=pmodel,
        child_side_mask=tagg.SideMask(0, 8, 16, 8),
        child_slot_side=t(jside) if mode == "tag" else None,
        child_ghost_rate=t(jghost) if ghost else None)
    return jctx, pctx, jm.counts, jm.locs, jm.fluxes


@pytest.mark.parametrize("mode", ["tag", "location"])
@pytest.mark.parametrize("ghost", [True, False])
def test_bridge_context_rates_and_logliks_match_jax(mode, ghost):
    _check_bridge_context(*_bridge(mode, ghost))


def _check_bridge_context(jctx, pctx, counts, locs, fluxes):
    """The port's bridge context against JAX's on one merged state: the
    parent and child rates, the log-likelihood terms and the tempered
    target to rtol 1e-5."""
    jrate, jchild = jax.jit(jctx.init_rates)(locs, fluxes)
    prate, pchild = pctx.init_rates(t(locs), t(fluxes))
    np.testing.assert_allclose(prate.numpy(), np.asarray(jrate), rtol=RTOL)
    np.testing.assert_allclose(pchild.numpy(), np.asarray(jchild),
                               rtol=RTOL)
    # the child rate differs from the parent's: the windows cut stars
    assert float((prate - pchild).abs().max()) > 1.0
    jll = jax.jit(jctx.loglik_terms)(jrate, jchild)
    pll = pctx.loglik_terms(prate, pchild)
    for a, b in zip(pll, jll):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    lp = pctx.prior.log_prob(t(counts, torch.int32), t(locs), t(fluxes))
    np.testing.assert_allclose(
        pctx.combine(lp, *pll).numpy(),
        np.asarray(jctx.combine(jnp.asarray(lp.numpy()), *jll)), rtol=RTOL)


@functools.cache
def _bridge_4x4(level, mode):
    """The bridge problem of level 2 or 3 of a 4x4 grid from JAX's merge
    (``_merged_4x4``: 64 or 128 slots, its origin tags and ghost rate): the
    JAX and the port contexts at temperature 0.4, counts, locs and
    fluxes."""
    js, axis, dims, M, jmodel_new, idx, (jm, jside, jghost) = _merged_4x4(
        level)
    prior, _, _ = _jax_setup()
    Th, Tw, H, W = dims
    shape = (Th // 2, Tw, 2 * H, W) if axis == 0 else (Th, Tw // 2, H, 2 * W)
    bound = H if axis == 0 else W
    rng = np.random.default_rng(12 + level)
    image = rng.poisson(160.0, shape).astype(np.float32)
    temp = np.full(shape[:2] + (1,), 0.4, np.float32)
    jctx = JaxCtx(prior=jagg.expand_prior(prior, *shape[2:], 2 * M),
                  model=jmodel_new, image=jnp.asarray(image)[:, :, None],
                  temperature=jnp.asarray(temp), child_model=jmodel_new,
                  child_side_mask=jagg._side_mask_fn(axis, bound, *shape[2:]),
                  child_slot_side=jside if mode == "tag" else None,
                  child_ghost_rate=jghost)
    pmodel = port_model(jmodel_new)
    pctx = TargetContext(
        tagg.expand_prior(port_prior(prior), *shape[2:], 2 * M), pmodel,
        t(image)[:, :, None], t(temp), child_model=pmodel,
        child_side_mask=tagg.SideMask(axis, bound, *shape[2:]),
        child_slot_side=t(jside) if mode == "tag" else None,
        child_ghost_rate=t(jghost))
    return jctx, pctx, jm.counts, jm.locs, jm.fluxes


@pytest.mark.parametrize("mode", ["tag", "location"])
@pytest.mark.parametrize("level", [2, 3])
def test_bridge_context_at_the_upper_levels_of_a_4x4_grid_matches_jax(
        level, mode):
    """The bridge target that levels 2 and 3 of a 4x4 grid build from
    their merge (origin tags one per slot past 32, the ghost rate of the
    dropped stars, the seam at row 16 or column 16): the parent and child
    rates, the log-likelihood terms and the tempered target equal JAX's to
    rtol 1e-5, elementwise."""
    _check_bridge_context(*_bridge_4x4(level, mode))


def _port_state(js):
    return KernelState(t(js.locs), t(js.fluxes), t(js.rate),
                       t(js.parent_ll), t(js.logprior), t(js.child_rate),
                       t(js.child_ll))


def _check_against_jax(pst, jst, flips, names):
    same = ~flips
    assert flips.mean() < 0.01
    for name in names:
        # rtol 1e-4: f32 ndtri/exp/log rounding and the pixel-sum order
        np.testing.assert_allclose(
            getattr(pst, name).numpy()[same],
            np.asarray(getattr(jst, name))[same], rtol=1e-4, atol=1e-3,
            err_msg=name)


_STATE = ("locs", "fluxes", "rate", "parent_ll", "logprior", "child_rate",
          "child_ll")


@pytest.mark.parametrize("mode", ["tag", "location"])
def test_one_bridge_sweep_matches_jax(mode):
    from test_torch_mh_sweep import _jax_sweep_uniforms

    jctx, pctx, counts, locs, fluxes = _bridge(mode)
    _, _, kernel = _jax_setup(num_iters=1)
    state = jax.jit(jax_init_state)(jctx, counts, locs, fluxes)
    key = jax.random.key(21)
    jst, japplied = jax.jit(
        lambda k, st: kernel.sweep(k, jctx, counts, st))(key, state)
    u = [t(x) for x in jax.jit(_jax_sweep_uniforms, static_argnums=1)(
        key, counts.shape)]
    pkernel = port_kernel(kernel)
    pcounts = t(counts, torch.int32)
    pstate = _port_state(state)
    pst, papplied = pkernel.sweep(None, pctx, pcounts, pstate, uniforms=u)
    # log alpha of every proposal (u_acc = 0 accepts every finite one)
    ast, _ = pkernel.sweep(None, pctx, pcounts, pstate,
                           uniforms=u[:3] + [torch.zeros_like(u[3])])
    prop = pkernel.proposal(pctx.prior)
    j = torch.minimum(torch.floor(u[0] * pcounts).long(),
                      pcounts.long() - 1).clamp(min=0)[..., None]
    take = lambda a: torch.gather(a, -1, j).squeeze(-1)  # noqa: E731
    lm = mh_sweep.truncated_normal_log_mass
    lo, hi = pctx.prior.loc_low, pctx.prior.loc_high
    log_q = sum(
        sgn * lm(take(st.locs[..., d]), prop.locs_stdev, lo[d], hi[d])
        for sgn, st in ((1, pstate), (-1, ast)) for d in (0, 1)) + (
        lm(take(pstate.fluxes), prop.fluxes_stdev, prop.flux_lo,
           prop.flux_hi)
        - lm(take(ast.fluxes), prop.fluxes_stdev, prop.flux_lo,
             prop.flux_hi))
    log_alpha = (pctx.combine(ast.logprior, ast.parent_ll, ast.child_ll)
                 - pctx.combine(pstate.logprior, pstate.parent_ll,
                                pstate.child_ll) + log_q)
    margin = (torch.log(u[3]) - torch.clamp(log_alpha, max=0.0)).abs()
    flips = np.asarray(japplied) != papplied.numpy()
    # a flip is allowed only where u sits on the acceptance boundary
    assert (margin.numpy()[flips] < 1e-3).all(), margin.numpy()[flips]
    assert papplied.float().mean() > 0.05  # the sweep does move particles
    _check_against_jax(pst, jst, flips, _STATE)


@pytest.mark.parametrize("mode", ["tag", "location"])
def test_one_bridge_relocation_matches_jax(mode):
    from test_torch_relocate import _jax_draws

    jctx, pctx, counts, locs, fluxes = _bridge(mode)
    state = jax.jit(jax_init_state)(jctx, counts, locs, fluxes)
    key = jax.random.key(23)
    jst, _ = jax.jit(lambda k, st: jax_relocate(k, jctx, counts, st, 1))(
        key, state)
    draws = jax.jit(lambda k: _jax_draws(k, jctx.prior, counts.shape))(key)
    u_j, u_loc, f_prop, u_acc = (t(d) for d in draws)
    pcounts = t(counts, torch.int32)
    pstate = _port_state(state)
    pst, applied = relocate_sweep(pctx, pcounts, pstate, u_j, u_loc, f_prop,
                                  u_acc)
    ast, _ = relocate_sweep(pctx, pcounts, pstate, u_j, u_loc, f_prop,
                            torch.zeros_like(u_acc))
    tau = pctx.temperature
    log_alpha = (tau * (ast.parent_ll - pstate.parent_ll)
                 + (1.0 - tau) * (ast.child_ll - pstate.child_ll))
    margin = (torch.log(u_acc) - torch.clamp(log_alpha, max=0.0)).abs()
    japplied = np.asarray(jst.locs != state.locs).any((-1, -2))
    flips = japplied != applied.numpy()
    assert (margin.numpy()[flips] < 1e-3).all(), margin.numpy()[flips]
    assert applied.float().mean() > 0.01  # relocations do happen
    _check_against_jax(pst, jst, flips, _STATE)


@pytest.mark.parametrize("mode", ["tag", "location"])
def test_plain_philox_bridge_loop_keeps_both_caches(mode):
    """200 sweeps of the plain version of K3 on its Philox stream: both
    incremental caches and likelihoods equal a fresh render, and the ghost
    rate is carried through, never re-rendered."""
    _, pctx, counts, locs, fluxes = _bridge(mode)
    _, _, kernel = _jax_setup(num_iters=200)
    pkernel = port_kernel(kernel)
    pcounts = t(counts, torch.int32)
    st0 = init_kernel_state(pctx, pcounts, t(locs), t(fluxes))
    st, acc = pkernel.run_from_state(torch.Generator().manual_seed(4), pctx,
                                     pcounts, st0)
    assert 0.05 < float(acc.mean()) < 0.95
    fresh = init_kernel_state(pctx, pcounts, st.locs, st.fluxes)
    for name in ("rate", "child_rate"):
        a, b = getattr(st, name), getattr(fresh, name)
        # f32 incremental accumulation over the accepted sweeps
        assert float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) < 2e-4
    for name in ("parent_ll", "child_ll"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   getattr(fresh, name).numpy(), rtol=1e-4,
                                   atol=1e-2)
    np.testing.assert_allclose(st.logprior.numpy(), fresh.logprior.numpy(),
                               rtol=1e-5, atol=1e-3)
    assert torch.equal(st.fluxes == 0, st0.fluxes == 0)  # counts unchanged


# ----------------------------------------------------------------------
# A whole Aggregate at a small size
# ----------------------------------------------------------------------
def _image():
    _, model, _ = _jax_setup()
    return model.replace(height=16, width=16).sample(
        jax.random.key(9), jnp.asarray(TRUE_LOCS), jnp.asarray(TRUE_FLUXES))


_SAMPLER = dict(tile_dim=8, num_catalogs=96, flux_detection_threshold=600.0,
                max_smc_iters=40, resample_method="systematic")


@pytest.fixture(scope="module")
def aggregated():
    """JAX's and the port's whole pipeline on one 16x16 image (three stars,
    one on the seam): per-tile CS-SMC with N = 96 and 5 sweeps, then two
    aggregation levels."""
    from smcdet_tpu.inference.smc import SMCSampler as JaxSampler
    from smcdet_tpu_torch.inference.smc import SMCSampler

    prior, model, kernel = _jax_setup(num_iters=5)
    image = _image()
    js = JaxSampler(image=image, Prior=prior, ImageModel=model,
                    MutationKernel=kernel, **_SAMPLER)
    js.run(jax.random.key(1))
    jaggr = jagg.Aggregate.from_smc(js, max_smc_iters=60)
    jaggr.run(jax.random.key(2))

    ps = SMCSampler(image=t(image), Prior=port_prior(prior),
                    ImageModel=port_model(model),
                    MutationKernel=port_kernel(kernel), **_SAMPLER)
    gen = torch.Generator().manual_seed(1)
    ps.run(gen)
    paggr = tagg.Aggregate.from_smc(ps, max_smc_iters=60)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no level may exit at the cap
        with torch.profiler.profile() as prof:
            paggr.run(gen)
    names = {e.key for e in prof.key_averages()}
    return jaggr, paggr, names


def test_aggregate_invariants(aggregated):
    _, agg, names = aggregated
    assert agg.num_aggregation_levels == 2
    assert agg.state.data.shape == (1, 1, 16, 16)
    assert (agg.image_height, agg.image_width) == (16, 16)
    for d in agg.diagnostics:
        assert torch.all(d["temperature"] == 1.0), d
        assert 0 <= d["iterations"] < 60
    np.testing.assert_allclose(agg.state.weights.sum(-1).numpy(), 1.0,
                               rtol=1e-5)
    assert torch.isfinite(agg.state.log_z.max())
    assert agg.state.locs.shape[-2] == 12  # 3 -> 6 -> 12 slots
    assert {"agg.merge", "agg.resample", "agg.rerender", "agg.mutate",
            "agg.relocate", "agg.temper"} <= names


def test_aggregate_summaries_match_jax(aggregated, capsys):
    """The posterior summaries of the JAX wrapper, on the port's state: the
    same shapes, flux totals within 10% (three stars of flux 2000-2400 at
    N = 4 x 96), and the printed summary."""
    jaggr, agg, _ = aggregated
    for name in ("ess", "posterior_mean_count", "posterior_mean_total_flux"):
        got, want = getattr(agg, name), getattr(jaggr, name)
        got, want = (got() if callable(got) else got), np.asarray(
            want() if callable(want) else want)
        assert tuple(got.shape) == want.shape == (1, 1), name
    flux = float(agg.posterior_mean_total_flux(agg.pruned_fluxes)[0, 0])
    jflux = float(jaggr.posterior_mean_total_flux(jaggr.pruned_fluxes)[0, 0])
    assert abs(flux - jflux) <= 0.1 * jflux, (flux, jflux)
    obs = agg.posterior_predictive_total_observed_flux(
        torch.Generator().manual_seed(0))
    assert obs.shape == agg.state.counts.shape
    agg.summarize()
    assert "posterior mean total intrinsic flux" in capsys.readouterr().out


def test_aggregate_count_posterior_matches_jax(aggregated):
    """Different random streams: the posterior count mode agrees, and the
    posterior mean pruned count within 0.5 (Monte Carlo error of a count
    posterior concentrated on 3 at N = 4 x 96 flat particles)."""
    jaggr, paggr, _ = aggregated
    jc = np.asarray(jaggr.pruned_counts[0, 0])
    pc = paggr.pruned_counts[0, 0].numpy()
    assert np.bincount(pc).argmax() == np.bincount(jc).argmax() == 3
    jmean = float(jaggr.posterior_mean_count()[0, 0])
    pmean = float(paggr.posterior_mean_count()[0, 0])
    assert abs(pmean - jmean) <= 0.5, (pmean, jmean)


# six stars on a 32x32 image: four bright, and two at the detection
# threshold (600) on seams, one at row 8 (level 0) and one at row 16
# (level 2), so that runs differ in the root's pruned count
TRUE_LOCS_4X4 = np.asarray([[3.0, 3.5], [12.5, 4.0], [8.0, 11.5],
                            [20.5, 24.0], [27.0, 16.0], [15.8, 29.0]])
TRUE_FLUXES_4X4 = np.asarray([2000.0, 2200.0, 590.0, 2100.0, 2300.0,
                              610.0])
# independent whole-tree runs of the image: the port's and JAX's
TREE_RUNS_4X4 = (4, 8)
# the pruned counts a root pmf is kept over
TREE_COUNTS_4X4 = 12


def _tree_grid(sampler, result, copies):
    """A finished sampler's posterior over ``copies`` 32x32 images stacked
    on the image's rows, as ``Aggregate.from_smc`` lays it out, with the
    copies on a leading axis: ``[copies, 4, 4, ...]``."""
    td, CN = sampler.tile_dim, result.counts.shape[-1]
    M = result.fluxes.shape[-1]
    g = (copies, 4, 4)
    return dict(data=sampler.tiled_image.reshape(g + (td, td)),
                counts=result.counts.reshape(g + (CN,)),
                locs=result.locs.reshape(g + (CN, M, 2)),
                fluxes=result.fluxes.reshape(g + (CN, M)),
                weights=result.weights.reshape(g + (CN,)),
                log_z=result.log_normalizing_constant.reshape(g + (-1,)))


def _root_pmf(pruned):
    return np.bincount(pruned, minlength=TREE_COUNTS_4X4)[
        :TREE_COUNTS_4X4] / pruned.size


@pytest.fixture(scope="module")
def tree_runs_4x4():
    """``TREE_RUNS_4X4`` independent runs of each package's whole pipeline
    on the 32x32 image, a 4x4 grid of 8x8 tiles, on the plain path:
    per-tile CS-SMC with N = 16 and 5 sweeps (every run's 16 tiles in one
    sampler run, the copies of the image stacked on its rows), then each
    run's four aggregation levels (16x8, 16x16, 32x16 and 32x32 with 6, 12,
    24 and 48 slots) and the final resample and prune. The port runs
    ``Aggregate.run``; JAX runs ``Aggregate.run``'s steps (its
    ``_run_level`` per level, ``resample_indices``, ``prune_catalog``)
    under one ``vmap`` over the runs, so that they compile once. Returns
    the port's aggregations and both packages' root pmfs ``[runs, K]``."""
    from smcdet_tpu.inference.smc import SMCSampler as JaxSampler
    from smcdet_tpu.ops.catalogs import prune_catalog, slot_mask
    from smcdet_tpu.ops.resampling import gather_particles
    from smcdet_tpu_torch.inference.smc import SMCSampler

    prior, model, kernel = _jax_setup(num_iters=5)
    image = model.replace(height=32, width=32).sample(
        jax.random.key(9), jnp.asarray(TRUE_LOCS_4X4, jnp.float32),
        jnp.asarray(TRUE_FLUXES_4X4, jnp.float32))
    sampler = dict(_SAMPLER, num_catalogs=16)
    agg = dict(flux_detection_threshold=600.0, resample_method="systematic",
               max_smc_iters=60)
    n_port, n_jax = TREE_RUNS_4X4

    js = JaxSampler(image=jnp.concatenate([image] * n_jax), Prior=prior,
                    ImageModel=model, MutationKernel=kernel, **sampler)
    js.run(jax.random.key(1))
    cfg = jagg.AggregateConfig(**agg)

    def tree(key, state):
        Th, Tw, H, W = 4, 4, 8, 8
        temps = []
        for level in range(4):
            key, k_level = jax.random.split(key)
            state, diag = jagg._run_level(k_level, state, prior, model,
                                          kernel, cfg, level % 2,
                                          (Th, Tw, H, W))
            temps.append(diag["temperature"].min())
            Th, H, Tw, W = ((Th // 2, 2 * H, Tw, W) if level % 2 == 0
                            else (Th, H, Tw // 2, 2 * W))
        key, k_final = jax.random.split(key)
        idx = jagg.resample_indices(k_final, state.weights,
                                    state.counts.shape[-1],
                                    cfg.resample_method)
        counts, locs, fluxes = gather_particles(
            idx, state.counts, state.locs, state.fluxes, particle_axis=2)
        pruned, _, _ = prune_catalog(
            locs, fluxes, height=H, width=W,
            flux_threshold=cfg.flux_detection_threshold,
            mask=slot_mask(counts, fluxes.shape[-1]))
        return pruned[0, 0], jnp.stack(temps)

    pruned, temps = jax.jit(jax.vmap(tree))(
        jax.random.split(jax.random.key(2), n_jax),
        jagg.AggregateState(**_tree_grid(js, js.result, n_jax)))
    assert bool((temps == 1.0).all()), temps  # every level of every run
    jpmf = np.stack([_root_pmf(p) for p in np.asarray(pruned)])

    pp, pm, pk = port_prior(prior), port_model(model), port_kernel(kernel)
    ps = SMCSampler(image=t(jnp.concatenate([image] * n_port)), Prior=pp,
                    ImageModel=pm, MutationKernel=pk, **sampler)
    gen = torch.Generator().manual_seed(1)
    ps.run(gen)
    grid = _tree_grid(ps, ps.result, n_port)
    runs = []
    for r in range(n_port):
        a = tagg.Aggregate(
            Prior=pp, ImageModel=pm, MutationKernel=pk,
            log_normalizing_constant=grid["log_z"][r],
            **{k: v[r] for k, v in grid.items() if k != "log_z"}, **agg)
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # no level may exit at the cap
            a.run(gen)
        runs.append(a)
    ppmf = np.stack([_root_pmf(a.pruned_counts[0, 0].numpy()) for a in runs])
    return runs, ppmf, jpmf


def test_aggregate_4x4_grid_runs_four_levels(tree_runs_4x4):
    runs, _, _ = tree_runs_4x4
    for agg in runs:
        assert agg.num_aggregation_levels == 4
        assert agg.state.data.shape == (1, 1, 32, 32)
        for d in agg.diagnostics:
            assert torch.all(d["temperature"] == 1.0), d
            assert 0 <= d["iterations"] < 60
        np.testing.assert_allclose(agg.state.weights.sum(-1).numpy(), 1.0,
                                   rtol=1e-5)
        assert torch.isfinite(agg.state.log_z.max())
        assert agg.state.locs.shape[-2] == 48  # 3 -> 6 -> 12 -> 24 -> 48


def test_aggregate_4x4_root_count_pmf_matches_jax(tree_runs_4x4):
    """Different random streams: the root's pruned-count pmf pooled over
    the port's 4 runs within the spread of JAX's pooled over 8. At N = 16
    a run's root collapses onto one or two counts, and runs differ: on this
    image 64 JAX runs and 60 port runs (made as here, other seeds) put
    0.1235 and 0.0958 of their mass on 5 and the rest on 4 (11% and 10% of
    runs with mode 5). Drawing a pool of 4 and one of 8 from those 124
    runs 20,000 times gives a TVD of 0.105 at the median, 0.438 at the
    99th percentile and 0.594 at the 99.9th: the limit is 0.6. This holds
    the tree's law only coarsely; the level-2 and -3 merge and bridge
    target are held elementwise above (faulty tags or ghost rates at
    those levels left this statistic within its spread over 12 runs)."""
    _, ppmf, jpmf = tree_runs_4x4
    tvd = 0.5 * np.abs(ppmf.mean(0) - jpmf.mean(0)).sum()
    assert tvd <= 0.6, (ppmf.mean(0), jpmf.mean(0))
    # every run of both packages finds the four bright stars and at most
    # the two faint ones
    assert ppmf[:, 4:7].sum() == len(ppmf) and jpmf[:, 4:7].sum() == len(
        jpmf), (ppmf, jpmf)


def test_aggregate_cap_exit_warns():
    from smcdet_tpu_torch.inference.smc import SMCSampler

    prior, model, kernel = _jax_setup(num_iters=3)
    ps = SMCSampler(image=t(_image()), Prior=port_prior(prior),
                    ImageModel=port_model(model),
                    MutationKernel=port_kernel(kernel),
                    **dict(_SAMPLER, num_catalogs=32, max_smc_iters=10))
    gen = torch.Generator().manual_seed(4)
    ps.run(gen)
    agg = tagg.Aggregate.from_smc(ps, max_smc_iters=1, relocate_sweeps=0)
    with pytest.warns(UserWarning, match="max_smc_iters"):
        agg.run(gen)
    if not torch.cuda.is_available():
        # the level split over devices never runs a CUDA device's share on
        # the CPU
        with pytest.raises(RuntimeError, match="no CUDA card"):
            agg.run(gen, devices=["cuda:0"])


def test_bridge_runs_pair_sweeps_and_blends_acceptance(monkeypatch):
    """``agg.pair`` runs after ``agg.relocate`` in every bridge iteration,
    and a level's acceptance is JAX's blend (aggregate.py:479-489): the
    mutation's, the relocations' and the pair move's, weighted by their
    sweep counts."""
    from smcdet_tpu_torch.inference.smc import SMCSampler

    prior, model, kernel = _jax_setup(num_iters=3)
    ps = SMCSampler(image=t(_image()), Prior=port_prior(prior),
                    ImageModel=port_model(model),
                    MutationKernel=port_kernel(kernel),
                    **dict(_SAMPLER, num_catalogs=32, max_smc_iters=10))
    gen = torch.Generator().manual_seed(5)
    ps.run(gen)
    agg = tagg.Aggregate.from_smc(ps, max_smc_iters=2, relocate_sweeps=2,
                                  pair_sweeps=4)
    with torch.profiler.profile() as prof, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the 2-iteration cap
        agg.run(gen)
    names = [e.name for e in prof.events() if e.name.startswith("agg.")]
    assert names.index("agg.relocate") < names.index("agg.pair")
    assert names.count("agg.pair") == names.count("agg.mutate")

    def fixed(value, run):
        def wrapped(*args, **kwargs):
            st, acc = run(*args, **kwargs)
            return st, torch.full_like(acc, value)
        return wrapped

    pk = agg.kernel
    monkeypatch.setattr(pk, "run_from_state", fixed(0.2, pk.run_from_state))
    monkeypatch.setattr(tagg, "relocate_sweeps",
                        fixed(0.5, tagg.relocate_sweeps))
    monkeypatch.setattr(tagg, "pair_redistribute_sweeps",
                        fixed(0.9, tagg.pair_redistribute_sweeps))
    agg = tagg.Aggregate.from_smc(ps, max_smc_iters=1, relocate_sweeps=2,
                                  pair_sweeps=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        agg.run(gen)
    want = (0.2 * 3 + 0.5 * 2 + 0.9 * 4) / (3 + 2 + 4)
    acc = torch.cat([d["acc_rate"].flatten() for d in agg.diagnostics])
    blended = (acc - want).abs() <= 1e-6 * want
    # a merged tile already at temperature 1 before the first iteration
    # keeps the acceptance 0
    assert torch.all(blended | (acc == 0)) and bool(blended.any()), acc


@pytest.mark.parametrize("grid,method,match", [
    ((2, 4), "multinomial", "square"),
    ((2, 2), "bogus", "resample_method"),
    ((3, 3), "multinomial", "power of two"),
])
def test_aggregate_rejects_bad_inputs(grid, method, match):
    prior, model, kernel = _jax_setup()
    th, tw = grid
    with pytest.raises(ValueError, match=match):
        tagg.Aggregate(
            Prior=port_prior(prior), ImageModel=port_model(model),
            MutationKernel=port_kernel(kernel),
            data=torch.zeros((th, tw, 8, 8)),
            counts=torch.zeros((th, tw, 8), dtype=torch.int32),
            locs=torch.zeros((th, tw, 8, 3, 2)),
            fluxes=torch.zeros((th, tw, 8, 3)),
            weights=torch.full((th, tw, 8), 1 / 8),
            log_normalizing_constant=torch.zeros((th, tw, 4)),
            resample_method=method)
    # pair sweeps are ported: the config takes them
    # (test_bridge_runs_pair_sweeps_and_blends_acceptance)
    assert tagg.AggregateConfig(pair_sweeps=4).pair_sweeps == 4


def test_from_smc_left_pads_log_z_below_min_objects():
    from types import SimpleNamespace

    from smcdet_tpu_torch.convert import prior_from_params

    prior, model, kernel = _jax_setup()
    pprior = prior_from_params(dict(
        min_objects=1, max_objects=3, image_height=8, image_width=8, pad=1.0,
        counts={"kind": "uniform", "low": 1, "high": 3},
        flux={"kind": "normal", "mean": 2000.0, "stdev": 300.0}), "cpu")
    T, C, N, M = 4, 3, 5, 3
    result = SimpleNamespace(
        counts=torch.ones((T, C * N), dtype=torch.int32),
        locs=torch.zeros((T, C * N, M, 2)), fluxes=torch.zeros((T, C * N, M)),
        weights=torch.full((T, C * N), 1.0 / (C * N)),
        log_normalizing_constant=torch.zeros((T, C)))
    sampler = SimpleNamespace(
        result=result, num_tiles_h=2, num_tiles_w=2, tile_dim=8,
        prior=pprior, image_model=port_model(model),
        kernel=port_kernel(kernel), tiled_image=torch.zeros((T, 8, 8)),
        config=SimpleNamespace(flux_detection_threshold=600.0,
                               resample_method="systematic",
                               ess_threshold_prop=0.5))
    agg = tagg.Aggregate.from_smc(sampler)
    assert agg.state.log_z.shape == (2, 2, 4)
    assert torch.all(agg.state.log_z[..., 0] == np.float32(-1e30))
    assert agg.config.resample_method == "systematic"
