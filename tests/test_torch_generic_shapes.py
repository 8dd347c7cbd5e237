"""The sweep kernels at any tile shape and slot count: the routing of
``sweep_kernel`` / ``mala_kernel`` (K1-K4 at the shapes they are built for,
K2g, K3g and K4g beyond, a raise above the shared-memory limit), and the
plain versions of K2g, K3g and K4g (``ops/mh_sweep.py``,
``ops/mala_sweep.py``, which sum a particle's pixels in those kernels' lane
order: their lanes by pixel class, 32 on the wide routes) against the JAX
package's MH and MALA sweeps given the same uniforms, on the tile and the
bridge target (tag and location mode) at the joined shapes of a 4x4 grid of
8x8 tiles (32x16 with 64 slots, 32x32 with 128), its 32x32 single tile (32
slots), and off it (24x24 with 20 slots, 8x8 with 17).

The CUDA kernels themselves run only on the card: see
tests/test_torch_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mh_sweep import _jax_sweep_uniforms
from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    m71_problem,
    one_torch_thread,
    port_kernel,
    port_model,
    port_prior,
    t,
)

from smcdet_tpu.inference import aggregate as jagg
from smcdet_tpu.inference.kernels import (
    SingleComponentMALA as JaxMALA,
    SingleComponentMH as JaxMH,
    TargetContext as JaxCtx,
    init_kernel_state as jax_init_state,
)
from smcdet_tpu.models.imaging import ImageModel as JaxImageModel
from smcdet_tpu.models.priors import (
    NormalFlux as JaxNormalFlux,
    PointProcessPrior as JaxPrior,
    UniformCounts as JaxUniformCounts,
)
from smcdet_tpu.models.psf import GaussianPSF as JaxGaussianPSF
from smcdet_tpu_torch.inference import aggregate as tagg
from smcdet_tpu_torch.inference.kernels import KernelState, TargetContext
from smcdet_tpu_torch.models.imaging import ImageModel
from smcdet_tpu_torch.models.psf import GaussianPSF
from smcdet_tpu_torch.ops import mala_sweep, mh_sweep


# ----------------------------------------------------------------------
# Routing
# ----------------------------------------------------------------------
def _targets():
    """The port's M71 tile target (K1's kind) and a Poisson / Gaussian-PSF
    model (K2's kind), both on 8x8."""
    prior, model, _ = m71_problem(max_objects=4)
    poisson = ImageModel(8, 8, 4, GaussianPSF(1.0, device="cpu"),
                         noise="poisson", background=100.0, device="cpu")
    return port_prior(prior), port_model(model), poisson


# (shape, slots, bridge, the MH kernel, the MALA kernel) on the M71 target:
# every shape K1-K4 take today at its most slots, one slot past it, and the
# launch shapes of a 4x4 grid and its 32x32 single tile
_ROUTES = [
    ((8, 8), 1, False, "K1", "K4"),
    ((8, 8), 16, False, "K1", "K4"),
    ((8, 8), 17, False, "K2g", "K4g"),
    ((16, 16), 16, False, "K2", "K4"),
    ((16, 16), 17, False, "K2g", "K4g"),
    ((16, 8), 16, True, "K3", "K4"),
    ((16, 8), 17, True, "K3g", "K4g"),
    ((16, 16), 32, True, "K3", "K4"),
    ((16, 16), 33, True, "K3g", "K4g"),
    ((32, 16), 64, True, "K3g", "K4g"),
    ((32, 32), 128, True, "K3g", "K4g"),
    ((32, 32), 32, False, "K2g", "K4g"),
    ((24, 24), 20, False, "K2g", "K4g"),
    ((16, 8), 16, False, "K2g", "K4g"),
    ((8, 8), 8, True, "K3g", "K4g"),
]


@pytest.mark.parametrize("shape,M,bridge,mh,mala", _ROUTES)
def test_kernels_route_every_shape(shape, M, bridge, mh, mala):
    prior, model, _ = _targets()
    model = model.with_shape(*shape)
    assert mh_sweep.sweep_kernel(prior, model, M, child=bridge) == mh
    assert mala_sweep.mala_kernel(prior, model, M, child=bridge) == mala
    # the plain versions sum in the order of the kernel that runs the shape:
    # K2g's, K3g's and K4g's lanes by pixel class
    generic = mh.endswith("g")
    cap = mh_sweep.generic_pixel_class(shape[0] * shape[1])
    assert mh_sweep.generic_lanes(model, M, bridge) == (
        mh_sweep.GENERIC_CLASS_LANES[cap, bridge] if generic else None)
    assert mala_sweep.k4_lanes(model, bridge, M) == (
        mh_sweep.GENERIC_CLASS_LANES[cap, bridge] if generic
        else mala_sweep.K4_LANES[(shape, bridge)])


@pytest.mark.parametrize("shape,M", [((128, 128), 1200), ((32, 32), 5000),
                                     ((256, 256), 1)])
@pytest.mark.parametrize("bridge", [False, True])
def test_kernels_raise_above_the_shared_memory_limit(shape, M, bridge):
    """A block's image and 8 catalogs past 227 KB of shared memory raise
    for both kernels, naming the bytes and the limit; one slot fewer on the
    largest M that fits routes."""
    _, _, poisson = _targets()
    prior, _, _ = _targets()
    model = poisson.with_shape(*shape)
    need = mh_sweep.generic_smem_bytes(*shape, M)
    assert need > mh_sweep.GENERIC_SMEM_LIMIT
    for route in (mh_sweep.sweep_kernel, mala_sweep.mala_kernel):
        with pytest.raises(NotImplementedError,
                           match=f"{shape[0]}x{shape[1]} tiles with M={M}: "
                                 f".*{need} bytes.*232448-byte limit"):
            route(prior, model, M, child=bridge)
    free = (mh_sweep.GENERIC_SMEM_LIMIT - 4 * 2 * shape[0] * shape[1]) // 96
    if free >= 1:
        assert mh_sweep.generic_smem_bytes(*shape, free) <= \
            mh_sweep.GENERIC_SMEM_LIMIT
        assert mh_sweep.sweep_kernel(prior, model, free, child=bridge) in (
            "K2g", "K3g")


@pytest.mark.parametrize("bridge", [False, True])
def test_every_shape_routed_before_still_launches_a_kernel(bridge):
    """Every (shape, M, target) that K2g or K3g took before their pixel
    classes (wherever K1-K3 are not built and a block of 8 particles'
    catalogs with the image fits 227 KB) is still theirs, and none raises
    that did not: a tile of up to 1024 pixels takes its class's kernel,
    whose smallest block (one warp of particles with their caches and
    proposals in shared memory) fits, and a larger one, or one whose
    smallest block does not fit (a few pixels with thousands of slots), the
    wide route; every other shape raises as before."""
    _, _, poisson = _targets()
    prior, _, _ = _targets()
    limit = mh_sweep.GENERIC_SMEM_LIMIT
    fixed = {(8, 8): 16, (16, 16): 16} if not bridge else {(16, 8): 16,
                                                           (16, 16): 32}
    for h in (1, 3, 8, 12, 16, 24, 32, 40, 64, 72, 128):
        for w in (1, 8, 16, 20, 32, 48):
            model = poisson.with_shape(h, w)
            for M in (1, 9, 16, 17, 32, 33, 64, 128, 1000, 2400):
                if M <= fixed.get((h, w), 0):
                    assert mh_sweep.sweep_kernel(
                        prior, model, M, child=bridge) in ("K1", "K2", "K3")
                    continue
                if 4 * (2 * h * w + 8 * 3 * M) > limit:
                    with pytest.raises(NotImplementedError):
                        mh_sweep.sweep_kernel(prior, model, M, child=bridge)
                    continue
                assert mh_sweep.sweep_kernel(prior, model, M,
                                             child=bridge) == (
                    "K3g" if bridge else "K2g")
                lanes = mh_sweep.generic_lanes(model, M, bridge)
                cap = mh_sweep.generic_pixel_class(h * w)
                wide = cap is None
                if not wide:
                    L = mh_sweep.GENERIC_CLASS_LANES[cap, bridge]
                    extra = (4 if bridge else 2) * cap
                    wide = 4 * (2 * h * w + (32 // L) * (3 * M + extra)) \
                        > limit
                    assert h * w <= cap and (wide or lanes == L)
                assert wide == (mh_sweep.generic_class(h, w, M, bridge)
                                is None)
                if wide:
                    assert lanes == mh_sweep.GENERIC_LANES


@pytest.mark.parametrize("bridge", [False, True])
def test_every_mala_shape_takes_its_class_or_the_wide_route(bridge):
    """Where K4 is not built, every shape and slot count that fits the
    wide route's block (8 particles' catalogs beside the image) takes K4g,
    the rest raise: a tile of up to 4096 pixels takes its pixel class's
    kernel when one warp of particles' catalogs, caches and proposals (``3
    M + 2 CAP`` floats a particle, ``3 M + 4 CAP`` on the bridge) fits
    ``GENERIC_SMEM_LIMIT`` beside the image (``generic_class``), the
    wide route otherwise; the plain version sums in that kernel's lanes."""
    _, _, poisson = _targets()
    prior, _, _ = _targets()
    limit = mh_sweep.GENERIC_SMEM_LIMIT
    fixed = {(8, 8): 16, (16, 16): 16} if not bridge else {(16, 8): 16,
                                                           (16, 16): 32}
    classes = set()
    for h in (1, 3, 8, 12, 16, 24, 32, 40, 64, 72, 128):
        for w in (1, 8, 16, 20, 32, 48):
            model = poisson.with_shape(h, w)
            for M in (1, 9, 16, 17, 32, 33, 64, 128, 1000, 2400):
                if M <= fixed.get((h, w), 0):
                    assert mala_sweep.mala_kernel(prior, model, M,
                                                  child=bridge) == "K4"
                    continue
                if 4 * (2 * h * w + 8 * 3 * M) > limit:
                    with pytest.raises(NotImplementedError):
                        mala_sweep.mala_kernel(prior, model, M, child=bridge)
                    continue
                assert mala_sweep.mala_kernel(prior, model, M,
                                              child=bridge) == "K4g"
                cap = mh_sweep.generic_pixel_class(h * w)
                wide = cap is None
                if not wide:
                    L = mh_sweep.GENERIC_CLASS_LANES[cap, bridge]
                    extra = (4 if bridge else 2) * cap
                    wide = 4 * (2 * h * w + (32 // L) * (3 * M + extra)) \
                        > limit
                    assert h * w <= cap
                got = mh_sweep.generic_class(h, w, M, bridge)
                assert got == (None if wide else cap)
                assert mala_sweep.k4_lanes(model, bridge, M) == (
                    mh_sweep.GENERIC_LANES if wide else L)
                classes.add(got)
    # every class and the wide route are reached, and the wide route also
    # below 4096 pixels (a few pixels with thousands of slots)
    assert classes == {64, 128, 256, 512, 1024, 2048, 4096, None}
    assert mh_sweep.generic_class(8, 8, 2400, bridge) == (
        64 if bridge else None)


# (class, bridge target) of every K4g kernel, and the wide route (None),
# with a tile shape each takes
_K4G_CLASSES = [(cap, bridge, shape) for bridge in (False, True)
                for cap, shape in ((64, (4, 16)), (128, (16, 8)),
                                   (256, (32, 8)), (512, (32, 16)),
                                   (1024, (24, 24)), (2048, (40, 40)),
                                   (4096, (64, 64)), (None, (72, 64)))]


@pytest.mark.parametrize("cap,bridge,shape", _K4G_CLASSES)
def test_k4_lanes_follow_k4gs_pixel_classes(cap, bridge, shape):
    """``k4_lanes`` returns K4g's ``GENERIC_CLASS_LANES`` at each of its
    classes, 64 to 4096 pixels, and ``GENERIC_LANES`` on its wide route;
    the plain version's gradient sums in that order."""
    _, _, poisson = _targets()
    model = poisson.with_shape(*shape)
    M = 40 if bridge else 17
    assert mh_sweep.generic_class(*shape, M, bridge) == cap
    want = (mh_sweep.GENERIC_LANES if cap is None
            else mh_sweep.GENERIC_CLASS_LANES[cap, bridge])
    assert mala_sweep.k4_lanes(model, bridge, M) == want
    rng = np.random.default_rng(shape[0] * shape[1])
    x = torch.from_numpy(rng.normal(0.0, 100.0, (2, shape[0] * shape[1]))
                         .astype(np.float32))
    ones = torch.ones_like(x)
    prior = _targets()[0]
    # image 0 and rate 1 under Poisson noise: dll/drate = -1 at every pixel;
    # psi = x, the rest 1; on the bridge a child term outside its window
    kw = dict(child_rate=ones, window=torch.zeros_like(x)) if bridge else {}
    _, gf = mala_sweep.slot_gradient(
        prior, model, torch.zeros_like(x), torch.ones(2),
        torch.ones(2, dtype=torch.bool), torch.ones(2), (x, ones, ones, ones),
        ones, M, **kw)
    assert torch.equal(gf, mh_sweep.lane_sum(-ones * x, want)
                       * model.adu_per_nmgy
                       + mala_sweep.flux_log_prob_grad(prior, torch.ones(2)))


def test_kernels_raise_without_a_slot():
    prior, model, _ = _targets()
    for route in (mh_sweep.sweep_kernel, mala_sweep.mala_kernel):
        with pytest.raises(NotImplementedError, match="M=0"):
            route(prior, model.with_shape(32, 32), 0)


@pytest.mark.parametrize("HW,lanes", [(1024, 32), (576, 32), (100, 32),
                                      (512, 32), (64, 4)])
def test_lane_sum_pads_a_ragged_tile(HW, lanes):
    """``lane_sum`` adds pixel ``l + L k`` into lane ``l`` in turn, then the
    butterfly; a pixel count ``L`` does not divide takes zeros, which change
    no partial sum: the same bits as an explicit loop in that order."""
    rng = np.random.default_rng(HW)
    x = rng.normal(0.0, 100.0, (3, HW)).astype(np.float32)
    acc = np.zeros((3, lanes), np.float32)
    for p in range(HW):
        acc[:, p % lanes] = acc[:, p % lanes] + x[:, p] if p >= lanes \
            else x[:, p]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[:, :half] + acc[:, half:]
    got = mh_sweep.lane_sum(torch.from_numpy(x), lanes).numpy()
    np.testing.assert_array_equal(got, acc[:, 0])


# ----------------------------------------------------------------------
# One plain sweep against JAX's given the same uniforms
# ----------------------------------------------------------------------
# (shape, slots): the levels 2 and 3 of a 4x4 grid, a shape off it, the
# grid's 32x32 single tile, and an 8x8 tile past K1's slots (K2g's and K3g's
# pixel classes of 512, 1024 and 64 pixels)
_SHAPES = [((32, 16), 64), ((32, 32), 128), ((24, 24), 20), ((32, 32), 32),
           ((8, 8), 17)]
_N = 24  # particles a group; 2 groups
_STEPS = (0.02, 20.0)  # MALA's location and flux steps


@functools.cache
def _problem(shape, M, bridge):
    """JAX's and the port's contexts on an ``H x W`` tile with ``M`` slots:
    tests/test_aggregate.py's model (Poisson noise, Gaussian PSF, Normal
    fluxes) at temperature 0.4, 2 groups x ``_N`` particles with counts
    drawn over 0..M and random catalogs, an image drawn from the first
    particle's rate; on the bridge the child term of a split along the rows
    at H / 2 with random origin tags (``bridge`` True) or the side of each
    star's location (``bridge`` "location"), and a ghost rate."""
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w + M)
    jprior = JaxPrior(
        min_objects=0, max_objects=M, image_height=h, image_width=w, pad=1.0,
        counts=JaxUniformCounts(low=0, high=M),
        flux=JaxNormalFlux(mean=jnp.float32(2000.0),
                           stdev=jnp.float32(300.0)))
    jmodel = JaxImageModel(height=h, width=w, psf_radius=4, noise="poisson",
                           background=jnp.float32(100.0),
                           psf=JaxGaussianPSF(stdev=jnp.float32(1.0)))
    counts = rng.integers(0, M + 1, (1, 2, _N)).astype(np.int32)
    counts[..., :2] = (M // 2, 0)  # a half-full catalog, an empty one
    active = np.arange(M) < counts[..., None]
    locs = np.stack([rng.uniform(-0.9, h + 0.9, counts.shape + (M,)),
                     rng.uniform(-0.9, w + 0.9, counts.shape + (M,))], -1)
    locs = (locs * active[..., None]).astype(np.float32)
    fluxes = (np.clip(rng.normal(2000.0, 300.0, counts.shape + (M,)), 600.0,
                      4000.0) * active).astype(np.float32)
    kw = {}
    if bridge:
        tags = jnp.asarray((rng.uniform(size=counts.shape + (M,)) < 0.5)
                           .astype(np.float32))
        kw = dict(child_model=jmodel,
                  child_side_mask=jagg._side_mask_fn(0, h // 2, h, w),
                  child_slot_side=None if bridge == "location" else tags,
                  child_ghost_rate=jnp.asarray(
                      rng.uniform(0.0, 50.0, counts.shape + (h * w,))
                      .astype(np.float32)))
    temp = np.full((1, 2, 1), 0.4, np.float32)
    rate, _ = JaxCtx(prior=jprior, model=jmodel,
                     image=jnp.zeros((1, 2, 1, h, w)),
                     temperature=jnp.asarray(temp), **kw).init_rates(
        jnp.asarray(locs), jnp.asarray(fluxes))
    image = rng.poisson(np.asarray(rate)[:, :, 0].reshape(1, 2, h, w))
    image = image.astype(np.float32)[:, :, None]
    jctx = JaxCtx(prior=jprior, model=jmodel, image=jnp.asarray(image),
                  temperature=jnp.asarray(temp), **kw)
    pmodel = port_model(jmodel)
    pkw = {}
    if bridge:
        pkw = dict(child_model=pmodel,
                   child_side_mask=tagg.SideMask(0, h // 2, h, w),
                   child_slot_side=None if bridge == "location"
                   else t(kw["child_slot_side"]),
                   child_ghost_rate=t(kw["child_ghost_rate"]))
    pctx = TargetContext(port_prior(jprior), pmodel, t(image), t(temp),
                         **pkw)
    return jctx, pctx, jnp.asarray(counts), jnp.asarray(locs), \
        jnp.asarray(fluxes)


def _kernel(kind):
    mh = JaxMH(num_iters=1, locs_stdev=jnp.float32(0.25),
               fluxes_stdev=jnp.float32(60.0), fluxes_min=jnp.float32(500.0),
               fluxes_max=jnp.float32(5000.0))
    if kind == "mh":
        return mh
    return JaxMALA(num_iters=1, locs_step=jnp.float32(_STEPS[0]),
                   fluxes_step=jnp.float32(_STEPS[1]),
                   fluxes_min=mh.fluxes_min, fluxes_max=mh.fluxes_max,
                   backend="xla")


_FIELDS = ("locs", "fluxes", "rate", "parent_ll", "logprior", "child_rate",
           "child_ll")


@pytest.mark.parametrize("kind", ["mh", "mala"])
@pytest.mark.parametrize("bridge", [False, True, "location"])
@pytest.mark.parametrize("shape,M", _SHAPES)
def test_one_plain_sweep_matches_jax(shape, M, bridge, kind):
    """One plain sweep (the pixel sums in K2g's, K3g's and K4g's lane order
    by pixel class) given JAX's uniforms against JAX's sweep. Tolerance:
    rtol 1e-4 on every output,
    atol 1e-3 on the caches and log-likelihoods, 1e-4 on the rest (f32
    exp / log / ndtri rounding, the pixel-sum order and, under MALA, the
    gradient's sum order inside the drifted means). A particle may differ
    only by an accept flip with u on the boundary, within the f32 rounding
    of the two targets (margin under 2e-5 (|target| + |target'|) + 1e-4),
    or, under MALA, where a drifted mean leaves one of the six truncation
    masses below 1e-3 (``mala_sweep.smallest_box_mass``); at most 2 of the
    48 particles."""
    _, pctx, *_ = _problem(shape, M, bridge)
    assert mh_sweep.generic_lanes(pctx.model, M, bool(bridge)) == \
        mh_sweep.GENERIC_CLASS_LANES[mh_sweep.generic_pixel_class(
            shape[0] * shape[1]), bool(bridge)]
    _one_plain_sweep(shape, M, bridge, kind)


# (shape, slots) of K4g off the paths: the 128-pixel class (16x8 with 17
# slots: past K4's on the bridge) and the wide route (72x64, 4608 pixels)
_MALA_SHAPES = [((16, 8), 17), ((72, 64), 8)]


@pytest.mark.parametrize("bridge", [False, True, "location"])
@pytest.mark.parametrize("shape,M", _MALA_SHAPES)
def test_one_plain_mala_sweep_matches_jax_off_the_paths(shape, M, bridge):
    """``test_one_plain_sweep_matches_jax`` under MALA at K4g's 128-pixel
    class (its lanes, ``GENERIC_CLASS_LANES``) and on its wide route (32
    lanes), at that test's tolerance."""
    _, pctx, *_ = _problem(shape, M, bridge)
    cap = mh_sweep.generic_class(*shape, M, bool(bridge))
    assert mala_sweep.k4_lanes(pctx.model, bool(bridge), M) == (
        mh_sweep.GENERIC_LANES if cap is None
        else mh_sweep.GENERIC_CLASS_LANES[cap, bool(bridge)])
    assert (cap is None) == (shape == (72, 64))
    _one_plain_sweep(shape, M, bridge, "mala")


def _one_plain_sweep(shape, M, bridge, kind):
    """One plain sweep of ``kind`` against JAX's on ``_problem(shape, M,
    bridge)``, held as ``test_one_plain_sweep_matches_jax`` says."""
    jctx, pctx, counts, locs, fluxes = _problem(shape, M, bridge)
    kernel = _kernel(kind)
    state = jax.jit(jax_init_state)(jctx, counts, locs, fluxes)
    key = jax.random.key(11)
    jst, japplied = jax.jit(
        lambda k, st: kernel.sweep(k, jctx, counts, st))(key, state)
    u = [t(x) for x in jax.jit(_jax_sweep_uniforms, static_argnums=1)(
        key, counts.shape)]
    pkernel = port_kernel(kernel)
    pcounts = t(counts, torch.int32)
    pstate = KernelState(*(None if getattr(state, f) is None
                           else t(getattr(state, f)) for f in _FIELDS))
    kw = dict(prior=pctx.prior, model=pctx.model,
              proposal=pkernel.proposal(pctx.prior),
              image_flat=pctx.image_flat, temperature=pctx.temperature,
              counts=pcounts, locs=pstate.locs, fluxes=pstate.fluxes,
              rate=pstate.rate, pll=pstate.parent_ll, lp=pstate.logprior,
              child=pctx.child_term(pstate, pcounts.shape))
    step = (mh_sweep.sweep_with_uniforms if kind == "mh"
            else mala_sweep.mala_sweep_with_uniforms)
    out = step(*u, **kw)
    papplied = out[5]
    pst = KernelState(*out[:5], *out[6:])
    # every proposal's log alpha and targets: the proposals accepted
    # wherever they are finite (u_acc = 0)
    acc_all = step(*u[:3], torch.zeros_like(u[3]), **kw)
    if kind == "mh":
        lm = mh_sweep.truncated_normal_log_mass
        prop = kw["proposal"]
        lo, hi = pctx.prior.loc_low, pctx.prior.loc_high
        j = torch.minimum(torch.floor(u[0] * pcounts).long(),
                          pcounts.long() - 1).clamp(min=0)[..., None]
        take = lambda a: torch.gather(a, -1, j).squeeze(-1)  # noqa: E731
        new = KernelState(*acc_all[:5], *acc_all[6:])
        log_q = sum(
            sgn * lm(take(st.locs[..., d]), prop.locs_stdev, lo[d], hi[d])
            for sgn, st in ((1, pstate), (-1, new)) for d in (0, 1)) + (
            lm(take(pstate.fluxes), prop.fluxes_stdev, prop.flux_lo,
               prop.flux_hi)
            - lm(take(new.fluxes), prop.fluxes_stdev, prop.flux_lo,
                 prop.flux_hi))
        target_new = pctx.combine(new.logprior, new.parent_ll, new.child_ll)
        log_alpha = target_new - pctx.combine(
            pstate.logprior, pstate.parent_ll, pstate.child_ll) + log_q
        tail = np.zeros(counts.shape, dtype=bool)
    else:
        q = mala_sweep.mala_proposal(*u[:3], **kw)
        log_alpha = q.log_alpha
        target_new = pctx.combine(q.lp, q.pll, q.cll)
        tail = (mala_sweep.smallest_box_mass(q, kw["proposal"], pctx.prior)
                < 1e-3).numpy()
    close = np.ones(counts.shape, dtype=bool)
    for name in _FIELDS:
        got = getattr(pst, name)
        if got is None:
            continue
        atol = 1e-3 if "rate" in name or "ll" in name else 1e-4
        ok = np.isclose(got.numpy(), np.asarray(getattr(jst, name)),
                        rtol=1e-4, atol=atol)
        close &= ok.reshape(counts.shape + (-1,)).all(-1)
    flips = np.asarray(japplied) != papplied.numpy()
    margin = (torch.log(u[3]) - torch.clamp(log_alpha, max=0.0)).abs()
    targets = (pctx.combine(pstate.logprior, pstate.parent_ll,
                            pstate.child_ll).abs() + target_new.abs())
    boundary = (margin < 2e-5 * targets + 1e-4).numpy()
    off = ~close & ~(flips & boundary)
    assert tail[off].all(), (margin.numpy()[off & ~tail], flips[off & ~tail])
    assert (~close).sum() <= 2, ((~close).sum(), flips.sum())
    assert papplied.float().mean() > 0.05  # the sweep does move particles
    # the empty particle passes through
    assert not bool(papplied[0, 0, 1])


# ----------------------------------------------------------------------
# The 4x4 grid's configs and images
# ----------------------------------------------------------------------
def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_dnc_grid_derives_the_committed_configs(tmp_path):
    """The derived configs differ from the committed ones in the image
    size (and where they write and read) only; the single tile's
    ``tile_dim`` is the image, its N the tree's total per image and its
    ``max_objects`` scaled with the area; the MALA copy changes the kernel
    alone. Both packages load them."""
    import yaml

    from smcdet_tpu import config as jcfg
    from smcdet_tpu_torch.config import load_config
    from smcdet_tpu_torch.studies.dnc_grid import COMMITTED, derived_configs

    paths = derived_configs(tmp_path, 32, output_dir="out/dnc4",
                            mala_steps=(0.05, 20.0))
    sizes = {f"{p}.image_{d}": 32 for p in ("prior", "image_model")
             for d in ("height", "width")}
    for name, committed, want in (
            ("dnc", "config.yaml", dict(sizes, output_dir="out/dnc4")),
            ("singletile", "config_singletile.yaml", dict(
                sizes, output_dir="out/dnc4",
                data_path="out/dnc4/divideandconquer/tiles.npz",
                **{"sampler.tile_dim": 32, "sampler.num_catalogs": 8192,
                   "prior.max_objects": 32})),
            ("mala", "config.yaml", dict(
                sizes, output_dir="out/dnc4/mala",
                data_path="out/dnc4/divideandconquer/tiles.npz",
                **{"kernel.kind": "mala", "kernel.locs_stdev": 0.05,
                   "kernel.fluxes_stdev": 20.0}))):
        old = _flat(yaml.safe_load((COMMITTED / committed).read_text()))
        new = _flat(yaml.safe_load(paths[name].read_text()))
        assert set(new) == set(old)
        assert {k: v for k, v in new.items() if old[k] != v} == want, name
        cfg = load_config(paths[name])
        assert cfg.image_model.image_height == cfg.prior.image_width == 32
        assert jcfg.load_config(paths[name]).prior.image_height == 32
    with pytest.raises(ValueError, match="power-of-two"):
        derived_configs(tmp_path, 24)


def test_dnc4_tiles_are_the_jax_draw(tmp_path):
    """``tests/data/divideandconquer32_tiles.npz`` is the JAX runner's
    ``simulate_tiles`` of the derived config (seed 5, 100 images), array
    for array."""
    from pathlib import Path

    from smcdet_tpu import config as jcfg
    from smcdet_tpu.runner import simulate_tiles
    from smcdet_tpu_torch.studies.dnc_grid import derived_configs

    cfg = jcfg.load_config(derived_configs(tmp_path, 32)["dnc"])
    want = simulate_tiles(cfg)
    path = (Path(__file__).parent / "data"
            / "divideandconquer32_tiles.npz")
    with np.load(path) as got:
        assert sorted(got.files) == sorted(want)
        for k in got.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["images"].shape == (100, 32, 32)
