"""Kernels K1 to K5, K2g, K3g and K4g on the card (CUDA only; every test
skips without a card).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch with CUDA:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""

import pytest
import torch

from smcdet_tpu_torch import roofline
from smcdet_tpu_torch.inference.kernels import (
    SingleComponentMALA,
    SingleComponentMH,
    TargetContext,
    init_kernel_state,
)
from smcdet_tpu_torch.models.imaging import ImageModel, M71ImageModel
from smcdet_tpu_torch.models.priors import (
    M71Prior,
    NormalFlux,
    ParetoStarPrior,
    PointProcessPrior,
    UniformCounts,
)
from smcdet_tpu_torch.models.psf import GaussianPSF
from smcdet_tpu_torch.ops import mala_sweep, mh_sweep

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _m71_model(dev, tile=8, beta=3.0):
    return M71ImageModel(tile, tile, 179.0, 155.0,
                         (1.33, 4.82, 3.15, beta, 0.06, 0.002), 8, 0.0, 1.94,
                         device=dev)


def _normal_flux(dev, max_objects, tile):
    prior = PointProcessPrior(
        0, max_objects, tile, tile, pad=1.0,
        counts=UniformCounts(0, max_objects),
        flux=NormalFlux(2000.0, 300.0, device=dev), device=dev)
    return prior, SingleComponentMH(20, 0.25, 60.0, 500.0, 5000.0,
                                    device=dev)


def _target(dev, k2=False, T=2, N=1000, max_objects=6, name=None):
    """A tile target and its inputs. ``name`` picks a K2 target: "poisson"
    (8x8, Gaussian PSF, Normal flux; also ``k2=True``), "basic" and
    "cells" (the suites' targets), "wing" (general-beta SDSS wing),
    "gauss16" (Gaussian noise on 16x16); the default is K1's M71 target."""
    name = name or ("poisson" if k2 else "m71")
    if name == "poisson":
        prior, kernel = _normal_flux(dev, 4, 8)
        model = ImageModel(8, 8, 4, GaussianPSF(1.0, device=dev),
                           noise="poisson", background=100.0, device=dev)
    elif name == "basic":
        prior = ParetoStarPrior(0, 8, 8, 8, 345.84, 2.0, pad=2.0, device=dev)
        model = ImageModel(8, 8, 8, GaussianPSF(0.93, device=dev),
                           noise="poisson", background=200.0, device=dev)
        kernel = SingleComponentMH(20, 0.1, 100.0, 345.84, 1e6, device=dev)
    elif name == "cells":
        prior = M71Prior(0, 12, 0.02, 16, 16, 0.5, 100.0, 1e5, pad=1.0,
                         device=dev)
        model = ImageModel(16, 16, 6, GaussianPSF(1.4, device=dev),
                           noise="poisson", background=50.0, device=dev)
        kernel = SingleComponentMH(20, 0.3, 40.0, 50.0, 1e5, device=dev)
    elif name == "wing":
        prior = M71Prior(0, max_objects, 0.03, 8, 8, 0.214, 0.252,
                         1804.679, pad=1.0, device=dev)
        model = _m71_model(dev, beta=2.5)
        kernel = SingleComponentMH(20, 0.25, 5.0, 0.252, 1804.679,
                                   device=dev)
    elif name == "gauss16":
        prior, kernel = _normal_flux(dev, max_objects, 16)
        model = _m71_model(dev, tile=16)
    else:
        prior = M71Prior(0, max_objects, 0.03, 8, 8, 0.214, 0.252,
                         1804.679, pad=1.0, device=dev)
        model = _m71_model(dev)
        kernel = SingleComponentMH(20, 0.25, 5.0, 0.252, 1804.679,
                                   device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    strata, locs, fluxes = prior.sample_stratified(g, N, (T,))
    C = prior.num_counts
    counts = strata[None, :, None].expand(T, C, N).contiguous()
    images = model.sample(g, locs[:, -1, 0], fluxes[:, -1, 0]).abs()
    ctx = TargetContext(prior, model, images[:, None, None],
                        torch.full((T, 1, 1), 0.8, device=dev))
    return kernel, ctx, counts, locs, fluxes


def _zero_launch(run, kernel, prior, model, M, G=2, N=8):
    """``run`` (a sweep wrapper) on zero inputs of ``G`` x ``N`` particles
    with ``M`` slots on ``model``'s tile, 5 sweeps."""
    HW = model.height * model.width
    dev = kernel.fluxes_min.device
    z = torch.zeros
    return run(z(2, dtype=torch.int64, device=dev), kernel.proposal(prior),
               prior, model, z((G, HW), device=dev), z(G, device=dev),
               z((G, N), dtype=torch.int32, device=dev),
               z((G, N, M, 2), device=dev), z((G, N, M), device=dev),
               torch.ones((G, N, HW), device=dev), z((G, N), device=dev),
               z((G, N), device=dev), 5)


def test_cuda_tensor_never_reaches_plain_version(dev, monkeypatch):
    kernel, ctx, counts, locs, fluxes = _target(dev)

    def forbidden(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(mh_sweep, "mh_sweeps_reference", forbidden)
    monkeypatch.setattr(mh_sweep, "sweep_with_uniforms", forbidden)
    before = mh_sweep.mh_sweeps.launches
    st, acc = kernel.run(torch.Generator(device=dev).manual_seed(0), ctx,
                         counts, locs, fluxes)
    torch.cuda.synchronize()
    assert mh_sweep.mh_sweeps.launches == before + 1
    assert torch.isfinite(st.parent_ll).all() and float(acc.mean()) > 0.0

    # a K2 target launches K2, never the plain path
    kernel, ctx, counts, locs, fluxes = _target(dev, k2=True)
    k2_before = mh_sweep.mh_sweeps.k2_launches
    st, acc = kernel.run(torch.Generator(device=dev).manual_seed(0), ctx,
                         counts, locs, fluxes)
    torch.cuda.synchronize()
    assert mh_sweep.mh_sweeps.k2_launches == k2_before + 1
    assert mh_sweep.mh_sweeps.launches == before + 1
    assert torch.isfinite(st.parent_ll).all() and float(acc.mean()) > 0.0

    # a 32x32 tile launches K2g; a shape whose block needs more shared
    # memory than the card has raises instead of running the plain path
    big = ImageModel(32, 32, 6, GaussianPSF(1.4, device=dev),
                     noise="poisson", background=50.0, device=dev)
    ctx = TargetContext(ctx.prior, big, torch.ones((2, 1, 1, 32, 32),
                                                   device=dev),
                        ctx.temperature)
    k2g_before = mh_sweep.mh_sweeps.k2g_launches
    st, _ = kernel.run(torch.Generator(device=dev).manual_seed(0), ctx,
                       counts, locs, fluxes)
    torch.cuda.synchronize()
    assert mh_sweep.mh_sweeps.k2g_launches == k2g_before + 1
    assert torch.isfinite(st.parent_ll).all()
    huge = ImageModel(128, 128, 6, GaussianPSF(1.4, device=dev),
                      noise="poisson", background=50.0, device=dev)
    with pytest.raises(NotImplementedError, match="232448-byte limit"):
        _zero_launch(mh_sweep.mh_sweeps, kernel, ctx.prior, huge, 1200)
    assert mh_sweep.mh_sweeps.k2_launches == k2_before + 1
    assert mh_sweep.mh_sweeps.k2g_launches == k2g_before + 1


@pytest.mark.parametrize("max_objects", [1, 6, 8, 16])
def test_cuda_kernel_matches_plain_version(dev, max_objects):
    """Same key, 20 sweeps: the kernel and the plain version draw the same
    Philox stream, so they agree particle by particle (rtol 1e-4: expf /
    logf / normcdff rounding and the pixel-sum order) except accept flips
    where u sits on the acceptance boundary."""
    kernel, ctx, counts, locs, fluxes = _target(dev, max_objects=max_objects)
    state = init_kernel_state(ctx, counts, locs, fluxes)
    outs = {}
    for backend in ("auto", "torch"):
        kernel.backend = backend
        outs[backend], _ = kernel.run_from_state(
            torch.Generator(device=dev).manual_seed(3), ctx, counts, state)
    torch.cuda.synchronize()
    close = torch.ones(counts.shape, dtype=torch.bool, device=dev)
    for a, b in zip(outs["auto"][:5], outs["torch"][:5]):  # tile fields
        ok = torch.isclose(a, b, rtol=1e-4, atol=1e-4)
        close &= ok.reshape(counts.shape + (-1,)).all(-1)
    assert float(close.float().mean()) >= 0.99


def test_cuda_wrapper_checks_inputs(dev):
    kernel, ctx, counts, locs, fluxes = _target(dev, N=64)
    state = init_kernel_state(ctx, counts, locs, fluxes)
    G, N = counts.shape[0] * counts.shape[1], counts.shape[2]
    key = torch.zeros(2, dtype=torch.int64, device=dev)
    args = [key, kernel.proposal(ctx.prior), ctx.prior, ctx.model,
            ctx.image.expand(2, counts.shape[1], 1, 8, 8).reshape(G, 64)
            .contiguous(), torch.full((G,), 0.8, device=dev),
            counts.reshape(G, N).int(), state.locs.reshape(G, N, 6, 2),
            state.fluxes.reshape(G, N, 6), state.rate.reshape(G, N, 64),
            state.parent_ll.reshape(G, N), state.logprior.reshape(G, N), 3]
    mh_sweep.mh_sweeps(*args)
    bad = list(args)
    bad[6] = bad[6].long()
    with pytest.raises(TypeError, match="counts"):
        mh_sweep.mh_sweeps(*bad)
    bad = list(args)
    bad[9] = state.rate.reshape(G, N, 64).transpose(0, 1)
    with pytest.raises(ValueError, match="rate"):
        mh_sweep.mh_sweeps(*bad)
    bad = list(args)
    bad[4] = bad[4].cpu()
    with pytest.raises(ValueError, match="image"):
        mh_sweep.mh_sweeps(*bad)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name,N", [("poisson", 1000), ("basic", 512),
                                    ("cells", 4096), ("wing", 1000),
                                    ("gauss16", 1000)])
def test_k2_matches_plain_version(dev, name, N):
    """K2 on each of its branches: zero-count passthrough bit-exact; same
    key, 20 sweeps, >= 99% of particles agree with the plain version to
    rtol 1e-4 (the rest are accept flips on the boundary)."""
    kernel, ctx, counts, locs, fluxes = _target(dev, name=name, N=N)
    assert mh_sweep.sweep_kernel(ctx.prior, ctx.model,
                                 fluxes.shape[-1]) == "K2"
    zc = torch.zeros_like(counts)
    zstate = init_kernel_state(ctx, zc, locs, fluxes)
    out, acc = kernel.run_from_state(
        torch.Generator(device=dev).manual_seed(1), ctx, zc, zstate)
    torch.cuda.synchronize()
    for a, b in zip(out[:5], zstate[:5]):  # the tile target's fields
        assert torch.equal(a, b)
    assert float(acc.max()) == 0.0

    state = init_kernel_state(ctx, counts, locs, fluxes)
    outs = {}
    for backend in ("auto", "torch"):
        kernel.backend = backend
        outs[backend], _ = kernel.run_from_state(
            torch.Generator(device=dev).manual_seed(3), ctx, counts, state)
    torch.cuda.synchronize()
    close = torch.ones(counts.shape, dtype=torch.bool, device=dev)
    for a, b in zip(outs["auto"][:5], outs["torch"][:5]):  # tile fields
        ok = torch.isclose(a, b, rtol=1e-4, atol=1e-4)
        close &= ok.reshape(counts.shape + (-1,)).all(-1)
    assert float(close.float().mean()) >= 0.99


def _mixed_counts_target(dev, tile, M, N, num_iters, name="poisson"):
    """A tile target with counts that vary per particle: 2 tiles x 3 groups
    x N, every third particle empty (so every warp and every lane group
    mixes empty and occupied particles next to each other) and particles
    64..127 of each group empty (whole warps that skip the loop). ``name``:
    "poisson" (K2's: Poisson noise, Gaussian PSF, Normal flux, ``tile`` x
    ``tile``, M slots) or "m71" (K1's: Gaussian noise, SDSS beta = 3,
    truncated Pareto flux, 8x8)."""
    if name == "m71":
        prior = M71Prior(0, M, 0.03, 8, 8, 0.214, 0.252, 1804.679, pad=1.0,
                         device=dev)
        model = _m71_model(dev)
        kernel = SingleComponentMH(num_iters, 0.25, 5.0, 0.252, 1804.679,
                                   device=dev)
    else:
        prior, _ = _normal_flux(dev, M, tile)
        kernel = SingleComponentMH(num_iters, 0.25, 60.0, 500.0, 5000.0,
                                   device=dev)
        model = ImageModel(tile, tile, 4, GaussianPSF(1.0, device=dev),
                           noise="poisson", background=100.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    counts = torch.randint(1, M + 1, (2, 3, N), generator=g, device=dev,
                           dtype=torch.int32)
    counts[..., ::3] = 0
    counts[..., 64:128] = 0
    locs, fluxes = prior.sample_marks(g, counts, (2, 3, N))
    images = model.sample(g, locs[:, 0, 1], fluxes[:, 0, 1]).abs()
    ctx = TargetContext(prior, model, images[:, None, None],
                        torch.full((2, 1, 1), 0.8, device=dev))
    return kernel, ctx, counts, init_kernel_state(ctx, counts, locs, fluxes)


@pytest.mark.parametrize("tile,M,N,num_iters", [
    (8, 8, 1001, 20),    # N not a multiple of the particles per block
    (8, 16, 999, 20),    # M = 16 on 8x8
    (16, 16, 999, 20),   # M = 16 on 16x16
    (8, 8, 512, 37),     # sweeps that end inside a Philox draw-ahead batch
    (16, 12, 1000, 37),
])
def test_k2_lane_groups_match_plain_version(dev, tile, M, N, num_iters):
    """K2's lane groups on what their layout risks: empty and occupied
    particles mixed in every warp, whole warps of empty particles, N not a
    multiple of the particles per block, M = 16, and a sweep count that is
    not a multiple of the sweeps one Philox draw-ahead covers. One K2
    launch; the empty particles pass through bit-exactly with acceptance 0;
    on the same key >= 99% of the occupied ones agree with the plain version
    to rtol 1e-4 (the rest are accept flips on the boundary)."""
    kernel, ctx, counts, state = _mixed_counts_target(dev, tile, M, N,
                                                      num_iters)
    assert mh_sweep.sweep_kernel(ctx.prior, ctx.model, M) == "K2"
    args, _ = _launch_args(kernel, ctx, counts, state, num_iters)
    _lane_groups_agree(mh_sweep.mh_sweeps, mh_sweep.mh_sweeps_reference,
                       lambda: mh_sweep.mh_sweeps.k2_launches, args)


def _launch_args(kernel, ctx, counts, state, num_iters):
    """The flattened arguments of one sweep-kernel launch on the ``[T, C,
    N]`` batch of ``state`` (what ``run_from_state`` passes), key (777,
    4242), and the bridge's flattened child term (None on a tile)."""
    T, C, N = counts.shape
    model = ctx.model
    G, HW, M = T * C, model.height * model.width, state.fluxes.shape[-1]
    args = [torch.tensor([777, 4242], dtype=torch.int64,
                         device=counts.device),
            kernel.proposal(ctx.prior), ctx.prior, model,
            ctx.image.expand(T, C, 1, model.height, model.width)
            .reshape(G, HW).contiguous(),
            ctx.temperature.expand(T, C, 1).reshape(G).contiguous(),
            counts.reshape(G, N).contiguous(),
            state.locs.reshape(G, N, M, 2).contiguous(),
            state.fluxes.reshape(G, N, M).contiguous(),
            state.rate.reshape(G, N, HW).contiguous(),
            state.parent_ll.reshape(G, N).contiguous(),
            state.logprior.reshape(G, N).contiguous(), num_iters]
    child = ctx.child_term(state, counts.shape)
    if child is not None:
        tags = child.slot_side
        child = child._replace(
            rate=child.rate.reshape(G, N, HW).contiguous(),
            ll=child.ll.reshape(G, N).contiguous(),
            slot_side=None if tags is None
            else tags.expand(T, C, N, M).reshape(G, N, M).contiguous())
    return args, child


def _lane_groups_agree(run, plain, launches, args, child=None):
    """One launch of a kernel's wrapper ``run`` (its counter ``launches()``
    goes up by one) against its plain version ``plain`` on the same key:
    the empty particles pass through bit-exactly with acceptance 0; >= 99%
    of the occupied ones agree to rtol 1e-4 (the rest are accept flips on
    the boundary and, under MALA, tail proposals and truncation masses in
    Phi's f32 tail: chip_smoke.py classifies them)."""
    before = launches()
    got = run(*args, child=child)
    want = plain(*args, child=child)
    torch.cuda.synchronize()
    assert launches() == before + 1
    empty = args[6] == 0
    assert bool(empty.any()) and not bool(empty.all())
    ins = list(args[7:12]) + ([] if child is None else [child.rate, child.ll])
    for a, b in zip(list(got[:5]) + list(got[6:]), ins):
        assert torch.equal(a[empty], b[empty])
    assert float(got[5][empty].abs().max()) == 0.0
    assert float(got[5][~empty].mean()) > 0.01
    close = torch.ones(empty.shape, dtype=torch.bool, device=empty.device)
    for a, b in zip(list(got[:5]) + list(got[6:]),
                    list(want[:5]) + list(want[6:])):
        ok = torch.isclose(a, b, rtol=1e-4, atol=1e-4)
        close &= ok.reshape(empty.shape + (-1,)).all(-1)
    assert float(close[~empty].float().mean()) >= 0.99


@pytest.mark.parametrize("M,N,num_iters", [
    (6, 1001, 20),     # the quick cell's M; N not a multiple of a block's
    (16, 999, 20),     # M = 16, K1's most
    (8, 512, 37),      # sweeps that end inside a Philox draw-ahead batch
    (16, 1000, 37),
])
def test_k1_lane_groups_match_plain_version(dev, M, N, num_iters):
    """K1 (K2's lane-group kernel on the M71 8x8 target) on what its layout
    risks: empty and occupied particles mixed in every warp and lane group,
    whole warps of empty particles, ragged N, M up to 16, and a sweep count
    that is not a multiple of the sweeps one Philox draw-ahead covers."""
    kernel, ctx, counts, state = _mixed_counts_target(dev, 8, M, N,
                                                      num_iters, "m71")
    assert mh_sweep.sweep_kernel(ctx.prior, ctx.model, M) == "K1"
    args, _ = _launch_args(kernel, ctx, counts, state, num_iters)
    _lane_groups_agree(mh_sweep.mh_sweeps, mh_sweep.mh_sweeps_reference,
                       lambda: mh_sweep.mh_sweeps.launches, args)


def _kind_model(dev, noise, psf):
    """An 8x8 tile model of one noise kind ("gaussian", "poisson") and one
    PSF kind ("gaussian", "sdss3": SDSS with the beta = 3 wing, "sdss": the
    general wing at beta = 2.5), the three PSF kinds of the sweep kernels'
    instantiations."""
    if psf == "gaussian":
        shape, radius = GaussianPSF(1.0, device=dev), 4
    else:
        shape = _m71_model(dev, beta=3.0 if psf == "sdss3" else 2.5).psf
        radius = 8
    return ImageModel(8, 8, radius, shape, noise=noise, background=179.0,
                      adu_per_nmgy=155.0 if noise == "gaussian" else 1.0,
                      noise_multiplicative=1.94, device=dev)


def _bridge_target(dev, name="m71", shape=(16, 8), mode="tag", N=512,
                   M=None, mixed=False, kind=None):
    """An aggregation-bridge target on a joined tile: random catalogs with
    counts varying per particle, origin tags (``mode`` "tag") or the side
    of each star's location ("location"), a ghost rate, temperature 0.4.
    ``name``: "m71" (Gaussian noise, SDSS beta = 3, truncated Pareto) or
    "poisson" (Poisson noise, Gaussian PSF, Normal flux); ``kind`` (noise,
    PSF) replaces the model by ``_kind_model``'s. ``mixed`` empties every
    third particle and particles 64..127 of each group, as
    ``_mixed_counts_target``."""
    from smcdet_tpu_torch.inference.aggregate import SideMask, expand_prior

    h, w = shape
    M = M or (16 if shape == (16, 8) else 32)
    if name == "m71":
        prior = M71Prior(0, 8, 0.012, 8, 8, 0.214, 7.0, 1804.679, pad=1.0,
                         device=dev)
        model = M71ImageModel(8, 8, 865.0, 856.0,
                              (1.51, 4.85, 1.32, 3.0, 0.09, 0.002), 8,
                              0.001, 1.94, device=dev)
        kernel = SingleComponentMH(20, 0.25, 5.0, 7.0, 1804.679, device=dev)
    else:
        prior, kernel = _normal_flux(dev, 8, 8)
        model = ImageModel(8, 8, 4, GaussianPSF(1.0, device=dev),
                           noise="poisson", background=100.0, device=dev)
    if kind is not None:
        model = _kind_model(dev, *kind)
    prior = expand_prior(prior, h, w, M)
    model = model.with_shape(h, w)
    g = torch.Generator(device=dev).manual_seed(0)
    G = 2
    counts = torch.randint(0, M + 1, (1, G, N), generator=g, device=dev,
                           dtype=torch.int32)
    if mixed:
        counts[..., ::3] = 0
        counts[..., 64:128] = 0
    locs, fluxes = prior.sample_marks(g, counts, (1, G, N))
    tags = (torch.rand((1, G, N, M), generator=g, device=dev) < 0.5).float()
    ghost = 50.0 * torch.rand((1, G, N, h * w), generator=g, device=dev)
    images = model.sample(g, locs[0, :, 0], fluxes[0, :, 0]).abs()[None]
    ctx = TargetContext(prior, model, images[:, :, None],
                        torch.full((1, G, 1), 0.4, device=dev),
                        child_model=model,
                        child_side_mask=SideMask(0, h // 2, h, w),
                        child_slot_side=tags if mode == "tag" else None,
                        child_ghost_rate=ghost)
    return kernel, ctx, counts, locs, fluxes


@pytest.mark.parametrize("name,shape,mode", [
    ("m71", (16, 8), "tag"), ("m71", (16, 16), "tag"),
    ("m71", (16, 8), "location"), ("poisson", (16, 16), "tag")])
def test_k3_matches_plain_version(dev, name, shape, mode):
    """K3: zero-count passthrough bit-exact; same key, 20 sweeps, >= 99% of
    particles agree with the plain version in both caches to rtol 1e-4
    (the rest are accept flips on the boundary); a K3 launch per bridge
    mutation, never a K1 or K2 one."""
    kernel, ctx, counts, locs, fluxes = _bridge_target(dev, name, shape,
                                                       mode)
    M = fluxes.shape[-1]
    assert mh_sweep.sweep_kernel(ctx.prior, ctx.model, M, child=True) == "K3"
    zc = torch.zeros_like(counts)
    zstate = init_kernel_state(ctx, zc, locs, fluxes)
    before = (mh_sweep.mh_sweeps.launches, mh_sweep.mh_sweeps.k2_launches,
              mh_sweep.mh_sweeps.k3_launches)
    out, acc = kernel.run_from_state(
        torch.Generator(device=dev).manual_seed(1), ctx, zc, zstate)
    torch.cuda.synchronize()
    for a, b in zip(out, zstate):
        assert torch.equal(a, b)
    assert float(acc.max()) == 0.0
    assert (mh_sweep.mh_sweeps.launches, mh_sweep.mh_sweeps.k2_launches,
            mh_sweep.mh_sweeps.k3_launches) == (before[0], before[1],
                                                before[2] + 1)

    state = init_kernel_state(ctx, counts, locs, fluxes)
    outs = {}
    for backend in ("auto", "torch"):
        kernel.backend = backend
        outs[backend], acc = kernel.run_from_state(
            torch.Generator(device=dev).manual_seed(3), ctx, counts, state)
    torch.cuda.synchronize()
    assert float(acc.mean()) > 0.01
    close = torch.ones(counts.shape, dtype=torch.bool, device=dev)
    for a, b in zip(outs["auto"], outs["torch"]):
        ok = torch.isclose(a, b, rtol=1e-4, atol=1e-4)
        close &= ok.reshape(counts.shape + (-1,)).all(-1)
    assert float(close.float().mean()) >= 0.99


@pytest.mark.parametrize("shape,mode,M,N,num_iters,kind", [
    ((16, 8), "tag", 16, 999, 37, ("gaussian", "sdss3")),  # dnc's kind
    ((16, 8), "location", 16, 1001, 20, ("gaussian", "sdss3")),
    ((16, 16), "tag", 32, 1001, 37, ("gaussian", "sdss3")),  # M = 32
    ((16, 16), "location", 32, 999, 37, ("gaussian", "sdss3")),
    ((16, 8), "tag", 16, 999, 37, ("gaussian", "gaussian")),
    ((16, 16), "location", 32, 1001, 37, ("gaussian", "sdss")),
    ((16, 8), "location", 16, 1001, 37, ("poisson", "gaussian")),
    ((16, 16), "tag", 32, 999, 37, ("poisson", "sdss3")),
    ((16, 8), "tag", 16, 1000, 37, ("poisson", "sdss")),
])
def test_k3_lane_groups_match_plain_version(dev, shape, mode, M, N,
                                            num_iters, kind):
    """K3's lane groups on what their layout risks, on both joined tiles in
    tag and location mode and on each noise and PSF kind (one
    instantiation each): empty and occupied particles mixed in every warp
    and lane group, whole warps of empty particles, ragged N, M = 16 on
    16x8 and 32 on 16x16, and 37 sweeps, which end inside a Philox
    draw-ahead batch. One K3 launch; the empty particles pass through
    bit-exactly; >= 99% of the occupied ones agree with the plain version
    in both caches."""
    kernel, ctx, counts, locs, fluxes = _bridge_target(
        dev, "m71", shape, mode, N, M, mixed=True, kind=kind)
    assert mh_sweep.sweep_kernel(ctx.prior, ctx.model, M, child=True) == "K3"
    state = init_kernel_state(ctx, counts, locs, fluxes)
    args, child = _launch_args(kernel, ctx, counts, state, num_iters)
    _lane_groups_agree(mh_sweep.mh_sweeps, mh_sweep.mh_sweeps_reference,
                       lambda: mh_sweep.mh_sweeps.k3_launches, args, child)


def test_k3_raises_for_an_unbuilt_joined_tile(dev):
    """A bridge on a joined tile whose block needs more shared memory than
    the card has (128x64 with 2000 slots) raises on the card instead of
    running the plain version; a joined tile K3 is not built for (the 32x16
    tile of a 4x4 grid) goes to K3g."""
    kernel, ctx, *_ = _bridge_target(dev, shape=(16, 8))
    assert mh_sweep.sweep_kernel(ctx.prior, ctx.model.with_shape(32, 16), 64,
                                 child=True) == "K3g"
    wide = ctx.model.with_shape(128, 64)
    G, N, M, HW = 2, 64, 2000, 128 * 64
    z = torch.zeros
    child = mh_sweep.ChildTerm(torch.ones((G, N, HW), device=dev),
                               z((G, N), device=dev),
                               z((G, N, M), device=dev), 0, 64)
    before = mh_sweep.mh_sweeps.k3g_launches
    with pytest.raises(NotImplementedError, match="128x64"):
        mh_sweep.mh_sweeps(
            z(2, dtype=torch.int64, device=dev), kernel.proposal(ctx.prior),
            ctx.prior, wide, z((G, HW), device=dev), z(G, device=dev),
            z((G, N), dtype=torch.int32, device=dev),
            z((G, N, M, 2), device=dev), z((G, N, M), device=dev),
            torch.ones((G, N, HW), device=dev), z((G, N), device=dev),
            z((G, N), device=dev), 5, child=child)
    assert mh_sweep.mh_sweeps.k3g_launches == before


def _generic_tile_target(dev, shape, M, N, num_iters, name="m71"):
    """A tile target at any shape for K2g and K4g, with counts that vary
    per particle as ``_mixed_counts_target``'s (every third particle and
    particles 64..127 of each group empty): ``name`` "m71" (the
    divideandconquer suite's model and prior on an ``H x W`` image: Gaussian
    noise, SDSS beta = 3, truncated Pareto) or "poisson" (Poisson noise,
    Gaussian PSF, Normal flux)."""
    h, w = shape
    if name == "m71":
        prior = M71Prior(0, M, 0.012, h, w, 0.214, 7.0, 1804.679, pad=1.0,
                         device=dev)
        model = M71ImageModel(h, w, 865.0, 856.0,
                              (1.51, 4.85, 1.32, 3.0, 0.09, 0.002), 8,
                              0.001, 1.94, device=dev)
        kernel = SingleComponentMH(num_iters, 0.25, 5.0, 7.0, 1804.679,
                                   device=dev)
    else:
        prior = PointProcessPrior(
            0, M, h, w, pad=1.0, counts=UniformCounts(0, M),
            flux=NormalFlux(2000.0, 300.0, device=dev), device=dev)
        kernel = SingleComponentMH(num_iters, 0.25, 60.0, 500.0, 5000.0,
                                   device=dev)
        model = ImageModel(h, w, 4, GaussianPSF(1.0, device=dev),
                           noise="poisson", background=100.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    counts = torch.randint(1, M + 1, (2, 3, N), generator=g, device=dev,
                           dtype=torch.int32)
    counts[..., ::3] = 0
    counts[..., 64:128] = 0
    locs, fluxes = prior.sample_marks(g, counts, (2, 3, N))
    images = model.sample(g, locs[:, 0, 1], fluxes[:, 0, 1]).abs()
    ctx = TargetContext(prior, model, images[:, None, None],
                        torch.full((2, 1, 1), 0.8, device=dev))
    return kernel, ctx, counts, init_kernel_state(ctx, counts, locs, fluxes)


# (kernel, name, shape, bridge mode, M, N, sweeps, (noise, PSF) kind): the
# launch shapes of a 4x4 grid of 8x8 tiles and its 32x32 single tile, a
# shape off that path (24x24 with 20 slots), slot counts past K1's, K3's and
# K4's, ragged N, sweeps that end inside a Philox draw-ahead batch, and each
# noise and PSF kind on the bridge
_GENERIC_CASES = [
    ("K2g", "m71", (32, 32), None, 32, 999, 37, None),
    ("K2g", "m71", (24, 24), None, 20, 257, 20, None),
    ("K2g", "poisson", (8, 8), None, 17, 1001, 20, None),
    ("K3g", "m71", (32, 16), "tag", 64, 1001, 37, ("gaussian", "sdss3")),
    ("K3g", "m71", (32, 32), "tag", 128, 999, 20, ("gaussian", "sdss3")),
    ("K3g", "m71", (32, 16), "location", 64, 999, 37,
     ("poisson", "gaussian")),
    ("K3g", "m71", (32, 32), "tag", 128, 513, 20, ("poisson", "sdss")),
    ("K3g", "m71", (16, 16), "tag", 33, 1001, 20, None),
    # every other pixel class of K2g and K3g (64 to 512 pixels; 2048 in
    # shared memory), a ragged tile inside its class (12x20 in 256), and the
    # wide route past 4096 pixels, on both targets
    ("K2g", "poisson", (16, 8), None, 16, 1001, 37, None),
    ("K2g", "m71", (16, 16), None, 17, 999, 20, None),
    ("K2g", "poisson", (32, 16), None, 40, 513, 20, None),
    ("K2g", "m71", (12, 20), None, 10, 257, 37, None),
    ("K2g", "poisson", (40, 40), None, 12, 257, 20, None),
    ("K3g", "m71", (8, 8), "tag", 9, 1001, 37, ("poisson", "gaussian")),
    ("K3g", "m71", (16, 8), "location", 17, 999, 20, None),
    ("K3g", "m71", (48, 32), "tag", 40, 257, 20, None),
    ("K2g", "poisson", (72, 64), None, 12, 129, 20, None),
    ("K3g", "m71", (72, 64), "location", 20, 129, 20, None),
    ("K4g", "m71", (32, 32), None, 32, 999, 37, None),
    ("K4g", "poisson", (24, 24), None, 20, 257, 20, None),
    ("K4g", "m71", (32, 16), "tag", 64, 1001, 37, None),
    ("K4g", "m71", (32, 32), "tag", 128, 999, 20, None),
    ("K4g", "m71", (32, 16), "location", 64, 999, 20, None),
    # K4g's classes no path reaches (64, 128, 256 and 2048 pixels, on both
    # targets) and its wide route past 4096 pixels
    ("K4g", "poisson", (8, 8), None, 17, 1001, 37, None),
    ("K4g", "poisson", (16, 8), None, 16, 1001, 37, None),
    ("K4g", "m71", (16, 8), "location", 17, 999, 20, None),
    ("K4g", "m71", (16, 16), "tag", 33, 1001, 20, None),
    ("K4g", "m71", (8, 8), "tag", 9, 1001, 37, None),
    ("K4g", "poisson", (40, 40), None, 12, 257, 20, None),
    ("K4g", "m71", (48, 32), "tag", 40, 257, 20, None),
    ("K4g", "poisson", (72, 64), None, 12, 129, 20, None),
    ("K4g", "m71", (72, 64), "location", 20, 129, 20, None),
]


@pytest.mark.parametrize("kid,name,shape,mode,M,N,num_iters,kind",
                         _GENERIC_CASES)
def test_generic_kernels_match_plain_version(dev, kid, name, shape, mode, M,
                                             N, num_iters, kind):
    """K2g, K3g and K4g against their plain versions on one launch each:
    the empty particles (every third, whole warps of them) pass through
    bit-exactly with acceptance 0, the launch counter goes up by one, and
    on the same key >= 99% of the occupied particles agree to rtol 1e-4 in
    every output (the rest are accept flips on the boundary and, under
    MALA, tail proposals and masses in Phi's f32 tail)."""
    bridge = mode is not None
    if bridge:
        mh, ctx, counts, locs, fluxes = _bridge_target(
            dev, name, shape, mode, N, M, mixed=True, kind=kind)
        state = init_kernel_state(ctx, counts, locs, fluxes)
    else:
        mh, ctx, counts, state = _generic_tile_target(dev, shape, M, N,
                                                      num_iters, name)
    if kid == "K4g":
        kernel = _mala(mh, f"{name} bridge" if bridge else name)
        assert mala_sweep.mala_kernel(ctx.prior, ctx.model, M,
                                      child=bridge) == "K4g"
        run, plain = mala_sweep.mala_sweeps, mala_sweep.mala_sweeps_reference
        counter = "k4g_bridge_launches" if bridge else "k4g_launches"
        launches = lambda: getattr(mala_sweep.mala_sweeps, counter)  # noqa
    else:
        kernel = mh
        assert mh_sweep.sweep_kernel(ctx.prior, ctx.model, M,
                                     child=bridge) == kid
        run, plain = mh_sweep.mh_sweeps, mh_sweep.mh_sweeps_reference
        counter = f"{kid.lower()}_launches"
        launches = lambda: getattr(mh_sweep.mh_sweeps, counter)  # noqa
    args, child = _launch_args(kernel, ctx, counts, state, num_iters)
    _lane_groups_agree(run, plain, launches, args, child)


# MALA's steps on each target: those of tests/test_torch_mala.py's matching
# targets; the M71 bridge takes divideandconquer's (chip_smoke.py)
_MALA_STEPS = {"m71": (0.05, 0.2), "poisson": (0.05, 20.0),
               "basic": (0.05, 20.0), "cells": (0.05, 5.0),
               "wing": (0.05, 0.2), "gauss16": (0.02, 20.0),
               "m71 bridge": (0.25, 5.0), "poisson bridge": (0.02, 20.0)}


def _mala(kernel, name):
    ls, fs = _MALA_STEPS[name]
    return SingleComponentMALA(kernel.num_iters, ls, fs, kernel.fluxes_min,
                               kernel.fluxes_max,
                               device=kernel.fluxes_min.device)


def _k4_agreement(kernel, ctx, counts, state, dev):
    """Same key, 20 sweeps of K4 and of its plain version: the share of
    particles on which every output agrees to rtol 1e-4."""
    outs = {}
    for backend in ("auto", "torch"):
        kernel.backend = backend
        outs[backend], acc = kernel.run_from_state(
            torch.Generator(device=dev).manual_seed(3), ctx, counts, state)
    kernel.backend = "auto"
    torch.cuda.synchronize()
    assert 0.01 < float(acc.mean()) < 1.0
    close = torch.ones(counts.shape, dtype=torch.bool, device=dev)
    for a, b in zip(outs["auto"], outs["torch"]):
        if a is None:
            continue
        ok = torch.isclose(a, b, rtol=1e-4, atol=1e-4)
        close &= ok.reshape(counts.shape + (-1,)).all(-1)
    return float(close.float().mean())


def _k4_passthrough(kernel, ctx, counts, locs, fluxes, dev, bridge):
    """Zero counts: K4 launches once (tile or bridge counter) and passes
    the state through bit-exactly."""
    zc = torch.zeros_like(counts)
    zstate = init_kernel_state(ctx, zc, locs, fluxes)
    before = (mala_sweep.mala_sweeps.launches,
              mala_sweep.mala_sweeps.bridge_launches,
              mh_sweep.mh_sweeps.launches + mh_sweep.mh_sweeps.k2_launches
              + mh_sweep.mh_sweeps.k3_launches)
    out, acc = kernel.run_from_state(
        torch.Generator(device=dev).manual_seed(1), ctx, zc, zstate)
    torch.cuda.synchronize()
    for a, b in zip(out, zstate):
        assert (a is None and b is None) or torch.equal(a, b)
    assert float(acc.max()) == 0.0
    after = (mala_sweep.mala_sweeps.launches,
             mala_sweep.mala_sweeps.bridge_launches,
             mh_sweep.mh_sweeps.launches + mh_sweep.mh_sweeps.k2_launches
             + mh_sweep.mh_sweeps.k3_launches)
    assert after == (before[0] + (not bridge), before[1] + bridge,
                     before[2])


@pytest.mark.parametrize("name,N", [("m71", 1000), ("basic", 512),
                                    ("poisson", 1000), ("cells", 1024),
                                    ("wing", 1000), ("gauss16", 1000)])
def test_k4_matches_plain_version(dev, name, N):
    """K4 on the tile target, every noise, PSF and flux branch on 8x8 and
    16x16: zero-count passthrough bit-exact with one K4 launch and no MH
    launch; same key, 20 sweeps, >= 99% of particles agree with the plain
    version to rtol 1e-4 (the rest are accept flips on the boundary, tail
    proposals and truncation masses in Phi's f32 tail: chip_smoke.py
    classifies them)."""
    mh, ctx, counts, locs, fluxes = _target(dev, name=name, N=N)
    kernel = _mala(mh, name)
    assert mala_sweep.mala_kernel(ctx.prior, ctx.model,
                                  fluxes.shape[-1]) == "K4"
    _k4_passthrough(kernel, ctx, counts, locs, fluxes, dev, bridge=False)
    state = init_kernel_state(ctx, counts, locs, fluxes)
    assert _k4_agreement(kernel, ctx, counts, state, dev) >= 0.99


@pytest.mark.parametrize("name,shape,mode", [
    ("m71", (16, 8), "tag"), ("m71", (16, 16), "tag"),
    ("m71", (16, 8), "location"), ("poisson", (16, 16), "tag")])
def test_k4_bridge_matches_plain_version(dev, name, shape, mode):
    """K4 on the bridge: passthrough bit-exact with one K4 bridge launch;
    same key, 20 sweeps, >= 99% of particles agree with the plain version
    in both caches to rtol 1e-4."""
    mh, ctx, counts, locs, fluxes = _bridge_target(dev, name, shape, mode)
    kernel = _mala(mh, f"{name} bridge")
    assert mala_sweep.mala_kernel(ctx.prior, ctx.model, fluxes.shape[-1],
                                  child=True) == "K4"
    _k4_passthrough(kernel, ctx, counts, locs, fluxes, dev, bridge=True)
    state = init_kernel_state(ctx, counts, locs, fluxes)
    assert _k4_agreement(kernel, ctx, counts, state, dev) >= 0.99


@pytest.mark.parametrize("name,shape,mode,M,N,num_iters", [
    ("m71", (8, 8), None, 16, 999, 37),          # K1's target, M = 16
    ("poisson", (8, 8), None, 8, 1001, 20),
    ("poisson", (16, 16), None, 16, 999, 37),    # M = 16 on 16x16
    ("m71", (16, 8), "tag", 16, 999, 37),
    ("m71", (16, 8), "location", 16, 1001, 20),
    ("m71", (16, 16), "tag", 32, 1001, 37),      # M = 32 on the bridge
    ("m71", (16, 16), "location", 32, 999, 37),
])
def test_k4_lane_groups_match_plain_version(dev, name, shape, mode, M, N,
                                            num_iters):
    """K4's lane groups on what their layout risks, on the tile target and
    on both bridge tiles in tag and location mode: empty and occupied
    particles mixed in every warp and lane group, whole warps of empty
    particles, ragged N, M = 16 on both tiles and 32 on the 16x16 bridge,
    and 37 sweeps, which end inside a Philox draw-ahead batch."""
    if mode is None:
        mh, ctx, counts, state = _mixed_counts_target(dev, shape[0], M, N,
                                                      num_iters, name)
        kernel = _mala(mh, name)
    else:
        mh, ctx, counts, locs, fluxes = _bridge_target(
            dev, name, shape, mode, N, M, mixed=True)
        kernel = _mala(mh, f"{name} bridge")
        state = init_kernel_state(ctx, counts, locs, fluxes)
    assert mala_sweep.mala_kernel(ctx.prior, ctx.model, M,
                                  child=mode is not None) == "K4"
    args, child = _launch_args(kernel, ctx, counts, state, num_iters)
    counter = "launches" if mode is None else "bridge_launches"
    _lane_groups_agree(mala_sweep.mala_sweeps,
                       mala_sweep.mala_sweeps_reference,
                       lambda: getattr(mala_sweep.mala_sweeps, counter),
                       args, child)


def test_mala_on_cuda_never_reaches_plain_version(dev, monkeypatch):
    """``backend="auto"`` on CUDA tensors launches K4 or raises; it never
    runs the plain version."""
    mh, ctx, counts, locs, fluxes = _target(dev, name="basic", N=256)
    kernel = _mala(mh, "basic")

    def forbidden(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(mala_sweep, "mala_sweeps_reference", forbidden)
    monkeypatch.setattr(mala_sweep, "mala_sweep_with_uniforms", forbidden)
    before = mala_sweep.mala_sweeps.launches
    st, acc = kernel.run(torch.Generator(device=dev).manual_seed(0), ctx,
                         counts, locs, fluxes)
    torch.cuda.synchronize()
    assert mala_sweep.mala_sweeps.launches == before + 1
    assert torch.isfinite(st.parent_ll).all() and float(acc.mean()) > 0.0
    big = ImageModel(32, 32, 6, GaussianPSF(1.4, device=dev),
                     noise="poisson", background=50.0, device=dev)
    ctx = TargetContext(ctx.prior, big, torch.ones((2, 1, 1, 32, 32),
                                                   device=dev),
                        ctx.temperature)
    k4g_before = mala_sweep.mala_sweeps.k4g_launches
    st, _ = kernel.run(torch.Generator(device=dev).manual_seed(0), ctx,
                       counts, locs, fluxes)
    torch.cuda.synchronize()
    assert mala_sweep.mala_sweeps.k4g_launches == k4g_before + 1
    assert torch.isfinite(st.parent_ll).all()
    with pytest.raises(NotImplementedError, match="232448-byte limit"):
        _zero_launch(mala_sweep.mala_sweeps, kernel, ctx.prior, big, 5000)
    assert mala_sweep.mala_sweeps.launches == before + 1
    assert mala_sweep.mala_sweeps.k4g_launches == k4g_before + 1


@pytest.mark.parametrize("kind", roofline.KINDS)
def test_k5_matches_plain_version(dev, kind):
    """K5's chains against the plain chains on the card, one launch each,
    at the lengths and tolerances of ``roofline.CHECK_N_CHAIN`` /
    ``CHECK_RTOL``: within the tolerance of the plain chain, and beyond it
    from the plain chain one step shorter or longer."""
    x0 = torch.linspace(0.0, 10.0, 5000, device=dev)
    n_chain, rtol = roofline.CHECK_N_CHAIN[kind], roofline.CHECK_RTOL[kind]
    before = roofline.chain.launches
    got = roofline.chain(kind, x0, n_chain)
    want = roofline.chain_reference(kind, x0, n_chain)
    torch.cuda.synchronize()
    assert roofline.chain.launches == before + 1
    torch.testing.assert_close(got, want, rtol=rtol, atol=0.0)
    for d in (-1, 1):
        off = roofline.chain_reference(kind, x0, 0,
                                       n_chain * roofline.UNROLL + d)
        assert float(((got - off).abs() / off.abs()).max()) > rtol, d


def test_k5_rate_is_linear_in_the_chain_length(dev):
    m = roofline.measure("fma", target_s=0.05, device=dev)
    assert 1.8 <= m["linearity"] <= 2.2, m
    assert m["steps_per_s"] > 0 and m["sm_clock_mhz"] > 0


# ----------------------------------------------------------------------
# Plain PyTorch on the card: the pair move and the assignment solver
# ----------------------------------------------------------------------
def _pair_on_both(ctx_cpu, ctx_cuda, counts, locs, fluxes, dev):
    """One pair sweep on the CPU and on the card from the same state and
    the same draws (made on the CPU); returns both outcomes."""
    from smcdet_tpu_torch.distributions import gumbel_sample
    from smcdet_tpu_torch.inference.kernels import pair_redistribute_sweep

    g = torch.Generator().manual_seed(3)
    shape, M = counts.shape, fluxes.shape[-1]
    draws = (torch.rand(shape, generator=g), gumbel_sample(shape + (M,), g,
                                                           "cpu"),
             torch.rand(shape, generator=g),
             1.5 * torch.randn(shape + (2,), generator=g),
             torch.rand(shape, generator=g))
    out = []
    for ctx, d in ((ctx_cpu, "cpu"), (ctx_cuda, dev)):
        st = init_kernel_state(ctx, counts.to(d), locs.to(d), fluxes.to(d))
        new, applied = pair_redistribute_sweep(
            ctx, counts.to(d), st, *(x.to(d) for x in draws),
            select_scale=2.0, displace_scale=1.5)
        out.append((new, applied.cpu()))
    return out


def _moved(ctx, dev):
    """``ctx`` with its tensors on ``dev`` (prior and models built there)."""
    return ctx._replace(**{
        k: getattr(ctx, k).to(dev) for k in (
            "image", "temperature", "child_slot_side", "child_ghost_rate")
        if getattr(ctx, k) is not None})


@pytest.mark.parametrize("target", ["cells", "bridge tag", "bridge location"])
def test_pair_move_on_cuda_matches_the_cpu(dev, target):
    """The plain pair move on a CUDA state equals the CPU move given the
    same draws: the same acceptances but for boundary flips (under 1%),
    the same states elsewhere to f32 rounding (rtol 1e-4, atol 1e-3)."""
    cpu = torch.device("cpu")
    if target == "cells":
        _, cctx, counts, locs, fluxes = _target(cpu, name="cells", N=256)
        _, gctx, *_ = _target(dev, name="cells", N=8)
    else:
        mode = target.split()[1]
        _, cctx, counts, locs, fluxes = _bridge_target(cpu, mode=mode, N=256)
        _, gctx, *_ = _bridge_target(dev, mode=mode, N=8)
    gctx = _moved(cctx, dev)._replace(prior=gctx.prior, model=gctx.model,
                                      child_model=gctx.child_model)
    (cst, capp), (gst, gapp) = _pair_on_both(cctx, gctx, counts, locs,
                                             fluxes, dev)
    flips = capp != gapp
    assert float(flips.float().mean()) < 0.01
    assert 0.01 < float(capp.float().mean()) < 0.99
    same = ~flips
    for name in ("locs", "fluxes", "rate", "parent_ll", "logprior",
                 "child_rate", "child_ll"):
        a, b = getattr(cst, name), getattr(gst, name)
        if a is None:
            continue
        torch.testing.assert_close(b.cpu()[same], a[same], rtol=1e-4,
                                   atol=1e-3, msg=name)


def test_assignment_on_cuda_matches_the_cpu(dev):
    """The batched solver and the catalog matching give the same answers
    on the card as on the CPU (random and padded-block costs)."""
    from smcdet_tpu_torch.metrics import match_catalogs
    from smcdet_tpu_torch.ops.assignment import (
        linear_sum_assignment,
        pad_cost_matrix,
    )

    g = torch.Generator().manual_seed(0)
    for n in (1, 5, 13):
        cost = torch.rand((512, n, n), generator=g)
        rv = torch.arange(n) < torch.randint(0, n + 1, (512, 1), generator=g)
        cv = torch.arange(n) < torch.randint(0, n + 1, (512, 1), generator=g)
        cost = torch.cat([cost, pad_cost_matrix(cost, rv, cv)])
        assert torch.equal(linear_sum_assignment(cost.to(dev)).cpu(),
                           linear_sum_assignment(cost))
    T, N, M = 20, 64, 6
    tc = torch.randint(0, M + 1, (T,), generator=g, dtype=torch.int32)
    tl = 8 * torch.rand((T, M, 2), generator=g)
    tf = torch.exp(6 * torch.rand((T, M), generator=g))
    ec = (tc[:, None] + torch.randint(-1, 2, (T, N), generator=g)).clamp(
        0, M).to(torch.int32)
    el = tl[:, None] + 0.3 * torch.randn((T, N, M, 2), generator=g)
    ef = tf[:, None] * torch.exp(0.3 * torch.randn((T, N, M), generator=g))
    idx = torch.randint(0, N, (T, 30), generator=g)
    kw = dict(num_est_catalogs_to_match=30, locs_tol=0.5, mags_tol=0.5,
              mag_bins=[1.0, 18.0, 21.0, 24.0])
    a = match_catalogs(tc, tl, tf, ec, el, ef, indices=idx, **kw)
    b = match_catalogs(*(x.to(dev) for x in (tc, tl, tf, ec, el, ef)),
                       indices=idx.to(dev), **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y.cpu())
    assert float(a.num_true_matches.sum()) > 0


def _chains(dev, name, T=50):
    """One MH chain per tile of ``_target(name)``'s images (G = T, N = 1:
    one live particle a block), from the empty start moved 100 sweeps by
    the kernel: ``(kernel, ctx, counts, state)``."""
    from smcdet_tpu_torch.inference.mcmc import init_chain, with_iters

    kernel, ctx, _, _, _ = _target(dev, name=name, T=T, N=1)
    images = ctx.image[:, 0, 0]
    gen = torch.Generator(device=dev).manual_seed(1)
    ctx, counts, state = init_chain(gen, images, ctx.prior, ctx.model,
                                    kernel)
    state, _ = with_iters(kernel, 100).run_from_state(gen, ctx, counts,
                                                      state)
    return kernel, ctx, counts, state


@pytest.mark.parametrize("name,kid,mala", [
    ("m71", "K1", False), ("basic", "K2", False), ("cells", "K2", False),
    ("basic", "K4", True)])
def test_chain_launches_at_one_particle_match_plain_version(dev, name, kid,
                                                            mala):
    """The MCMC baseline's launch shape, N = 1 with 63 or 15 padded
    particles in every block: empty chains pass through bit-exactly, two
    launches on one key are bit-identical, and the chains agree with the
    plain version after 20 sweeps on one stream."""
    from smcdet_tpu_torch.inference.mcmc import with_iters

    kernel, ctx, counts, state = _chains(dev, name)
    if mala:
        kernel = SingleComponentMALA(1, 0.05, 20.0, kernel.fluxes_min,
                                     kernel.fluxes_max, device=dev)
        run, plain = mala_sweep.mala_sweeps, mala_sweep.mala_sweeps_reference
        assert mala_sweep.mala_kernel(ctx.prior, ctx.model,
                                      ctx.prior.max_objects) == kid
    else:
        run, plain = mh_sweep.mh_sweeps, mh_sweep.mh_sweeps_reference
        assert mh_sweep.sweep_kernel(ctx.prior, ctx.model,
                                     ctx.prior.max_objects) == kid
    T = counts.shape[0]
    key = torch.tensor([7, 9], dtype=torch.int64, device=dev)
    counts_mixed = counts.clone()
    counts_mixed[::2] = 0  # every other chain empty
    args = [key, kernel.proposal(ctx.prior), ctx.prior, ctx.model,
            ctx.image.reshape(T, -1).contiguous(),
            ctx.temperature.reshape(T).contiguous(), counts_mixed,
            state.locs, state.fluxes, state.rate, state.parent_ll,
            state.logprior, 20]
    first, again = run(*args), run(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    for out, inp in zip(first[:5], args[7:12]):
        assert torch.equal(out[::2], inp[::2])
    assert float(first[5][::2].abs().max()) == 0.0
    ref = plain(*args)
    agree = torch.ones(T, dtype=torch.bool, device=dev)
    for a, b in zip(first, ref):
        agree &= torch.isclose(a, b, rtol=1e-4, atol=1e-4).reshape(
            T, -1).all(-1)
    assert float(agree.float().mean()) >= 0.99
    assert float(first[5][1::2].mean()) > 0.0

    # and through run_from_state: one launch per block, counted
    counter = (mala_sweep.mala_sweeps, "launches") if mala else (
        mh_sweep.mh_sweeps, "launches" if kid == "K1" else "k2_launches")
    before = getattr(*counter)
    with_iters(kernel, 2).run_from_state(
        torch.Generator(device=dev).manual_seed(0), ctx, counts, state)
    assert getattr(*counter) == before + 1


def test_run_mh_on_cuda_launches_one_kernel_a_block(dev, monkeypatch):
    """``run_mh`` on the card: one burn-in launch and one launch a kept
    sample, never the plain version, and the burn-in's rate cache within
    f32 drift of a fresh render."""
    from smcdet_tpu_torch.inference.mcmc import MCMCConfig, run_mh

    kernel, ctx, _, _, _ = _target(dev, name="basic", T=20, N=1)

    def forbidden(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(mh_sweep, "mh_sweeps_reference", forbidden)
    before = mh_sweep.mh_sweeps.k2_launches
    res = run_mh(torch.Generator(device=dev).manual_seed(0),
                 ctx.image[:, 0, 0], ctx.prior, ctx.model, kernel,
                 MCMCConfig(3000, 2000, 2, 384.26))
    torch.cuda.synchronize()
    assert mh_sweep.mh_sweeps.k2_launches == before + 1 + 500
    assert res.locs.shape == (20, 500, 8, 2)
    assert torch.isfinite(res.fluxes).all()
    assert 0.0 < float(res.acc_rate.min()) < 1.0


def test_birth_death_sweep_on_cuda_matches_the_cpu(dev):
    """One reversible-jump sweep (all five kinds) on the card equals the
    CPU's on the same draws."""
    from smcdet_tpu_torch.inference.kernels import init_kernel_state
    from smcdet_tpu_torch.inference.transdimensional import (
        BirthDeathMH,
        TDKernelState,
    )

    kernel, ctx, counts, locs, fluxes = _target(dev, name="poisson", T=2,
                                                N=512)
    counts, locs, fluxes = counts[:, 2], locs[:, 2], fluxes[:, 2]
    ctx = ctx._replace(image=ctx.image[:, 0], temperature=ctx.temperature[:,
                                                                          0])
    bd = BirthDeathMH(1, kernel, prob_birth=0.2, prob_death=0.2,
                      prob_split=0.15, prob_merge=0.15)
    state = TDKernelState(counts, init_kernel_state(ctx, counts, locs,
                                                    fluxes))
    draws = bd.draws(torch.Generator(device=dev).manual_seed(3), ctx.prior,
                     counts, ctx.prior.max_objects)
    got, applied = bd.sweep(None, ctx, state, draws)

    def cpu(x):
        if isinstance(x, tuple):
            return tuple(cpu(v) for v in x)
        return None if x is None else x.cpu()

    cprior, _ = _normal_flux("cpu", 4, 8)
    cmodel = ImageModel(8, 8, 4, GaussianPSF(1.0, device="cpu"),
                        noise="poisson", background=100.0, device="cpu")
    ckernel = SingleComponentMH(1, 0.25, 60.0, 500.0, 5000.0, device="cpu")
    cctx = TargetContext(cprior, cmodel, ctx.image.cpu(),
                         ctx.temperature.cpu())
    cbd = BirthDeathMH(1, ckernel, prob_birth=0.2, prob_death=0.2,
                       prob_split=0.15, prob_merge=0.15)
    cstate = TDKernelState(counts.cpu(), init_kernel_state(
        cctx, counts.cpu(), locs.cpu(), fluxes.cpu()))
    want, wapplied = cbd.sweep(None, cctx, cstate,
                               type(draws)(*(cpu(v) for v in draws)))
    same = applied.cpu() == wapplied
    assert float(same.float().mean()) >= 0.99
    assert torch.equal(got.counts.cpu()[same], want.counts[same])
    for a, b in zip(got.inner, want.inner):
        if a is not None:
            torch.testing.assert_close(a.cpu()[same], b[same], rtol=1e-4,
                                       atol=1e-3)


def test_extractor_on_cuda_matches_the_cpu(dev):
    """The extractor on the card gives the CPU's detections (the m71
    fixture's tiles)."""
    from pathlib import Path

    import numpy as np

    from smcdet_tpu_torch.detect import extract_batch

    d = np.load(Path(__file__).resolve().parents[1]
                / "experiments/m71/data/m71/tiles.npz")
    sub = torch.as_tensor(d["images"] - d["background"],
                          dtype=torch.float32)
    for thresh, minarea, deblend in ((1.0, 1, 1e-6), (4.0, 3, 1e-3)):
        kw = dict(thresh=thresh, err=29.4, minarea=minarea,
                  deblend_cont=deblend, clean_param=1.0)
        a = extract_batch(sub, **kw)
        b = [x.cpu() for x in extract_batch(sub.to(dev), **kw)]
        same = a[0] == b[0]
        assert float(same.float().mean()) >= 0.99
        torch.testing.assert_close(b[1][same], a[1][same], rtol=0,
                                   atol=1e-3)
        torch.testing.assert_close(b[2][same], a[2][same], rtol=1e-4,
                                   atol=1e-3)
        assert int(a[0].sum()) > 0


@pytest.mark.parametrize("kind", ["mh", "mala"])
def test_early_stop_launches_a_kernel_a_sweep(dev, kind):
    """``sqjumpdist_tol`` on CUDA tensors: one launch of the target's
    kernel a sweep, counted (K1 for the M71 target, K4 under MALA): a
    tolerance of 0 runs every sweep, a huge one stops after one; the
    result equals the one-sweep run on the same generator bit for bit."""
    import copy

    kernel, ctx, counts, locs, fluxes = _target(dev, N=256)
    if kind == "mala":
        kernel = SingleComponentMALA(20, 0.05, 2.0, 0.252, 1804.679,
                                     device=dev)
    counter = (mala_sweep.mala_sweeps, "launches") if kind == "mala" else (
        mh_sweep.mh_sweeps, "launches")
    state = init_kernel_state(ctx, counts, locs, fluxes)
    for tol, sweeps in ((0.0, 7), (1e9, 1)):
        k = copy.copy(kernel)
        k.num_iters, k.sqjumpdist_tol = 7, tol
        before = getattr(*counter)
        st, acc = k.run_from_state(torch.Generator(device=dev).manual_seed(3),
                                   ctx, counts, state)
        torch.cuda.synchronize()
        assert getattr(*counter) == before + sweeps
        assert torch.isfinite(st.parent_ll).all()
    one = copy.copy(kernel)
    one.num_iters, one.sqjumpdist_tol = 1, None
    want, acc_want = one.run_from_state(
        torch.Generator(device=dev).manual_seed(3), ctx, counts, state)
    assert torch.equal(st.locs, want.locs) and torch.equal(acc, acc_want)


def test_early_stop_failed_launch_raises_and_never_falls_back(dev,
                                                              monkeypatch):
    """A launch that fails inside the early-stop loop raises out of the
    mutation; the plain version is never run in its place."""
    kernel, ctx, counts, locs, fluxes = _target(dev, N=256)
    kernel.sqjumpdist_tol = 0.0
    state = init_kernel_state(ctx, counts, locs, fluxes)

    def forbidden(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    calls = []
    launch = mh_sweep.launch

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("K1 sweep kernel launch failed")
        return launch(*a, **k)

    monkeypatch.setattr(mh_sweep, "mh_sweeps_reference", forbidden)
    monkeypatch.setattr(mh_sweep, "sweep_with_uniforms", forbidden)
    monkeypatch.setattr(mh_sweep, "launch", failing)
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel.run_from_state(torch.Generator(device=dev).manual_seed(0),
                              ctx, counts, state)
    assert len(calls) == 3
