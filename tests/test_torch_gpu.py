"""Kernels K1 to K5 on the card (CUDA only; every test skips without a
card).

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

    # a target neither kernel covers raises instead of running the plain path
    big = ImageModel(32, 32, 6, GaussianPSF(1.4, device=dev),
                     noise="poisson", background=50.0, device=dev)
    ctx = TargetContext(ctx.prior, big, torch.ones((2, 1, 1, 32, 32),
                                                   device=dev),
                        ctx.temperature)
    with pytest.raises(NotImplementedError, match="32x32"):
        kernel.run(torch.Generator(device=dev).manual_seed(0), ctx, counts,
                   locs, fluxes)
    assert mh_sweep.mh_sweeps.k2_launches == k2_before + 1


@pytest.mark.parametrize("max_objects", [1, 6, 8])
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


def _bridge_target(dev, name="m71", shape=(16, 8), mode="tag", N=512,
                   M=None):
    """An aggregation-bridge target on a joined tile: random catalogs with
    counts varying per particle, origin tags (``mode`` "tag") or the side
    of each star's location ("location"), a ghost rate, temperature 0.4.
    ``name``: "m71" (Gaussian noise, SDSS beta = 3, truncated Pareto) or
    "poisson" (Poisson noise, Gaussian PSF, Normal flux)."""
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
    prior = expand_prior(prior, h, w, M)
    model = model.with_shape(h, w)
    g = torch.Generator(device=dev).manual_seed(0)
    G = 2
    counts = torch.randint(0, M + 1, (1, G, N), generator=g, device=dev,
                           dtype=torch.int32)
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


def test_k3_raises_for_an_unbuilt_joined_tile(dev):
    """A bridge on a joined tile K3 is not built for (the 32x16 tile of a
    4x4 grid) raises on the card instead of running the plain version."""
    kernel, ctx, *_ = _bridge_target(dev, shape=(16, 8))
    wide = ctx.model.with_shape(32, 16)
    G, N, M, HW = 2, 64, 16, 512
    z = torch.zeros
    child = mh_sweep.ChildTerm(torch.ones((G, N, HW), device=dev),
                               z((G, N), device=dev),
                               z((G, N, M), device=dev), 0, 16)
    with pytest.raises(NotImplementedError, match="32x16"):
        mh_sweep.mh_sweeps(
            z(2, dtype=torch.int64, device=dev), kernel.proposal(ctx.prior),
            ctx.prior, wide, z((G, HW), device=dev), z(G, device=dev),
            z((G, N), dtype=torch.int32, device=dev),
            z((G, N, M, 2), device=dev), z((G, N, M), device=dev),
            torch.ones((G, N, HW), device=dev), z((G, N), device=dev),
            z((G, N), device=dev), 5, child=child)


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
    with pytest.raises(NotImplementedError, match="32x32"):
        kernel.run(torch.Generator(device=dev).manual_seed(0), ctx, counts,
                   locs, fluxes)
    assert mala_sweep.mala_sweeps.launches == before + 1


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
