"""The plain version of kernels K1 and K2 (smcdet_tpu_torch/ops/mh_sweep.py)
against the JAX package's MH sweep, the stream it shares with the CUDA
kernels, and the choice of kernel for a target.

The CUDA kernels themselves run only on the card: see
tests/test_torch_gpu.py.
"""

import functools

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

from smcdet_tpu.inference.kernels import (
    SingleComponentMH as JaxMH,
    TargetContext as JaxCtx,
    init_kernel_state as jax_init_state,
)
from smcdet_tpu_torch.inference.kernels import (
    KernelState,
    TargetContext,
    init_kernel_state,
)
from smcdet_tpu_torch.ops import mh_sweep

_MASK = np.uint64(0xFFFFFFFF)


def np_philox4x32_10(ctr, key):
    """Independent Philox4x32-10 in numpy uint64 (products of two 32-bit
    words fit without overflow)."""
    c = [np.asarray(x, dtype=np.uint64) for x in ctr]
    k0, k1 = (np.uint64(k) for k in key)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [
            (p1 >> np.uint64(32)) ^ c[1] ^ k0,
            p1 & _MASK,
            (p0 >> np.uint64(32)) ^ c[3] ^ k1,
            p0 & _MASK,
        ]
        k0 = (k0 + np.uint64(0x9E3779B9)) & _MASK
        k1 = (k1 + np.uint64(0xBB67AE85)) & _MASK
    return c


# ----------------------------------------------------------------------
# Philox
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "ctr,key,want",
    [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
)
def test_philox_known_answers(ctr, key, want):
    # Random123's published known-answer vectors for philox4x32_10
    got_np = [int(w) for w in np_philox4x32_10(ctr, key)]
    assert got_np == list(want)
    got = mh_sweep.philox4x32(
        tuple(torch.tensor([c], dtype=torch.int64) for c in ctr),
        tuple(torch.tensor(k, dtype=torch.int64) for k in key),
    )
    assert [int(w) for w in got] == list(want)


def test_philox_uniforms_match_numpy():
    rng = np.random.default_rng(0)
    key_np = rng.integers(0, 2**32, size=2, dtype=np.uint64)
    # particle indices spanning the 32-bit boundary exercise counter word 3
    particle = np.concatenate([np.arange(512, dtype=np.uint64),
                               np.uint64(2**32) + np.arange(3, dtype=np.uint64)])
    key = torch.tensor(key_np.astype(np.int64))
    got = mh_sweep.philox_uniforms(key, torch.tensor(particle.astype(np.int64)),
                                   sweep=37)
    hi = particle >> np.uint64(32)
    lo = particle & _MASK
    sweep = np.full_like(particle, 37)
    r0 = np_philox4x32_10((lo, sweep, np.zeros_like(particle), hi), key_np)
    r1 = np_philox4x32_10((lo, sweep, np.ones_like(particle), hi), key_np)

    def unit(bits):
        return ((bits >> np.uint64(8)).astype(np.float32) + np.float32(0.5)) \
            * np.float32(2.0**-24)

    want = [unit(r0[0]), unit(r0[1]), unit(r0[2]), unit(r0[3]), unit(r1[0])]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    u = torch.stack(got).numpy()
    assert u.min() > 0.0 and u.max() <= 1.0


# ----------------------------------------------------------------------
# One sweep against JAX given the same uniforms
# ----------------------------------------------------------------------
def _normal_flux_prior(max_objects, tile):
    from smcdet_tpu.models.priors import NormalFlux, PointProcessPrior, \
        UniformCounts

    return PointProcessPrior(
        min_objects=0, max_objects=max_objects, image_height=tile,
        image_width=tile, pad=1.0, counts=UniformCounts(0, max_objects),
        flux=NormalFlux(mean=jnp.float32(2000.0), stdev=jnp.float32(300.0)),
    )


def _normal_flux_kernel():
    return JaxMH(num_iters=1, locs_stdev=jnp.float32(0.25),
                 fluxes_stdev=jnp.float32(60.0),
                 fluxes_min=jnp.float32(500.0),
                 fluxes_max=jnp.float32(5000.0))


@functools.cache
def _jax_setup(noise="gaussian", T=2, N=256, max_objects=4, seed=0):
    """The test_pallas.py target at small size. ``noise`` names the target:

    - "gaussian": M71 (Gaussian noise, SDSS beta = 3, truncated Pareto), K1;
    - "poisson": Poisson noise, Gaussian PSF, Normal flux, 8x8;
    - "cells": the cells suite's target (Poisson, Gaussian PSF of radius 6
      on 16x16 tiles, truncated Pareto, ``max_objects`` slots);
    - "wing": Gaussian noise with the general-beta SDSS wing (beta = 2.5);
    - "gauss16": Gaussian noise, SDSS beta = 3 and Normal flux on 16x16.
    """
    from smcdet_tpu.models.imaging import ImageModel, M71ImageModel
    from smcdet_tpu.models.psf import GaussianPSF

    if noise == "gaussian":
        prior, model, kernel = m71_problem(max_objects=max_objects)
        kernel = kernel.replace(num_iters=1)
    elif noise == "poisson":
        prior = _normal_flux_prior(max_objects, 8)
        model = ImageModel(height=8, width=8, psf_radius=4, noise="poisson",
                           background=jnp.float32(100.0),
                           psf=GaussianPSF(stdev=jnp.float32(1.0)))
        kernel = _normal_flux_kernel()
    elif noise == "cells":
        from smcdet_tpu.models.priors import M71Prior

        prior = M71Prior(min_objects=0, max_objects=max_objects,
                         counts_rate=0.02, image_height=16, image_width=16,
                         flux_alpha=0.5, flux_lower=100.0,
                         flux_upper=100000.0, pad=1.0)
        model = ImageModel(height=16, width=16, psf_radius=6,
                           noise="poisson", background=jnp.float32(50.0),
                           psf=GaussianPSF(stdev=jnp.float32(1.4)))
        kernel = JaxMH(num_iters=1, locs_stdev=jnp.float32(0.3),
                       fluxes_stdev=jnp.float32(40.0),
                       fluxes_min=jnp.float32(50.0),
                       fluxes_max=jnp.float32(100000.0))
    elif noise == "wing":
        prior, _, kernel = m71_problem(max_objects=max_objects)
        kernel = kernel.replace(num_iters=1)
        model = M71ImageModel(
            image_height=8, image_width=8, background=179.0,
            adu_per_nmgy=155.0,
            psf_params=(1.33, 4.82, 3.15, 2.5, 0.06, 0.002), psf_radius=8,
            noise_additive=0.0, noise_multiplicative=1.94,
        )
        assert not model.psf.wing_beta3
    elif noise == "gauss16":
        prior = _normal_flux_prior(max_objects, 16)
        _, model, _ = m71_problem(max_objects=max_objects, tile=16)
        kernel = _normal_flux_kernel()
    else:
        raise ValueError(noise)
    C = prior.num_counts

    @jax.jit
    def draw(k_prior, k_image):
        strata, locs, fluxes = prior.sample_stratified(k_prior, N, (T,))
        images = jnp.abs(model.sample(k_image, locs[:, -1, 0],
                                      fluxes[:, -1, 0]))
        return strata, locs, fluxes, images

    strata, locs, fluxes, images = draw(jax.random.key(seed),
                                        jax.random.key(seed + 1))
    counts = jnp.broadcast_to(strata[None, :, None], (T, C, N))
    ctx = JaxCtx(prior=prior, model=model, image=images[:, None, None],
                 temperature=jnp.full((T, 1, 1), 0.8))
    return prior, model, kernel, ctx, counts, locs, fluxes


def _port(prior, model, kernel, ctx, **kw):
    p_prior, p_model = port_prior(prior), port_model(model)
    p_kernel = port_kernel(kernel, **kw)
    p_ctx = TargetContext(p_prior, p_model, t(ctx.image), t(ctx.temperature))
    return p_prior, p_model, p_kernel, p_ctx


def _jax_sweep_uniforms(key, shape):
    """The uniforms JAX's sweep draws (kernels.py:309-334, :396 and
    distributions.py:62-64)."""
    k_j, k_loc, k_flux, k_acc = jax.random.split(key, 4)
    eps = 1e-6
    return (
        jax.random.uniform(k_j, shape),
        jax.random.uniform(k_loc, shape + (2,), minval=eps, maxval=1 - eps),
        jax.random.uniform(k_flux, shape, minval=eps, maxval=1 - eps),
        jax.random.uniform(k_acc, shape),
    )


_SWEEP_TARGETS = {
    "gaussian": {},
    "poisson": {},
    "cells": {"N": 64, "max_objects": 12},
    "wing": {},
    "gauss16": {"N": 64, "max_objects": 6},
}


@pytest.mark.parametrize("noise", list(_SWEEP_TARGETS))
def test_one_sweep_matches_jax(noise):
    prior, model, kernel, ctx, counts, locs, fluxes = _jax_setup(
        noise, **_SWEEP_TARGETS[noise])
    state = jax.jit(jax_init_state)(ctx, counts, locs, fluxes)
    key = jax.random.key(11)
    jst, japplied = jax.jit(
        lambda k, st: kernel.sweep(k, ctx, counts, st))(key, state)
    u = [t(x) for x in jax.jit(_jax_sweep_uniforms, static_argnums=1)(
        key, counts.shape)]

    p_prior, p_model, p_kernel, p_ctx = _port(prior, model, kernel, ctx)
    pcounts = t(counts, torch.int32)
    pstate = KernelState(t(state.locs), t(state.fluxes), t(state.rate),
                         t(state.parent_ll), t(state.logprior))
    pst, papplied = p_kernel.sweep(None, p_ctx, pcounts, pstate, uniforms=u)

    # log alpha of every proposal, from a sweep that accepts every finite
    # active proposal (u_acc = 0), to classify accept flips
    ast, _ = p_kernel.sweep(None, p_ctx, pcounts, pstate,
                            uniforms=u[:3] + [torch.zeros_like(u[3])])
    pp = p_kernel.proposal(p_prior)
    j = torch.minimum(torch.floor(u[0] * pcounts).long(), pcounts.long() - 1)
    jj = j.clamp(min=0)
    take = lambda a: torch.gather(a, -1, jj[..., None]).squeeze(-1)  # noqa
    ly, lx = take(pstate.locs[..., 0]), take(pstate.locs[..., 1])
    yp, xp = take(ast.locs[..., 0]), take(ast.locs[..., 1])
    f, fp = take(pstate.fluxes), take(ast.fluxes)
    from smcdet_tpu_torch.distributions import truncated_normal_log_mass as lm
    lo, hi = p_prior.loc_low, p_prior.loc_high
    log_q = (lm(ly, pp.locs_stdev, lo[0], hi[0]) + lm(lx, pp.locs_stdev, lo[1],
                                                      hi[1])
             - lm(yp, pp.locs_stdev, lo[0], hi[0])
             - lm(xp, pp.locs_stdev, lo[1], hi[1])
             + lm(f, pp.fluxes_stdev, pp.flux_lo, pp.flux_hi)
             - lm(fp, pp.fluxes_stdev, pp.flux_lo, pp.flux_hi))
    tau = p_ctx.temperature
    log_alpha = ((ast.logprior + tau * ast.parent_ll)
                 - (pstate.logprior + tau * pstate.parent_ll) + log_q)
    margin = (torch.log(u[3]) - torch.clamp(log_alpha, max=0.0)).abs()

    ja = np.asarray(japplied)
    pa = papplied.numpy()
    flips = ja != pa
    # a flip is allowed only where u sits on the acceptance boundary
    assert (margin.numpy()[flips] < 1e-4).all(), margin.numpy()[flips]
    assert flips.mean() < 0.01
    assert pa.mean() > 0.05  # the sweep does move particles
    same = ~flips
    for name, tol in (("locs", 1e-4), ("fluxes", 1e-4), ("rate", 1e-4),
                      ("parent_ll", 1e-4), ("logprior", 1e-4)):
        got = getattr(pst, name).numpy()[same]
        want = np.asarray(getattr(jst, name))[same]
        # rtol 1e-4: f32 ndtri/exp/log rounding and the pixel-sum order
        np.testing.assert_allclose(got, want, rtol=tol, atol=1e-4,
                                   err_msg=name)


def test_zero_count_passthrough_is_exact():
    prior, model, kernel, ctx, counts, locs, fluxes = _jax_setup()
    p_prior, p_model, p_kernel, p_ctx = _port(prior, model, kernel, ctx)
    zc = torch.zeros(counts.shape, dtype=torch.int32)
    ploc, pflux = t(locs), t(fluxes)
    st = init_kernel_state(p_ctx, zc, ploc, pflux)
    p_kernel.num_iters = 5
    out, acc = p_kernel.run_from_state(torch.Generator().manual_seed(0),
                                       p_ctx, zc, st)
    for a, b in zip(out[:5], st[:5]):  # the tile target's fields
        assert torch.equal(a, b)
    assert float(acc.max()) == 0.0


# ----------------------------------------------------------------------
# The sweep loop at equilibrium against JAX (tests/test_pallas.py protocol)
# ----------------------------------------------------------------------
def test_plain_sweep_loop_matches_jax_equilibrium():
    """Different random streams, so the comparison is at equilibrium: 800
    sweeps, the tempered-target quantiles q50/q75 within 5% + 5 nats and
    the acceptance within 0.02 (the bounds and size of
    tests/test_pallas.py:107-154), and the incremental caches equal a
    fresh render."""
    prior, model, kernel, ctx, counts, locs, fluxes = _jax_setup()
    kernel = kernel.replace(num_iters=800, backend="xla")
    stx, accx = jax.jit(lambda k: kernel.run(k, ctx, counts, locs, fluxes))(
        jax.random.key(5))
    p_prior, p_model, p_kernel, p_ctx = _port(prior, model, kernel, ctx)
    pcounts = t(counts, torch.int32)
    stp, accp = p_kernel.run(torch.Generator().manual_seed(5), p_ctx,
                             pcounts, t(locs), t(fluxes))

    ltx = np.asarray(stx.logprior + 0.8 * stx.parent_ll).ravel()
    ltp = (stp.logprior + 0.8 * stp.parent_ll).numpy().ravel()
    for q in (50, 75):
        a, b = np.percentile(ltx, q), np.percentile(ltp, q)
        assert abs(a - b) <= 0.05 * abs(a) + 5.0, (q, a, b)
    assert abs(float(accp.mean()) - float(accx.mean())) < 0.02

    fresh = init_kernel_state(p_ctx, pcounts, stp.locs, stp.fluxes)
    scale = fresh.rate.abs().clamp(min=1.0)
    # f32 incremental accumulation over the accepted sweeps
    assert float(((stp.rate - fresh.rate).abs() / scale).max()) < 2e-3
    scale = fresh.parent_ll.abs().clamp(min=1.0)
    assert float(((stp.parent_ll - fresh.parent_ll).abs() / scale).max()) \
        < 2e-3
    assert float((stp.logprior - fresh.logprior).abs().max()) < 0.01
    # inactive slots are never touched
    inactive = ~(torch.arange(fluxes.shape[-1]) < pcounts[..., None])
    assert torch.equal(stp.fluxes[inactive], t(fluxes)[inactive])


# ----------------------------------------------------------------------
# Dispatch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("noise", ["gaussian", "poisson"])
def test_auto_backend_on_cpu_runs_plain_version(noise):
    """A CPU tensor takes the plain version whatever the target, K1's or
    K2's, and never counts a launch."""
    prior, model, kernel, ctx, counts, locs, fluxes = _jax_setup(noise, N=64)
    p_prior, p_model, p_kernel, p_ctx = _port(prior, model, kernel, ctx)
    assert p_kernel.backend == "auto"
    before = (mh_sweep.mh_sweeps.launches, mh_sweep.mh_sweeps.k2_launches)
    pcounts = t(counts, torch.int32)
    out, acc = p_kernel.run(torch.Generator().manual_seed(1), p_ctx, pcounts,
                            t(locs), t(fluxes))
    assert (mh_sweep.mh_sweeps.launches,
            mh_sweep.mh_sweeps.k2_launches) == before
    assert torch.isfinite(out.parent_ll).all()
    # the same key through the plain version directly gives the same state
    ref, _ = port_kernel(kernel, backend="torch").run(
        torch.Generator().manual_seed(1), p_ctx, pcounts, t(locs), t(fluxes))
    for a, b in zip(out[:5], ref[:5]):  # the tile target's fields
        assert torch.equal(a, b)


def test_k1_coverage_names_missing_kernel():
    """``sweep_kernel`` routes each CUDA target to K1 or K2, and every
    other shape or slot count to K2g; it names the limit where a block's
    shared memory is too small. K1 takes the M71 8x8 target (Gaussian
    noise, SDSS beta = 3) with 1..16 slots, as K2 takes its targets."""
    from smcdet_tpu_torch.models.imaging import ImageModel
    from smcdet_tpu_torch.models.psf import GaussianPSF

    prior, model, *_ = _jax_setup("gaussian")
    pp, pm = port_prior(prior), port_model(model)
    assert mh_sweep.sweep_kernel(pp, pm, 6) == "K1"
    assert mh_sweep.sweep_kernel(pp, pm, 8) == "K1"
    assert mh_sweep.sweep_kernel(pp, pm, 12) == "K1"
    assert mh_sweep.sweep_kernel(pp, pm, 16) == "K1"
    assert mh_sweep.sweep_kernel(pp, pm, 17) == "K2g"
    for target, M in (("poisson", 4), ("wing", 4), ("cells", 12),
                      ("gauss16", 6)):
        prior, model, *_ = _jax_setup(target, **_SWEEP_TARGETS[target])
        assert mh_sweep.sweep_kernel(port_prior(prior), port_model(model),
                                     M) == "K2", target
    prior, model, *_ = _jax_setup("cells", **_SWEEP_TARGETS["cells"])
    pp = port_prior(prior)
    assert mh_sweep.sweep_kernel(pp, port_model(model), 17) == "K2g"
    big = ImageModel(32, 32, 6, GaussianPSF(1.4, device="cpu"), device="cpu")
    assert mh_sweep.sweep_kernel(pp, big, 12) == "K2g"
    huge = ImageModel(128, 128, 6, GaussianPSF(1.4, device="cpu"),
                      device="cpu")
    with pytest.raises(NotImplementedError,
                       match="128x128 tiles with M=1200: .* 232448-byte"):
        mh_sweep.sweep_kernel(pp, huge, 1200)


def test_sweep_kernel_routes_the_bridge_to_k3():
    """A child term (the aggregation bridge) goes to K3 on the joined tiles
    of a 2x2 grid, whatever the noise, PSF and flux prior, and to K3g on
    any other joined tile or slot count."""
    from smcdet_tpu_torch.models.imaging import ImageModel

    for target, M in (("gaussian", 4), ("poisson", 4)):
        prior, model, *_ = _jax_setup(target)
        pp, pm = port_prior(prior), port_model(model)
        for (h, w), m in (((16, 8), 16), ((16, 16), 32)):
            joined = pm.with_shape(h, w)
            assert mh_sweep.sweep_kernel(pp, joined, m, child=True) == "K3"
            assert mh_sweep.sweep_kernel(pp, joined, m + 1,
                                         child=True) == "K3g"
        for h, w in ((8, 8), (32, 16), (32, 32)):
            assert mh_sweep.sweep_kernel(pp, pm.with_shape(h, w), M,
                                         child=True) == "K3g"
        # the tile target of the same shapes is not K3's
        assert mh_sweep.sweep_kernel(pp, pm.with_shape(16, 16), M) == "K2"
    big = ImageModel(16, 8, 6, object(), device="cpu")
    with pytest.raises(NotImplementedError, match="PSF"):
        mh_sweep.sweep_kernel(pp, big, 4, child=True)


def test_tag_bits_pack_the_origin_tags():
    rng = np.random.default_rng(0)
    tags = (rng.uniform(size=(3, 5, 32)) < 0.5).astype(np.float32)
    bits = mh_sweep.tag_bits(torch.from_numpy(tags)).numpy()
    assert bits.dtype == np.int64 and bits.max() < 2**32
    want = (tags.astype(np.int64) << np.arange(32)).sum(-1)
    np.testing.assert_array_equal(bits, want)
