"""Kernels K1, K2 and K3: the fused single-component MH sweep loop, and
its plain version.

``mh_sweeps`` runs ``num_iters`` MH sweeps over a batch of particles. On a
CUDA tensor it launches one of three hand-written kernels, which together
replace ``smcdet_tpu/ops/pallas_sweep.py:_make_kernel``: K1
(``csrc/mh_sweep.cu``, the M71 main path: Gaussian noise, SDSS beta = 3,
Pareto flux, 8x8), K2 (``csrc/mh_sweep_k2.cu``, every other tile target on
8x8 and 16x16 tiles) or K3 (``csrc/mh_sweep_k3.cu``, the aggregation
bridge target with its child term, on the joined 16x8 and 16x16 tiles);
``sweep_kernel`` picks one or raises. On a CPU tensor it runs the plain
PyTorch version, ``mh_sweeps_reference``. There is no fallback from one to
the other.

Both versions draw the same random stream: Philox4x32-10 with a 64-bit key
drawn once per call and the counter ``(particle, sweep, draw,
particle >> 32)``, where ``particle = g * N + n`` indexes the flattened
batch. Draw 0 gives the slot, y, x and flux uniforms, draw 1 the accept
uniform; bits map to ``((bits >> 8) + 0.5) * 2**-24``. So on the card the
kernel and the plain version can be compared particle by particle.

Layouts (flattened groups ``G`` = tiles x strata): ``image [G, H*W]``,
``temperature [G]``, ``counts [G, N]`` int32, ``locs [G, N, M, 2]``,
``fluxes [G, N, M]``, ``rate [G, N, H*W]``, ``pll``/``lp`` ``[G, N]``,
``key`` int64 ``[2]`` holding two 32-bit words. The bridge target adds
``ChildTerm``: the child rate ``[G, N, H*W]``, the child log-likelihood
``[G, N]`` and the slot origin tags ``[G, N, M]`` (or none, for the side of
the star's location).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from smcdet_tpu_torch.distributions import (
    TruncatedPareto,
    truncated_normal_log_mass,
    truncated_normal_sample,
)
from smcdet_tpu_torch.models.priors import NormalFlux, ParetoFlux
from smcdet_tpu_torch.models.psf import SDSSPSF, GaussianPSF

__all__ = [
    "ChildTerm",
    "MHProposal",
    "even_pixels",
    "flux_prior_delta",
    "launch",
    "location_window",
    "mh_sweeps",
    "mh_sweeps_reference",
    "philox4x32",
    "philox_uniforms",
    "select_slot",
    "side_window",
    "sweep_kernel",
    "sweep_with_uniforms",
    "sweeps_on_stream",
]

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


@dataclass
class MHProposal:
    """Truncated-normal random-walk scales and flux bounds (0-d tensors)."""

    locs_stdev: torch.Tensor
    fluxes_stdev: torch.Tensor
    flux_lo: torch.Tensor
    flux_hi: torch.Tensor


class ChildTerm(NamedTuple):
    """The aggregation bridge's child term: the child rate cache and
    log-likelihood, the slot origin tags (1 = the even child; ``None``
    assigns each star the side of its location instead), and the split of
    the joined tile: pixels with ``coord < boundary`` along ``axis``
    belong to the even child."""

    rate: torch.Tensor
    ll: torch.Tensor
    slot_side: Optional[torch.Tensor]
    axis: int
    boundary: float


def even_pixels(axis: int, boundary, height: int, width: int, device):
    """``[H*W]`` bool: the flat pixels of the even child tile."""
    p = torch.arange(height * width, device=device)
    coord = torch.div(p, width, rounding_mode="floor") if axis == 0 \
        else p % width
    return coord < boundary


def side_window(side_mask, model, side):
    """Child pixel window ``[..., H*W]`` of stars with origin tags ``side
    [...]`` (``side_mask`` carries ``.axis`` and ``.boundary``)."""
    even = even_pixels(side_mask.axis, side_mask.boundary, model.height,
                       model.width, side.device)
    return torch.where(side[..., None] > 0.5, even, ~even)


def location_window(axis: int, boundary, model, loc):
    """Child pixel window ``[..., H*W]`` of stars at ``loc [..., 2]``: the
    even child's pixels when ``loc[axis] <= boundary``."""
    even = even_pixels(axis, boundary, model.height, model.width, loc.device)
    return torch.where((loc[..., axis] <= boundary)[..., None], even, ~even)


# ----------------------------------------------------------------------
# Philox4x32-10 on int64 tensors holding unsigned 32-bit words
# ----------------------------------------------------------------------
def _mulhilo(a: int, b):
    """``(hi, lo)`` 32-bit words of ``a * b`` for a 32-bit constant ``a``.

    The 64-bit product can overflow signed int64, so ``a`` is split into
    16-bit limbs: ``b * a0`` and ``b * a1`` stay below 2**48, and
    ``floor(a * b / 2**32) = (b * a1 + (b * a0 >> 16)) >> 16``.
    """
    p0 = b * (a & 0xFFFF)
    p1 = b * (a >> 16)
    hi = (p1 + (p0 >> 16)) >> 16
    lo = (p0 + ((p1 & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32(counter, key):
    """Philox4x32-10 of the four counter words under the two key words
    (int64 tensors or ints in ``[0, 2**32)``); returns four int64 words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def _unit(bits):
    return ((bits >> 8).to(torch.float32) + 0.5) * 2.0**-24


def philox_uniforms(key, particle, sweep: int):
    """The kernel's uniforms for one sweep: ``(u_j, u_y, u_x, u_f, u_acc)``,
    each shaped like ``particle`` (int64 global particle indices).
    ``key`` is an int64 tensor or a pair of ints holding two 32-bit words."""
    k0, k1 = (int(k) for k in key)
    # draws 0 and 1 of every particle in one pass: leading axis = draw
    p = particle.expand((2,) + particle.shape)
    draw = torch.arange(2, device=particle.device).reshape(
        (2,) + (1,) * particle.ndim).expand_as(p)
    r = philox4x32((p & _MASK32, torch.full_like(p, sweep), draw, p >> 32),
                   (k0, k1))
    return (_unit(r[0][0]), _unit(r[1][0]), _unit(r[2][0]), _unit(r[3][0]),
            _unit(r[0][1]))


# ----------------------------------------------------------------------
# The plain version
# ----------------------------------------------------------------------
def select_slot(u_j, counts, locs, fluxes):
    """The slot each particle moves, uniform over its occupied prefix
    ``0..count-1`` from ``u_j``: ``(onehot [..., N, M], active [..., N],
    loc_j [..., N, 2], f_j [..., N])``, with location and flux 0 where the
    particle has no occupied slot."""
    M = fluxes.shape[-1]
    j = torch.minimum(torch.floor(u_j * counts).to(torch.int64),
                      counts.to(torch.int64) - 1)
    active = counts > 0
    onehot = torch.arange(M, device=counts.device) == j[..., None]
    j_safe = j.clamp(min=0)[..., None]
    loc_j = torch.gather(locs, -2, j_safe[..., None].expand(
        j_safe.shape + (2,))).squeeze(-2)
    f_j = torch.gather(fluxes, -1, j_safe).squeeze(-1)
    return (onehot, active, torch.where(active[..., None], loc_j, 0.0),
            torch.where(active, f_j, 0.0))


def flux_prior_delta(prior, active, f_old, f_new):
    """Flux-prior log-density change of the moved slot (0 where inactive)."""
    if prior.flux is None:
        return torch.zeros_like(f_old)
    ref = prior.flux.reference_point
    safe_old = torch.where(active, f_old, ref)
    safe_new = torch.where(active, f_new, ref)
    delta = prior.flux.log_prob(safe_new) - prior.flux.log_prob(safe_old)
    return torch.where(active, delta, 0.0)


def sweep_with_uniforms(u_j, u_loc, u_f, u_acc, *, prior, model, proposal,
                        image_flat, temperature, counts, locs, fluxes, rate,
                        pll, lp, child: ChildTerm | None = None):
    """One single-component MH sweep given explicit uniforms.

    Port of ``smcdet_tpu/inference/kernels.py:SingleComponentMH.sweep``:
    one slot per particle, chosen uniformly over the occupied prefix, gets
    a truncated-normal move of its location and flux, accepted with the
    tempered MH ratio including the truncation-mass correction. With
    ``child`` the target is the bridge's ``lp + tau pll + (1 - tau) cll``
    and the child rate follows the moved star inside its child window.
    ``u_j``/``u_f``/``u_acc`` are ``[..., N]``, ``u_loc`` ``[..., N, 2]``;
    ``image_flat`` and ``temperature`` broadcast against ``[..., N, H*W]``
    and ``[..., N]``. Returns ``(locs, fluxes, rate, pll, lp, applied)``,
    and with ``child`` also ``(child_rate, cll)``.
    """
    onehot, active, loc_j, f_j = select_slot(u_j, counts, locs, fluxes)

    lo, hi = prior.loc_low, prior.loc_high
    p = proposal
    loc_prop = truncated_normal_sample(loc_j, p.locs_stdev, lo, hi, u=u_loc)
    f_prop = truncated_normal_sample(f_j, p.fluxes_stdev, p.flux_lo,
                                     p.flux_hi, u=u_f)

    old = model.star_image_flat(loc_j)
    new = model.star_image_flat(loc_prop)
    a = active[..., None]
    d = model.adu_per_nmgy * (f_prop[..., None] * new - f_j[..., None] * old)
    rate_prop = rate + torch.where(a, d, 0.0)
    pll_prop = model.loglikelihood_from_rate_flat(image_flat, rate_prop)
    lp_prop = lp + flux_prior_delta(prior, active, f_j, f_prop)

    log_target_old = lp + temperature * pll
    log_target_new = lp_prop + temperature * pll_prop
    if child is not None:
        if child.slot_side is not None:
            side_j = (child.slot_side * onehot).sum(-1)
            w_old = w_new = side_window(child, model, side_j)
        else:
            w_old = location_window(child.axis, child.boundary, model, loc_j)
            w_new = location_window(child.axis, child.boundary, model,
                                    loc_prop)
        dc = model.adu_per_nmgy * (f_prop[..., None] * (new * w_new)
                                   - f_j[..., None] * (old * w_old))
        crate_prop = child.rate + torch.where(a, dc, 0.0)
        cll_prop = model.loglikelihood_from_rate_flat(image_flat, crate_prop)
        log_target_old = log_target_old + (1.0 - temperature) * child.ll
        log_target_new = log_target_new + (1.0 - temperature) * cll_prop
    log_q = (
        truncated_normal_log_mass(loc_j, p.locs_stdev, lo, hi).sum(-1)
        - truncated_normal_log_mass(loc_prop, p.locs_stdev, lo, hi).sum(-1)
        + truncated_normal_log_mass(f_j, p.fluxes_stdev, p.flux_lo, p.flux_hi)
        - truncated_normal_log_mass(f_prop, p.fluxes_stdev, p.flux_lo,
                                    p.flux_hi)
    )
    log_alpha = log_target_new - log_target_old + log_q
    accept = u_acc <= torch.exp(torch.clamp(log_alpha, max=0.0))
    applied = accept & active

    sel = onehot & applied[..., None]
    ap = applied[..., None]
    locs = torch.where(sel[..., None], loc_prop[..., None, :], locs)
    fluxes = torch.where(sel, f_prop[..., None], fluxes)
    rate = torch.where(ap, rate_prop, rate)
    pll = torch.where(applied, pll_prop, pll)
    lp = torch.where(applied, lp_prop, lp)
    if child is None:
        return locs, fluxes, rate, pll, lp, applied
    return (locs, fluxes, rate, pll, lp, applied,
            torch.where(ap, crate_prop, child.rate),
            torch.where(applied, cll_prop, child.ll))


def mh_sweeps_reference(key, proposal, prior, model, image, temperature,
                        counts, locs, fluxes, rate, pll, lp, num_iters: int,
                        child: ChildTerm | None = None):
    """Plain PyTorch version of K1, K2 and K3 for any target the eager
    model supports: ``num_iters`` sweeps over the kernels' random stream.
    Returns ``(locs, fluxes, rate, pll, lp, acc)`` with ``acc`` the applied
    fraction per particle, and with ``child`` also ``(child_rate, cll)``."""
    return sweeps_on_stream(sweep_with_uniforms, key, proposal, prior, model,
                            image, temperature, counts, locs, fluxes, rate,
                            pll, lp, num_iters, child)


def sweeps_on_stream(step, key, proposal, prior, model, image, temperature,
                     counts, locs, fluxes, rate, pll, lp, num_iters: int,
                     child: ChildTerm | None = None):
    """``num_iters`` sweeps of ``step`` (``sweep_with_uniforms`` or a
    function of the same signature) over the kernels' Philox stream, on
    the kernels' flattened layouts; returns what ``mh_sweeps_reference``
    returns."""
    G, N = counts.shape
    key = [int(k) for k in key.tolist()]  # one host read, not one a sweep
    particle = torch.arange(G * N, device=counts.device).reshape(G, N)
    image_flat = image[:, None, :]
    tau = temperature[:, None]
    acc = torch.zeros((G, N), dtype=torch.float32, device=counts.device)
    for it in range(num_iters):
        u_j, u_y, u_x, u_f, u_acc = philox_uniforms(key, particle, it)
        out = step(
            u_j, torch.stack([u_y, u_x], -1), u_f, u_acc, prior=prior,
            model=model, proposal=proposal, image_flat=image_flat,
            temperature=tau, counts=counts, locs=locs, fluxes=fluxes,
            rate=rate, pll=pll, lp=lp, child=child,
        )
        locs, fluxes, rate, pll, lp, applied = out[:6]
        if child is not None:
            child = child._replace(rate=out[6], ll=out[7])
        acc = acc + applied.to(torch.float32)
    if child is None:
        return locs, fluxes, rate, pll, lp, acc / num_iters
    return locs, fluxes, rate, pll, lp, acc / num_iters, child.rate, child.ll


# ----------------------------------------------------------------------
# The CUDA kernels
# ----------------------------------------------------------------------
_K1_PARAMS = (
    "locs_stdev", "fluxes_stdev", "flux_lo", "flux_hi",
    "loc_low_y", "loc_low_x", "loc_high_y", "loc_high_x",
    "adu", "noise_add", "noise_mult", "psf_radius",
    "s1", "s2", "sp", "beta", "b", "p0", "norm",
    "pareto_alpha", "pareto_lognorm",
)
_K2_FLOATS = (
    "locs_stdev", "fluxes_stdev", "flux_lo", "flux_hi",
    "loc_low_y", "loc_low_x", "loc_high_y", "loc_high_x",
    "adu", "noise_add", "noise_mult", "psf_radius", "normal_tail",
    "s1", "s2", "sp", "beta", "b", "p0", "norm",
    "gauss_stdev", "gauss_norm", "flux_a", "flux_b", "flux_c",
)
_K2_INTS = ("noise_kind", "psf_kind", "flux_kind")
# K2's tile sizes and slot range (csrc/mh_sweep_k2.cu)
K2_TILES = ((8, 8), (16, 16))
K2_MAX_SLOTS = 16
# K3's joined tiles and the most slots each is built for
# (csrc/mh_sweep_k3.cu): the two levels of a 2x2 tile grid of 8x8 tiles
K3_TILES = {(16, 8): 16, (16, 16): 32}


class _MHParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in _K1_PARAMS]


class _K2Params(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_float) for name in _K2_FLOATS]
                + [(name, ctypes.c_int) for name in _K2_INTS])


class _K3Params(ctypes.Structure):
    _fields_ = [("base", _K2Params), ("boundary", ctypes.c_float),
                ("child_axis", ctypes.c_int), ("side_from_tag", ctypes.c_int)]


def _check_target(prior, model, pareto):
    if not isinstance(model.psf, (SDSSPSF, GaussianPSF)):
        raise NotImplementedError(
            f"no CUDA sweep kernel for the PSF {type(model.psf).__name__}")
    if prior.flux is not None and not (
            pareto or isinstance(prior.flux, NormalFlux)):
        raise NotImplementedError(
            f"no CUDA sweep kernel for the flux prior "
            f"{type(prior.flux).__name__}")


def sweep_kernel(prior, model, M: int, child: bool = False) -> str:
    """The CUDA kernel that runs this target: ``"K1"`` (Gaussian noise,
    SDSS beta = 3, Pareto flux, 8x8, 1..8 slots), ``"K2"`` (every other
    noise, PSF and flux prior on 8x8 or 16x16 tiles with 1..16 slots) or,
    for the aggregation bridge (``child``), ``"K3"`` (the joined 16x8 tile
    with 1..16 slots and 16x16 with 1..32). Raises ``NotImplementedError``
    naming what is missing for a target none covers."""
    pareto = isinstance(prior.flux, (TruncatedPareto, ParetoFlux))
    shape = (model.height, model.width)
    if child:
        if M < 1 or M > K3_TILES.get(shape, 0):
            raise NotImplementedError(
                f"no CUDA bridge sweep kernel for {shape[0]}x{shape[1]} "
                f"tiles with M={M}: K3 is built for "
                + " and ".join(f"{h}x{w} with 1..{m} slots"
                               for (h, w), m in K3_TILES.items()))
        _check_target(prior, model, pareto)
        return "K3"
    if (model.noise == "gaussian" and isinstance(model.psf, SDSSPSF)
            and model.psf.wing_beta3 and pareto
            and shape == (8, 8) and 1 <= M <= 8):
        return "K1"
    if shape not in K2_TILES or not 1 <= M <= K2_MAX_SLOTS:
        raise NotImplementedError(
            f"no CUDA sweep kernel for {shape[0]}x{shape[1]} tiles "
            f"with M={M}: K2 is built for "
            f"{' and '.join(f'{h}x{w}' for h, w in K2_TILES)} tiles with "
            f"1..{K2_MAX_SLOTS} slots")
    _check_target(prior, model, pareto)
    return "K2"


def _host_floats(values):
    return torch.stack([torch.as_tensor(v, dtype=torch.float32).cpu()
                        for v in values]).tolist()


def _pareto_lognorm(flux):
    if isinstance(flux, ParetoFlux):
        return torch.log(flux.alpha) + flux.alpha * torch.log(flux.scale)
    return flux.logpdf_norm_const


def _k1_params(proposal, prior, model) -> _MHParams:
    psf, flux = model.psf, prior.flux
    values = [
        proposal.locs_stdev, proposal.fluxes_stdev, proposal.flux_lo,
        proposal.flux_hi, prior.loc_low[0], prior.loc_low[1],
        prior.loc_high[0], prior.loc_high[1], model.adu_per_nmgy,
        model.noise_additive, model.noise_multiplicative,
        torch.tensor(float(model.psf_radius)), *psf.params,
        psf.normalizing_constant, flux.alpha, _pareto_lognorm(flux),
    ]
    return _MHParams(*_host_floats(values))


def _k2_params(proposal, prior, model) -> _K2Params:
    psf, flux = model.psf, prior.flux
    zero = torch.tensor(0.0)
    if isinstance(psf, SDSSPSF):
        psf_kind = 1 if psf.wing_beta3 else 2
        sdss = [*psf.params, psf.normalizing_constant]
        gauss = [zero, zero]
    else:
        psf_kind = 0
        sdss = [zero] * 7
        # the plain version's normaliser, rounded as it rounds it
        gauss = [psf.stdev, psf.stdev * math.sqrt(2.0 * math.pi)]
    if flux is None:
        flux_kind, marks = 0, [zero] * 3
    elif isinstance(flux, NormalFlux):
        flux_kind = 2
        marks = [flux.mean, flux.stdev, torch.log(flux.stdev)]
    else:
        flux_kind, marks = 1, [flux.alpha, _pareto_lognorm(flux), zero]
    values = [
        proposal.locs_stdev, proposal.fluxes_stdev, proposal.flux_lo,
        proposal.flux_hi, prior.loc_low[0], prior.loc_low[1],
        prior.loc_high[0], prior.loc_high[1], model.adu_per_nmgy,
        model.noise_additive, model.noise_multiplicative,
        torch.tensor(float(model.psf_radius)),
        torch.tensor(model.normal_tail_threshold), *sdss, *gauss, *marks,
    ]
    noise_kind = 1 if model.noise == "poisson" else 0
    return _K2Params(*_host_floats(values), noise_kind, psf_kind, flux_kind)


def _k3_params(proposal, prior, model, child) -> _K3Params:
    """The bridge's parameters; without ``child`` (K4's tile target)
    ``child_axis`` is -1."""
    if child is None:
        return _K3Params(_k2_params(proposal, prior, model), 0.0, -1, 0)
    return _K3Params(_k2_params(proposal, prior, model),
                     float(child.boundary), int(child.axis),
                     int(child.slot_side is not None))


_ENTRY_POINTS = {"K1": "smcdet_mh_sweeps_launch",
                 "K2": "smcdet_mh_sweeps_k2_launch",
                 "K3": "smcdet_mh_sweeps_k3_launch",
                 "K4": "smcdet_mala_sweeps_k4_launch"}
_PARAMS = {"K1": (_MHParams, 15), "K2": (_K2Params, 15),
           "K3": (_K3Params, 20), "K4": (_K3Params, 20)}


def _entry(name: str):
    from smcdet_tpu_torch import _build

    fn = getattr(_build.load_library(), _ENTRY_POINTS[name])
    if fn.argtypes is None:
        params, n_ptr = _PARAMS[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [params, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def tag_bits(slot_side):
    """Origin tags ``[G, N, M]`` (M <= 32) as one int64 bit mask per
    particle, bit ``m`` set where slot ``m`` came from the even child."""
    M = slot_side.shape[-1]
    weights = torch.ones((), dtype=torch.int64, device=slot_side.device) \
        << torch.arange(M, device=slot_side.device)
    return ((slot_side > 0.5).to(torch.int64) * weights).sum(-1)


def mh_sweeps(key, proposal, prior, model, image, temperature, counts, locs,
              fluxes, rate, pll, lp, num_iters: int,
              child: ChildTerm | None = None):
    """Run ``num_iters`` fused MH sweeps; returns ``(locs, fluxes, rate,
    pll, lp, acc)``, and with ``child`` also ``(child_rate, cll)`` (the
    outputs of ``pallas_mh_sweeps``).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    ``sweep_kernel`` names (K1, K2, or K3 with ``child``) on the current
    stream, without synchronising, or raise ``NotImplementedError`` for a
    target none covers. ``mh_sweeps.launches``, ``.k2_launches`` and
    ``.k3_launches`` count the launches of each."""
    if not locs.is_cuda:
        return mh_sweeps_reference(key, proposal, prior, model, image,
                                   temperature, counts, locs, fluxes, rate,
                                   pll, lp, num_iters, child)
    name = sweep_kernel(prior, model, fluxes.shape[-1],
                        child=child is not None)
    outs = launch(name, key, proposal, prior, model, image, temperature,
                  counts, locs, fluxes, rate, pll, lp, num_iters, child)
    if name == "K1":
        mh_sweeps.launches += 1
    elif name == "K2":
        mh_sweeps.k2_launches += 1
    else:
        mh_sweeps.k3_launches += 1
    return outs


mh_sweeps.launches = 0
mh_sweeps.k2_launches = 0
mh_sweeps.k3_launches = 0


def launch(name, key, proposal, prior, model, image, temperature, counts,
           locs, fluxes, rate, pll, lp, num_iters: int,
           child: ChildTerm | None = None):
    """Launch sweep kernel ``name`` ("K1" to "K4") on CUDA tensors on the
    current stream, without synchronising, after checking every input;
    returns the outputs of ``mh_sweeps``. ``proposal`` carries the
    proposal scales (for K4, MALA's step sizes)."""
    G, N, M = fluxes.shape
    if num_iters < 1:
        raise ValueError("num_iters must be positive")
    HW = model.height * model.width
    dev = locs.device
    f32 = torch.float32
    _check("key", key, (2,), torch.int64, dev)
    _check("image", image, (G, HW), f32, dev)
    _check("temperature", temperature, (G,), f32, dev)
    _check("counts", counts, (G, N), torch.int32, dev)
    _check("locs", locs, (G, N, M, 2), f32, dev)
    _check("fluxes", fluxes, (G, N, M), f32, dev)
    _check("rate", rate, (G, N, HW), f32, dev)
    _check("pll", pll, (G, N), f32, dev)
    _check("lp", lp, (G, N), f32, dev)
    ins = [key, image, temperature, counts, locs, fluxes, rate, pll, lp]
    outs = [torch.empty_like(t) for t in (locs, fluxes, rate, pll, lp, pll)]
    child_outs = []
    if child is not None:
        _check("child_rate", child.rate, (G, N, HW), f32, dev)
        _check("cll", child.ll, (G, N), f32, dev)
        tags = None
        if child.slot_side is not None:
            _check("slot_side", child.slot_side, (G, N, M), f32, dev)
            tags = tag_bits(child.slot_side)
        ins += [child.rate, child.ll, tags]
        child_outs = [torch.empty_like(child.rate),
                      torch.empty_like(child.ll)]
        bufs = ins + outs + child_outs
    elif name == "K4":  # the tile target: no child buffers
        bufs = ins + [None] * 3 + outs + [None] * 2
    else:
        bufs = ins + outs
    if name in ("K3", "K4"):
        params = _k3_params(proposal, prior, model, child)
    elif name == "K2":
        params = _k2_params(proposal, prior, model)
    else:
        params = _k1_params(proposal, prior, model)
    fn = _entry(name)
    ptrs = [None if t is None else t.data_ptr() for t in bufs]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, G, N, M, model.height, model.width, num_iters,
                 params, stream)
    if err != 0:
        raise RuntimeError(f"{name} sweep kernel launch failed with CUDA "
                           f"error {err}")
    return tuple(outs + child_outs)
