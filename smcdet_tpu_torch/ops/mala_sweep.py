"""Kernel K4: the fused single-component MALA sweep loop, and its plain
version.

``mala_sweeps`` runs ``num_iters`` MALA sweeps over a batch of particles, on
the tile target or, with a ``ChildTerm``, the aggregation bridge's. On a
CUDA tensor it launches K4 (``csrc/mala_sweep_k4.cu``), which replaces
``smcdet_tpu/ops/pallas_sweep.py:_make_mala_kernel``; ``mala_kernel`` names
the shapes it is built for and raises for any other. On a CPU tensor it runs
the plain PyTorch version, ``mala_sweeps_reference``. There is no fallback
from one to the other.

One update moves one occupied slot: its location and flux are drawn from
normals truncated to the prior's box, centred on the drifted means
``x + step^2 / 2 * grad``, and accepted with the tempered ratio that carries
both truncated-normal proposal densities. The slot target's gradient is
closed-form, as in the TPU kernel: with ``rate = rate_wo + a adu f psi(r2)``,

    dG/df  = flux_lp'(f) + sum_px g * a adu psi
    dG/dly = sum_px g * a adu f dpsi/dr2 * (-2 dy)   (and lx with dx)

where ``g = tau dll/drate(rate)`` on the tile target and adds
``(1 - tau) dll/drate(child_rate) w`` on the bridge (``w`` the moved star's
child window, constant in its location). The patch mask and ``floor`` have
zero gradient, as for ``torch.autograd``.

Both versions draw the stream of K1-K3 (``mh_sweep.philox_uniforms``): draw
0 gives the slot, y, x and flux uniforms, draw 1 the accept uniform. Layouts
are those of ``mh_sweep``. MALA's drift amplifies a last-bit difference
over the sweeps, so the plain version sums the pixels in K4's lane order
(``lane_sum``) and K4 rounds each multiply and add on its own as the plain
version's tensor ops do; the two then differ only where the library
functions round differently.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from smcdet_tpu_torch.distributions import (
    TruncatedPareto,
    truncated_normal_log_prob,
    truncated_normal_sample,
)
from smcdet_tpu_torch.models.priors import NormalFlux, ParetoFlux
from smcdet_tpu_torch.models.psf import SDSSPSF
from smcdet_tpu_torch.ops import mh_sweep
from smcdet_tpu_torch.ops.mh_sweep import (
    K2_MAX_SLOTS,
    K2_TILES,
    K3_TILES,
    ChildTerm,
    flux_prior_delta,
    location_window,
    select_slot,
    side_window,
)

__all__ = [
    "MALAProposal",
    "accept",
    "dll_drate",
    "flux_log_prob_grad",
    "lane_sum",
    "mala_kernel",
    "mala_proposal",
    "mala_sweep_with_uniforms",
    "mala_sweeps",
    "mala_sweeps_reference",
    "psf_and_deriv",
    "slot_gradient",
    "smallest_box_mass",
]


def psf_and_deriv(model, loc):
    """``(psi, dpsi/dr2, dy, dx)``, each ``[..., H*W]``, of one star at
    ``loc [..., 2]``: its unit-flux render (``model.star_image_flat``, the
    same operations) and the derivative of the PSF in the squared radius,
    both under the patch mask; ``dy, dx`` are the pixel centre minus the
    location."""
    H, W = model.height, model.width
    ly, lx = loc[..., 0:1], loc[..., 1:2]
    p = torch.arange(H * W, device=loc.device)
    h = torch.div(p, W, rounding_mode="floor").to(torch.float32)
    w = (p % W).to(torch.float32)
    dy = (h + 0.5) - ly
    dx = (w + 0.5) - lx
    patch = ((h - torch.floor(ly)).abs() <= model.psf_radius) & (
        (w - torch.floor(lx)).abs() <= model.psf_radius)
    r2 = dy * dy + dx * dx
    psf = model.psf
    if isinstance(psf, SDSSPSF):
        s1, s2, sp, beta, b, p0 = psf.params
        # the exponentials of psi serve its derivative too
        t1 = torch.exp(-r2 / (2.0 * s1))
        t2 = b * torch.exp(-r2 / (2.0 * s2))
        q = 1.0 + r2 / (beta * sp)
        t3 = p0 * (torch.rsqrt(q * q * q) if psf.wing_beta3
                   else q ** (-beta / 2.0))
        k = 1.0 + b + p0
        psi = ((t1 + t2 + t3) / k) / psf.normalizing_constant
        dpsi = ((t1 * (-1.0 / (2.0 * s1)) + t2 * (-1.0 / (2.0 * s2))
                 + t3 * (-0.5) / (sp + r2 / beta)) / k
                ) / psf.normalizing_constant
    else:
        s = psf.stdev
        psi = psf.normalized(r2)
        dpsi = psi * (-0.5 / (s * s))
    return psi * patch, dpsi * patch, dy, dx


def dll_drate(model, image_flat, rate):
    """Per-pixel derivative of the pixel log-likelihood in the rate, by the
    likelihood's own branch rule (the Normal tail above
    ``normal_tail_threshold`` for Poisson noise)."""
    r = image_flat - rate
    if model.noise == "gaussian":
        m = model.noise_multiplicative
        var = model.noise_additive + m * rate
        return r / var + 0.5 * r * r * m / (var * var) - 0.5 * m / var
    d_norm = r / rate + 0.5 * r * r / (rate * rate) - 0.5 / rate
    return torch.where(rate > model.normal_tail_threshold, d_norm,
                       image_flat / rate - 1.0)


def flux_log_prob_grad(prior, f):
    """Derivative of the flux prior's log-density at ``f`` (0 without a flux
    mark)."""
    flux = prior.flux
    if isinstance(flux, (TruncatedPareto, ParetoFlux)):
        return -(flux.alpha + 1.0) / f
    if isinstance(flux, NormalFlux):
        return -(f - flux.mean) / (flux.stdev * flux.stdev)
    if flux is None:
        return torch.zeros_like(f)
    raise NotImplementedError(f"no flux-prior gradient for "
                              f"{type(flux).__name__}")


def lane_sum(x):
    """Sum over the trailing pixel axis in K4's order: on a tile of HW
    pixels K4 gives each particle L = HW / 8 lanes, lane ``l`` adds pixels
    ``l, l + L, ..., l + 7 L`` in turn, then the lanes add up pairwise as
    its ``__shfl_xor_sync`` butterfly does (lane ``l`` with ``l + L / 2``,
    then ``l + L / 4``, ...). The same order gives the kernel's bits where
    the terms agree. A tile K4 has no lane layout for (HW not 8 times a
    power of two) sums with ``.sum(-1)``."""
    L = x.shape[-1] // 8
    if x.shape[-1] != 8 * L or L & (L - 1):
        return x.sum(-1)
    parts = x.unflatten(-1, (8, L))
    acc = parts[..., 0, :]
    for k in range(1, 8):
        acc = acc + parts[..., k, :]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def slot_gradient(prior, model, image_flat, temperature, active, f, render,
                  rate, child_rate=None, window=None):
    """Closed-form gradient of the tempered slot target at the star
    ``render = psf_and_deriv(model, loc)`` with flux ``f [..., N]``, given
    the full rate cache ``rate`` (and on the bridge the child rate and the
    star's child window): ``(grad_loc [..., N, 2], grad_f [..., N])``, 0
    for an inactive particle but for its flux-prior term."""
    psi, dpsi, dy, dx = render
    tau = temperature[..., None]
    g = tau * dll_drate(model, image_flat, rate)
    if child_rate is not None:
        g = g + (1.0 - tau) * dll_drate(model, image_flat, child_rate) * window
    aeff = torch.where(active, model.adu_per_nmgy, 0.0)
    gd = g * dpsi
    gl = torch.stack([lane_sum(gd * (-2.0 * dy)), lane_sum(gd * (-2.0 * dx))],
                     -1) * (aeff * f)[..., None]
    gf = lane_sum(g * psi) * aeff + torch.where(
        active, flux_log_prob_grad(prior, f), 0.0)
    return gl, gf


class MALAProposal(NamedTuple):
    """One sweep's proposals before the accept test: the moved slot
    (``onehot``, ``active``), its current location and flux (the flux floor
    where inactive), the forward drifted means, the proposal, the reverse
    drifted means at the proposal, its log acceptance ratio, and the caches
    and log-terms at the proposal (the child pair None on the tile
    target)."""

    onehot: torch.Tensor
    active: torch.Tensor
    loc: torch.Tensor
    f: torch.Tensor
    mu_loc: torch.Tensor
    mu_f: torch.Tensor
    loc_prop: torch.Tensor
    f_prop: torch.Tensor
    mu_loc_rev: torch.Tensor
    mu_f_rev: torch.Tensor
    log_alpha: torch.Tensor
    rate: torch.Tensor
    pll: torch.Tensor
    lp: torch.Tensor
    child_rate: Optional[torch.Tensor]
    cll: Optional[torch.Tensor]


def mala_proposal(u_j, u_loc, u_f, *, prior, model, proposal, image_flat,
                  temperature, counts, locs, fluxes, rate, pll, lp,
                  child: ChildTerm | None = None) -> MALAProposal:
    """One sweep's MALA proposals and their log acceptance ratios given
    explicit uniforms, operation by operation as ``_make_mala_kernel``
    (``pallas_sweep.py:703-818``) with the closed-form gradient. The
    arguments are those of ``mh_sweep.sweep_with_uniforms`` without
    ``u_acc``, with MALA's step sizes in ``proposal.locs_stdev`` /
    ``proposal.fluxes_stdev``. A particle with no occupied slot proposes
    from the flux floor."""
    onehot, active, loc_j, f_j = select_slot(u_j, counts, locs, fluxes)
    p = proposal
    lo, hi = prior.loc_low, prior.loc_high
    f_safe = torch.where(active, f_j, p.flux_lo)
    aeff = torch.where(active, model.adu_per_nmgy, 0.0)[..., None]
    tau = temperature
    args = (prior, model, image_flat, tau, active)

    w_old = w_new = None
    if child is not None:
        if child.slot_side is not None:
            side_j = (child.slot_side * onehot).sum(-1)
            w_old = side_window(child, model, side_j)
        else:
            w_old = location_window(child.axis, child.boundary, model, loc_j)

    # the forward drift at the current point (the cached rates)
    old = psf_and_deriv(model, loc_j)
    rate_wo = rate - (aeff * f_safe[..., None]) * old[0]
    gl, gf = slot_gradient(*args, f_safe, old, rate,
                           None if child is None else child.rate, w_old)
    half_ls2 = 0.5 * p.locs_stdev * p.locs_stdev
    half_fs2 = 0.5 * p.fluxes_stdev * p.fluxes_stdev
    mu_loc = loc_j + half_ls2 * gl
    mu_f = f_safe + half_fs2 * gf
    loc_prop = truncated_normal_sample(mu_loc, p.locs_stdev, lo, hi, u=u_loc)
    f_prop = truncated_normal_sample(mu_f, p.fluxes_stdev, p.flux_lo,
                                     p.flux_hi, u=u_f)

    # the proposal's render, target and reverse drift
    new = psf_and_deriv(model, loc_prop)
    rate_prop = rate_wo + (aeff * f_prop[..., None]) * new[0]
    pll_prop = lane_sum(model.pixel_loglik(image_flat, rate_prop))
    lp_prop = lp + flux_prior_delta(prior, active, f_safe, f_prop)
    log_target_old = lp + tau * pll
    log_target_new = lp_prop + tau * pll_prop
    crate_prop = cll_prop = None
    if child is not None:
        w_new = w_old if child.slot_side is not None else location_window(
            child.axis, child.boundary, model, loc_prop)
        crate_wo = child.rate - (aeff * f_safe[..., None]) * old[0] * w_old
        crate_prop = crate_wo + (aeff * f_prop[..., None]) * new[0] * w_new
        cll_prop = lane_sum(model.pixel_loglik(image_flat, crate_prop))
        log_target_old = log_target_old + (1.0 - tau) * child.ll
        log_target_new = log_target_new + (1.0 - tau) * cll_prop
    gl_r, gf_r = slot_gradient(*args, f_prop, new, rate_prop, crate_prop,
                               w_new)
    mu_loc_r = loc_prop + half_ls2 * gl_r
    mu_f_r = f_prop + half_fs2 * gf_r

    log_q_fwd = truncated_normal_log_prob(
        loc_prop, mu_loc, p.locs_stdev, lo, hi).sum(-1) + (
        truncated_normal_log_prob(f_prop, mu_f, p.fluxes_stdev, p.flux_lo,
                                  p.flux_hi))
    log_q_rev = truncated_normal_log_prob(
        loc_j, mu_loc_r, p.locs_stdev, lo, hi).sum(-1) + (
        truncated_normal_log_prob(f_safe, mu_f_r, p.fluxes_stdev, p.flux_lo,
                                  p.flux_hi))
    log_alpha = ((log_target_new - log_target_old) + log_q_rev) - log_q_fwd
    return MALAProposal(onehot, active, loc_j, f_safe, mu_loc, mu_f,
                        loc_prop, f_prop, mu_loc_r, mu_f_r, log_alpha,
                        rate_prop, pll_prop, lp_prop, crate_prop, cll_prop)


def accept(q: MALAProposal, u_acc, locs, fluxes, rate, pll, lp,
           child_rate=None, cll=None):
    """Apply the proposals ``q`` where ``u_acc <= alpha`` and the particle
    has an occupied slot (``pallas_sweep.py:819-837``): ``(locs, fluxes,
    rate, pll, lp, applied)``, and with a child pair also ``(child_rate,
    cll)``."""
    applied = q.active & (u_acc <= torch.exp(torch.clamp(q.log_alpha,
                                                         max=0.0)))
    sel = q.onehot & applied[..., None]
    ap = applied[..., None]
    out = (torch.where(sel[..., None], q.loc_prop[..., None, :], locs),
           torch.where(sel, q.f_prop[..., None], fluxes),
           torch.where(ap, q.rate, rate),
           torch.where(applied, q.pll, pll),
           torch.where(applied, q.lp, lp), applied)
    if child_rate is None:
        return out
    return out + (torch.where(ap, q.child_rate, child_rate),
                  torch.where(applied, q.cll, cll))


def smallest_box_mass(q: MALAProposal, proposal, prior):
    """Per particle, the smallest of the six truncated-normal box masses of
    ``q``'s two proposal densities (forward at ``mu``, reverse at
    ``mu_rev``; each a difference of two f32 values of Phi). Where a mass
    falls below about 1e-5, Phi's rounding near 1 (an ulp, 6e-8) is no
    longer small against it, so its log, and with it the proposal and the
    acceptance ratio, is rounding noise that differs from one Phi
    implementation to another."""
    from torch.special import ndtr

    p = proposal
    lo, hi = prior.loc_low, prior.loc_high

    def mass(mu, sigma, lb, ub):
        return ndtr((ub - mu) / sigma) - ndtr((lb - mu) / sigma)

    return torch.stack([
        *(mass(mu, p.locs_stdev, lo, hi).min(-1).values
          for mu in (q.mu_loc, q.mu_loc_rev)),
        *(mass(mu, p.fluxes_stdev, p.flux_lo, p.flux_hi)
          for mu in (q.mu_f, q.mu_f_rev)),
    ]).min(0).values


def mala_sweep_with_uniforms(u_j, u_loc, u_f, u_acc, *, prior, model,
                             proposal, image_flat, temperature, counts, locs,
                             fluxes, rate, pll, lp,
                             child: ChildTerm | None = None):
    """One single-component MALA sweep given explicit uniforms: the
    proposals of ``mala_proposal`` through ``accept``. Arguments and
    outputs are those of ``mh_sweep.sweep_with_uniforms``."""
    q = mala_proposal(u_j, u_loc, u_f, prior=prior, model=model,
                      proposal=proposal, image_flat=image_flat,
                      temperature=temperature, counts=counts, locs=locs,
                      fluxes=fluxes, rate=rate, pll=pll, lp=lp, child=child)
    return accept(q, u_acc, locs, fluxes, rate, pll, lp,
                  *(() if child is None else (child.rate, child.ll)))


def mala_sweeps_reference(key, proposal, prior, model, image, temperature,
                          counts, locs, fluxes, rate, pll, lp,
                          num_iters: int, child: ChildTerm | None = None):
    """Plain PyTorch version of K4: ``num_iters`` MALA sweeps over the
    kernels' random stream; returns what ``mala_sweeps`` returns."""
    return mh_sweep.sweeps_on_stream(
        mala_sweep_with_uniforms, key, proposal, prior, model, image,
        temperature, counts, locs, fluxes, rate, pll, lp, num_iters, child)


def mala_kernel(prior, model, M: int, child: bool = False) -> str:
    """``"K4"`` where K4 is built for the target: the tile target on K2's
    tiles (8x8 and 16x16 with 1..16 slots), the aggregation bridge
    (``child``) on K3's joined tiles (16x8 with 1..16 slots, 16x16 with
    1..32), every noise, PSF and flux prior of K2. Raises
    ``NotImplementedError`` naming what is missing otherwise."""
    shape = (model.height, model.width)
    if child:
        if not 1 <= M <= K3_TILES.get(shape, 0):
            raise NotImplementedError(
                f"no CUDA MALA bridge kernel for {shape[0]}x{shape[1]} "
                f"tiles with M={M}: K4 is built for "
                + " and ".join(f"{h}x{w} with 1..{m} slots"
                               for (h, w), m in K3_TILES.items()))
    elif shape not in K2_TILES or not 1 <= M <= K2_MAX_SLOTS:
        raise NotImplementedError(
            f"no CUDA MALA kernel for {shape[0]}x{shape[1]} tiles with "
            f"M={M}: K4 is built for "
            f"{' and '.join(f'{h}x{w}' for h, w in K2_TILES)} tiles with "
            f"1..{K2_MAX_SLOTS} slots")
    mh_sweep._check_target(prior, model, isinstance(
        prior.flux, (TruncatedPareto, ParetoFlux)))
    return "K4"


def mala_sweeps(key, proposal, prior, model, image, temperature, counts,
                locs, fluxes, rate, pll, lp, num_iters: int,
                child: ChildTerm | None = None):
    """Run ``num_iters`` fused MALA sweeps; returns ``(locs, fluxes, rate,
    pll, lp, acc)``, and with ``child`` also ``(child_rate, cll)`` (the
    outputs of ``pallas_mala_sweeps``). CPU tensors take the plain version;
    CUDA tensors launch K4 on the current stream, without synchronising, or
    raise ``NotImplementedError`` for a shape K4 is not built for.
    ``mala_sweeps.launches`` counts the tile-target launches,
    ``.bridge_launches`` the bridge's."""
    if not locs.is_cuda:
        return mala_sweeps_reference(key, proposal, prior, model, image,
                                     temperature, counts, locs, fluxes, rate,
                                     pll, lp, num_iters, child)
    mala_kernel(prior, model, fluxes.shape[-1], child=child is not None)
    outs = mh_sweep.launch("K4", key, proposal, prior, model, image,
                           temperature, counts, locs, fluxes, rate, pll, lp,
                           num_iters, child)
    if child is None:
        mala_sweeps.launches += 1
    else:
        mala_sweeps.bridge_launches += 1
    return outs


mala_sweeps.launches = 0
mala_sweeps.bridge_launches = 0
