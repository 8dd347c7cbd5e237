"""Single-component MH and MALA mutation kernels and prior-draw relocation
moves, for the tile target and the aggregation bridge (port of
``smcdet_tpu/inference/kernels.py``).

The sweep carries the rendered rate image of every particle and updates it
incrementally: moving one star costs two single-star renders, not M. The
pixel log-likelihood and the changed slot's prior term are recomputed
exactly. Particles are ``[..., N, M(, 2)]`` padded catalogs (slot m active
iff ``m < count``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from smcdet_tpu_torch.distributions import (
    truncated_normal_log_prob,
    truncated_normal_sample,
)
from smcdet_tpu_torch.ops import mala_sweep, mh_sweep
from smcdet_tpu_torch.ops.mh_sweep import MHProposal

__all__ = [
    "TargetContext",
    "KernelState",
    "SingleComponentMALA",
    "SingleComponentMH",
    "init_kernel_state",
    "relocate_sweep",
    "relocate_sweeps",
]


class TargetContext(NamedTuple):
    """Tempered target decomposed for incremental single-component updates.

    The tile target is ``logprior + temperature * loglik``. ``image``
    ``[..., H, W]`` and ``temperature`` broadcast against the particle batch
    (``[T, 1, 1, H, W]`` and ``[T, 1, 1]`` in the SMC loop).

    The aggregation bridge adds a child term: the target becomes
    ``logprior + temperature * parent_ll + (1 - temperature) * child_ll``,
    where the child rate renders each star only into its own child tile's
    pixel window (``child_side_mask``: ``.axis`` and ``.boundary`` split the
    joined tile). The window is the slot's fixed origin tag
    (``child_slot_side [..., N, M]``, 1 = the even child) or, when no tags
    are given, the side the star's location lies on. ``child_ghost_rate
    [..., N, H*W]`` holds the frozen renders of the stars the merge dropped
    and enters the child rate only at ``init_rates``.
    """

    prior: Any
    model: Any
    image: torch.Tensor
    temperature: torch.Tensor
    child_model: Optional[Any] = None
    child_side_mask: Optional[Any] = None
    child_slot_side: Optional[torch.Tensor] = None
    child_ghost_rate: Optional[torch.Tensor] = None

    @property
    def image_flat(self):
        return self.image.reshape(self.image.shape[:-2] + (-1,))

    def _side_window(self, side):
        """Child pixel window ``[..., H*W]`` of stars with origin tags
        ``side [...]``."""
        return mh_sweep.side_window(self.child_side_mask, self.model, side)

    def star_images(self, loc, side=None):
        """Unit-flux renders of one star at ``loc [..., 2]``: ``(parent
        [..., H*W], child [..., H*W] or None)``; the child render is the
        parent render masked to the star's child window."""
        img = self.model.star_image_flat(loc)
        if self.child_model is None:
            return img, None
        if self.child_slot_side is not None:
            if side is None:
                raise ValueError(
                    "origin-side child context requires the slot side")
            return img, img * self._side_window(side)
        return img, img * self.child_side_mask(loc)

    def init_rates(self, locs, fluxes):
        """Full renders seeding the incremental caches, accumulated slot by
        slot: ``(rate, child_rate or None)``. The ghost rate seeds the child
        rate. ``background`` is a scalar or a per-tile map whose trailing
        ``[H, W]`` dims are flattened to match the flat-pixel rates."""
        model = self.model
        eff = model.adu_per_nmgy * fluxes
        bg = model.background
        if bg.ndim >= 2:
            bg = bg.reshape(bg.shape[:-2] + (-1,))
        rate = torch.zeros(fluxes.shape[:-1] + (model.height * model.width,),
                           dtype=torch.float32, device=fluxes.device)
        child = None
        if self.child_model is not None:
            child = rate if self.child_ghost_rate is None else (
                rate + self.child_ghost_rate)
        for m in range(fluxes.shape[-1]):
            side = (None if self.child_slot_side is None
                    else self.child_slot_side[..., m])
            img, child_img = self.star_images(locs[..., m, :], side)
            rate = rate + eff[..., m, None] * img
            if child is not None:
                child = child + eff[..., m, None] * child_img
        return rate + bg, None if child is None else child + bg

    def loglik(self, rate):
        return self.model.loglikelihood_from_rate_flat(self.image_flat, rate)

    def loglik_terms(self, rate, child_rate):
        """``(parent_ll, child_ll or None)`` from flat-pixel rates."""
        if self.child_model is None:
            return self.loglik(rate), None
        child = self.child_model.loglikelihood_from_rate_flat(
            self.image_flat, child_rate)
        return self.loglik(rate), child

    def combine(self, logprior, parent_ll, child_ll):
        """Tempered log-target from its cached pieces."""
        if self.child_model is None:
            return logprior + self.temperature * parent_ll
        return (logprior + self.temperature * parent_ll
                + (1.0 - self.temperature) * child_ll)

    def child_term(self, state, counts_shape):
        """The child term of ``state`` for ``mh_sweep`` (None for the tile
        target), its tags broadcast to ``counts_shape + (M,)``."""
        if self.child_model is None:
            return None
        tags = self.child_slot_side
        if tags is not None:
            tags = torch.broadcast_to(tags, tuple(counts_shape)
                                      + (state.fluxes.shape[-1],))
        mask = self.child_side_mask
        return mh_sweep.ChildTerm(state.child_rate, state.child_ll, tags,
                                  mask.axis, mask.boundary)


class KernelState(NamedTuple):
    """Cached quantities carried across sweeps (the child pair is None for
    the tile target)."""

    locs: torch.Tensor  # [..., N, M, 2]
    fluxes: torch.Tensor  # [..., N, M]
    rate: torch.Tensor  # [..., N, H*W]
    parent_ll: torch.Tensor  # [..., N]
    logprior: torch.Tensor  # [..., N]
    child_rate: Optional[torch.Tensor] = None  # [..., N, H*W]
    child_ll: Optional[torch.Tensor] = None  # [..., N]


def init_kernel_state(ctx: TargetContext, counts, locs, fluxes) -> KernelState:
    rate, child_rate = ctx.init_rates(locs, fluxes)
    parent_ll, child_ll = ctx.loglik_terms(rate, child_rate)
    return KernelState(
        locs=locs,
        fluxes=fluxes,
        rate=rate,
        parent_ll=parent_ll,
        logprior=ctx.prior.log_prob(counts, locs, fluxes),
        child_rate=child_rate,
        child_ll=child_ll,
    )


def _effective_flux_floor(kernel_fluxes_min, prior):
    """Proposal truncation floor clamped into the flux prior's support, so
    a proposal never lands where the prior log-density is infinite."""
    lo = torch.as_tensor(kernel_fluxes_min, dtype=torch.float32,
                         device=prior.device)
    if prior.flux is not None:
        lo = torch.maximum(lo, prior.flux.support_lower)
    return lo


class SingleComponentMH:
    """Random-walk single-component Metropolis-Hastings.

    ``backend="auto"`` sends CUDA tensors to kernel K1, K2 or, on the
    aggregation bridge target, K3 (``mh_sweep.sweep_kernel``; raising for a
    target none covers) and CPU tensors to the plain version;
    ``backend="torch"`` always runs the plain version, which is how the
    kernel is compared with it on the card.
    """

    def __init__(self, num_iters, locs_stdev=0.1, fluxes_stdev=1.0,
                 fluxes_min=0.0, fluxes_max=1e6, backend="auto",
                 sqjumpdist_tol=None, device="cuda"):
        if backend not in ("auto", "torch"):
            raise ValueError(f"backend must be 'auto' or 'torch', got "
                             f"{backend!r}")
        if sqjumpdist_tol is not None:
            raise NotImplementedError(
                "sqjumpdist_tol early stopping is not ported yet"
            )

        def t(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        self.num_iters = int(num_iters)
        self.locs_stdev = t(locs_stdev)
        self.fluxes_stdev = t(fluxes_stdev)
        self.fluxes_min = t(fluxes_min)
        self.fluxes_max = t(fluxes_max)
        self.backend = backend

    def proposal(self, prior) -> MHProposal:
        return MHProposal(
            locs_stdev=self.locs_stdev,
            fluxes_stdev=self.fluxes_stdev,
            flux_lo=_effective_flux_floor(self.fluxes_min, prior),
            flux_hi=self.fluxes_max,
        )

    def sweep(self, generator, ctx: TargetContext, counts,
              state: KernelState, uniforms=None):
        """One sweep. ``uniforms = (u_j, u_loc, u_f, u_acc)`` replaces the
        draws from ``generator`` (in that order)."""
        if uniforms is None:
            shape = counts.shape
            dev = counts.device
            uniforms = tuple(
                torch.rand(s, generator=generator, device=dev)
                for s in (shape, shape + (2,), shape, shape)
            )
        out = mh_sweep.sweep_with_uniforms(
            *uniforms, prior=ctx.prior, model=ctx.model,
            proposal=self.proposal(ctx.prior), image_flat=ctx.image_flat,
            temperature=ctx.temperature, counts=counts, locs=state.locs,
            fluxes=state.fluxes, rate=state.rate, pll=state.parent_ll,
            lp=state.logprior, child=ctx.child_term(state, counts.shape),
        )
        return KernelState(*out[:5], *out[6:]), out[5]

    def run(self, generator, ctx: TargetContext, counts, locs, fluxes):
        state = init_kernel_state(ctx, counts, locs, fluxes)
        return self.run_from_state(generator, ctx, counts, state)

    def run_from_state(self, generator, ctx: TargetContext, counts,
                       state: KernelState):
        """``num_iters`` sweeps from caller-provided caches. Draws one
        64-bit Philox key from ``generator`` and returns the final state and
        the acceptance rate averaged over sweeps and particles
        (``[...]`` = the batch shape without N)."""
        run = (mh_sweep.mh_sweeps_reference if self.backend == "torch"
               else mh_sweep.mh_sweeps)
        return _run_fused(run, self.proposal(ctx.prior), self.num_iters,
                          generator, ctx, counts, state)


def _run_fused(run, proposal, num_iters, generator, ctx: TargetContext,
               counts, state: KernelState):
    """``run`` (a fused sweep loop of ``ops/``, or its plain version) over
    the state flattened to the kernels' ``[G, N, ...]`` layouts, on one
    64-bit Philox key drawn from ``generator``; returns the final state and
    the acceptance rate averaged over sweeps and particles."""
    batch = counts.shape
    N = batch[-1]
    G = counts.numel() // N
    model = ctx.model
    HW = model.height * model.width
    M = state.fluxes.shape[-1]
    dev = counts.device
    key = torch.randint(0, 2**32, (2,), generator=generator, device=dev,
                        dtype=torch.int64)
    # one image and one temperature per group (the particle axis of both
    # is broadcast)
    image = torch.broadcast_to(ctx.image_flat, batch + (HW,))[..., 0, :]
    temperature = torch.broadcast_to(
        torch.as_tensor(ctx.temperature, dtype=torch.float32, device=dev),
        batch,
    )[..., 0]
    child = ctx.child_term(state, batch)
    if child is not None:
        child = child._replace(
            rate=child.rate.reshape(G, N, HW).contiguous(),
            ll=child.ll.reshape(G, N).contiguous(),
            slot_side=None if child.slot_side is None
            else child.slot_side.reshape(G, N, M).contiguous())
    args = (
        key, proposal, ctx.prior, model,
        image.reshape(G, HW).contiguous(),
        temperature.reshape(G).contiguous(),
        counts.reshape(G, N).to(torch.int32).contiguous(),
        state.locs.reshape(G, N, M, 2).contiguous(),
        state.fluxes.reshape(G, N, M).contiguous(),
        state.rate.reshape(G, N, HW).contiguous(),
        state.parent_ll.reshape(G, N).contiguous(),
        state.logprior.reshape(G, N).contiguous(),
        num_iters,
    )
    locs, fluxes, rate, pll, lp, acc, *child_out = run(*args, child=child)
    new_state = KernelState(
        locs=locs.reshape(state.locs.shape),
        fluxes=fluxes.reshape(state.fluxes.shape),
        rate=rate.reshape(state.rate.shape),
        parent_ll=pll.reshape(batch),
        logprior=lp.reshape(batch),
        child_rate=None if child is None
        else child_out[0].reshape(state.child_rate.shape),
        child_ll=None if child is None else child_out[1].reshape(batch),
    )
    return new_state, acc.reshape(batch).mean(-1)


class SingleComponentMALA:
    """Single-component Metropolis-adjusted Langevin (port of
    ``smcdet_tpu/inference/kernels.py:SingleComponentMALA``): truncated-
    normal proposals around the drifted means ``x + step^2 / 2 * grad log
    target``, accepted with the ratio that carries both proposal densities.

    ``sweep`` is the eager version: its gradient is ``torch.autograd.grad``
    of the summed slot target, as the reference takes ``jax.grad``. It runs
    on any device and is the reference for the statistics.
    ``run_from_state`` runs the fused loop with the closed-form gradient:
    ``backend="auto"`` sends CUDA tensors to kernel K4
    (``ops/mala_sweep.py``, raising for a shape K4 is not built for) and CPU
    tensors to its plain version; ``backend="torch"`` always runs the plain
    version.
    """

    def __init__(self, num_iters, locs_step=0.05, fluxes_step=1.0,
                 fluxes_min=0.0, fluxes_max=1e6, backend="auto",
                 sqjumpdist_tol=None, device="cuda"):
        if backend not in ("auto", "torch"):
            raise ValueError(f"backend must be 'auto' or 'torch', got "
                             f"{backend!r}")
        if sqjumpdist_tol is not None:
            raise NotImplementedError(
                "sqjumpdist_tol early stopping is not ported yet"
            )

        def t(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        self.num_iters = int(num_iters)
        self.locs_step = t(locs_step)
        self.fluxes_step = t(fluxes_step)
        self.fluxes_min = t(fluxes_min)
        self.fluxes_max = t(fluxes_max)
        self.backend = backend

    def proposal(self, prior) -> MHProposal:
        """The step sizes and flux bounds, in the fields the kernels read
        for the proposal scales."""
        return MHProposal(
            locs_stdev=self.locs_step,
            fluxes_stdev=self.fluxes_step,
            flux_lo=_effective_flux_floor(self.fluxes_min, prior),
            flux_hi=self.fluxes_max,
        )

    def _slot_target(self, ctx, base, active, loc, f, side=None):
        """Tempered log-target as a function of slot ``j``'s location and
        flux; ``base`` carries the slot-removed caches. Returns the summed
        target and ``(target, caches)``."""
        rate_wo, child_rate_wo, logprior_wo = base
        eff = ctx.model.adu_per_nmgy
        parent, child = ctx.star_images(loc, side)
        a = active[..., None]
        rate = rate_wo + torch.where(a, eff * f[..., None] * parent, 0.0)
        child_rate = None if child_rate_wo is None else (
            child_rate_wo + torch.where(a, eff * f[..., None] * child, 0.0))
        parent_ll, child_ll = ctx.loglik_terms(rate, child_rate)
        flux = ctx.prior.flux
        logprior = logprior_wo
        if flux is not None:
            # log_prob at the reference point where inactive, so that the
            # unselected branch's gradient is finite (0 * inf is NaN)
            safe = torch.where(active, f, flux.reference_point)
            logprior = logprior_wo + torch.where(active, flux.log_prob(safe),
                                                 0.0)
        target = ctx.combine(logprior, parent_ll, child_ll)
        return target.sum(), (target, (rate, child_rate, parent_ll,
                                       child_ll, logprior))

    def slot_grad(self, ctx, base, active, loc, f, side=None):
        """``(grad_loc, grad_f, target, caches)`` of ``_slot_target`` at
        ``(loc, f)``, the gradient by ``torch.autograd.grad``."""
        loc = loc.detach().requires_grad_(True)
        f = f.detach().requires_grad_(True)
        with torch.enable_grad():
            total, (target, caches) = self._slot_target(ctx, base, active,
                                                        loc, f, side)
            gl, gf = torch.autograd.grad(total, (loc, f))
        return gl, gf, target.detach(), tuple(
            None if c is None else c.detach() for c in caches)

    def propose(self, ctx: TargetContext, counts, state: KernelState, u_j,
                u_loc, u_f) -> mala_sweep.MALAProposal:
        """The eager sweep's proposals and log acceptance ratios given its
        uniforms (``kernels.py:973-1059`` of the reference)."""
        prior = ctx.prior
        onehot, active, loc_j, f_j = mh_sweep.select_slot(
            u_j, counts, state.locs, state.fluxes)
        side_j = None
        if ctx.child_slot_side is not None:
            tags = torch.broadcast_to(ctx.child_slot_side, onehot.shape)
            side_j = (tags * onehot).sum(-1)

        # remove slot j from the caches once; the rest is a function of the
        # slot's parameters only
        eff = ctx.model.adu_per_nmgy
        old, old_child = ctx.star_images(loc_j, side_j)
        a = active[..., None]
        rate_wo = state.rate - torch.where(a, eff * f_j[..., None] * old, 0.0)
        child_rate_wo = None if state.child_rate is None else (
            state.child_rate
            - torch.where(a, eff * f_j[..., None] * old_child, 0.0))
        logprior_wo = state.logprior
        if prior.flux is not None:
            safe = torch.where(active, f_j, prior.flux.reference_point)
            logprior_wo = state.logprior - torch.where(
                active, prior.flux.log_prob(safe), 0.0)
        base = (rate_wo, child_rate_wo, logprior_wo)

        p = self.proposal(prior)
        lo, hi = prior.loc_low, prior.loc_high
        half_ls2 = 0.5 * self.locs_step**2
        half_fs2 = 0.5 * self.fluxes_step**2
        gl, gf, target_old, _ = self.slot_grad(ctx, base, active, loc_j, f_j,
                                               side_j)
        loc_qmean = loc_j + half_ls2 * gl
        f_qmean = f_j + half_fs2 * gf
        loc_prop = truncated_normal_sample(loc_qmean, self.locs_step, lo, hi,
                                           u=u_loc)
        f_prop = truncated_normal_sample(f_qmean, self.fluxes_step, p.flux_lo,
                                         p.flux_hi, u=u_f)
        glp, gfp, target_new, caches = self.slot_grad(
            ctx, base, active, loc_prop, f_prop, side_j)
        loc_qmean_rev = loc_prop + half_ls2 * glp
        f_qmean_rev = f_prop + half_fs2 * gfp

        log_q_fwd = truncated_normal_log_prob(
            loc_prop, loc_qmean, self.locs_step, lo, hi).sum(-1) + (
            truncated_normal_log_prob(f_prop, f_qmean, self.fluxes_step,
                                      p.flux_lo, p.flux_hi))
        log_q_rev = truncated_normal_log_prob(
            loc_j, loc_qmean_rev, self.locs_step, lo, hi).sum(-1) + (
            truncated_normal_log_prob(f_j, f_qmean_rev, self.fluxes_step,
                                      p.flux_lo, p.flux_hi))
        log_alpha = (target_new + log_q_rev) - (target_old + log_q_fwd)
        rate_new, child_rate_new, pll_new, cll_new, lp_new = caches
        return mala_sweep.MALAProposal(
            onehot, active, loc_j, f_j, loc_qmean, f_qmean, loc_prop, f_prop,
            loc_qmean_rev, f_qmean_rev, log_alpha, rate_new, pll_new, lp_new,
            child_rate_new, cll_new)

    def sweep(self, generator, ctx: TargetContext, counts,
              state: KernelState, uniforms=None):
        """One eager sweep. ``uniforms = (u_j, u_loc, u_f, u_acc)`` replaces
        the draws from ``generator`` (in that order, the order of the
        reference's keys). Returns ``(state, applied)``."""
        if uniforms is None:
            shape = counts.shape
            dev = counts.device
            uniforms = tuple(
                torch.rand(s, generator=generator, device=dev)
                for s in (shape, shape + (2,), shape, shape)
            )
        u_j, u_loc, u_f, u_acc = uniforms
        q = self.propose(ctx, counts, state, u_j, u_loc, u_f)
        out = mala_sweep.accept(q, u_acc, state.locs, state.fluxes,
                                state.rate, state.parent_ll, state.logprior,
                                state.child_rate, state.child_ll)
        return KernelState(*out[:5], *out[6:]), out[5]

    def run(self, generator, ctx: TargetContext, counts, locs, fluxes):
        state = init_kernel_state(ctx, counts, locs, fluxes)
        return self.run_from_state(generator, ctx, counts, state)

    def run_from_state(self, generator, ctx: TargetContext, counts,
                       state: KernelState):
        """``num_iters`` fused sweeps from caller-provided caches (see
        ``SingleComponentMH.run_from_state``)."""
        run = (mala_sweep.mala_sweeps_reference if self.backend == "torch"
               else mala_sweep.mala_sweeps)
        return _run_fused(run, self.proposal(ctx.prior), self.num_iters,
                          generator, ctx, counts, state)


def relocate_sweep(ctx: TargetContext, counts, state: KernelState, u_j,
                   u_loc, f_prop, u_acc):
    """One independence (prior-draw) relocation sweep given its draws.

    Slot ``j`` (uniform over the occupied prefix, from ``u_j [..., N]``)
    gets a location uniform over the padded box (``u_loc [..., N, 2]``) and
    the flux ``f_prop [..., N]`` drawn from the prior's flux mark (ignored
    when the prior has none). Proposal density and prior terms cancel, so
    the acceptance ratio is the tempered likelihood-term ratio (both terms
    on the bridge target); counts never change. Accepted where ``u_acc <=
    alpha``. Returns ``(state, applied)``.
    """
    prior, model = ctx.prior, ctx.model
    onehot, active, loc_j, f_j = mh_sweep.select_slot(u_j, counts,
                                                      state.locs,
                                                      state.fluxes)

    loc_prop = prior.loc_low + (prior.loc_high - prior.loc_low) * u_loc
    if prior.flux is None:
        f_prop = f_j
    side_j = None
    if ctx.child_slot_side is not None:
        tags = torch.broadcast_to(ctx.child_slot_side, onehot.shape)
        side_j = (tags * onehot).sum(-1)
    old, old_child = ctx.star_images(loc_j, side_j)
    new, new_child = ctx.star_images(loc_prop, side_j)
    a = active[..., None]
    eff = model.adu_per_nmgy
    d = eff * (f_prop[..., None] * new - f_j[..., None] * old)
    rate_prop = state.rate + torch.where(a, d, 0.0)
    child_rate_prop = None
    if state.child_rate is not None:
        dc = eff * (f_prop[..., None] * new_child
                    - f_j[..., None] * old_child)
        child_rate_prop = state.child_rate + torch.where(a, dc, 0.0)
    pll_prop, cll_prop = ctx.loglik_terms(rate_prop, child_rate_prop)
    delta = mh_sweep.flux_prior_delta(prior, active, f_j, f_prop)
    lp_prop = state.logprior + delta

    log_alpha = (ctx.combine(lp_prop, pll_prop, cll_prop)
                 - ctx.combine(state.logprior, state.parent_ll,
                               state.child_ll) - delta)
    applied = active & (u_acc <= torch.exp(torch.clamp(log_alpha, max=0.0)))

    sel = onehot & applied[..., None]
    ap = applied[..., None]
    return KernelState(
        locs=torch.where(sel[..., None], loc_prop[..., None, :], state.locs),
        fluxes=torch.where(sel, f_prop[..., None], state.fluxes),
        rate=torch.where(ap, rate_prop, state.rate),
        parent_ll=torch.where(applied, pll_prop, state.parent_ll),
        logprior=torch.where(applied, lp_prop, state.logprior),
        child_rate=None if child_rate_prop is None
        else torch.where(ap, child_rate_prop, state.child_rate),
        child_ll=None if cll_prop is None
        else torch.where(applied, cll_prop, state.child_ll),
    ), applied


def relocate_sweeps(generator, ctx: TargetContext, counts,
                    state: KernelState, num_sweeps: int):
    """``num_sweeps`` relocation sweeps (port of
    ``smcdet_tpu/inference/kernels.py:relocate_sweeps``), plain PyTorch as
    in the JAX package, which runs them outside its Pallas kernel. Each
    sweep draws ``u_j``, ``u_loc``, the prior flux and ``u_acc`` from
    ``generator`` in that order. Returns the state and the applied
    fraction averaged over sweeps and particles (``[...]`` = ``counts``'
    shape without N)."""
    shape = counts.shape
    dev = counts.device
    flux = ctx.prior.flux
    applied_sum = torch.zeros(shape, dtype=torch.float32, device=dev)
    for _ in range(num_sweeps):
        u_j = torch.rand(shape, generator=generator, device=dev)
        u_loc = torch.rand(shape + (2,), generator=generator, device=dev)
        f_prop = None if flux is None else flux.sample(shape, generator)
        u_acc = torch.rand(shape, generator=generator, device=dev)
        state, applied = relocate_sweep(ctx, counts, state, u_j, u_loc,
                                        f_prop, u_acc)
        applied_sum = applied_sum + applied.to(torch.float32)
    return state, (applied_sum / num_sweeps).mean(-1)
