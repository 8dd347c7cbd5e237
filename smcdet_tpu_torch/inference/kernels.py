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
    beta_log_prob,
    beta_sample,
    gumbel_sample,
    truncated_normal_log_prob,
    truncated_normal_sample,
)
from smcdet_tpu_torch.ops import mala_sweep, mh_sweep
from smcdet_tpu_torch.ops.mh_sweep import MHProposal

__all__ = [
    "TargetContext",
    "KernelState",
    "early_stop_sweeps",
    "SingleComponentMALA",
    "SingleComponentMH",
    "init_kernel_state",
    "PairProposal",
    "pair_propose",
    "pair_redistribute_sweep",
    "pair_redistribute_sweeps",
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
    aggregation bridge target, K3, and at any other tile shape or slot
    count to K2g or K3g (``mh_sweep.sweep_kernel``; raising for a target
    none covers) and CPU tensors to the plain version;
    ``backend="torch"`` always runs the plain version, which is how the
    kernel is compared with it on the card. ``sqjumpdist_tol`` stops a
    mutation's sweeps early (``early_stop_sweeps``): one launch a sweep.
    """

    def __init__(self, num_iters, locs_stdev=0.1, fluxes_stdev=1.0,
                 fluxes_min=0.0, fluxes_max=1e6, backend="auto",
                 sqjumpdist_tol=None, device="cuda"):
        if backend not in ("auto", "torch"):
            raise ValueError(f"backend must be 'auto' or 'torch', got "
                             f"{backend!r}")

        def t(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        self.num_iters = int(num_iters)
        self.locs_stdev = t(locs_stdev)
        self.fluxes_stdev = t(fluxes_stdev)
        self.fluxes_min = t(fluxes_min)
        self.fluxes_max = t(fluxes_max)
        self.backend = backend
        # stop sweeping once a sweep's batch-mean squared location jump
        # falls below this (None: always num_iters sweeps)
        self.sqjumpdist_tol = sqjumpdist_tol

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
        (``[...]`` = the batch shape without N). With ``sqjumpdist_tol``
        set, a key a sweep (``early_stop_sweeps``)."""
        run = (mh_sweep.mh_sweeps_reference if self.backend == "torch"
               else mh_sweep.mh_sweeps)
        return _run_fused(run, self.proposal(ctx.prior), self.num_iters,
                          generator, ctx, counts, state,
                          self.sqjumpdist_tol)


def _run_fused(run, proposal, num_iters, generator, ctx: TargetContext,
               counts, state: KernelState, sqjumpdist_tol=None):
    """``run`` (a fused sweep loop of ``ops/``, or its plain version) over
    the state flattened to the kernels' ``[G, N, ...]`` layouts; returns
    the final state and the acceptance rate averaged over sweeps and
    particles. ``num_iters`` sweeps on one 64-bit Philox key drawn from
    ``generator``, or with ``sqjumpdist_tol`` one sweep a call, each on a
    key of its own, until ``early_stop_sweeps`` stops."""
    if sqjumpdist_tol is None:
        state, acc = _fused_sweeps(run, proposal, num_iters, generator, ctx,
                                   counts, state)
        return state, acc.mean(-1)

    def sweep(_, st):
        return _fused_sweeps(run, proposal, 1, generator, ctx, counts, st)

    state, acc_rate, _ = early_stop_sweeps(sweep, state, num_iters,
                                           sqjumpdist_tol)
    return state, acc_rate


def early_stop_sweeps(sweep, state: KernelState, num_iters: int, tol):
    """Sweep until the batch-mean squared location jump of a sweep falls
    below ``tol``, at most ``num_iters`` sweeps (the JAX package's
    ``_run_sweeps_early_stop``: rejected proposals jump 0, so the statistic
    is the accepted moves' mixing speed). ``sweep(i, state)`` runs sweep
    ``i`` and returns ``(state, applied [..., N])``. The statistic is
    formed on the tensors' device and read to the host once a sweep.
    Returns the state, the applied fraction averaged over the sweeps run
    and the particles (``[...]``), and the number of sweeps run."""
    acc = torch.zeros(state.fluxes.shape[:-1], dtype=torch.float32,
                      device=state.fluxes.device)
    done = 0
    while done < num_iters:
        new, applied = sweep(done, state)
        sqjd = ((new.locs - state.locs) ** 2).sum((-1, -2)).mean()
        acc = acc + applied.to(torch.float32)
        state, done = new, done + 1
        if not float(sqjd) >= tol:  # a NaN statistic stops, as in JAX
            break
    return state, (acc / max(done, 1)).mean(-1), done


def _fused_sweeps(run, proposal, num_iters, generator, ctx: TargetContext,
                  counts, state: KernelState):
    """``num_iters`` sweeps of ``run`` on one key drawn from
    ``generator``; returns the final state and the applied fraction of
    each particle (``counts``' shape)."""
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
    return new_state, acc.reshape(batch)


class SingleComponentMALA:
    """Single-component Metropolis-adjusted Langevin (port of
    ``smcdet_tpu/inference/kernels.py:SingleComponentMALA``): truncated-
    normal proposals around the drifted means ``x + step^2 / 2 * grad log
    target``, accepted with the ratio that carries both proposal densities.

    ``sweep`` is the eager version: its gradient is ``torch.autograd.grad``
    of the summed slot target, as the reference takes ``jax.grad``. It runs
    on any device and is the reference for the statistics.
    ``run_from_state`` runs the fused loop with the closed-form gradient:
    ``backend="auto"`` sends CUDA tensors to kernel K4, or K4g at a shape
    K4 is not built for (``ops/mala_sweep.py:mala_kernel``), and CPU
    tensors to its plain version; ``backend="torch"`` always runs the plain
    version.
    """

    def __init__(self, num_iters, locs_step=0.05, fluxes_step=1.0,
                 fluxes_min=0.0, fluxes_max=1e6, backend="auto",
                 sqjumpdist_tol=None, device="cuda"):
        if backend not in ("auto", "torch"):
            raise ValueError(f"backend must be 'auto' or 'torch', got "
                             f"{backend!r}")

        def t(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        self.num_iters = int(num_iters)
        self.locs_step = t(locs_step)
        self.fluxes_step = t(fluxes_step)
        self.fluxes_min = t(fluxes_min)
        self.fluxes_max = t(fluxes_max)
        self.backend = backend
        # stop sweeping once a sweep's batch-mean squared location jump
        # falls below this (None: always num_iters sweeps)
        self.sqjumpdist_tol = sqjumpdist_tol

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
                          generator, ctx, counts, state,
                          self.sqjumpdist_tol)


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


def _flux_support(prior):
    """(lower, upper) bounds of the flux mark's support (+-inf when there
    is no flux mark); they gate the moves that build fluxes arithmetically
    instead of drawing them from the prior."""
    if prior.flux is None:
        inf = torch.tensor(float("inf"), device=prior.device)
        return -inf, inf
    return prior.flux.support_lower, prior.flux.support_upper


def _take_slot(values, onehot):
    """Slot ``onehot [..., N, M]`` of ``values [..., N, M, *ev]`` as a
    masked sum (0 where ``onehot`` selects no slot)."""
    ev = values.ndim - onehot.ndim
    oh = onehot.reshape(onehot.shape + (1,) * ev)
    return (values * oh).sum(onehot.ndim - 1)


def _apply_slot_update(values, onehot, new_slot, apply):
    """``new_slot [..., N, *ev]`` written into the one-hot slot where
    ``apply [..., N]``."""
    ev = values.ndim - onehot.ndim
    sel = (onehot & apply[..., None]).reshape(onehot.shape + (1,) * ev)
    return torch.where(sel, new_slot.unsqueeze(onehot.ndim - 1), values)


class PairProposal(NamedTuple):
    """A pair-redistribute proposal per particle: the two slots, their new
    locations and fluxes, whether the split is valid, its log acceptance
    ratio and the proposed caches."""

    onehot_i: torch.Tensor  # [..., N, M]
    onehot_j: torch.Tensor  # [..., N, M]
    loc_i: torch.Tensor  # [..., N, 2]
    loc_j: torch.Tensor  # [..., N, 2]
    f_i: torch.Tensor  # [..., N]
    f_j: torch.Tensor  # [..., N]
    valid: torch.Tensor  # [..., N]
    log_alpha: torch.Tensor  # [..., N]
    rate: torch.Tensor  # [..., N, H*W]
    parent_ll: torch.Tensor  # [..., N]
    logprior: torch.Tensor  # [..., N]
    child_rate: Optional[torch.Tensor]
    child_ll: Optional[torch.Tensor]


def pair_propose(ctx: TargetContext, counts, state: KernelState, u_i, g, u,
                 d, *, select_scale=2.0, displace_scale=1.0,
                 flux_conc=1.0) -> PairProposal:
    """The proposal of one coordinated two-star sweep given its draws (port
    of the sweep body of
    ``smcdet_tpu/inference/kernels.py:pair_redistribute_sweeps``).

    Each particle with at least two stars picks slot ``i`` uniformly over
    its occupied prefix (``u_i [..., N]``) and slot ``j`` among the other
    occupied slots by the proximity softmax ``-|l_i - l_k|^2 / (2
    select_scale^2)``, Gumbel-max with the noise ``g [..., N, M]``. The pair
    is merged, keeping the total flux ``f`` and the flux-weighted centroid
    ``c``, and split again with the fraction ``u [..., N]`` (a Beta(a, a)
    draw, ``a = flux_conc``) and the displacement ``d [..., N, 2]`` (an
    N(0, displace_scale^2 I) draw): ``f_i' = u f``, ``f_j' = (1 - u) f``,
    ``l_i' = c + (1 - u) d``, ``l_j' = c - u d``. The map swaps ``(u, d)``
    with the reverse move's auxiliaries ``u* = f_i / f``, ``d* = l_i -
    l_j`` (Jacobian 1), so the acceptance ratio is the tempered target ratio
    times the pair-selection ratio (the reverse one at the proposed
    locations, where ``|l_i' - l_j'| = |d|``) times ``q(u*) q(d*) / q(u)
    q(d)``. A split that leaves the box or the flux support, or a current
    pair with ``u*`` outside (0, 1), is rejected outright. Counts never
    change.
    """
    prior, model = ctx.prior, ctx.model
    eff = model.adu_per_nmgy
    M = state.fluxes.shape[-1]
    dev = counts.device
    flux_lo, flux_hi = _flux_support(prior)
    inv2s2 = 1.0 / (2.0 * float(select_scale) ** 2)
    neg = torch.finfo(torch.float32).min
    slots = torch.arange(M, device=dev)
    occupied = slots < counts[..., None]
    locs, fluxes = state.locs, state.fluxes

    def pair_logits(all_locs, loc_a, exclude):
        """Selection logits from star ``a`` to every other occupied slot."""
        d2 = ((all_locs - loc_a[..., None, :]) ** 2).sum(-1)
        return torch.where(occupied & ~exclude, -d2 * inv2s2, neg)

    active = counts >= 2
    # slot i: uniform over the occupied prefix (-1, no slot, at count 0)
    i = torch.minimum(torch.floor(u_i * counts).to(torch.int64).clamp(min=0),
                      counts.to(torch.int64) - 1)
    onehot_i = slots == i[..., None]
    loc_i = _take_slot(locs, onehot_i)
    f_i = _take_slot(fluxes, onehot_i)

    # slot j: proximity softmax by Gumbel-max
    logits_i = pair_logits(locs, loc_i, onehot_i)
    j = torch.argmax(logits_i + g, dim=-1)
    onehot_j = slots == j[..., None]
    loc_j = _take_slot(locs, onehot_j)
    f_j = _take_slot(fluxes, onehot_j)

    # forward selection log[p(i, j) + p(j, i)] (the 1/n factor cancels):
    # w_ij = w_ji, so log w_ij + log(1/Z_i + 1/Z_j)
    logits_j = pair_logits(locs, loc_j, onehot_j)
    log_z_i = torch.logsumexp(logits_i, dim=-1)
    log_z_j = torch.logsumexp(logits_j, dim=-1)
    log_w = -((loc_i - loc_j) ** 2).sum(-1) * inv2s2
    log_sel_fwd = log_w + torch.logaddexp(-log_z_i, -log_z_j)

    # merge invariants and the fresh split
    f_tot = f_i + f_j
    safe_tot = torch.clamp(f_tot, min=torch.finfo(torch.float32).tiny)
    cent = (f_i[..., None] * loc_i + f_j[..., None] * loc_j) / (
        safe_tot[..., None])
    f_i_new = u * f_tot
    f_j_new = (1.0 - u) * f_tot
    loc_i_new = cent + (1.0 - u)[..., None] * d
    loc_j_new = cent - u[..., None] * d

    # reverse auxiliaries that recover the current pair
    u_star = f_i / safe_tot
    d_star = loc_i - loc_j

    def in_box(loc):
        return ((loc >= prior.loc_low) & (loc <= prior.loc_high)).all(-1)

    valid = (active & (f_tot > 0) & in_box(loc_i_new) & in_box(loc_j_new)
             & (f_i_new >= flux_lo) & (f_i_new <= flux_hi)
             & (f_j_new >= flux_lo) & (f_j_new <= flux_hi)
             & (u_star > 0.0) & (u_star < 1.0))

    # reverse selection at the proposed locations
    always = torch.ones_like(active)
    locs_prop = _apply_slot_update(locs, onehot_i, loc_i_new, always)
    locs_prop = _apply_slot_update(locs_prop, onehot_j, loc_j_new, always)
    log_z_i_rev = torch.logsumexp(
        pair_logits(locs_prop, loc_i_new, onehot_i), dim=-1)
    log_z_j_rev = torch.logsumexp(
        pair_logits(locs_prop, loc_j_new, onehot_j), dim=-1)
    log_w_rev = -(d**2).sum(-1) * inv2s2  # |l_i' - l_j'| = |d|
    log_sel_rev = log_w_rev + torch.logaddexp(-log_z_i_rev, -log_z_j_rev)

    # auxiliary-density ratio (the Jacobian is 1)
    eps = 1e-6
    u_star_safe = torch.where(valid, u_star.clamp(eps, 1 - eps), 0.5)
    u_safe = u.clamp(eps, 1 - eps)
    log_q_aux = (beta_log_prob(u_star_safe, flux_conc)
                 - beta_log_prob(u_safe, flux_conc)
                 + ((d**2).sum(-1) - (d_star**2).sum(-1))
                 / (2.0 * float(displace_scale) ** 2))

    # flux-prior change (the uniform location terms are constant inside
    # the box; a split outside it is invalid)
    if prior.flux is not None:
        ref = prior.flux.reference_point
        lp = prior.flux.log_prob
        sf_i, sf_j, sf_i_new, sf_j_new = (
            torch.where(valid, x, ref) for x in (f_i, f_j, f_i_new, f_j_new))
        lp_delta = torch.where(
            valid, lp(sf_i_new) + lp(sf_j_new) - lp(sf_i) - lp(sf_j), 0.0)
    else:
        lp_delta = torch.zeros_like(f_i)

    # incremental rates: four single-star renders, accumulated one at a
    # time in the reference's order ((+i' + j') - i) - j, so that at most
    # one render is held at once
    side_i = side_j = None
    if ctx.child_slot_side is not None:
        tags = torch.broadcast_to(ctx.child_slot_side, onehot_i.shape)
        side_i = _take_slot(tags, onehot_i)
        side_j = _take_slot(tags, onehot_j)
    def accumulate(acc, sign, term):
        if acc is None:
            return term
        return acc.add_(term) if sign > 0 else acc.sub_(term)

    dparent = dchild = None
    for sign, f, loc, side in ((1, f_i_new, loc_i_new, side_i),
                               (1, f_j_new, loc_j_new, side_j),
                               (-1, f_i, loc_i, side_i),
                               (-1, f_j, loc_j, side_j)):
        img, child_img = ctx.star_images(loc, side)
        dparent = accumulate(dparent, sign, f[..., None] * img)
        if state.child_rate is not None:
            dchild = accumulate(dchild, sign, f[..., None] * child_img)
        del img, child_img
    v = valid[..., None]
    rate_prop = state.rate + torch.where(v, dparent.mul_(eff), 0.0)
    del dparent
    child_rate_prop = None
    if state.child_rate is not None:
        child_rate_prop = state.child_rate + torch.where(
            v, dchild.mul_(eff), 0.0)
        del dchild

    pll_prop, cll_prop = ctx.loglik_terms(rate_prop, child_rate_prop)
    lp_prop = state.logprior + lp_delta
    log_alpha = (ctx.combine(lp_prop, pll_prop, cll_prop)
                 - ctx.combine(state.logprior, state.parent_ll,
                               state.child_ll)
                 + log_sel_rev - log_sel_fwd + log_q_aux)
    return PairProposal(onehot_i, onehot_j, loc_i_new, loc_j_new, f_i_new,
                        f_j_new, valid, log_alpha, rate_prop, pll_prop,
                        lp_prop, child_rate_prop, cll_prop)


def pair_redistribute_sweep(ctx: TargetContext, counts, state: KernelState,
                            u_i, g, u, d, u_acc, **scales):
    """One pair-redistribute sweep given its draws (``pair_propose``'s and
    ``u_acc [..., N]``), accepted where ``u_acc <= alpha``. ``scales``:
    ``select_scale``, ``displace_scale``, ``flux_conc``. Returns ``(state,
    applied)``."""
    q = pair_propose(ctx, counts, state, u_i, g, u, d, **scales)
    applied = q.valid & (u_acc <= torch.exp(torch.clamp(q.log_alpha,
                                                        max=0.0)))
    ap = applied[..., None]
    locs = _apply_slot_update(state.locs, q.onehot_i, q.loc_i, applied)
    locs = _apply_slot_update(locs, q.onehot_j, q.loc_j, applied)
    fluxes = _apply_slot_update(state.fluxes, q.onehot_i, q.f_i, applied)
    fluxes = _apply_slot_update(fluxes, q.onehot_j, q.f_j, applied)
    return KernelState(
        locs=locs,
        fluxes=fluxes,
        rate=torch.where(ap, q.rate, state.rate),
        parent_ll=torch.where(applied, q.parent_ll, state.parent_ll),
        logprior=torch.where(applied, q.logprior, state.logprior),
        child_rate=None if q.child_rate is None
        else torch.where(ap, q.child_rate, state.child_rate),
        child_ll=None if q.child_ll is None
        else torch.where(applied, q.child_ll, state.child_ll),
    ), applied


def pair_redistribute_sweeps(generator, ctx: TargetContext, counts,
                             state: KernelState, num_sweeps: int, *,
                             select_scale=2.0, displace_scale=1.0,
                             flux_conc=1.0):
    """``num_sweeps`` pair-redistribute sweeps (port of
    ``smcdet_tpu/inference/kernels.py:pair_redistribute_sweeps``), plain
    PyTorch as in the JAX package, which runs them outside its Pallas
    kernel. Each sweep draws ``u_i``, the Gumbel noise, the Beta fraction,
    the displacement and ``u_acc`` from ``generator`` in that order (see
    ``pair_redistribute_sweep``). Returns the state and the applied
    fraction averaged over sweeps and particles (``[...]`` = ``counts``'
    shape without N). Every call adds one to ``pair_redistribute_sweeps
    .calls`` and that fraction's mean over ``[...]`` to ``.applied`` (a
    tensor on the state's device; no value is read back)."""
    shape = counts.shape
    dev = counts.device
    M = state.fluxes.shape[-1]
    applied_sum = torch.zeros(shape, dtype=torch.float32, device=dev)
    for _ in range(num_sweeps):
        u_i = torch.rand(shape, generator=generator, device=dev)
        g = gumbel_sample(shape + (M,), generator, dev)
        u = beta_sample(flux_conc, shape, generator, dev)
        d = float(displace_scale) * torch.randn(shape + (2,),
                                                generator=generator,
                                                device=dev)
        u_acc = torch.rand(shape, generator=generator, device=dev)
        state, applied = pair_redistribute_sweep(
            ctx, counts, state, u_i, g, u, d, u_acc,
            select_scale=select_scale, displace_scale=displace_scale,
            flux_conc=flux_conc)
        applied_sum = applied_sum + applied.to(torch.float32)
    share = (applied_sum / num_sweeps).mean(-1)
    pair_redistribute_sweeps.calls += 1
    pair_redistribute_sweeps.applied = (pair_redistribute_sweeps.applied
                                        + share.mean())
    return state, share


pair_redistribute_sweeps.calls = 0
pair_redistribute_sweeps.applied = 0.0
