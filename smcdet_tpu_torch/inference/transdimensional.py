"""Transdimensional SMC: reversible-jump moves over the object count (port
of ``smcdet_tpu/inference/transdimensional.py``).

``BirthDeathMH`` picks one proposal kind per particle and sweep:

- move: the single-component truncated-normal update of
  ``SingleComponentMH`` (its plain sweep);
- birth (count -> count + 1): a new star drawn from the prior marks into
  the first free slot; the mark densities cancel against the proposal,
  leaving the count-pmf ratio, the tempered likelihood ratio and
  ``P_death / (P_birth (n + 1))``;
- death (count -> count - 1): a uniformly chosen star is removed and the
  last active star moves into its slot;
- split (``prob_split > 0``): a star ``(f, l)`` becomes ``(u f, l + (1 - u)
  d)`` and ``((1 - u) f, l - u d)`` with ``u ~ Beta(a, a)`` and ``d ~ N(0,
  split_scale^2 I)``, Jacobian ``f``;
- merge (``prob_merge > 0``): the reverse, a proximity-weighted pair
  becomes one star at the flux-weighted centroid, Jacobian ``1 / f``.

It is plain PyTorch on every device, as the JAX package's is XLA. A sweep
takes its draws explicitly (``TDDraws``, drawn from a generator by
``BirthDeathMH.draws``), so one sweep can be held against JAX's on JAX's
own draws. ``run_tdsmc`` is one likelihood-tempered SMC population whose
particles move across counts with it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from smcdet_tpu_torch.distributions import (
    beta_log_prob,
    beta_sample,
    gumbel_sample,
)
from smcdet_tpu_torch.inference.kernels import (
    KernelState,
    TargetContext,
    _apply_slot_update,
    _flux_support,
    _take_slot,
    init_kernel_state,
)
from smcdet_tpu_torch.ops.catalogs import prune_catalog, slot_mask
from smcdet_tpu_torch.ops.resampling import gather_particles, resample_indices
from smcdet_tpu_torch.ops.tempering import solve_tempering_step

__all__ = ["BirthDeathMH", "TDDraws", "TDKernelState", "TDSMCConfig",
           "TDSMCResult", "run_tdsmc"]


class TDKernelState(NamedTuple):
    counts: torch.Tensor  # [..., N] int32, changed by the jumps
    inner: KernelState


class TDDraws(NamedTuple):
    """The draws of one sweep, per particle ``[..., N]`` unless noted."""

    u_kind: torch.Tensor  # picks the proposal kind
    move: tuple  # (u_j, u_loc [..., N, 2], u_f, u_acc) of the move sweep
    birth_u_loc: torch.Tensor  # [..., N, 2] uniforms of the new location
    birth_flux: Optional[torch.Tensor]  # the new star's prior flux draw
    death_u: torch.Tensor  # picks the star a death removes
    u_acc: torch.Tensor  # the jump's acceptance uniform
    split_u_pick: Optional[torch.Tensor] = None  # the star a split splits
    split_u: Optional[torch.Tensor] = None  # Beta(a, a) flux fraction
    split_d: Optional[torch.Tensor] = None  # [..., N, 2] displacement
    merge_u_pick: Optional[torch.Tensor] = None  # a merge's first star
    merge_g: Optional[torch.Tensor] = None  # [..., N, M] Gumbel noise


def _log(p: float) -> float:
    return math.log(p) if p > 0 else -math.inf


class BirthDeathMH:
    """Reversible-jump birth/death(/split/merge) + single-component move
    kernel (the JAX constructor). Split and merge are computed only when
    ``prob_split`` or ``prob_merge`` is positive."""

    def __init__(self, num_iters, move, prob_birth=0.2, prob_death=0.2,
                 prob_split=0.0, prob_merge=0.0, split_scale=1.0,
                 split_flux_conc=1.0, merge_select_scale=2.0):
        self.num_iters = int(num_iters)
        self.move = move
        self.prob_birth = float(prob_birth)
        self.prob_death = float(prob_death)
        self.prob_split = float(prob_split)
        self.prob_merge = float(prob_merge)
        self.split_scale = float(split_scale)
        self.split_flux_conc = float(split_flux_conc)
        self.merge_select_scale = float(merge_select_scale)

    @property
    def use_split_merge(self) -> bool:
        return self.prob_split > 0.0 or self.prob_merge > 0.0

    def draws(self, generator, prior, counts, M: int) -> TDDraws:
        """One sweep's draws from ``generator``, in ``TDDraws``' field
        order."""
        shape = counts.shape
        dev = counts.device

        def rand(s=shape):
            return torch.rand(s, generator=generator, device=dev)

        u_kind = rand()
        move = (rand(), rand(shape + (2,)), rand(), rand())
        birth_u_loc = rand(shape + (2,))
        birth_flux = (None if prior.flux is None
                      else prior.flux.sample(shape, generator))
        d = TDDraws(u_kind, move, birth_u_loc, birth_flux, rand(), rand())
        if not self.use_split_merge:
            return d
        return d._replace(
            split_u_pick=rand(),
            split_u=beta_sample(self.split_flux_conc, shape, generator, dev),
            split_d=self.split_scale * torch.randn(
                shape + (2,), generator=generator, device=dev),
            merge_u_pick=rand(),
            merge_g=gumbel_sample(shape + (M,), generator, dev))

    def _split_merge(self, ctx: TargetContext, state: TDKernelState,
                     draws: TDDraws) -> dict:
        """Both dimension-matched proposals with all their bookkeeping
        (selection probabilities, the Beta and normal auxiliary densities,
        count-pmf and mark-prior deltas, the Jacobian ``+-log f``); the
        caller's kind mask picks one."""
        prior, model = ctx.prior, ctx.model
        counts, inner = state.counts, state.inner
        locs, fluxes = inner.locs, inner.fluxes
        M = fluxes.shape[-1]
        dev = counts.device
        eff = model.adu_per_nmgy
        flux_lo, flux_hi = _flux_support(prior)
        inv2s2 = 1.0 / (2.0 * self.merge_select_scale**2)
        sig2 = self.split_scale**2
        a_conc = self.split_flux_conc
        neg = torch.finfo(torch.float32).min
        tiny = torch.finfo(torch.float32).tiny
        n_f = torch.clamp(counts, min=1).to(torch.float32)
        slots = torch.arange(M, device=dev)
        occupied = slots < counts[..., None]
        counts64 = counts.to(torch.int64)
        cl = prior.counts.log_prob

        def log_normal2_pdf(d):
            return (-(d**2).sum(-1) / (2.0 * sig2)
                    - math.log(2.0 * math.pi * sig2))

        def in_box(loc):
            return ((loc >= prior.loc_low) & (loc <= prior.loc_high)).all(-1)

        def flux_lp(f, safe_mask):
            if prior.flux is None:
                return torch.zeros_like(f)
            safe = torch.where(safe_mask & (f > 0), f,
                               prior.flux.reference_point)
            return torch.where(safe_mask, prior.flux.log_prob(safe), 0.0)

        def pair_logits(all_locs, loc_a, exclude, occ):
            d2 = ((all_locs - loc_a[..., None, :]) ** 2).sum(-1)
            return torch.where(occ & ~exclude, -d2 * inv2s2, neg)

        def pick(u):  # uniform over the occupied prefix, -1 at count 0
            return torch.minimum(
                torch.floor(u * counts).to(torch.int64).clamp(min=0),
                counts64 - 1)

        log_area = torch.log(prior.loc_high - prior.loc_low).sum()

        # ---------------------------- split ---------------------------
        can_split = (counts >= 1) & (counts < M)
        onehot_k = slots == pick(draws.split_u_pick)[..., None]
        loc_k = _take_slot(locs, onehot_k)
        f_k = _take_slot(fluxes, onehot_k)
        u_s, d_s = draws.split_u, draws.split_d
        f_si = u_s * f_k
        f_sj = (1.0 - u_s) * f_k
        loc_si = loc_k + (1.0 - u_s)[..., None] * d_s
        loc_sj = loc_k - u_s[..., None] * d_s
        slot_new = torch.clamp(counts64, max=M - 1)
        onehot_new = slots == slot_new[..., None]
        valid_split = (can_split & (f_k > 0) & in_box(loc_si)
                       & in_box(loc_sj) & (f_si >= flux_lo)
                       & (f_si <= flux_hi) & (f_sj >= flux_lo)
                       & (f_sj <= flux_hi))
        img_k, _ = ctx.star_images(loc_k)
        img_si, _ = ctx.star_images(loc_si)
        img_sj, _ = ctx.star_images(loc_sj)
        rate_s = inner.rate + torch.where(
            valid_split[..., None],
            eff * (f_si[..., None] * img_si + f_sj[..., None] * img_sj
                   - f_k[..., None] * img_k), 0.0)
        ll_s, _ = ctx.loglik_terms(rate_s, None)
        lp_delta_s = (cl(counts + 1) - cl(counts) - log_area
                      + flux_lp(f_si, valid_split)
                      + flux_lp(f_sj, valid_split)
                      - flux_lp(f_k, valid_split))
        lp_s = inner.logprior + torch.where(valid_split, lp_delta_s, 0.0)
        # the reverse merge's pair selection in the post-split state
        always = torch.ones_like(can_split)
        locs_split = _apply_slot_update(locs, onehot_k, loc_si, always)
        locs_split = _apply_slot_update(locs_split, onehot_new, loc_sj,
                                        always)
        occ_split = slots < (counts + 1)[..., None]
        log_z_rk = torch.logsumexp(
            pair_logits(locs_split, loc_si, onehot_k, occ_split), dim=-1)
        log_z_rn = torch.logsumexp(
            pair_logits(locs_split, loc_sj, onehot_new, occ_split), dim=-1)
        log_w_r = -(d_s**2).sum(-1) * inv2s2
        log_pair_rev = (log_w_r + torch.logaddexp(-log_z_rk, -log_z_rn)
                        - torch.log(n_f + 1.0))
        log_q_fwd_s = (_log(self.prob_split) - torch.log(n_f)
                       + beta_log_prob(u_s, a_conc) + log_normal2_pdf(d_s))
        log_q_rev_s = _log(self.prob_merge) + log_pair_rev
        safe_f_k = torch.where(valid_split, torch.clamp(f_k, min=tiny), 1.0)
        la_split = (ctx.combine(lp_s, ll_s, None)
                    - ctx.combine(inner.logprior, inner.parent_ll, None)
                    + log_q_rev_s - log_q_fwd_s
                    + torch.log(safe_f_k))  # Jacobian

        # ---------------------------- merge ---------------------------
        min_c = max(2, prior.min_objects + 1)
        can_merge = counts >= min_c
        i = pick(draws.merge_u_pick)
        onehot_mi = slots == i[..., None]
        loc_mi = _take_slot(locs, onehot_mi)
        f_mi = _take_slot(fluxes, onehot_mi)
        logits_mi = pair_logits(locs, loc_mi, onehot_mi, occupied)
        j = torch.argmax(logits_mi + draws.merge_g, dim=-1)
        onehot_mj = slots == j[..., None]
        loc_mj = _take_slot(locs, onehot_mj)
        f_mj = _take_slot(fluxes, onehot_mj)
        f_m = f_mi + f_mj
        safe_m = torch.clamp(f_m, min=tiny)
        cent = (f_mi[..., None] * loc_mi
                + f_mj[..., None] * loc_mj) / safe_m[..., None]
        u_star = f_mi / safe_m
        d_star = loc_mi - loc_mj
        valid_merge = (can_merge & (f_m >= flux_lo) & (f_m <= flux_hi)
                       & (u_star > 0.0) & (u_star < 1.0))
        img_mi, _ = ctx.star_images(loc_mi)
        img_mj, _ = ctx.star_images(loc_mj)
        img_c, _ = ctx.star_images(cent)
        rate_m = inner.rate + torch.where(
            valid_merge[..., None],
            eff * (f_m[..., None] * img_c - f_mi[..., None] * img_mi
                   - f_mj[..., None] * img_mj), 0.0)
        ll_m, _ = ctx.loglik_terms(rate_m, None)
        lp_delta_m = (cl(torch.clamp(counts - 1, min=0)) - cl(counts)
                      + log_area + flux_lp(f_m, valid_merge)
                      - flux_lp(f_mi, valid_merge)
                      - flux_lp(f_mj, valid_merge))
        lp_m = inner.logprior + torch.where(valid_merge, lp_delta_m, 0.0)
        log_z_mi = torch.logsumexp(logits_mi, dim=-1)
        log_z_mj = torch.logsumexp(
            pair_logits(locs, loc_mj, onehot_mj, occupied), dim=-1)
        log_w_m = -(d_star**2).sum(-1) * inv2s2
        log_pair_fwd = (log_w_m + torch.logaddexp(-log_z_mi, -log_z_mj)
                        - torch.log(n_f))
        eps = 1e-6
        u_star_safe = torch.where(valid_merge, u_star.clamp(eps, 1 - eps),
                                  0.5)
        log_q_fwd_m = _log(self.prob_merge) + log_pair_fwd
        log_q_rev_m = (_log(self.prob_split) - torch.log(n_f - 1.0)
                       + beta_log_prob(u_star_safe, a_conc)
                       + log_normal2_pdf(d_star))
        la_merge = (ctx.combine(lp_m, ll_m, None)
                    - ctx.combine(inner.logprior, inner.parent_ll, None)
                    + log_q_rev_m - log_q_fwd_m
                    - torch.log(torch.where(valid_merge, safe_m,
                                            1.0)))  # 1/Jacobian
        return {
            "valid_split": valid_split, "la_split": la_split,
            "onehot_k": onehot_k, "onehot_new": onehot_new,
            "loc_si": loc_si, "f_si": f_si, "loc_sj": loc_sj, "f_sj": f_sj,
            "rate_s": rate_s, "ll_s": ll_s, "lp_s": lp_s,
            "valid_merge": valid_merge, "la_merge": la_merge,
            "onehot_mi": onehot_mi, "onehot_mj": onehot_mj, "cent": cent,
            "f_m": f_m, "merge_i": i, "rate_m": rate_m, "ll_m": ll_m,
            "lp_m": lp_m,
        }

    def sweep(self, generator, ctx: TargetContext, state: TDKernelState,
              draws: TDDraws | None = None):
        """One sweep (JAX's ``_sweep``), its draws from ``generator`` unless
        ``draws`` are given. Returns ``(state, applied [..., N])``."""
        prior, model = ctx.prior, ctx.model
        counts, inner = state.counts, state.inner
        locs, fluxes = inner.locs, inner.fluxes
        M = fluxes.shape[-1]
        dev = counts.device
        if draws is None:
            draws = self.draws(generator, prior, counts, M)
        use_sm = self.use_split_merge
        slots = torch.arange(M, device=dev)
        counts64 = counts.to(torch.int64)
        cl = prior.counts.log_prob
        flux = prior.flux

        u_kind = draws.u_kind
        pb, pd = self.prob_birth, self.prob_death
        p_bd = pb + pd
        do_birth = u_kind < pb
        do_death = (u_kind >= pb) & (u_kind < p_bd)
        no = torch.zeros_like(do_birth)
        do_split = (u_kind >= p_bd) & (u_kind < p_bd + self.prob_split) \
            if use_sm else no
        do_merge = ((u_kind >= p_bd + self.prob_split)
                    & (u_kind < p_bd + self.prob_split + self.prob_merge)) \
            if use_sm else no

        # ------------------------- move -------------------------------
        moved, move_applied = self.move.sweep(None, ctx, counts, inner,
                                              uniforms=draws.move)

        # ------------------------- birth ------------------------------
        log_area = torch.log(prior.loc_high - prior.loc_low).sum()
        new_loc = prior.loc_low + (prior.loc_high
                                   - prior.loc_low) * draws.birth_u_loc
        new_flux = (draws.birth_flux if flux is not None
                    else torch.zeros_like(u_kind))
        can_birth = counts < M
        # the new star goes into slot `counts` (the first inactive slot)
        onehot_b = slots == torch.clamp(counts64, max=M - 1)[..., None]
        eff = model.adu_per_nmgy
        birth_img, _ = ctx.star_images(new_loc)
        rate_b = inner.rate + torch.where(
            can_birth[..., None], eff * new_flux[..., None] * birth_img, 0.0)
        ll_b, _ = ctx.loglik_terms(rate_b, None)
        flux_lp_b = flux.log_prob(new_flux) if flux is not None else 0.0
        lp_b = inner.logprior + (cl(counts + 1) - cl(counts) - log_area
                                 + flux_lp_b)
        # q_birth = P_b * prior(mark); the reverse q = P_d / (n + 1)
        log_q_fwd_b = _log(pb) + (flux_lp_b - log_area)
        log_q_rev_b = _log(pd) - torch.log((counts + 1).to(torch.float32))
        target_old = ctx.combine(inner.logprior, inner.parent_ll, None)
        la_birth = (ctx.combine(lp_b, ll_b, None) - target_old
                    + log_q_rev_b - log_q_fwd_b)

        # ------------------------- death ------------------------------
        can_death = counts > prior.min_objects
        pick = torch.minimum(
            torch.floor(draws.death_u * counts.to(torch.float32)).to(
                torch.int64),
            torch.clamp(counts64 - 1, min=0))
        onehot_d = slots == pick[..., None]
        dead_loc = (locs * onehot_d[..., None]).sum(-2)
        dead_flux = (fluxes * onehot_d).sum(-1)
        dead_img, _ = ctx.star_images(dead_loc)
        rate_d = inner.rate - torch.where(
            can_death[..., None], eff * dead_flux[..., None] * dead_img, 0.0)
        ll_d, _ = ctx.loglik_terms(rate_d, None)
        if flux is not None:
            safe_dead = torch.where(can_death & (dead_flux > 0), dead_flux,
                                    flux.reference_point)
            flux_lp_d = flux.log_prob(safe_dead)
        else:
            flux_lp_d = 0.0
        lp_d = inner.logprior + (cl(torch.clamp(counts - 1, min=0))
                                 - cl(counts) + log_area - flux_lp_d)
        log_q_fwd_d = _log(pd) - torch.log(
            torch.clamp(counts, min=1).to(torch.float32))
        log_q_rev_d = _log(pb) + (flux_lp_d - log_area)
        la_death = (ctx.combine(lp_d, ll_d, None) - target_old
                    + log_q_rev_d - log_q_fwd_d)

        sm = self._split_merge(ctx, state, draws) if use_sm else None

        # ------------------------- select + accept --------------------
        u = draws.u_acc

        def accepts(la):
            return u <= torch.exp(torch.clamp(la, max=0.0))

        acc_birth = do_birth & can_birth & accepts(la_birth)
        acc_death = do_death & can_death & accepts(la_death)
        if use_sm:
            acc_split = do_split & sm["valid_split"] & accepts(sm["la_split"])
            acc_merge = do_merge & sm["valid_merge"] & accepts(sm["la_merge"])
        else:
            acc_split = acc_merge = no

        # a birth or death applies to the arrays before the move: its
        # particle did not take the move branch, and its cache deltas are
        # relative to ``inner``
        sel_b = onehot_b & acc_birth[..., None]
        locs1 = torch.where(sel_b[..., None], new_loc[..., None, :], locs)
        fluxes1 = torch.where(sel_b, new_flux[..., None], fluxes)
        # death: the last active star moves into the gap
        onehot_last = slots == torch.clamp(counts64 - 1, min=0)[..., None]
        last_loc = (locs * onehot_last[..., None]).sum(-2)
        last_flux = (fluxes * onehot_last).sum(-1)
        sel_d = onehot_d & acc_death[..., None]
        sel_last = onehot_last & acc_death[..., None]
        locs2 = torch.where(sel_d[..., None], last_loc[..., None, :], locs1)
        locs2 = torch.where(sel_last[..., None], 0.0, locs2)
        fluxes2 = torch.where(sel_d, last_flux[..., None], fluxes1)
        fluxes2 = torch.where(sel_last, 0.0, fluxes2)

        if use_sm:
            # the kind masks are disjoint, so the slot writes stack
            locs2 = _apply_slot_update(locs2, sm["onehot_k"], sm["loc_si"],
                                       acc_split)
            locs2 = _apply_slot_update(locs2, sm["onehot_new"], sm["loc_sj"],
                                       acc_split)
            fluxes2 = _apply_slot_update(fluxes2, sm["onehot_k"], sm["f_si"],
                                         acc_split)
            fluxes2 = _apply_slot_update(fluxes2, sm["onehot_new"],
                                         sm["f_sj"], acc_split)
            # merge: the merged star -> slot i; the last active star fills
            # slot j (the post-write value, so i == last is handled); the
            # last slot is then cleared
            i_is_last = sm["merge_i"] == torch.clamp(counts64 - 1, min=0)
            mlast_loc = torch.where(i_is_last[..., None], sm["cent"],
                                    _take_slot(locs, onehot_last))
            mlast_flux = torch.where(i_is_last, sm["f_m"],
                                     _take_slot(fluxes, onehot_last))
            locs2 = _apply_slot_update(locs2, sm["onehot_mi"], sm["cent"],
                                       acc_merge)
            locs2 = _apply_slot_update(locs2, sm["onehot_mj"], mlast_loc,
                                       acc_merge)
            locs2 = _apply_slot_update(locs2, onehot_last,
                                       torch.zeros_like(mlast_loc),
                                       acc_merge)
            fluxes2 = _apply_slot_update(fluxes2, sm["onehot_mi"], sm["f_m"],
                                         acc_merge)
            fluxes2 = _apply_slot_update(fluxes2, sm["onehot_mj"],
                                         mlast_flux, acc_merge)
            fluxes2 = _apply_slot_update(fluxes2, onehot_last,
                                         torch.zeros_like(mlast_flux),
                                         acc_merge)

        is_move = ~(do_birth | do_death | do_split | do_merge)
        locs_out = torch.where(is_move[..., None, None], moved.locs, locs2)
        fluxes_out = torch.where(is_move[..., None], moved.fluxes, fluxes2)
        counts_out = (counts + acc_birth.to(torch.int32)
                      - acc_death.to(torch.int32)
                      + acc_split.to(torch.int32)
                      - acc_merge.to(torch.int32))

        def pick_cache(b, d, cur, *sm_vals):
            e = (lambda x: x[..., None]) if cur.ndim > u.ndim else (
                lambda x: x)
            out = torch.where(e(acc_birth), b, torch.where(e(acc_death), d,
                                                           cur))
            if use_sm:
                out = torch.where(e(acc_split), sm_vals[0],
                                  torch.where(e(acc_merge), sm_vals[1], out))
            return out

        rate_out = pick_cache(rate_b, rate_d, inner.rate,
                              *((sm["rate_s"], sm["rate_m"]) if use_sm
                                else ()))
        pll_out = pick_cache(ll_b, ll_d, inner.parent_ll,
                             *((sm["ll_s"], sm["ll_m"]) if use_sm else ()))
        lp_out = pick_cache(lp_b, lp_d, inner.logprior,
                            *((sm["lp_s"], sm["lp_m"]) if use_sm else ()))
        rate_out = torch.where(is_move[..., None], moved.rate, rate_out)
        pll_out = torch.where(is_move, moved.parent_ll, pll_out)
        lp_out = torch.where(is_move, moved.logprior, lp_out)
        applied = torch.where(is_move, move_applied,
                              acc_birth | acc_death | acc_split | acc_merge)
        new_inner = KernelState(locs=locs_out, fluxes=fluxes_out,
                                rate=rate_out, parent_ll=pll_out,
                                logprior=lp_out)
        return TDKernelState(counts=counts_out, inner=new_inner), applied

    def run(self, generator, ctx: TargetContext, counts, locs, fluxes):
        """``num_iters`` sweeps from fresh caches; returns the state and the
        last sweep's applied share over particles (``[...]``)."""
        state = TDKernelState(counts=counts,
                              inner=init_kernel_state(ctx, counts, locs,
                                                      fluxes))
        applied = torch.zeros(counts.shape, dtype=torch.bool,
                              device=counts.device)
        for _ in range(self.num_iters):
            state, applied = self.sweep(generator, ctx, state)
        return state, applied.to(torch.float32).mean(-1)


@dataclass
class TDSMCConfig:
    num_particles: int
    ess_threshold_prop: float = 0.5
    resample_method: str = "systematic"
    max_smc_iters: int = 100
    flux_detection_threshold: float = 0.0


class TDSMCResult(NamedTuple):
    counts: torch.Tensor  # [T, N]
    locs: torch.Tensor  # [T, N, M, 2]
    fluxes: torch.Tensor  # [T, N, M]
    pruned_counts: torch.Tensor
    pruned_locs: torch.Tensor
    pruned_fluxes: torch.Tensor
    log_normalizing_constant: torch.Tensor  # [T]
    temperature: torch.Tensor  # [T]
    ess: torch.Tensor  # [T]
    num_iters: int
    acc_rate: torch.Tensor  # [T]


def run_tdsmc(generator, images, prior, model, kernel: BirthDeathMH,
              cfg: TDSMCConfig) -> TDSMCResult:
    """Single-population tempered SMC with transdimensional mutation for
    ``images [T, h, w]``: the count posterior comes from the particles'
    counts. The loop runs on the host, one iteration at a time, while any
    tile is below temperature 1 and under ``max_smc_iters``; finished tiles
    are frozen."""
    T = images.shape[0]
    N = cfg.num_particles
    dev = images.device
    counts, locs, fluxes = prior.sample(generator, N, batch_shape=(T,))
    image = images[:, None]
    loglik = model.loglikelihood(image, locs, fluxes)
    weights = torch.full((T, N), 1.0 / N, device=dev)
    log_z = torch.zeros(T, device=dev)
    temperature = torch.zeros(T, device=dev)
    acc_rate = torch.zeros(T, device=dev)

    def temper_reweight(loglik, temperature, weights, log_z):
        done = temperature >= 1.0
        delta = solve_tempering_step(loglik, temperature,
                                     cfg.ess_threshold_prop * N)
        delta = torch.where(done, 0.0, delta)
        new_t = torch.clamp(temperature + delta, 0.0, 1.0)
        w_log = delta[:, None] * loglik
        m = w_log.max(-1).values
        shifted = torch.exp(w_log - m[:, None])
        s = shifted.sum(-1)
        log_z = log_z + torch.where(done, 0.0, m + torch.log(s / N))
        weights = torch.where(done[:, None], weights, shifted / s[:, None])
        return new_t, weights, log_z

    temperature, weights, log_z = temper_reweight(loglik, temperature,
                                                  weights, log_z)
    it = 0
    while it < cfg.max_smc_iters and bool((temperature < 1.0).any()):
        done = temperature >= 1.0
        keep = done[:, None]
        idx = resample_indices(weights, N, cfg.resample_method,
                               generator=generator)
        c_r, l_r, f_r = gather_particles(idx, counts, locs, fluxes,
                                         particle_axis=1)
        c_r = torch.where(keep, counts, c_r)
        l_r = torch.where(keep[..., None, None], locs, l_r)
        f_r = torch.where(keep[..., None], fluxes, f_r)
        ctx = TargetContext(prior=prior, model=model, image=image,
                            temperature=temperature[:, None])
        td, acc = kernel.run(generator, ctx, c_r, l_r, f_r)
        counts = torch.where(keep, c_r, td.counts)
        locs = torch.where(keep[..., None, None], l_r, td.inner.locs)
        fluxes = torch.where(keep[..., None], f_r, td.inner.fluxes)
        loglik = torch.where(keep, loglik, td.inner.parent_ll)
        weights = torch.where(keep, weights, 1.0 / N)
        acc_rate = torch.where(done, acc_rate, acc)
        it += 1
        temperature, weights, log_z = temper_reweight(loglik, temperature,
                                                      weights, log_z)

    idx = resample_indices(weights, N, cfg.resample_method,
                           generator=generator)
    counts, locs, fluxes = gather_particles(idx, counts, locs, fluxes,
                                            particle_axis=1)
    M = fluxes.shape[-1]
    pruned_counts, pruned_locs, pruned_fluxes = prune_catalog(
        locs, fluxes, height=model.height, width=model.width,
        flux_threshold=cfg.flux_detection_threshold,
        mask=slot_mask(counts, M))
    return TDSMCResult(
        counts=counts, locs=locs, fluxes=fluxes,
        pruned_counts=pruned_counts, pruned_locs=pruned_locs,
        pruned_fluxes=pruned_fluxes, log_normalizing_constant=log_z,
        temperature=temperature, ess=1.0 / (weights**2).sum(-1),
        num_iters=it, acc_rate=acc_rate)
