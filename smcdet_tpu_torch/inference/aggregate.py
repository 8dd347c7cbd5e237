"""Divide-and-conquer aggregation of per-tile posteriors (port of
``smcdet_tpu/inference/aggregate.py``).

The tile posteriors of one image merge up a binary tree: ``2 log2(Th)``
levels, alternating the height and the width axis. Each level resamples
and joins tile pairs (``_merge``), then re-targets every merged pair from
the product of its children's posteriors to the joined tile's posterior
with a tempered-SMC bridge (``_run_level``) whose target is ``logprior +
tau * parent_ll + (1 - tau) * child_ll``. Every particle's stratum is its
count; per-stratum weights, ESS and log normalising constants are masked
reductions over a dense ``[Th, Tw, C, N]`` membership mask.

The bridge loop runs on the host, one ``(temperature < 1).any()`` read per
iteration, like ``run_csmc``; its mutation is the tile stage's kernel,
``SingleComponentMH`` (on a CUDA tensor kernel K3) or ``SingleComponentMALA``
(kernel K4), then plain-PyTorch relocation sweeps,
as the JAX package runs them outside its Pallas kernel. Each stage runs in
a profiler range: ``agg.merge``, ``agg.resample``, ``agg.rerender``,
``agg.mutate``, ``agg.relocate``, ``agg.temper``.

Not ported: the multi-device level sharding (``Aggregate.run(devices=)``
raises).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from smcdet_tpu_torch.inference.kernels import (
    TargetContext,
    init_kernel_state,
    relocate_sweeps,
)
from smcdet_tpu_torch.models.priors import (
    PointProcessPrior,
    PoissonCounts,
    UniformCounts,
)
from smcdet_tpu_torch.ops import mh_sweep
from smcdet_tpu_torch.ops.catalogs import (
    compact_catalog,
    prune_catalog,
    slot_mask,
)
from smcdet_tpu_torch.ops.resampling import (
    gather_particles,
    resample_indices,
    stratified_indices,
)
from smcdet_tpu_torch.ops.tempering import solve_tempering_step

__all__ = ["AggregateConfig", "AggregateState", "Aggregate", "SideMask",
           "expand_prior"]

_NEG = -1e30


@dataclass(frozen=True)
class AggregateConfig:
    ess_threshold_prop: float = 0.5
    resample_method: str = "multinomial"
    flux_detection_threshold: float = 0.0
    max_smc_iters: int = 100
    # cap on the slot axis as it doubles per level (None = no cap); a cap
    # below the children's joint counts truncates real stars
    max_objects_cap: Optional[int] = None
    # prior-draw relocation sweeps appended to each bridge mutation
    relocate_sweeps: int = 8
    # pair-redistribute sweeps are not ported yet
    pair_sweeps: int = 0

    def __post_init__(self):
        if self.pair_sweeps:
            raise NotImplementedError(
                "pair_sweeps is not ported yet (ROADMAP item 7: "
                "pair_redistribute_sweeps)")


class AggregateState(NamedTuple):
    """Particle system at one tree level, grid layout ``[Th, Tw, ...]``."""

    data: torch.Tensor  # [Th, Tw, H, W]
    counts: torch.Tensor  # [Th, Tw, N] int32
    locs: torch.Tensor  # [Th, Tw, N, M, 2]
    fluxes: torch.Tensor  # [Th, Tw, N, M]
    weights: torch.Tensor  # [Th, Tw, N] flat posterior weights
    log_z: torch.Tensor  # [Th, Tw, C] per-count log normalising constant


def expand_prior(prior, new_h, new_w, new_max_objects):
    """The prior of a joined tile: new dims and slot axis; a Poisson count
    rate rescaled with the padded area, a uniform count support grown to
    the new slot axis."""
    counts = prior.counts
    if isinstance(counts, PoissonCounts):
        old_area = (prior.image_height + 2 * prior.pad) * (
            prior.image_width + 2 * prior.pad)
        new_area = (new_h + 2 * prior.pad) * (new_w + 2 * prior.pad)
        counts = PoissonCounts(counts.rate * (new_area / old_area),
                               device=prior.device)
    elif isinstance(counts, UniformCounts):
        counts = UniformCounts(counts.low, new_max_objects)
    return PointProcessPrior(prior.min_objects, new_max_objects, new_h, new_w,
                             pad=prior.pad, counts=counts, flux=prior.flux,
                             device=prior.device)


def _stratum_mask(counts, num_strata: int):
    """``[..., C, N]`` bool: particle n belongs to stratum ``counts[n]``."""
    return counts[..., None, :] == torch.arange(
        num_strata, device=counts.device)[:, None]


def _member_max(x, mask):
    """Masked max over the particle axis (``_NEG`` for an empty stratum)."""
    return torch.where(mask, x[..., None, :], _NEG).max(-1).values


class SideMask(NamedTuple):
    """The child split of a joined tile: a star at ``loc`` belongs to the
    even child iff ``loc[axis] <= boundary``, whose pixels are those with
    ``coord < boundary`` along ``axis``. Called on ``loc [..., 2]``, it
    gives the star's child pixel window ``[..., H*W]``."""

    axis: int
    boundary: int
    height: int
    width: int

    def __call__(self, loc):
        return mh_sweep.location_window(self.axis, self.boundary, self, loc)


def _merge(generator, state: AggregateState, axis: int, dims, M_new: int,
           cfg: AggregateConfig, model_new, idx=None):
    """Resample, drop the sources of the pair overlap, join tile pairs and
    merge the per-count normalising constants. ``idx [Th, Tw, N]`` replaces
    the resample draw.

    Returns the merged state, the per-slot origin tags ``[th, tw, N, M_new]``
    (1 = the even member sampled the star) and the ghost child rate
    ``[th, tw, N, H*W]``: the renders of the dropped stars in their origin
    child's window, so that the bridge's tau = 0 target is exactly the
    product of the children's posteriors."""
    Th, Tw, H, W = dims
    N = state.counts.shape[-1]
    M = state.fluxes.shape[-1]
    C_old = state.log_z.shape[-1]
    dim_axis = H if axis == 0 else W
    dev = state.counts.device

    # 1. resample to uniform weights
    if idx is None:
        idx = resample_indices(state.weights, N, cfg.resample_method,
                               generator=generator)
    counts_r, locs_r, fluxes_r = gather_particles(
        idx, state.counts, state.locs, state.fluxes, particle_axis=2)

    # 2. the even member keeps the sources inside its own region (coord <
    # dim), the odd member those with coord > 0
    active = slot_mask(counts_r, M)
    coord = locs_r[..., axis]
    grid = torch.arange(Th if axis == 0 else Tw, device=dev)
    grid = grid[:, None] if axis == 0 else grid[None, :]
    is_even = (grid % 2 == 0)[..., None, None]  # [Th|1, Tw|1, 1, 1]
    keep = active & torch.where(is_even, coord < dim_axis, coord > 0.0)
    counts_d, locs_d, fluxes_d = compact_catalog(locs_r, fluxes_r, keep)

    # 2b. ghost child rate: each dropped star rendered into its origin
    # child's window, in parent coordinates
    dropped = active & ~keep
    shift = torch.zeros(2, device=dev)
    shift[axis] = float(dim_axis)
    locs_parent = locs_r + torch.where(is_even[..., None], 0.0, 1.0) * shift
    eff = model_new.adu_per_nmgy
    even_pix = mh_sweep.even_pixels(axis, dim_axis, model_new.height,
                                    model_new.width, dev)
    window = torch.where(is_even, even_pix, ~even_pix)  # [..., 1, HW]
    ghost = torch.zeros(counts_r.shape + (model_new.height * model_new.width,),
                        device=dev)
    for m in range(M):
        img = model_new.star_image_flat(locs_parent[..., m, :])
        ghost = ghost + torch.where(
            dropped[..., m, None],
            eff * fluxes_r[..., m, None] * img * window, 0.0)

    # 3. join the pairs along `axis`
    if axis == 0:
        d = state.data.reshape(Th // 2, 2, Tw, H, W)
        data_new = torch.cat([d[:, 0], d[:, 1]], dim=-2)
        even, odd = (slice(None, None, 2), slice(None)), (slice(1, None, 2),
                                                          slice(None))
    else:
        d = state.data.reshape(Th, Tw // 2, 2, H, W)
        data_new = torch.cat([d[:, :, 0], d[:, :, 1]], dim=-1)
        even, odd = (slice(None), slice(None, None, 2)), (slice(None),
                                                          slice(1, None, 2))
    c1, c2 = counts_d[even], counts_d[odd]
    joint_locs = torch.cat([locs_d[even], locs_d[odd] + shift], dim=-2)
    joint_fluxes = torch.cat([fluxes_d[even], fluxes_d[odd]], dim=-1)
    joint_keep = torch.cat([slot_mask(c1, M), slot_mask(c2, M)], dim=-1)
    joint_counts, joint_locs, joint_fluxes = compact_catalog(
        joint_locs, joint_fluxes, joint_keep)
    joint_locs = joint_locs[..., :M_new, :]
    joint_fluxes = joint_fluxes[..., :M_new]
    joint_counts = torch.clamp(joint_counts, max=M_new)

    # origin tags: the stable compaction keeps the even member's c1 stars
    # first, then the odd member's
    slot_side = (torch.arange(M_new, device=dev)
                 < c1[..., None]).to(torch.float32)
    ghost_rate = ghost[even] + ghost[odd]

    # 4. per-count normalising constants: p(x | s_joint = j) = sum_k
    # p(x | s_child = k) q(s_child = k | s_joint = j), with q the empirical
    # conditional pmf of the paired resampled catalogs
    C_new = M_new + 1
    oh_joint = (joint_counts[..., None].long() == torch.arange(
        C_new, device=dev)).to(torch.float32)  # [th, tw, N, Cj]
    oh_child = (counts_r[..., None].long() == torch.arange(
        C_old, device=dev)).to(torch.float32)  # [Th, Tw, N, Ck]
    n_joint = oh_joint.sum(-2)  # [th, tw, Cj]

    def child_term(oh_c, log_z_c):
        hist = torch.einsum("...nj,...nk->...jk", oh_joint, oh_c)
        pmf = hist / torch.clamp(n_joint[..., None], min=1.0)
        log_pmf = torch.where(pmf > 0, torch.log(torch.clamp(pmf, min=1e-37)),
                              _NEG)
        return torch.logsumexp(log_z_c[..., None, :] + log_pmf, dim=-1)

    log_z_new = (child_term(oh_child[even], state.log_z[even])
                 + child_term(oh_child[odd], state.log_z[odd]))
    log_z_new = torch.where(n_joint > 0, log_z_new, _NEG)

    merged = AggregateState(
        data=data_new,
        counts=joint_counts,
        locs=joint_locs,
        fluxes=joint_fluxes,
        weights=torch.full(joint_counts.shape, 1.0 / N, device=dev),
        log_z=log_z_new,
    )
    return merged, slot_side, ghost_rate


class _Bridge(NamedTuple):
    locs: torch.Tensor
    fluxes: torch.Tensor
    slot_side: torch.Tensor  # [Th, Tw, N, M] origin tags (ride resampling)
    ghost_rate: torch.Tensor  # [Th, Tw, N, HW] frozen dropped-star renders
    loglik_diff: torch.Tensor  # [Th, Tw, N] parent_ll - child_ll
    weights_ic: torch.Tensor  # [Th, Tw, N] within-stratum weights
    log_z: torch.Tensor  # [Th, Tw, C]
    temperature: torch.Tensor  # [Th, Tw]
    acc_rate: torch.Tensor  # [Th, Tw]
    iteration: int


def _loglik_diff(ctx, locs, fluxes):
    rate, child_rate = ctx.init_rates(locs, fluxes)
    parent_ll, child_ll = ctx.loglik_terms(rate, child_rate)
    return parent_ll - child_ll


def _temper_reweight(carry: _Bridge, counts_idx, smask, n_strat,
                     cfg: AggregateConfig) -> _Bridge:
    """Per-stratum adaptive tempering and the weight / log Z update, as
    masked reductions; the stratum of particle n is ``counts_idx[n]``."""
    done = carry.temperature >= 1.0
    ld = carry.loglik_diff
    masked_ld = torch.where(smask, ld[..., None, :], _NEG)  # [Th,Tw,C,N]
    ess_target = cfg.ess_threshold_prop * n_strat  # [Th,Tw,C]
    delta_c = solve_tempering_step(masked_ld, carry.temperature[..., None],
                                   ess_target)
    delta = torch.where(done, 0.0, delta_c.min(-1).values)
    temperature = torch.clamp(carry.temperature + delta, 0.0, 1.0)

    w_log = delta[..., None] * ld  # [Th,Tw,N]
    m_c = _member_max(w_log, smask)  # [Th,Tw,C]
    m_n = torch.gather(m_c, -1, counts_idx)
    shifted = torch.exp(w_log - m_n)
    sum_c = torch.where(smask, shifted[..., None, :], 0.0).sum(-1)
    sum_n = torch.gather(sum_c, -1, counts_idx)
    weights_ic = shifted / torch.clamp(sum_n, min=1e-37)

    occupied = n_strat > 0
    lz_inc = torch.where(
        occupied & ~done[..., None],
        torch.log(torch.clamp(sum_c, min=1e-37)
                  / torch.clamp(n_strat, min=1.0)) + m_c,
        0.0)
    return carry._replace(
        weights_ic=torch.where(done[..., None], carry.weights_ic, weights_ic),
        log_z=carry.log_z + lz_inc,
        temperature=temperature,
    )


def _run_level(generator, state: AggregateState, prior, model, kernel,
               cfg: AggregateConfig, axis: int, dims):
    """One tree level: merge, then the tempered-SMC bridge, iterated on the
    host until every merged tile reaches temperature 1 or
    ``cfg.max_smc_iters``. Returns the new state and the level's
    diagnostics (``temperature``, ``iterations``, ``acc_rate``)."""
    Th, Tw, H, W = dims
    N = state.counts.shape[-1]
    M = state.fluxes.shape[-1]
    M_new = 2 * M if cfg.max_objects_cap is None else min(
        2 * M, cfg.max_objects_cap)
    C_new = M_new + 1
    H_new, W_new = (2 * H, W) if axis == 0 else (H, 2 * W)
    dim_axis = H if axis == 0 else W

    prior_new = expand_prior(prior, H_new, W_new, M_new)
    model_new = model.with_shape(H_new, W_new)
    side_mask = SideMask(axis, dim_axis, H_new, W_new)

    with record_function("agg.merge"):
        state, slot_side0, ghost0 = _merge(generator, state, axis, dims,
                                           M_new, cfg, model_new)

    def make_ctx(temperature, slot_side, ghost_rate):
        return TargetContext(
            prior=prior_new, model=model_new,
            image=state.data[:, :, None],  # [Th, Tw, 1, H, W] vs N
            temperature=temperature[..., None],  # [Th, Tw, 1]
            child_model=model_new, child_side_mask=side_mask,
            child_slot_side=slot_side, child_ghost_rate=ghost_rate)

    counts = state.counts
    counts_idx = counts.long()  # the stratum of particle n is its count
    smask = _stratum_mask(counts_idx, C_new)  # [Th, Tw, C, N]
    n_strat = smask.sum(-1).to(torch.float32)
    dev = counts.device
    temperature0 = torch.zeros(counts.shape[:2], device=dev)
    with record_function("agg.rerender"):
        ld0 = _loglik_diff(make_ctx(temperature0, slot_side0, ghost0),
                           state.locs, state.fluxes)
    carry = _Bridge(
        locs=state.locs, fluxes=state.fluxes, slot_side=slot_side0,
        ghost_rate=ghost0, loglik_diff=ld0,
        weights_ic=torch.full(counts.shape, 1.0 / N, device=dev),
        log_z=state.log_z, temperature=temperature0,
        acc_rate=torch.zeros(counts.shape[:2], device=dev), iteration=0)
    with record_function("agg.temper"):
        carry = _temper_reweight(carry, counts_idx, smask, n_strat, cfg)

    while carry.iteration < cfg.max_smc_iters and bool(
            (carry.temperature < 1.0).any()):
        done = carry.temperature >= 1.0
        keep = done[..., None]
        with record_function("agg.resample"):
            # within-stratum resampling keeps every stratum's size
            idx = stratified_indices(carry.weights_ic, counts_idx, C_new,
                                     cfg.resample_method,
                                     generator=generator)
            locs_r, fluxes_r, ld_r, side_r, ghost_r = gather_particles(
                idx, carry.locs, carry.fluxes, carry.loglik_diff,
                carry.slot_side, carry.ghost_rate, particle_axis=2)
            locs = torch.where(keep[..., None, None], carry.locs, locs_r)
            fluxes = torch.where(keep[..., None], carry.fluxes, fluxes_r)
            ld = torch.where(keep, carry.loglik_diff, ld_r)
            slot_side = torch.where(keep[..., None], carry.slot_side, side_r)
            ghost = torch.where(keep[..., None], carry.ghost_rate, ghost_r)
            weights_ic = torch.where(keep, carry.weights_ic, 1.0 / N)
        ctx = make_ctx(carry.temperature, slot_side, ghost)
        with record_function("agg.rerender"):
            kstate = init_kernel_state(ctx, counts, locs, fluxes)
        with record_function("agg.mutate"):
            kstate, acc = kernel.run_from_state(generator, ctx, counts,
                                                kstate)
        if cfg.relocate_sweeps:
            with record_function("agg.relocate"):
                kstate, acc_rel = relocate_sweeps(
                    generator, ctx, counts, kstate, cfg.relocate_sweeps)
                n_mh = kernel.num_iters
                acc = (acc * n_mh + acc_rel * cfg.relocate_sweeps) / (
                    n_mh + cfg.relocate_sweeps)
        locs = torch.where(keep[..., None, None], locs, kstate.locs)
        fluxes = torch.where(keep[..., None], fluxes, kstate.fluxes)
        ld = torch.where(keep, ld, kstate.parent_ll - kstate.child_ll)
        carry = carry._replace(
            locs=locs, fluxes=fluxes, slot_side=slot_side, ghost_rate=ghost,
            loglik_diff=ld, weights_ic=weights_ic,
            acc_rate=torch.where(done, carry.acc_rate, acc),
            iteration=carry.iteration + 1)
        with record_function("agg.temper"):
            carry = _temper_reweight(carry, counts_idx, smask, n_strat, cfg)

    # flat weights = within-stratum weight x stratum probability
    count_pmf = torch.softmax(carry.log_z, dim=-1)
    flat = carry.weights_ic * torch.gather(count_pmf, -1, counts_idx)
    flat = flat / torch.clamp(flat.sum(-1, keepdim=True), min=1e-37)
    new_state = AggregateState(data=state.data, counts=counts,
                               locs=carry.locs, fluxes=carry.fluxes,
                               weights=flat, log_z=carry.log_z)
    diag = dict(temperature=carry.temperature, iterations=carry.iteration,
                acc_rate=carry.acc_rate)
    return new_state, diag


class Aggregate:
    """User-facing wrapper (the reference ``Aggregate`` API): take a
    finished sampler's tile posteriors and the model objects, run the merge
    tree, expose posterior summaries. Tensors live on ``Prior.device``."""

    def __init__(self, Prior, ImageModel, MutationKernel, data, counts, locs,
                 fluxes, weights, log_normalizing_constant,
                 flux_detection_threshold=0.0, resample_method="multinomial",
                 ess_threshold_prop=0.5, max_smc_iters=100,
                 max_objects_cap=None, relocate_sweeps=8, pair_sweeps=0):
        if resample_method not in {"multinomial", "systematic"}:
            raise ValueError(
                "resample_method must be either multinomial or systematic.")
        self.prior = Prior
        self.image_model = ImageModel
        self.kernel = MutationKernel
        self.config = AggregateConfig(
            ess_threshold_prop=ess_threshold_prop,
            resample_method=resample_method,
            flux_detection_threshold=flux_detection_threshold,
            max_smc_iters=max_smc_iters,
            max_objects_cap=max_objects_cap,
            relocate_sweeps=relocate_sweeps,
            pair_sweeps=pair_sweeps,
        )
        dev = Prior.device

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        data = f32(data)
        self.num_tiles_h, self.num_tiles_w = data.shape[:2]
        if self.num_tiles_h != self.num_tiles_w:
            raise ValueError("aggregation requires a square tile grid")
        levels, t = 0, self.num_tiles_h
        while t > 1:
            if t % 2:
                raise ValueError("tile grid side must be a power of two")
            t //= 2
            levels += 2
        self.num_aggregation_levels = levels
        self.state = AggregateState(
            data=data,
            counts=torch.as_tensor(counts, dtype=torch.int32, device=dev),
            locs=f32(locs), fluxes=f32(fluxes), weights=f32(weights),
            log_z=f32(log_normalizing_constant),
        )
        self.diagnostics = []
        self.has_run = False

    @classmethod
    def from_smc(cls, sampler, result=None, **kwargs):
        """Build the aggregation stage from a finished ``SMCSampler``: its
        flat ``[T, C*N]`` posterior (tiles row-major, from ``tile_image``)
        in the ``[Th, Tw, ...]`` grid layout, its prior, model and kernel.
        Extra kwargs override the aggregation config."""
        result = sampler.result if result is None else result
        th, tw = sampler.num_tiles_h, sampler.num_tiles_w
        td = sampler.tile_dim
        CN = result.counts.shape[-1]
        M = result.fluxes.shape[-1]
        # log Z is indexed by count value; the sampler's stratum axis starts
        # at min_objects, so the unsupported counts are left-padded
        log_z = result.log_normalizing_constant
        if sampler.prior.min_objects > 0:
            pad = torch.full(log_z.shape[:-1] + (sampler.prior.min_objects,),
                             _NEG, device=log_z.device)
            log_z = torch.cat([pad, log_z], dim=-1)
        kwargs.setdefault("flux_detection_threshold",
                          sampler.config.flux_detection_threshold)
        kwargs.setdefault("resample_method", sampler.config.resample_method)
        kwargs.setdefault("ess_threshold_prop",
                          sampler.config.ess_threshold_prop)
        return cls(
            Prior=sampler.prior, ImageModel=sampler.image_model,
            MutationKernel=sampler.kernel,
            data=sampler.tiled_image.reshape(th, tw, td, td),
            counts=result.counts.reshape(th, tw, CN),
            locs=result.locs.reshape(th, tw, CN, M, 2),
            fluxes=result.fluxes.reshape(th, tw, CN, M),
            weights=result.weights.reshape(th, tw, CN),
            log_normalizing_constant=log_z.reshape(th, tw, -1),
            **kwargs,
        )

    def run(self, generator=None, verbose=False, devices=None):
        """Run the merge tree, then the final resample and prune.
        ``devices`` (the JAX package's level sharding) is not ported."""
        if devices is not None:
            raise NotImplementedError(
                "sharding the aggregation over devices is not ported "
                "(ROADMAP item 11)")
        state = self.state
        if generator is None:
            generator = torch.Generator(device=state.data.device)
            generator.manual_seed(0)
        Th, Tw = self.num_tiles_h, self.num_tiles_w
        H, W = state.data.shape[2], state.data.shape[3]
        for level in range(self.num_aggregation_levels):
            axis = level % 2
            state, diag = _run_level(generator, state, self.prior,
                                     self.image_model, self.kernel,
                                     self.config, axis, (Th, Tw, H, W))
            self.diagnostics.append(diag)
            stuck = diag["temperature"] < 1.0
            if bool(stuck.any()):
                warnings.warn(
                    f"aggregation level {level}: {int(stuck.sum())} merged "
                    f"tile(s) exited the bridge at the max_smc_iters="
                    f"{self.config.max_smc_iters} cap with temperature < 1 "
                    f"(min {float(diag['temperature'].min()):.3f}); the "
                    "bridge posterior for those tiles is biased toward the "
                    "product-of-children target; raise max_smc_iters or "
                    "relocate_sweeps", UserWarning, stacklevel=2)
            if verbose:
                print(f"level {level}: {diag['iterations']} bridge iters, "
                      f"acc rate ~{float(diag['acc_rate'].mean()):.2f}")
            if axis == 0:
                Th, H = Th // 2, H * 2
            else:
                Tw, W = Tw // 2, W * 2

        # final resample + prune
        N = state.counts.shape[-1]
        idx = resample_indices(state.weights, N, self.config.resample_method,
                               generator=generator)
        counts, locs, fluxes = gather_particles(
            idx, state.counts, state.locs, state.fluxes, particle_axis=2)
        M = fluxes.shape[-1]
        self.pruned_counts, self.pruned_locs, self.pruned_fluxes = (
            prune_catalog(locs, fluxes, height=H, width=W,
                          flux_threshold=self.config.flux_detection_threshold,
                          mask=slot_mask(counts, M)))
        self.state = AggregateState(
            data=state.data, counts=counts, locs=locs, fluxes=fluxes,
            weights=torch.full(counts.shape, 1.0 / N,
                               device=counts.device),
            log_z=state.log_z)
        self.image_height, self.image_width = H, W
        self.has_run = True
        return self.state

    # -- posterior summaries -------------------------------------------
    @property
    def ess(self):
        return 1.0 / (self.state.weights**2).sum(-1)

    def posterior_mean_count(self, counts=None):
        c = self.pruned_counts if counts is None else counts
        return (self.state.weights * c).sum(-1)

    def posterior_mean_total_flux(self, fluxes=None):
        f = self.state.fluxes if fluxes is None else fluxes
        return (self.state.weights * f.sum(-1)).sum(-1)

    def posterior_predictive_total_observed_flux(self, generator):
        model = self.image_model.with_shape(self.image_height,
                                            self.image_width)
        img = model.sample(generator, self.state.locs, self.state.fluxes)
        return img.sum((-2, -1))

    def summarize(self):
        if not self.has_run:
            raise ValueError("aggregation procedure hasn't been run yet.")
        pc = self.pruned_counts.cpu()
        vals, cnts = torch.unique(pc, return_counts=True)
        print("posterior distribution of number of detectable stars within "
              "image boundary:")
        print(vals.numpy())
        print((cnts / pc.shape[-1]).numpy().round(3), "\n")
        print("posterior mean total intrinsic flux (including undetectable "
              "and/or in padding) = "
              f"{self.posterior_mean_total_flux().cpu().numpy()}\n")
        pruned = self.posterior_mean_total_flux(self.pruned_fluxes)
        print("posterior mean total intrinsic flux of detectable stars "
              f"within image boundary = {pruned.cpu().numpy()}")
