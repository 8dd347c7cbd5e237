"""Count-stratified SMC sampler (CS-SMC), tile target (port of
``smcdet_tpu/inference/smc.py``).

- Count strata live on a dense axis ``[T, C, N, ...]`` with per-stratum
  weights, ESS and log normalising constants; ``softmax(log_z)`` is the
  posterior count pmf.
- The temper -> resample -> mutate -> reweight loop is a host loop on
  ``(temperature < 1).any()``: one device-to-host read per SMC iteration,
  each of which holds ``num_iters`` sweeps of work.
- Finished tiles (``temperature == 1``) are frozen: their particles and
  weights stop changing, so a tile's result does not depend on which other
  tiles share its batch.
- The mutation caches are re-rendered from the resampled particles every
  iteration (carrying them through resampling lets f32 drift loosen the
  tempering steps).
- ``record_history`` keeps each iteration's temperature, per-stratum ESS
  and acceptance in device buffers indexed by the host's iteration count,
  so recording adds no host read; ``fixed_schedule`` replaces the ESS
  bisection by a ladder of temperatures.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from smcdet_tpu_torch.inference.kernels import (
    KernelState,
    TargetContext,
    init_kernel_state,
    pair_redistribute_sweeps,
    relocate_sweeps,
)
from smcdet_tpu_torch.ops.catalogs import prune_catalog, slot_mask
from smcdet_tpu_torch.ops.resampling import gather_particles, resample_indices
from smcdet_tpu_torch.ops.tempering import solve_tempering_step
from smcdet_tpu_torch.parallel.sharding import shard_runs

__all__ = [
    "SMCConfig",
    "SMCState",
    "SMCResult",
    "csmc_init",
    "csmc_step",
    "csmc_finalize",
    "run_csmc",
    "run_csmc_chunked",
    "join_results",
    "chunk_bytes_per_tile",
    "default_budget_bytes",
    "max_tiles_per_chunk",
    "tile_image",
    "SMCSampler",
    "SMCsampler",
]


@dataclass(frozen=True)
class SMCConfig:
    num_catalogs: int
    ess_threshold_prop: float = 0.5
    resample_method: str = "multinomial"
    max_smc_iters: int = 100
    flux_detection_threshold: float = 0.0
    # print the temperature and acceptance ranges every k iterations
    # (0 = silent)
    print_every: int = 0
    # prior-draw relocation sweeps appended to each mutation
    # (kernels.relocate_sweeps): a star jumps between source modes that the
    # random walk cannot connect
    relocate_sweeps: int = 0
    # coordinated two-star sweeps appended after the relocations
    # (kernels.pair_redistribute_sweeps): flux and separation move between
    # a nearby pair, the split mode single-star moves cannot leave
    pair_sweeps: int = 0
    # keep the temperature, per-stratum ESS and acceptance of every
    # iteration in SMCResult.history ([max_smc_iters, T(, C)] buffers)
    record_history: bool = False
    # a tempering ladder (ending at 1.0) in place of the adaptive ESS
    # bisection: iteration i tempers to fixed_schedule[min(i, len - 1)]
    fixed_schedule: Optional[tuple] = None


class SMCState(NamedTuple):
    generator: torch.Generator
    locs: torch.Tensor  # [T, C, N, M, 2]
    fluxes: torch.Tensor  # [T, C, N, M]
    temperature: torch.Tensor  # [T]
    temperature_prev: torch.Tensor  # [T]
    loglik: torch.Tensor  # [T, C, N]
    weights: torch.Tensor  # [T, C, N] within-stratum, normalised over N
    log_z: torch.Tensor  # [T, C] per-stratum log normalising constant
    ess: torch.Tensor  # [T, C]
    acc_rate: torch.Tensor  # [T]
    iteration: int
    history: Optional[dict] = None  # {temperature, ess, acc_rate} buffers


class SMCResult(NamedTuple):
    """Final particle system (after the terminal resample) + diagnostics."""

    counts: torch.Tensor  # [T, C*N] stratum count of each particle
    locs: torch.Tensor  # [T, C*N, M, 2]
    fluxes: torch.Tensor  # [T, C*N, M]
    pruned_counts: torch.Tensor  # [T, C*N] detectable in-bounds sources
    pruned_locs: torch.Tensor  # [T, C*N, M, 2]
    pruned_fluxes: torch.Tensor  # [T, C*N, M]
    weights: torch.Tensor  # [T, C*N] flat posterior weights
    weights_intracount: torch.Tensor  # [T, C, N]
    log_normalizing_constant: torch.Tensor  # [T, C]
    temperature: torch.Tensor  # [T]
    ess: torch.Tensor  # [T, C]
    num_iters: int
    acc_rate: torch.Tensor  # [T]
    # [max_smc_iters, T], [max_smc_iters, T, C], [max_smc_iters, T]: row i
    # holds iteration i + 1's values (zeros past the last iteration)
    history: Optional[dict] = None


def _context(prior, model, images, temperature):
    return TargetContext(prior=prior, model=model,
                         image=images[:, None, None],
                         temperature=temperature[:, None, None])


def _counts(prior, T, N):
    C = prior.num_counts
    return prior.strata()[None, :, None].expand(T, C, N)


def _temper_and_reweight(cfg, state: SMCState, loglik) -> SMCState:
    """Adaptive tempering (or the next rung of ``cfg.fixed_schedule``) +
    incremental weight / logZ / ESS update, per count stratum, with the
    tile's step the minimum over its strata."""
    T, C, N = loglik.shape
    done = state.temperature >= 1.0
    if cfg.fixed_schedule is not None:
        rung = min(state.iteration, len(cfg.fixed_schedule) - 1)
        # the rung as the float32 the JAX package's schedule array holds
        target = float(np.float32(cfg.fixed_schedule[rung]))
        delta = torch.where(done, 0.0, torch.clamp(
            target - state.temperature, 0.0, 1.0))
    else:
        delta_c = solve_tempering_step(loglik, state.temperature[:, None],
                                       cfg.ess_threshold_prop * N)
        delta = torch.where(done, 0.0, delta_c.min(-1).values)
    temperature = torch.clamp(state.temperature + delta, 0.0, 1.0)

    w_log = torch.nan_to_num(delta[:, None, None] * loglik, nan=-math.inf,
                             neginf=-math.inf)
    m = w_log.max(-1).values
    shifted = torch.exp(w_log - m[..., None])
    s = shifted.sum(-1)
    weights = shifted / s[..., None]
    ess = 1.0 / (weights**2).sum(-1)
    log_z = state.log_z + torch.where(done[:, None], 0.0,
                                      m + torch.log(s / N))
    keep = done[:, None, None]
    return state._replace(
        temperature=temperature,
        temperature_prev=state.temperature,
        loglik=torch.where(keep, state.loglik, loglik),
        weights=torch.where(keep, state.weights, weights),
        log_z=log_z,
        ess=torch.where(done[:, None], state.ess, ess),
    )


def tile_image(image, num_tiles_h: int, num_tiles_w: int, tile_dim: int):
    """Non-overlapping tiling ``[imH, imW] -> [Th*Tw, tile, tile]``
    (remainder rows and columns are dropped)."""
    image = image[: num_tiles_h * tile_dim, : num_tiles_w * tile_dim]
    tiles = image.reshape(num_tiles_h, tile_dim, num_tiles_w, tile_dim)
    return tiles.permute(0, 2, 1, 3).reshape(-1, tile_dim, tile_dim)


def csmc_init(generator, images, prior, model, cfg: SMCConfig) -> SMCState:
    """Initialise the particle system for ``images [T, h, w]`` and take the
    iteration-0 temper step."""
    T = images.shape[0]
    N = cfg.num_catalogs
    C = prior.num_counts
    dev = images.device
    strata, locs, fluxes = prior.sample_stratified(generator, N, (T,))
    zeros_t = torch.zeros(T, device=dev)
    state = SMCState(
        generator=generator,
        locs=locs,
        fluxes=fluxes,
        temperature=zeros_t,
        temperature_prev=zeros_t,
        loglik=torch.zeros((T, C, N), device=dev),
        weights=torch.full((T, C, N), 1.0 / N, device=dev),
        # stratum seeds: log p(count = c) renormalised over the support
        log_z=prior.count_log_prob_truncated(strata)[None, :].expand(T, C),
        ess=torch.full((T, C), float(N), device=dev),
        acc_rate=zeros_t,
        iteration=0,
        history=None if not cfg.record_history else {
            "temperature": torch.zeros((cfg.max_smc_iters, T), device=dev),
            "ess": torch.zeros((cfg.max_smc_iters, T, C), device=dev),
            "acc_rate": torch.zeros((cfg.max_smc_iters, T), device=dev),
        },
    )
    ctx = _context(prior, model, images, state.temperature)
    kstate = init_kernel_state(ctx, _counts(prior, T, N), locs, fluxes)
    return _temper_and_reweight(cfg, state, kstate.parent_ll)


def csmc_step(images, prior, model, kernel, cfg: SMCConfig,
              state: SMCState) -> SMCState:
    """One resample -> re-render -> mutate (+ relocate, + pair) ->
    temper/reweight iteration."""
    T, C, N = state.loglik.shape
    counts = _counts(prior, T, N)
    done = state.temperature >= 1.0
    keep = done[:, None, None]

    # the profiler ranges name the per-iteration stages (PERF.md, layers)
    with record_function("smc.resample"):
        idx = resample_indices(state.weights, N, cfg.resample_method,
                               generator=state.generator)
        locs, fluxes = gather_particles(idx, state.locs, state.fluxes,
                                        particle_axis=2)
        locs = torch.where(keep[..., None, None], state.locs, locs)
        fluxes = torch.where(keep[..., None], state.fluxes, fluxes)
        weights = torch.where(keep, state.weights, 1.0 / N)
    with record_function("smc.rerender"):
        ctx = _context(prior, model, images, state.temperature)
        kstate = init_kernel_state(ctx, counts, locs, fluxes)
    with record_function("smc.mutate"):
        kstate, acc_rate = kernel.run_from_state(state.generator, ctx,
                                                 counts, kstate)
    # the acceptance rate over all sweeps of the mutation
    n_prev = kernel.num_iters
    if cfg.relocate_sweeps:
        with record_function("smc.relocate"):
            kstate, acc_rel = relocate_sweeps(state.generator, ctx, counts,
                                              kstate, cfg.relocate_sweeps)
            acc_rate = (acc_rate * n_prev + acc_rel * cfg.relocate_sweeps) / (
                n_prev + cfg.relocate_sweeps)
            n_prev += cfg.relocate_sweeps
    if cfg.pair_sweeps:
        with record_function("smc.pair"):
            kstate, acc_pair = pair_redistribute_sweeps(
                state.generator, ctx, counts, kstate, cfg.pair_sweeps)
            acc_rate = (acc_rate * n_prev + acc_pair * cfg.pair_sweeps) / (
                n_prev + cfg.pair_sweeps)
    state = state._replace(
        locs=torch.where(keep[..., None, None], state.locs, kstate.locs),
        fluxes=torch.where(keep[..., None], state.fluxes, kstate.fluxes),
        weights=weights,
        acc_rate=torch.where(done, state.acc_rate, acc_rate.mean(-1)),
        iteration=state.iteration + 1,
    )
    loglik = torch.where(keep, state.loglik, kstate.parent_ll)
    with record_function("smc.temper"):
        state = _temper_and_reweight(cfg, state, loglik)
    if state.history is not None:
        # written in place at the host's iteration count: no host read
        i = state.iteration - 1
        for name, value in (("temperature", state.temperature),
                            ("ess", state.ess),
                            ("acc_rate", state.acc_rate)):
            state.history[name][i] = value
    return state


def csmc_finalize(prior, model, cfg: SMCConfig, state: SMCState) -> SMCResult:
    """Final resample + prune of a stepped state."""
    T, C, N = state.loglik.shape
    idx = resample_indices(state.weights, N, cfg.resample_method,
                           generator=state.generator)
    locs, fluxes = gather_particles(idx, state.locs, state.fluxes,
                                    particle_axis=2)
    M = locs.shape[-2]
    flat_counts = _counts(prior, T, N).reshape(T, C * N)
    flat_locs = locs.reshape(T, C * N, M, 2)
    flat_fluxes = fluxes.reshape(T, C * N, M)
    pruned_counts, pruned_locs, pruned_fluxes = prune_catalog(
        flat_locs, flat_fluxes, height=model.height, width=model.width,
        flux_threshold=cfg.flux_detection_threshold,
        mask=slot_mask(flat_counts, M),
    )
    count_pmf = torch.softmax(state.log_z, dim=-1)
    flat_weights = (count_pmf[..., None] / N).expand(T, C, N).reshape(
        T, C * N)
    return SMCResult(
        counts=flat_counts,
        locs=flat_locs,
        fluxes=flat_fluxes,
        pruned_counts=pruned_counts,
        pruned_locs=pruned_locs,
        pruned_fluxes=pruned_fluxes,
        weights=flat_weights,
        weights_intracount=torch.full((T, C, N), 1.0 / N,
                                      device=state.weights.device),
        log_normalizing_constant=state.log_z,
        temperature=state.temperature,
        ess=state.ess,
        num_iters=state.iteration,
        acc_rate=state.acc_rate,
        history=state.history,
    )


def run_csmc(generator, images, prior, model, kernel,
             cfg: SMCConfig) -> SMCResult:
    """Run count-stratified SMC on a batch of tiles ``images [T, h, w]``
    until every tile reaches temperature 1 or ``max_smc_iters``."""
    state = csmc_init(generator, images, prior, model, cfg)
    while True:
        with record_function("smc.loop_check"):  # the per-iteration host read
            if state.iteration >= cfg.max_smc_iters or not bool(
                (state.temperature < 1.0).any()
            ):
                break
        state = csmc_step(images, prior, model, kernel, cfg, state)
        if cfg.print_every and state.iteration % cfg.print_every == 0:
            t, a = state.temperature, state.acc_rate
            print(f"iteration {state.iteration}: temperature in "
                  f"[{float(t.min()):.2f}, {float(t.max()):.2f}], acceptance "
                  f"rate in [{float(a.min()):.2f}, {float(a.max()):.2f}]")
    return csmc_finalize(prior, model, cfg, state)


def default_budget_bytes(device) -> int:
    """Memory budget for one chunk's particle state: a quarter of the
    card's memory on CUDA, an eighth of physical memory on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 8


# float copies of the [T, C, N, H*W] rate cache that one SMC step holds at
# its peak, whatever its moves: the cache, the proposed cache, the rate
# change and a single-star render with its temporaries, then the
# likelihood's temporaries. The JAX package counts 5; the port's eager step
# holds more: 6.8 to 11.4 copies in the peaks measured on an H100
# (chip_smoke.py [main], [entry], [pair], [m71]: 8x8 and 16x16, with and
# without relocation and pair sweeps; the most at 8x8 with both moves),
# so 13 leaves over a tenth of headroom.
RATE_COPIES = 13


def chunk_bytes_per_tile(prior, num_catalogs: int, tile_hw: int) -> int:
    """Device bytes one tile takes in a chunk: ``RATE_COPIES`` rate-cache
    copies plus the catalogs."""
    C = prior.num_counts
    return C * num_catalogs * (RATE_COPIES * tile_hw
                               + 8 * prior.max_objects + 32) * 4


def max_tiles_per_chunk(prior, num_catalogs: int, tile_hw: int,
                        budget_bytes: int) -> int:
    """Largest tile batch within ``budget_bytes`` (``chunk_bytes_per_tile``:
    the JAX package's formula with the port's count of rate copies)."""
    per_tile = chunk_bytes_per_tile(prior, num_catalogs, tile_hw)
    return max(1, budget_bytes // max(per_tile, 1))


def _per_tile_background(background, num_tiles: int):
    """A per-tile background map ``[T, ..., h, w]`` promoted to
    ``[T, 1, 1, h, w]``, or ``None`` for a scalar/shared background."""
    if background.ndim < 3 or background.shape[0] != num_tiles:
        return None
    if background.ndim == 3:
        return background[:, None, None]
    if background.ndim == 4:
        return background[:, None]
    return background


def run_csmc_chunked(generator, images, prior, model, kernel,
                     cfg: SMCConfig, budget_bytes: int | None = None,
                     sort_tiles: bool = False) -> SMCResult:
    """``run_csmc`` over a tile batch too large for device memory, in
    sequential equal-size chunks concatenated along the tile axis (per-tile
    CS-SMC is independent, so this is exact).

    ``sort_tiles`` processes tiles in order of total image flux: every tile
    of a chunk runs to the chunk's longest tempering schedule, so grouping
    similar tiles wastes fewer iterations. Results come back in the
    caller's tile order. ``num_iters`` is the largest over chunks; a
    recorded history is concatenated along its tile axis.
    """
    T = images.shape[0]
    if budget_bytes is None:
        budget_bytes = default_budget_bytes(images.device)
    order = None
    if sort_tiles and T > 1:
        order = torch.argsort(images.reshape(T, -1).sum(-1))
        images = images[order]
    bg = _per_tile_background(model.background, T)
    if bg is not None and order is not None:
        bg = bg[order]
    chunk = max_tiles_per_chunk(prior, cfg.num_catalogs,
                                images.shape[1] * images.shape[2],
                                budget_bytes)
    n_chunks = -(-T // chunk)
    size = -(-T // n_chunks)
    parts = []
    for i in range(0, T, size):
        mdl = model if bg is None else model.with_background(bg[i:i + size])
        parts.append(run_csmc(generator, images[i:i + size], prior, mdl,
                              kernel, cfg))
    return join_results(parts,
                        None if order is None else torch.argsort(order))


def join_results(parts, inv=None, device=None) -> SMCResult:
    """``SMCResult``s of consecutive tile ranges joined along the tile axis
    (a recorded history along its own), on ``device`` (default: where
    they are), then put in the caller's order by the inverse permutation
    ``inv``; ``num_iters`` is the largest. A single part that needs no
    move and no reordering is returned as it is."""
    if (len(parts) == 1 and inv is None and (
            device is None or parts[0].weights.device == device)):
        return parts[0]

    def joined(vals, axis):
        v = torch.cat([x if device is None else x.to(device) for x in vals],
                      dim=axis)
        return v if inv is None else v.index_select(axis, inv)

    out = {}
    for f in SMCResult._fields:
        vals = [getattr(p, f) for p in parts]
        if f == "num_iters":
            out[f] = max(vals)
        elif f == "history":
            out[f] = None if vals[0] is None else {
                k: joined([v[k] for v in vals], 1) for k in vals[0]}
        else:
            out[f] = joined(vals, 0)
    return SMCResult(**out)


class SMCSampler:
    """User-facing wrapper (the reference ``SMCsampler`` API): tile the
    image (row-major, as ``Aggregate.from_smc`` reads it), run CS-SMC over
    difficulty-sorted chunks, expose posterior summaries.

    The image model's background is a scalar, a bare ``[h, w]`` map shared
    by every tile, or a per-tile map ``[T, 1, 1, h, w]`` in ``tile_image``
    order. ``dispatch_iters`` is accepted and ignored: the port's SMC loop
    already runs on the host one iteration at a time."""

    def __init__(self, image, tile_dim, Prior, ImageModel, MutationKernel,
                 num_catalogs, ess_threshold_prop=0.5,
                 resample_method="multinomial", flux_detection_threshold=0.0,
                 max_smc_iters=100, print_every=0, relocate_sweeps=0,
                 pair_sweeps=0, dispatch_iters=None, budget_bytes=None):
        self.image = torch.as_tensor(image, dtype=torch.float32,
                                     device=Prior.device)
        self.image_height, self.image_width = self.image.shape
        self.tile_dim = tile_dim
        self.num_tiles_h = self.image_height // tile_dim
        self.num_tiles_w = self.image_width // tile_dim
        self.tiled_image = tile_image(self.image, self.num_tiles_h,
                                      self.num_tiles_w, tile_dim)
        self.prior = Prior
        self.image_model = ImageModel
        self.kernel = MutationKernel
        self.budget_bytes = budget_bytes
        self.config = SMCConfig(
            num_catalogs=num_catalogs,
            ess_threshold_prop=ess_threshold_prop,
            resample_method=resample_method,
            max_smc_iters=max_smc_iters,
            flux_detection_threshold=flux_detection_threshold,
            print_every=print_every,
            relocate_sweeps=relocate_sweeps,
            pair_sweeps=pair_sweeps,
        )
        self.result: SMCResult | None = None

    def run(self, generator=None, streaming=False,
            devices=None) -> SMCResult:
        """Run the sampler over difficulty-sorted chunks of tiles or, with
        ``streaming=True``, through the swap-on-converge tile pool
        (``inference/streaming.py``). The memory budget is
        ``memory_budget_bytes`` where the sampler has it, else
        ``budget_bytes``. ``devices``: a list of devices over which the
        tiles are split (``parallel/sharding.py``), each range run on its
        device and the results joined in tile order on the image's device
        (default: the image's device alone)."""
        if generator is None:
            generator = torch.Generator(device=self.image.device)
            generator.manual_seed(0)
        if devices is None:
            devices = [self.tiled_image.device]
        budget = getattr(self, "memory_budget_bytes", self.budget_bytes)
        if streaming:
            from smcdet_tpu_torch.inference.streaming import (
                run_csmc_streaming,
            )

            self.result = run_csmc_streaming(
                generator, self.tiled_image, self.prior, self.image_model,
                self.kernel, self.config, budget_bytes=budget,
                devices=devices)
            return self.result
        parts = shard_runs(
            lambda gen, images, prior, model, kernel, _: run_csmc_chunked(
                gen, images, prior, model, kernel, self.config,
                budget_bytes=budget, sort_tiles=True),
            devices, generator, self.tiled_image, self.prior,
            self.image_model, self.kernel)
        self.result = join_results(parts, device=self.image.device)
        return self.result

    # -- posterior summaries -------------------------------------------
    @property
    def has_run(self):
        return self.result is not None

    def posterior_mean_count(self, counts=None):
        r = self.result
        c = r.pruned_counts if counts is None else counts
        return (r.weights * c).sum(-1)

    def posterior_mean_total_flux(self, fluxes=None):
        r = self.result
        f = r.fluxes if fluxes is None else fluxes
        return (r.weights * f.sum(-1)).sum(-1)

    def posterior_predictive_total_observed_flux(self, generator):
        r = self.result
        img = self.image_model.sample(generator, r.locs, r.fluxes)
        return img.sum((-2, -1))

    def summarize(self):
        if not self.has_run:
            raise ValueError("Sampler hasn't been run yet.")
        r = self.result
        pc = r.pruned_counts.cpu()
        vals, cnts = torch.unique(pc, return_counts=True)
        print("posterior distribution of number of detectable stars within "
              "image boundary:")
        print(vals.numpy())
        print((cnts / pc.shape[-1]).numpy().round(3), "\n")
        print("posterior mean total intrinsic flux (including undetectable "
              "and/or in padding) = "
              f"{self.posterior_mean_total_flux().cpu().numpy()}\n")
        print("posterior mean total intrinsic flux of detectable stars "
              "within image boundary = "
              f"{self.posterior_mean_total_flux(r.pruned_fluxes).cpu().numpy()}"
              "\n")


SMCsampler = SMCSampler
