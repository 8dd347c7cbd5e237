"""The MCMC baselines: a saturated single-component MH chain and a
reversible-jump chain per tile (port of ``smcdet_tpu/inference/mcmc.py``).

``run_mh`` keeps every one of the ``max_objects`` slots active; the number
of detectable stars emerges from pruning (flux threshold and in-bounds).
Each tile is one chain, a ``[T, 1, M]`` particle batch, driven in blocks
through the mutation kernel's ``run_from_state``: on the card one launch
of the fused sweep kernel (K1 or K2 under MH, K4 under MALA) at ``N = 1``
does the burn-in, then one launch per kept sample does ``keep_every_k``
sweeps, and each block's state is written into preallocated ``[T, K, M,
...]`` chains. ``run_rjmh`` moves across counts with ``BirthDeathMH``
(plain PyTorch, one sweep at a time).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import NamedTuple

import torch

from smcdet_tpu_torch.inference.kernels import (
    SingleComponentMH,
    TargetContext,
    _effective_flux_floor,
    init_kernel_state,
)
from smcdet_tpu_torch.inference.smc import tile_image
from smcdet_tpu_torch.ops.catalogs import prune_catalog, slot_mask

__all__ = [
    "MCMCConfig",
    "MCMCResult",
    "init_chain",
    "num_kept",
    "run_mh",
    "run_rjmh",
    "with_iters",
    "MHSampler",
    "MHsampler",
]


@dataclass
class MCMCConfig:
    num_samples_total: int
    num_samples_burnin: int
    keep_every_k: int = 1
    flux_detection_threshold: float = 0.0


class MCMCResult(NamedTuple):
    counts: torch.Tensor  # [T, K] (saturated: == max_objects)
    locs: torch.Tensor  # [T, K, M, 2]
    fluxes: torch.Tensor  # [T, K, M]
    pruned_counts: torch.Tensor  # [T, K]
    pruned_locs: torch.Tensor  # [T, K, M, 2]
    pruned_fluxes: torch.Tensor  # [T, K, M]
    acc_rate: torch.Tensor  # [T]


def num_kept(cfg: MCMCConfig) -> int:
    """Kept samples: indices ``arange(burnin, total, keep_every_k)``."""
    return max(0, -(-(cfg.num_samples_total - cfg.num_samples_burnin)
                    // cfg.keep_every_k))


def with_iters(kernel, num_iters: int):
    """A copy of a mutation kernel that runs ``num_iters`` sweeps."""
    out = copy.copy(kernel)
    out.num_iters = int(num_iters)
    return out


def _context(prior, model, images):
    T = images.shape[0]
    return TargetContext(
        prior=prior, model=model, image=images[:, None],  # [T, 1, H, W]
        temperature=torch.ones((T, 1), device=images.device))


def init_chain(generator, images, prior, model, kernel):
    """The empty start of ``run_mh`` for ``images [T, h, w]``: every slot
    active, locations from the prior, every flux at the proposal floor
    clamped into the flux prior's support (below the detection threshold,
    so no star is detectable at step 0; a floor below the support would
    make every acceptance ratio NaN). Returns ``(ctx, counts [T, 1],
    state)``."""
    T = images.shape[0]
    M = prior.max_objects
    counts = torch.full((T, 1), M, dtype=torch.int32, device=images.device)
    locs, fluxes = prior.sample_marks(generator, counts, (T, 1))
    if fluxes is not None:
        floor = _effective_flux_floor(kernel.fluxes_min, prior)
        fluxes = torch.zeros_like(fluxes) + floor
    ctx = _context(prior, model, images)
    return ctx, counts, init_kernel_state(ctx, counts, locs, fluxes)


def _result(model, cfg, chain_counts, chain_locs, chain_fluxes, acc_rate):
    M = chain_fluxes.shape[-1]
    pruned_counts, pruned_locs, pruned_fluxes = prune_catalog(
        chain_locs, chain_fluxes, height=model.height, width=model.width,
        flux_threshold=cfg.flux_detection_threshold,
        mask=slot_mask(chain_counts, M))
    return MCMCResult(counts=chain_counts, locs=chain_locs,
                      fluxes=chain_fluxes, pruned_counts=pruned_counts,
                      pruned_locs=pruned_locs, pruned_fluxes=pruned_fluxes,
                      acc_rate=acc_rate)


def run_mh(generator, images, prior, model, kernel,
           cfg: MCMCConfig) -> MCMCResult:
    """One saturated chain per tile of ``images [T, h, w]``: the burn-in in
    one ``run_from_state`` of ``num_samples_burnin`` sweeps, then
    ``num_kept(cfg)`` blocks of ``keep_every_k`` sweeps, each recorded.
    ``kernel`` is a ``SingleComponentMH`` or ``SingleComponentMALA``; its
    ``num_iters`` is ignored. The acceptance rate weights the burn-in's and
    the blocks' by their sweeps (the JAX formula)."""
    T = images.shape[0]
    M = prior.max_objects
    dev = images.device
    ctx, counts, state = init_chain(generator, images, prior, model, kernel)

    nb = cfg.num_samples_burnin
    if nb:
        state, acc_burn = with_iters(kernel, nb).run_from_state(
            generator, ctx, counts, state)
    else:
        acc_burn = torch.zeros(T, device=dev)

    K, k = num_kept(cfg), cfg.keep_every_k
    block = with_iters(kernel, k)
    chain_locs = torch.empty((T, K, M, 2), dtype=torch.float32, device=dev)
    chain_fluxes = torch.empty((T, K, M), dtype=torch.float32, device=dev)
    acc_kept = torch.zeros(T, device=dev)
    for i in range(K):
        state, acc = block.run_from_state(generator, ctx, counts, state)
        chain_locs[:, i] = state.locs[:, 0]
        chain_fluxes[:, i] = state.fluxes[:, 0]
        acc_kept = acc_kept + acc
    total = nb + K * k
    acc_rate = (acc_burn * nb + (acc_kept / max(K, 1)) * K * k) / max(total,
                                                                      1)
    chain_counts = torch.full((T, K), M, dtype=torch.int32, device=dev)
    return _result(model, cfg, chain_counts, chain_locs, chain_fluxes,
                   acc_rate)


def run_rjmh(generator, images, prior, model, kernel,
             cfg: MCMCConfig) -> MCMCResult:
    """Reversible-jump MH: one transdimensional chain per tile, moved by
    ``kernel`` (a ``BirthDeathMH``) one sweep at a time. The chain starts
    empty (count 0); stars enter by birth. The acceptance rate is the
    applied share over every sweep."""
    from smcdet_tpu_torch.inference.transdimensional import TDKernelState

    T = images.shape[0]
    M = prior.max_objects
    dev = images.device
    counts = torch.zeros((T, 1), dtype=torch.int32, device=dev)
    locs = torch.zeros((T, 1, M, 2), device=dev)
    fluxes = torch.zeros((T, 1, M), device=dev)
    ctx = _context(prior, model, images)
    state = TDKernelState(counts=counts,
                          inner=init_kernel_state(ctx, counts, locs, fluxes))
    acc_n = torch.zeros((T, 1), device=dev)

    def sweep(st):
        nonlocal acc_n
        st, applied = kernel.sweep(generator, ctx, st)
        acc_n = acc_n + applied.to(torch.float32)
        return st

    nb = cfg.num_samples_burnin
    for _ in range(nb):
        state = sweep(state)
    K, k = num_kept(cfg), cfg.keep_every_k
    chain_counts = torch.empty((T, K), dtype=torch.int32, device=dev)
    chain_locs = torch.empty((T, K, M, 2), device=dev)
    chain_fluxes = torch.empty((T, K, M), device=dev)
    for i in range(K):
        for _ in range(k):
            state = sweep(state)
        chain_counts[:, i] = state.counts[:, 0]
        chain_locs[:, i] = state.inner.locs[:, 0]
        chain_fluxes[:, i] = state.inner.fluxes[:, 0]
    acc_rate = acc_n[:, 0] / (nb + K * k)
    return _result(model, cfg, chain_counts, chain_locs, chain_fluxes,
                   acc_rate)


class MHSampler:
    """User-facing wrapper with the reference ``MHsampler`` API: tile the
    image, run one saturated chain per tile (``run_mh``), summarise. The
    tensors live on ``Prior.device``."""

    def __init__(self, image, tile_dim, Prior, ImageModel, locs_stdev,
                 fluxes_stdev, flux_detection_threshold, num_samples_total,
                 num_samples_burnin, keep_every_k: int = 1, fluxes_min=0.0,
                 fluxes_max=1e6):
        dev = Prior.device
        self.image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        self.tile_dim = tile_dim
        h, w = self.image.shape
        self.num_tiles_h = h // tile_dim
        self.num_tiles_w = w // tile_dim
        self.tiled_image = tile_image(self.image, self.num_tiles_h,
                                      self.num_tiles_w, tile_dim)
        self.prior = Prior
        self.image_model = ImageModel
        self.kernel = SingleComponentMH(
            num_iters=1, locs_stdev=locs_stdev, fluxes_stdev=fluxes_stdev,
            fluxes_min=fluxes_min, fluxes_max=fluxes_max, device=dev)
        self.config = MCMCConfig(
            num_samples_total=num_samples_total,
            num_samples_burnin=num_samples_burnin,
            keep_every_k=keep_every_k,
            flux_detection_threshold=flux_detection_threshold)
        self.result: MCMCResult | None = None

    def run(self, generator=None) -> MCMCResult:
        if generator is None:
            generator = torch.Generator(device=self.image.device)
            generator.manual_seed(0)
        self.result = run_mh(generator, self.tiled_image, self.prior,
                             self.image_model, self.kernel, self.config)
        return self.result

    @property
    def has_run(self):
        return self.result is not None

    def posterior_mean_count(self):
        return self.result.pruned_counts.to(torch.float32).mean(-1)

    def posterior_mean_total_flux(self):
        return self.result.fluxes.sum(-1).mean(-1)

    def summarize(self):
        if not self.has_run:
            raise ValueError("Sampler hasn't been run yet.")
        r = self.result
        pc = r.pruned_counts.cpu()
        print("posterior distribution of number of detectable stars within "
              "image boundary:")
        vals, cnts = torch.unique(pc, return_counts=True)
        print(vals.numpy())
        print((cnts / pc.numel()).numpy().round(3), "\n")
        print("posterior mean total intrinsic flux = "
              f"{self.posterior_mean_total_flux().cpu().numpy()}\n")
        print(f"acceptance rate = {r.acc_rate.cpu().numpy()}")


# Reference spelling.
MHsampler = MHSampler
