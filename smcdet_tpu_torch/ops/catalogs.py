"""Fixed-shape padded-catalog operations (port of
``smcdet_tpu/ops/catalogs.py``): mask, stable compaction, prune."""

from __future__ import annotations

import torch

__all__ = ["compact_catalog", "prune_catalog", "slot_mask"]


def slot_mask(counts, max_objects: int):
    """``[..., M]`` bool mask with slot m active iff ``m < count``."""
    m = torch.arange(max_objects, device=counts.device)
    return m < counts[..., None]


def compact_catalog(locs, fluxes, keep):
    """Move kept slots to the front of the object axis, zero the rest.

    ``locs [..., M, 2]``, ``fluxes [..., M]``, ``keep [..., M]`` bool.
    Returns ``(counts, locs, fluxes)``; a stable sort keeps the relative
    order of kept slots.
    """
    counts = keep.sum(-1).to(torch.int32)
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    fluxes = torch.gather(fluxes * keep, -1, order)
    locs = torch.gather(locs * keep[..., None], -2,
                        order[..., None].expand(locs.shape))
    return counts, locs, fluxes


def prune_catalog(locs, fluxes, *, height, width, flux_threshold, mask=None):
    """Keep detectable, strictly-in-bounds sources and compact
    (``0 < loc < dim`` and flux strictly above threshold)."""
    keep = (
        (locs[..., 0] > 0)
        & (locs[..., 0] < height)
        & (locs[..., 1] > 0)
        & (locs[..., 1] < width)
        & (fluxes > flux_threshold)
    )
    if mask is not None:
        keep = keep & mask
    return compact_catalog(locs, fluxes, keep)
