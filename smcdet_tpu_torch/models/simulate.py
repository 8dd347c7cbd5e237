"""Synthetic-image simulator (port of ``smcdet_tpu/models/simulate.py``).

Draw catalogs from a prior, render and add noise with an image model, and
report both the raw catalogs and the detectable ones (sources strictly
inside the image with flux above threshold, compacted to the front).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smcdet_tpu_torch.ops.catalogs import compact_catalog, slot_mask

__all__ = ["SimulatedImages", "generate_images"]


class SimulatedImages(NamedTuple):
    unpruned_counts: torch.Tensor  # [n]
    unpruned_locs: torch.Tensor  # [n, M, 2]
    unpruned_fluxes: torch.Tensor  # [n, M]
    pruned_counts: torch.Tensor  # [n]
    pruned_locs: torch.Tensor  # [n, M, 2]
    pruned_fluxes: torch.Tensor  # [n, M]
    images: torch.Tensor  # [n, H, W]


def generate_images(generator, prior, image_model, flux_threshold,
                    loc_threshold_lower, loc_threshold_upper,
                    num_images: int = 1) -> SimulatedImages:
    """Simulate ``num_images`` tiles on the generator's device. Prune rule:
    every loc coordinate strictly inside the thresholds and flux strictly
    above ``flux_threshold``, restricted to active slots."""
    counts, locs, fluxes = prior.sample(generator, num_images)
    images = image_model.sample(generator, locs, fluxes)
    keep = (
        ((locs > loc_threshold_lower) & (locs < loc_threshold_upper)).all(-1)
        & (fluxes > flux_threshold)
        & slot_mask(counts, prior.max_objects)
    )
    pruned_counts, pruned_locs, pruned_fluxes = compact_catalog(
        locs, fluxes, keep
    )
    return SimulatedImages(counts, locs, fluxes, pruned_counts, pruned_locs,
                           pruned_fluxes, images)
