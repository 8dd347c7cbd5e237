"""Marked-point-process priors over (counts, locations, fluxes).

Port of ``smcdet_tpu/models/priors.py``. Catalogs are fixed-shape padded
tensors: slot ``m`` is active iff ``m < count``; inactive slots are zeroed
but never branched on. Count-stratified draws carry a dense stratum axis
``[..., C, N, M, ...]``.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from smcdet_tpu_torch.distributions import DiscreteUniform, TruncatedPareto
from smcdet_tpu_torch.ops.catalogs import slot_mask

__all__ = [
    "UniformCounts",
    "PoissonCounts",
    "GeometricCounts",
    "NormalFlux",
    "ParetoFlux",
    "TruncatedPareto",
    "PointProcessPrior",
    "PoissonProcessPrior",
    "GeometricProcessPrior",
    "StarPrior",
    "ParetoStarPrior",
    "M71Prior",
]


def _t(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


# the integer-uniform count prior is the distribution itself
UniformCounts = DiscreteUniform


class PoissonCounts:
    """Poisson count prior with rate ``mu * padded_area``."""

    def __init__(self, rate, device="cuda"):
        self.rate = _t(rate, device)

    def sample(self, shape, generator=None, device=None):
        rates = self.rate.to(device or self.rate.device)
        rates = rates.expand(tuple(shape)).contiguous()
        return torch.poisson(rates, generator=generator).to(torch.int32)

    def log_prob(self, value):
        value = torch.as_tensor(value, device=self.rate.device).to(
            torch.float32
        )
        return value * torch.log(self.rate) - self.rate - torch.lgamma(
            value + 1.0
        )


class GeometricCounts:
    """Geometric count prior, ``pmf(k) = (1 - p)^k p`` for k = 0, 1, ...,
    with ``p = 1 - exp(-1.5)`` by default (rounded in float32, as the
    reference rounds it)."""

    def __init__(self, prob=None, device="cuda"):
        if prob is None:
            prob = 1.0 - torch.exp(torch.tensor(-1.5))
        self.prob = _t(prob, device)

    def sample(self, shape, generator=None, device=None):
        device = device or self.prob.device
        u = torch.rand(tuple(shape), generator=generator, device=device)
        p = self.prob.to(device)
        return torch.floor(torch.log1p(-u) / torch.log1p(-p)).to(torch.int32)

    def log_prob(self, value):
        value = torch.as_tensor(value, device=self.prob.device).to(
            torch.float32
        )
        return value * torch.log1p(-self.prob) + torch.log(self.prob)


class NormalFlux:
    """Normal flux mark."""

    def __init__(self, mean, stdev, device="cuda"):
        self.mean = _t(mean, device)
        self.stdev = _t(stdev, device)

    def sample(self, shape, generator=None):
        z = torch.randn(tuple(shape), generator=generator,
                        device=self.mean.device)
        return self.mean + self.stdev * z

    def log_prob(self, value):
        z = (value - self.mean) / self.stdev
        return -0.5 * z * z - torch.log(self.stdev) - 0.5 * math.log(
            2.0 * math.pi
        )

    @property
    def reference_point(self):
        return self.mean

    @property
    def support_lower(self):
        return torch.full_like(self.mean, -math.inf)

    @property
    def support_upper(self):
        return torch.full_like(self.mean, math.inf)


class ParetoFlux:
    """Pareto flux mark with scale (minimum) and shape ``alpha``."""

    def __init__(self, scale, alpha, device="cuda"):
        self.scale = _t(scale, device)
        self.alpha = _t(alpha, device)

    def sample(self, shape, generator=None):
        u = torch.rand(tuple(shape), generator=generator,
                       device=self.scale.device)
        return self.scale * (1.0 - u) ** (-1.0 / self.alpha)

    def log_prob(self, value):
        return (torch.log(self.alpha) + self.alpha * torch.log(self.scale)
                - (self.alpha + 1.0) * torch.log(value))

    @property
    def reference_point(self):
        return self.scale

    @property
    def support_lower(self):
        return self.scale

    @property
    def support_upper(self):
        return torch.full_like(self.scale, math.inf)


class PointProcessPrior:
    """Prior over padded catalogs on a ``height x width`` tile with ``pad``
    pixels of slack on every side: ``loc ~ U([-pad, H+pad] x [-pad, W+pad])``.
    """

    def __init__(self, min_objects, max_objects, image_height, image_width,
                 pad=0.0, counts: Any = None, flux: Optional[Any] = None,
                 device="cuda"):
        self.min_objects = int(min_objects)
        self.max_objects = int(max_objects)
        self.image_height = int(image_height)
        self.image_width = int(image_width)
        self.pad = float(pad)
        self.counts = counts
        self.flux = flux
        self.device = torch.device(device)
        self.loc_low = _t([-self.pad, -self.pad], device)
        self.loc_high = _t([self.image_height + self.pad,
                            self.image_width + self.pad], device)

    @property
    def num_counts(self) -> int:
        return self.max_objects - self.min_objects + 1

    def strata(self):
        return torch.arange(self.min_objects, self.max_objects + 1,
                            dtype=torch.int32, device=self.device)

    def slot_mask(self, counts):
        return slot_mask(counts, self.max_objects)

    # ------------------------------------------------------------------
    def sample_marks(self, generator, counts, batch_shape):
        """Draw (locs, fluxes) given counts of shape ``batch_shape``; the
        loc uniforms are drawn before the flux uniforms."""
        mask = self.slot_mask(counts)
        shape = tuple(batch_shape) + (self.max_objects,)
        u = torch.rand(shape + (2,), generator=generator, device=self.device)
        locs = self.loc_low + (self.loc_high - self.loc_low) * u
        locs = locs * mask[..., None]
        if self.flux is None:
            return locs, None
        fluxes = self.flux.sample(shape, generator) * mask
        return locs, fluxes

    def sample(self, generator, num_catalogs, batch_shape=()):
        """Unstratified draw: counts ``[*B, N]`` clipped to
        ``[min_objects, max_objects]``, locs ``[*B, N, M, 2]``, fluxes
        ``[*B, N, M]``."""
        shape = tuple(batch_shape) + (num_catalogs,)
        counts = self.counts.sample(shape, generator, self.device).clamp(
            self.min_objects, self.max_objects
        ).to(torch.int32)
        locs, fluxes = self.sample_marks(generator, counts, shape)
        return counts, locs, fluxes

    def sample_stratified(self, generator, num_catalogs_per_count,
                          batch_shape=()):
        """Count-stratified draw: strata ``[C]``, locs ``[*B, C, N, M, 2]``,
        fluxes ``[*B, C, N, M]``."""
        strata = self.strata()
        shape = tuple(batch_shape) + (self.num_counts, num_catalogs_per_count)
        counts = strata[:, None].expand(shape)
        locs, fluxes = self.sample_marks(generator, counts, shape)
        return strata, locs, fluxes

    # ------------------------------------------------------------------
    def count_log_prob_truncated(self, counts):
        """Count log-pmf renormalised over ``{min_objects..max_objects}``."""
        log_norm = torch.logsumexp(self.counts.log_prob(self.strata()), 0)
        return self.counts.log_prob(counts) - log_norm

    def loc_log_prob(self, locs, mask):
        area_term = torch.log(self.loc_high - self.loc_low).sum()
        return -area_term * mask.sum(-1).to(torch.float32)

    def flux_log_prob(self, fluxes, mask):
        """Sum of per-active-slot flux terms, safe on padded slots."""
        safe = torch.where(mask, fluxes, self.flux.reference_point)
        return torch.where(mask, self.flux.log_prob(safe), 0.0).sum(-1)

    def log_prob(self, counts, locs, fluxes=None):
        """Joint prior log-density of a padded catalog."""
        mask = self.slot_mask(counts)
        lp = self.counts.log_prob(counts) + self.loc_log_prob(locs, mask)
        if self.flux is not None and fluxes is not None:
            lp = lp + self.flux_log_prob(fluxes, mask)
        return lp


def _padded_rate(counts_rate, image_height, image_width, pad):
    return counts_rate * (image_height + 2 * pad) * (image_width + 2 * pad)


def PoissonProcessPrior(min_objects, max_objects, counts_rate, image_height,
                        image_width, pad=0.0, device="cuda"):
    """Poisson counts with rate ``counts_rate * padded area``, no flux
    mark."""
    rate = _padded_rate(counts_rate, image_height, image_width, pad)
    return PointProcessPrior(min_objects, max_objects, image_height,
                             image_width, pad=pad,
                             counts=PoissonCounts(rate, device=device),
                             device=device)


def GeometricProcessPrior(min_objects, max_objects, image_height,
                          image_width, pad=0.0, device="cuda"):
    """Geometric counts, no flux mark."""
    return PointProcessPrior(min_objects, max_objects, image_height,
                             image_width, pad=pad,
                             counts=GeometricCounts(device=device),
                             device=device)


def StarPrior(min_objects, max_objects, image_height, image_width,
              flux_mean, flux_stdev, pad=0.0, device="cuda"):
    """Uniform counts and Normal fluxes."""
    return PointProcessPrior(
        min_objects, max_objects, image_height, image_width, pad=pad,
        counts=UniformCounts(min_objects, max_objects),
        flux=NormalFlux(flux_mean, flux_stdev, device=device), device=device,
    )


def ParetoStarPrior(min_objects, max_objects, image_height, image_width,
                    flux_scale, flux_alpha, pad=0.0, device="cuda"):
    """Uniform counts and Pareto fluxes."""
    return PointProcessPrior(
        min_objects, max_objects, image_height, image_width, pad=pad,
        counts=UniformCounts(min_objects, max_objects),
        flux=ParetoFlux(flux_scale, flux_alpha, device=device), device=device,
    )


def M71Prior(min_objects, max_objects, counts_rate, image_height,
             image_width, flux_alpha, flux_lower, flux_upper, pad=0.0,
             device="cuda") -> PointProcessPrior:
    """Poisson counts with rate ``counts_rate * padded area`` and
    truncated-Pareto fluxes (the reference ``M71Prior``)."""
    rate = _padded_rate(counts_rate, image_height, image_width, pad)
    return PointProcessPrior(
        min_objects=min_objects,
        max_objects=max_objects,
        image_height=image_height,
        image_width=image_width,
        pad=pad,
        counts=PoissonCounts(rate, device=device),
        flux=TruncatedPareto(flux_alpha, flux_lower, flux_upper,
                             device=device),
        device=device,
    )
