"""Particle resampling, batched over leading axes (port of
``smcdet_tpu/ops/resampling.py``): inverse-CDF ``searchsorted`` and
``gather`` along the particle axis."""

from __future__ import annotations

import torch

__all__ = [
    "multinomial_indices",
    "systematic_indices",
    "resample_indices",
    "gather_particles",
]


def _inverse_cdf(weights, u):
    cdf = torch.cumsum(weights, dim=-1)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), side="left")
    return idx.clamp(max=weights.shape[-1] - 1)


def multinomial_indices(weights, num: int, *, generator=None, u=None):
    """IID draws from ``Categorical(weights)``: ``weights [..., N]``
    (normalised) -> int64 ``[..., num]``. ``u [..., num]`` are the
    uniforms, drawn from ``generator`` when omitted."""
    if u is None:
        u = torch.rand(weights.shape[:-1] + (num,), generator=generator,
                       device=weights.device)
    return _inverse_cdf(weights, u)


def systematic_indices(weights, num: int, *, generator=None, offset=None):
    """Systematic (low-variance) resampling: one uniform ``offset [..., 1]``
    per batch element, strided by ``1/num``."""
    if offset is None:
        offset = torch.rand(weights.shape[:-1] + (1,), generator=generator,
                            device=weights.device)
    grid = torch.arange(num, dtype=torch.float32, device=weights.device)
    u = (grid + offset) / num
    return _inverse_cdf(weights, u)


def resample_indices(weights, num: int, method: str, *, generator=None):
    if method == "multinomial":
        return multinomial_indices(weights, num, generator=generator)
    if method == "systematic":
        return systematic_indices(weights, num, generator=generator)
    raise ValueError("resample_method must be multinomial or systematic")


def gather_particles(idx, *arrays, particle_axis: int):
    """Gather each array along ``particle_axis`` with batched indices
    ``idx [*B, n_out]``, where ``*B`` are the array's leading axes."""
    out = []
    for a in arrays:
        ax = particle_axis % a.ndim
        trailing = a.shape[ax + 1:]
        ix = idx.reshape(idx.shape + (1,) * len(trailing)).expand(
            idx.shape + trailing
        )
        out.append(torch.gather(a, ax, ix))
    return out[0] if len(out) == 1 else tuple(out)
