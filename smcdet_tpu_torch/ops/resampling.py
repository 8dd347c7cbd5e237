"""Particle resampling, batched over leading axes (port of
``smcdet_tpu/ops/resampling.py``): inverse-CDF ``searchsorted`` and
``gather`` along the particle axis."""

from __future__ import annotations

import torch

__all__ = [
    "multinomial_indices",
    "systematic_indices",
    "resample_indices",
    "stratified_indices",
    "gather_particles",
]


def _cdf(p):
    """``cumsum`` along the last axis, the same bits on every call. On a
    CUDA tensor whose only row is that axis (the aggregation's final
    ``[1, 1, N]`` resample) PyTorch scans with CUB's decoupled look-back,
    whose float sums may follow the blocks' timing; a second, zero row
    sends it to the row-wise scan, whose order is fixed."""
    if p.is_cuda and p.numel() == p.shape[-1]:
        rows = p.reshape(1, -1)
        two = torch.cat([rows, torch.zeros_like(rows)])
        return torch.cumsum(two, dim=-1)[0].reshape(p.shape)
    return torch.cumsum(p, dim=-1)


def _inverse_cdf(weights, u):
    cdf = _cdf(weights)
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


def stratified_indices(weights, strata, num_strata: int, method: str, *,
                       generator=None, u=None, offset=None):
    """Within-stratum resampling that keeps every particle's stratum (port
    of ``smcdet_tpu/ops/resampling.py:stratified_indices``, the aggregation
    bridge's resampling).

    ``weights [..., N]`` are within-stratum weights (not normalised across
    strata), ``strata [..., N]`` each particle's stratum id. Returns int64
    ancestors ``[..., N]`` with ``strata[idx] == strata``.

    - ``multinomial``: one iid index table per stratum, drawn from the
      uniforms ``u [..., C, N]``; particle ``n`` reads row ``strata[n]``.
    - ``systematic``: systematic resampling inside each compacted stratum,
      with one offset per stratum (``offset [..., C]``): particle ``n``
      queries its stratum's CDF at ``(rank + offset_c) / n_c``.

    ``u`` / ``offset`` are drawn from ``generator`` when omitted. A stratum
    whose weights are all 0 resamples uniformly over its members, and every
    index is clamped to its stratum's member range.
    """
    N = weights.shape[-1]
    batch = weights.shape[:-1]
    dev = weights.device
    strata = strata.to(torch.int64)
    smask = strata[..., None, :] == torch.arange(num_strata,
                                                 device=dev)[:, None]
    w_strat = torch.where(smask, weights[..., None, :], 0.0)  # [..., C, N]
    total = w_strat.sum(-1, keepdim=True)
    members = smask.sum(-1, keepdim=True)
    uniform = smask.to(torch.float32) / members.clamp(min=1)
    p = torch.where(total > 0.0, w_strat / total.clamp(min=1e-37), uniform)

    strata_row = strata[..., None, :]  # [..., 1, N]
    as_int = smask.to(torch.int32)
    first = torch.argmax(as_int, dim=-1)  # [..., C]
    last = N - 1 - torch.argmax(torch.flip(as_int, (-1,)), dim=-1)
    lo = torch.gather(first, -1, strata)
    hi = torch.gather(last, -1, strata)
    if method == "multinomial":
        if u is None:
            u = torch.rand(batch + (num_strata, N), generator=generator,
                           device=dev)
        table = _inverse_cdf(p, u)  # [..., C, N]
        idx = torch.gather(table, -2, strata_row)[..., 0, :]
        return torch.minimum(torch.maximum(idx, lo), hi)
    if method != "systematic":
        raise ValueError("resample_method must be multinomial or systematic")

    cdf = _cdf(p)
    cum = torch.cumsum(as_int, dim=-1)  # members up to and including n
    n_strat = cum[..., -1].to(torch.float32)  # [..., C]
    rank = torch.gather(cum, -2, strata_row)[..., 0, :] - 1
    if offset is None:
        offset = torch.rand(batch + (num_strata,), generator=generator,
                            device=dev)
    off_n = torch.gather(offset, -1, strata)
    n_n = torch.gather(n_strat, -1, strata)
    q = (rank.to(torch.float32) + off_n) / n_n.clamp(min=1.0)
    # every stratum row answers every query; each particle reads its own
    found = torch.searchsorted(cdf.contiguous(),
                               q[..., None, :].expand(cdf.shape).contiguous(),
                               side="left")
    idx = torch.gather(found, -2, strata_row)[..., 0, :]
    return torch.minimum(torch.maximum(idx, lo), hi)


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
