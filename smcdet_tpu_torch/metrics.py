"""Detection metrics: catalog matching and precision / recall / F1 (port of
``smcdet_tpu/metrics.py``).

The whole (tiles x sampled catalogs) batch is matched at once by the
batched assignment solver (``ops/assignment.py``) on the device of the
inputs, with magnitude bucketing as one-hot reductions. Semantics as the
JAX version's:

- a (true, estimated) pair is matchable iff their location distance is
  within ``locs_tol`` and their magnitude distance within ``mags_tol``;
- matching minimises the total location distance among matchable pairs
  (forbidden pairs cost ``BIG``);
- counts are bucketed by magnitude with ``searchsorted`` into ``mag_bins``;
  values beyond the last bin edge are dropped;
- ``num_est_catalogs_to_match`` posterior catalogs are drawn per tile with
  the posterior weights, or given as ``indices``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smcdet_tpu_torch.ops.assignment import (
    BIG,
    linear_sum_assignment,
    pad_cost_matrix,
)
from smcdet_tpu_torch.ops.resampling import (
    gather_particles,
    multinomial_indices,
)
from smcdet_tpu_torch.utils.units import convert_nmgy_to_mag

__all__ = ["MatchCounts", "match_one", "match_catalogs",
           "compute_precision_recall_f1"]


class MatchCounts(NamedTuple):
    """Bucketed match counts ``[T, n_match, n_bins]`` (float32)."""

    num_true_total: torch.Tensor
    num_true_matches: torch.Tensor
    num_est_total: torch.Tensor
    num_est_matches: torch.Tensor


def _bucket_onehot(mags, valid, mag_bins):
    """One-hot magnitude-bin membership ``[..., M, n_bins]`` of the valid
    slots."""
    idx = torch.searchsorted(mag_bins, mags.contiguous(), side="left")
    onehot = idx[..., None] == torch.arange(mag_bins.shape[0],
                                            device=mags.device)
    return onehot & valid[..., None]


def match_one(true_locs, true_mags, true_valid, est_locs, est_mags,
              est_valid, locs_tol, mags_tol):
    """Match true catalogs against estimated ones, batched over the leading
    axes: true ``[..., Mt(, 2)]``, est ``[..., Me(, 2)]``. Returns
    ``(true_matched [..., Mt], est_matched [..., Me])`` (bool)."""
    diff = true_locs[..., :, None, :] - est_locs[..., None, :, :]
    locs_dist = torch.sqrt((diff * diff).sum(-1))  # [..., Mt, Me]
    mags_dist = (true_mags[..., :, None] - est_mags[..., None, :]).abs()
    feasible = (locs_dist <= locs_tol) & (mags_dist <= mags_tol)

    Mt, Me = locs_dist.shape[-2:]
    n = max(Mt, Me)
    batch = locs_dist.shape[:-2]
    dev = locs_dist.device
    square = torch.full(batch + (n, n), BIG, device=dev)
    square[..., :Mt, :Me] = torch.where(feasible, locs_dist, BIG)
    # slots beyond a catalog's count are padding, like the extra rows and
    # columns of the rectangular embedding
    rv = torch.zeros(batch + (n,), dtype=torch.bool, device=dev)
    cv = torch.zeros(batch + (n,), dtype=torch.bool, device=dev)
    rv[..., :Mt] = true_valid
    cv[..., :Me] = est_valid
    square = pad_cost_matrix(square, rv, cv)

    col4row = linear_sum_assignment(square)  # [..., n]
    pair_ok = (rv & cv.gather(-1, col4row) & (col4row < Me)
               & (square.gather(-1, col4row[..., None]).squeeze(-1) < BIG))
    true_matched = pair_ok[..., :Mt]
    hit = col4row[..., :Mt].clamp(0, Me - 1)[..., None] == torch.arange(
        Me, device=dev)
    est_matched = (hit & true_matched[..., None]).any(-2)
    return true_matched, est_matched


def match_catalogs(true_counts, true_locs, true_fluxes, est_counts,
                   est_locs, est_fluxes, num_est_catalogs_to_match: int,
                   locs_tol: float, mags_tol: float, mag_bins,
                   est_weights=None, *, generator=None,
                   indices=None) -> MatchCounts:
    """Batched catalog matching over ``T`` tiles.

    ``true_*``: ``[T](, Mt(, 2))``; ``est_*``: ``[T, N](, Me(, 2))``, the
    flat posterior catalogs of a result. ``indices [T, S]`` are the sampled
    catalogs; when omitted, ``S = num_est_catalogs_to_match`` catalogs per
    tile are drawn from ``generator`` with the weights ``est_weights [T,
    N]`` (uniform by default). Everything runs on ``est_counts``' device.
    """
    dev = est_counts.device
    mag_bins = torch.as_tensor(mag_bins, dtype=torch.float32, device=dev)
    T, N = est_counts.shape[:2]
    Mt = true_locs.shape[-2]
    Me = est_locs.shape[-2]
    if indices is None:
        if est_weights is None:
            est_weights = torch.full((T, N), 1.0 / N, device=dev)
        indices = multinomial_indices(est_weights,
                                      num_est_catalogs_to_match,
                                      generator=generator)
    indices = torch.as_tensor(indices, device=dev).to(torch.int64)
    S = indices.shape[-1]
    s_counts, s_locs, s_fluxes = gather_particles(
        indices, est_counts, est_locs, est_fluxes, particle_axis=1)

    true_valid = torch.arange(Mt, device=dev) < true_counts[:, None]
    est_valid = torch.arange(Me, device=dev) < s_counts[..., None]
    true_mags = convert_nmgy_to_mag(torch.where(true_valid, true_fluxes,
                                                1.0))  # [T, Mt]
    est_mags = convert_nmgy_to_mag(torch.where(est_valid, s_fluxes,
                                               1.0))  # [T, S, Me]

    def per_catalog(x):
        return x[:, None].expand((T, S) + x.shape[1:])

    true_matched, est_matched = match_one(
        per_catalog(true_locs), per_catalog(true_mags),
        per_catalog(true_valid), s_locs, est_mags, est_valid, locs_tol,
        mags_tol)  # [T, S, Mt], [T, S, Me]

    true_onehot = _bucket_onehot(true_mags, true_valid, mag_bins)
    est_onehot = _bucket_onehot(est_mags, est_valid, mag_bins)
    B = mag_bins.shape[0]
    f32 = torch.float32
    n_true_total = true_onehot.sum(-2)[:, None, :].expand(T, S, B).to(f32)
    n_true_match = (true_onehot[:, None] & true_matched[..., None]).sum(
        -2).to(f32)
    n_est_total = est_onehot.sum(-2).to(f32)
    n_est_match = (est_onehot & est_matched[..., None]).sum(-2).to(f32)
    return MatchCounts(n_true_total, n_true_match, n_est_total, n_est_match)


def compute_precision_recall_f1(counts: MatchCounts):
    """Precision, recall and F1 per (sampled catalog, magnitude bin): the
    sums run over tiles (axis 0) only, leaving ``[n_match, n_bins]``; nan
    becomes 0."""
    precision = torch.nan_to_num(counts.num_est_matches.sum(0)
                                 / counts.num_est_total.sum(0))
    recall = torch.nan_to_num(counts.num_true_matches.sum(0)
                              / counts.num_true_total.sum(0))
    f1 = torch.nan_to_num(2 * precision * recall / (precision + recall))
    return precision, recall, f1
