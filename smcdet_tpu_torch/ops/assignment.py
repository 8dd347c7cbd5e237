"""Batched linear-sum assignment on the device of its input (port of
``smcdet_tpu/ops/assignment.py``).

The shortest-augmenting-path algorithm (Jonker-Volgenant, as scipy's
``linear_sum_assignment``) over square ``n x n`` cost matrices, batched over
every leading axis. The loops have fixed trip counts: ``n`` row
augmentations, each of at most ``n`` column scans and at most ``n``
path-augmentation steps, every step masked to the matrices still working on
it, so nothing is read back to the host. Rows are augmented in order and
ties go to the first minimum, preferring an unassigned column, as in the
JAX version, so both give the same assignment on the same matrix.
``n`` is small for this workload (at most the slot count), so the batch
axis carries the work.
"""

from __future__ import annotations

import torch

__all__ = ["BIG", "linear_sum_assignment", "pad_cost_matrix"]

# Forbidden/padding cost: large enough never to beat a real pairing, small
# enough that a sum of n of them stays finite in float32.
BIG = 1e9


def _set(x, idx, value, mask):
    """``x[b, idx[b]] = value[b]`` where ``mask[b]``."""
    cur = x.gather(1, idx[:, None]).squeeze(1)
    return x.scatter(1, idx[:, None], torch.where(mask, value, cur)[:, None])


def _first(mask):
    """Index of the first True along the last axis (0 if none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _augment(cost, u, v, col4row, row4col, cur_row):
    """One row augmentation of every matrix in the batch (``cost [B, n,
    n]``; the duals and the assignments ``[B, n]``)."""
    B, n, _ = cost.shape
    dev = cost.device
    inf = torch.tensor(float("inf"), device=dev)
    rows = torch.arange(n, device=dev)
    bidx = torch.arange(B, device=dev)
    shortest = torch.full((B, n), float("inf"), device=dev)
    path = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    scanned_cols = torch.zeros((B, n), dtype=torch.bool, device=dev)
    scanned_rows = torch.zeros((B, n), dtype=torch.bool, device=dev)
    min_val = torch.zeros(B, device=dev)
    i = torch.full((B,), cur_row, dtype=torch.int64, device=dev)
    sink = torch.full((B,), -1, dtype=torch.int64, device=dev)

    for _ in range(n):  # each scan takes a new column: n scans at most
        go = sink < 0
        g = go[:, None]
        scanned_rows = scanned_rows | (g & (rows == i[:, None]))
        cost_i = cost[bidx, i]
        u_i = u.gather(1, i[:, None])
        reduced = min_val[:, None] + cost_i - u_i - v
        better = g & (reduced < shortest) & ~scanned_cols
        shortest = torch.where(better, reduced, shortest)
        path = torch.where(better, i[:, None], path)

        masked = torch.where(scanned_cols, inf, shortest)
        lowest = masked.min(-1).values
        is_min = masked == lowest[:, None]
        # prefer an unassigned column among the minima (scipy's tie rule)
        unassigned_min = is_min & (row4col == -1)
        j = torch.where(unassigned_min.any(-1), _first(unassigned_min),
                        _first(is_min))
        scanned_cols = scanned_cols | (g & (rows == j[:, None]))
        owner = row4col.gather(1, j[:, None]).squeeze(1)
        free = owner == -1
        sink = torch.where(go & free, j, sink)
        i = torch.where(go & ~free, owner, i)
        min_val = torch.where(go, lowest, min_val)

    # dual updates
    u = u + torch.where(rows == cur_row, min_val[:, None], 0.0)
    other_rows = scanned_rows & (rows != cur_row)
    # shortest path cost at the column currently assigned to each row
    spc = torch.where(col4row >= 0,
                      shortest.gather(1, col4row.clamp(min=0)), 0.0)
    u = u + torch.where(other_rows, min_val[:, None] - spc, 0.0)
    v = v + torch.where(scanned_cols, -(min_val[:, None] - shortest), 0.0)

    # augment along the alternating path that ends at the sink
    # (indices clamped where a finished matrix reads on: its writes are
    # masked)
    j = sink.clamp(min=0)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(n):
        go = ~done
        r = path.gather(1, j[:, None]).squeeze(1).clamp(min=0)
        row4col = _set(row4col, j, r, go)
        next_j = col4row.gather(1, r[:, None]).squeeze(1)
        col4row = _set(col4row, r, j, go)
        done = done | (r == cur_row)
        j = torch.where(go, next_j, j).clamp(min=0)
    return u, v, col4row, row4col


def linear_sum_assignment(cost):
    """Minimum-cost perfect matching of square cost matrices.

    ``cost [..., n, n]`` -> ``col4row [..., n]`` (int64): the column assigned
    to each row. Runs on ``cost``'s device, batched over all leading axes.
    """
    cost = torch.as_tensor(cost, dtype=torch.float32)
    batch = cost.shape[:-2]
    n = cost.shape[-1]
    flat = cost.reshape(-1, n, n)
    B = flat.shape[0]
    dev = cost.device
    u = torch.zeros((B, n), device=dev)
    v = torch.zeros((B, n), device=dev)
    col4row = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    row4col = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    for cur_row in range(n):
        u, v, col4row, row4col = _augment(flat, u, v, col4row, row4col,
                                          cur_row)
    return col4row.reshape(batch + (n,))


def pad_cost_matrix(cost, row_valid, col_valid, big=BIG):
    """Embed a masked rectangular problem into a square one.

    Entries where one end is invalid (a padding slot) cost ``big``, except
    (pad, pad) pairs, which cost 0, so that padding absorbs padding. An
    optimal square assignment then never gives up a feasible real pairing,
    and marks infeasible or padded matches with cost >= ``big`` for the
    caller to discard.
    """
    rv = row_valid[..., :, None]
    cv = col_valid[..., None, :]
    return torch.where(rv & cv, cost,
                       torch.where(~rv & ~cv, 0.0, big))
