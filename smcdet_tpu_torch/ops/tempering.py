"""Adaptive likelihood tempering (port of ``smcdet_tpu/ops/tempering.py``).

Find the largest step ``delta in [0, 1 - temperature]`` whose incremental
weights ``exp(delta * loglik)`` keep ``ESS >= ess_target``, by a
fixed-iteration bisection batched over every leading axis.
"""

from __future__ import annotations

import torch

__all__ = ["ess_at_delta", "solve_tempering_step"]


def ess_at_delta(loglik, delta):
    """ESS of incremental weights ``delta * loglik``: ``loglik [..., N]``,
    ``delta [...]`` -> ``[...]``."""
    d = delta[..., None]
    log_num = 2.0 * torch.logsumexp(d * loglik, dim=-1)
    log_den = torch.logsumexp(2.0 * d * loglik, dim=-1)
    return torch.exp(log_num - log_den)


def _ess_shifted(shifted, delta):
    w = torch.exp(delta[..., None] * shifted)
    s1 = w.sum(-1)
    s2 = (w * w).sum(-1)
    return s1 * s1 / torch.clamp(s2, min=1e-37)


def solve_tempering_step(loglik, temperature, ess_target,
                         num_iters: int = 40):
    """Batched bisection for the adaptive tempering step.

    ``loglik [..., N]``, ``temperature`` broadcastable to ``[...]``.
    Returns ``delta [...]``: the full remaining step when its ESS meets
    the target, otherwise the bisection midpoint after ``num_iters``
    halvings.
    """
    loglik = torch.nan_to_num(loglik, neginf=-1e30)
    shifted = loglik - loglik.max(-1, keepdim=True).values
    remaining = torch.clamp(1.0 - temperature, 0.0, 1.0)
    remaining = remaining.expand(loglik.shape[:-1])
    full_step_ok = _ess_shifted(shifted, remaining) >= ess_target
    lo = torch.zeros_like(remaining)
    hi = remaining
    for _ in range(num_iters):
        mid = 0.5 * (lo + hi)
        too_degenerate = _ess_shifted(shifted, mid) < ess_target
        hi = torch.where(too_degenerate, mid, hi)
        lo = torch.where(too_degenerate, lo, mid)
    return torch.where(full_step_ok, remaining, 0.5 * (lo + hi))
