"""Distributions used by the priors and the mutation kernel.

Port of ``smcdet_tpu/distributions.py``. Samplers take either a
``torch.Generator`` or explicit uniforms; the explicit form is what lets a
test feed the JAX and PyTorch versions the same random numbers.
"""

from __future__ import annotations

import math

import torch
from torch.special import ndtri

__all__ = [
    "UNIFORM_EPS",
    "DiscreteUniform",
    "TruncatedPareto",
    "beta_log_prob",
    "beta_sample",
    "gamma_log_sample",
    "gumbel_sample",
    "ndtr",
    "truncated_normal_sample",
    "truncated_normal_log_mass",
    "truncated_normal_log_prob",
]

UNIFORM_EPS = 1e-6
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_HALF_SQRT_2 = 0.5 * math.sqrt(2.0)


def ndtr(x):
    """The standard normal CDF by the JAX package's formula
    (``jax.scipy.special.ndtr``): ``(1 + erf(x / sqrt 2)) / 2`` near 0 and
    ``erfc(|x| / sqrt 2) / 2`` (or 1 minus it) beyond. The lower tail stays
    accurate down to f32's smallest normal number, where
    ``torch.special.ndtr`` in f32 flushes to 0 below about -5.4: a
    truncation mass far above the box (a MALA drift's) then has its true
    log, not 0. A subnormal result is 0, as XLA's f32 arithmetic flushes
    it."""
    w = x * _HALF_SQRT_2
    z = w.abs()
    y = 0.5 * torch.where(z < _HALF_SQRT_2, 1.0 + torch.erf(w),
                          torch.where(w > 0, 2.0 - torch.erfc(z),
                                      torch.erfc(z)))
    return torch.where(y < torch.finfo(y.dtype).tiny, 0.0, y)


def truncated_normal_sample(mu, sigma, lb, ub, *, u=None, generator=None):
    """Inverse-CDF sample from a normal truncated to ``[lb, ub]``.

    ``u`` are base uniforms (drawn from ``generator`` when omitted),
    clipped to ``[1e-6, 1 - 1e-6]``; the transformed CDF value is clipped
    again and the result clamped into the box, as in the JAX version.
    """
    mu, sigma, lb, ub = (torch.as_tensor(v, dtype=torch.float32,
                                         device=mu.device)
                         for v in (mu, sigma, lb, ub))
    if u is None:
        shape = torch.broadcast_shapes(mu.shape, sigma.shape, lb.shape,
                                       ub.shape)
        u = torch.rand(shape, generator=generator, device=mu.device)
    u = u.clamp(UNIFORM_EPS, 1.0 - UNIFORM_EPS)
    cdf_lb = ndtr((lb - mu) / sigma)
    cdf_ub = ndtr((ub - mu) / sigma)
    p = (cdf_lb + u * (cdf_ub - cdf_lb)).clamp(UNIFORM_EPS, 1.0 - UNIFORM_EPS)
    x = mu + sigma * ndtri(p)
    return torch.minimum(torch.maximum(x, lb), ub)


def _log_mass(prob_in_box):
    return torch.nan_to_num(torch.log(prob_in_box), nan=0.0, posinf=0.0,
                            neginf=0.0)


def truncated_normal_log_mass(mu, sigma, lb, ub):
    """``log(Phi((ub-mu)/sigma) - Phi((lb-mu)/sigma))``, nan-guarded.

    For a truncated-normal random walk the Gaussian kernels cancel, so the
    MH proposal correction is ``log mass(x) - log mass(x')``.
    """
    return _log_mass(ndtr((ub - mu) / sigma) - ndtr((lb - mu) / sigma))


def truncated_normal_log_prob(value, mu, sigma, lb, ub):
    """Log-density of a normal truncated to ``[lb, ub]``."""
    z = (value - mu) / sigma
    normal = -0.5 * z * z - torch.log(torch.as_tensor(sigma)) - _HALF_LOG_2PI
    return normal - truncated_normal_log_mass(mu, sigma, lb, ub)


def gumbel_sample(shape, generator, device):
    """Standard Gumbel draws ``-log(-log(U))`` from ``generator``, with U
    clamped away from 0 and 1 so that both logs are finite."""
    u = torch.rand(tuple(shape), generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    u = u.clamp(tiny, 1.0 - torch.finfo(torch.float32).eps / 2)
    return -torch.log(-torch.log(u))


def gamma_log_sample(a: float, shape, generator, device):
    """Logs of Gamma(a, 1) draws from ``generator`` by Marsaglia and Tsang's
    rejection (for ``a < 1`` a Gamma(a + 1) draw times ``U^(1/a)``, added
    in logs so that small shapes do not underflow). Rejected entries draw
    again, a round at a time, until every entry is accepted."""
    a = float(a)
    if a <= 0:
        raise ValueError(f"gamma shape must be positive, got {a}")
    shape = tuple(shape)
    d = (a + 1.0 if a < 1.0 else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    while not bool(done.all()):
        x = torch.randn(shape, generator=generator, device=device)
        u = torch.rand(shape, generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        # log of a non-positive v is nan or -inf: the comparison rejects
        log_v = torch.log(v)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
        take = ok & ~done
        out = torch.where(take, math.log(d) + log_v, out)
        done = done | take
    if a < 1.0:
        u = torch.rand(shape, generator=generator, device=device)
        out = out + torch.log(u) / a
    return out


def beta_sample(a: float, shape, generator, device):
    """Symmetric Beta(a, a) draws from ``generator``: a uniform for
    ``a == 1`` (the only value the shipped configs use), else ``X / (X +
    Y)`` for two Gamma(a) draws, as the logistic of their log ratio."""
    if float(a) == 1.0:
        return torch.rand(tuple(shape), generator=generator, device=device)
    log_x = gamma_log_sample(a, shape, generator, device)
    log_y = gamma_log_sample(a, shape, generator, device)
    return torch.sigmoid(log_x - log_y)


def beta_log_prob(u, a: float):
    """Log-density of Beta(a, a) at ``u`` in (0, 1); 0 for ``a == 1``."""
    a = float(a)
    if a == 1.0:
        return torch.zeros_like(u)
    log_norm = 2.0 * math.lgamma(a) - math.lgamma(2.0 * a)
    return (a - 1.0) * (torch.log(u) + torch.log1p(-u)) - log_norm


class DiscreteUniform:
    """Uniform distribution over the integers ``{low, ..., high}``."""

    def __init__(self, low: int, high: int):
        self.low = int(low)
        self.high = int(high)

    def sample(self, shape, generator=None, device=None):
        """Integer draws on ``device``, by default the generator's (the
        card without one)."""
        if device is None:
            device = generator.device if generator is not None else "cuda"
        return torch.randint(self.low, self.high + 1, tuple(shape),
                             generator=generator, device=device,
                             dtype=torch.int32)

    def log_prob(self, value):
        value = torch.as_tensor(value)
        in_support = (value >= self.low) & (value <= self.high)
        logp = -math.log(float(self.high - self.low + 1))
        return torch.where(in_support, logp, -math.inf).to(torch.float32)


class TruncatedPareto:
    """Pareto distribution truncated to ``[lower, upper]`` (closed-form
    inverse-CDF sampling and log-pdf). ``alpha``, ``lower`` and ``upper``
    are 0-d float32 tensors on the distribution's device."""

    def __init__(self, alpha, lower, upper, device="cuda"):
        def t(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        self.alpha, self.lower, self.upper = t(alpha), t(lower), t(upper)

    @property
    def logpdf_norm_const(self):
        a, lo, hi = self.alpha, self.lower, self.upper
        return (torch.log(a) + a * torch.log(lo) + a * torch.log(hi)
                - torch.log(hi**a - lo**a))

    # reference-point / support hooks (smcdet_tpu/models/priors.py:172-180)
    @property
    def reference_point(self):
        return self.lower

    @property
    def support_lower(self):
        return self.lower

    @property
    def support_upper(self):
        return self.upper

    def sample(self, shape, generator=None, *, u=None):
        if u is None:
            u = torch.rand(tuple(shape), generator=generator,
                           device=self.alpha.device)
        ua = self.upper**self.alpha
        la = self.lower**self.alpha
        numerator = ua - u * ua + u * la
        return (numerator / (la * ua)) ** (-1.0 / self.alpha)

    def log_prob(self, value):
        return self.logpdf_norm_const - (self.alpha + 1.0) * torch.log(value)
