"""Model-hyperparameter fitting, the data-prep MLE stage (port of
``smcdet_tpu/fitting.py``):

- ``fit_truncated_pareto_flux``: the truncated-Pareto flux-prior MLE
  (``scipy.stats.truncpareto.fit``), a copy;
- ``fit_poisson_rate``: the Poisson count-rate MLE, a copy;
- ``fit_image_model``: the joint MLE of the six SDSS PSF parameters, the
  Gaussian noise model (additive + multiplicative) and the nmgy -> ADU
  calibration against an image with known star positions and fluxes, by
  ``optax.lbfgs``'s algorithm (its memory, scaling and zoom line search,
  here in torch) on the gradient that autograd takes of the port's M71
  log-likelihood, under the same log-parameterisation.

The PSF is built from tensors (``SDSSPSF`` with its normalising sum taken
on them, the general-beta wing), so the gradient reaches every parameter;
the sampler's constructor ``SDSSPSF.create`` reads its parameters as
floats and is not used here.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from smcdet_tpu_torch.models.imaging import ImageModel
from smcdet_tpu_torch.models.psf import SDSSPSF

__all__ = [
    "fit_truncated_pareto_flux",
    "fit_poisson_rate",
    "fit_image_model",
    "FittedImageModel",
    "in_window_calibration",
]


def fit_truncated_pareto_flux(fluxes, lower=None, upper=None):
    """MLE of the truncated-Pareto flux prior.

    Returns ``(alpha, lower, upper)``; bounds default to the sample range
    (``scipy.stats.truncpareto`` with the shape and scale free). A fixed
    ``upper`` (e.g. the saturation limit) leaves only the shape free and
    drops samples outside ``[lower, upper]`` with a warning.
    """
    from scipy.stats import truncpareto

    fluxes = np.asarray(fluxes, dtype=np.float64)
    fluxes = fluxes[fluxes > 0]
    lower = float(fluxes.min()) if lower is None else float(lower)
    # scipy's truncpareto: pdf(x, b, c) ~ x^{-b-1} on [1, c], scaled
    if upper is None:
        b, c, loc, scale = truncpareto.fit(fluxes, floc=0.0, fscale=lower)
        return float(b), lower, float(c * lower)
    # a heavy tail's sample maximum is a poor truncation point, so the
    # caller may fix it; samples outside the fixed support would make the
    # NLL infinite
    upper = float(upper)
    in_support = (fluxes >= lower) & (fluxes <= upper)
    if not in_support.all():
        dropped = int((~in_support).sum())
        warnings.warn(
            f"fit_truncated_pareto_flux: dropping {dropped} sample(s) "
            f"outside the fixed support [{lower:g}, {upper:g}]"
        )
        fluxes = fluxes[in_support]
    if fluxes.size == 0:
        raise ValueError(
            "fit_truncated_pareto_flux: no samples inside the fixed "
            f"support [{lower:g}, {upper:g}]"
        )
    b, c, loc, scale = truncpareto.fit(
        fluxes, fc=upper / lower, floc=0.0, fscale=lower
    )
    return float(b), lower, upper


def fit_poisson_rate(counts, area):
    """Poisson count-rate MLE: mean count per unit area."""
    counts = np.asarray(counts, dtype=np.float64)
    return float(counts.mean() / area)


# optax.lbfgs's defaults, which the JAX package fits with: the memory, and
# its zoom line search's (scale_by_zoom_linesearch)
MEMORY_SIZE = 10
_LS_STEPS = 20
_SLOPE_RTOL, _CURV_RTOL, _APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
_INCREASE, _INTERVAL_THRESHOLD = 2.0, 1e-5


def in_window_calibration(adu_per_nmgy, psf_params, psf_radius=8):
    """The ADU that one nmgy at a pixel corner puts into its render
    window, the ``(2r+1)^2`` pixels the image model renders it into:
    ``adu_per_nmgy`` times the window's share of the normalised PSF, whose
    normalising sum runs over the ``32r x 32r`` grid, both at the same
    half-pixel offsets (float64).

    An image constrains this product and not its factors: the wing's mass
    between the window and the grid's edge reaches no pixel, so a wider,
    heavier wing and a higher ``adu_per_nmgy`` give the same image. Where
    a patch barely constrains the wing, a fit moves along that valley
    (``adu_per_nmgy`` 854 to 1153 at one in-window calibration on a
    synthetic 64x64 patch) and this is what it recovers."""
    s1, s2, sp, beta, b, p0 = (float(v) for v in psf_params)

    def unnormalized(r2):
        return (np.exp(-r2 / (2.0 * s1)) + b * np.exp(-r2 / (2.0 * s2))
                + p0 * (1.0 + r2 / (beta * sp)) ** (-beta / 2.0))

    r = int(psf_radius)
    grid = np.arange(32 * r) - 16.0 * r + 0.5
    window = np.arange(-r, r + 1) + 0.5
    share = (unnormalized(window[:, None] ** 2 + window[None, :] ** 2).sum()
             / unnormalized(grid[:, None] ** 2 + grid[None, :] ** 2).sum())
    return float(adu_per_nmgy) * float(share)


class FittedImageModel(NamedTuple):
    psf_params: tuple
    background: float
    adu_per_nmgy: float
    noise_additive: float
    noise_multiplicative: float
    final_loss: float


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def _model(x, height, width, psf_radius, background, device):
    """The M71 image model at the log-parameters ``x`` (the six PSF
    entries, the calibration, the additive and the multiplicative noise),
    built from tensors so that autograd reaches every one."""
    e = torch.exp(x)
    psf = SDSSPSF(*e[:6], wing_beta3=False, device=device)
    side = 32 * int(psf_radius)
    # the normalising sum of SDSSPSF.create, over the same grid
    coords = (torch.arange(side, dtype=torch.float32, device=device)
              - side / 2.0 + 0.5)
    psf.normalizing_constant = psf.unnormalized(
        coords[:, None] ** 2 + coords[None, :] ** 2).sum()
    return ImageModel(
        height, width, psf_radius, psf, noise="gaussian",
        background=background, adu_per_nmgy=e[6], noise_additive=e[7],
        noise_multiplicative=e[8], device=device,
    )


def fit_image_model(
    image,
    locs,
    fluxes_nmgy,
    psf_params_init,
    background_init,
    adu_per_nmgy_init,
    psf_radius: int = 8,
    noise_additive_init: float = 1.0,
    noise_multiplicative_init: float = 1.0,
    num_steps: int = 200,
    fit_background: bool = False,
    device="cuda",
):
    """Joint MLE of PSF / noise / calibration against an image.

    ``image``: ``[H, W]`` (ADU); ``locs``: ``[M, 2]`` known star positions;
    ``fluxes_nmgy``: ``[M]`` known fluxes; ``background_init``: a scalar or
    an ``[H, W]`` map (held fixed unless ``fit_background``, which fits a
    scalar). Minimises the per-pixel negative Gaussian log-likelihood of
    the M71 image model with ``num_steps`` iterations of the L-BFGS that
    the JAX package runs (``optax.lbfgs`` with its zoom line search,
    ``_lbfgs``) on ``device``, in float32; positivity by
    log-parameterisation. Raises ``FloatingPointError`` if a step starts
    at a non-finite loss. ``final_loss`` is the loss at the fitted
    parameters.
    """
    device = torch.device(device)
    image = _f32(image, device)
    locs = _f32(locs, device)
    fluxes = _f32(fluxes_nmgy, device)
    background = _f32(background_init, device)
    H, W = image.shape
    # the log-parameters, as _model takes them, then the fitted scalar sky
    start = [*psf_params_init, adu_per_nmgy_init, noise_additive_init,
             noise_multiplicative_init]
    if fit_background:
        start.append(float(background.mean()))

    def model_at(x):
        bkg = torch.exp(x[9]) if fit_background else background
        return _model(x, H, W, psf_radius, bkg, device)

    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        loss = -model_at(x).loglikelihood(image, locs, fluxes) / (H * W)
        return loss.detach(), torch.autograd.grad(loss, x)[0]

    x, value = _lbfgs(value_and_grad, torch.log(_f32(start, device)),
                      num_steps)
    with torch.no_grad():
        e = torch.exp(x)
        return FittedImageModel(
            psf_params=tuple(float(v) for v in e[:6]),
            # a scalar summary even when a background map was given
            background=float(model_at(x).background.mean()),
            adu_per_nmgy=float(e[6]),
            noise_additive=float(e[7]),
            noise_multiplicative=float(e[8]),
            final_loss=float(value),
        )


def _lbfgs(value_and_grad, x, num_steps):
    """``num_steps`` iterations of ``optax.lbfgs()`` (memory 10, the first
    step's inverse-Hessian scale capped at the gradient's inverse norm,
    each later one ``s.y / y.y``, every pair kept, the zoom line search)
    from the flat float32 parameters ``x``; ``value_and_grad(x)`` returns
    the loss and its gradient. Returns the parameters and their loss.
    Raises ``FloatingPointError`` where a step starts at a non-finite
    loss."""
    value, grad = value_and_grad(x)
    memory = []  # (s, y, rho), the newest last
    prev = None
    for _ in range(num_steps):
        if not bool(torch.isfinite(value)):
            raise FloatingPointError("image-model fit diverged")
        if prev is None:
            s = y = torch.zeros_like(x)
            rho = torch.zeros((), device=x.device)
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        else:
            s, y = x - prev[0], grad - prev[1]
            sy, yy = torch.dot(y, s), torch.dot(y, y)
            rho = torch.where(sy == 0, 0.0, 1.0 / sy)
            gamma = torch.where(yy > 0, sy / yy, 1.0)
        memory = (memory + [(s, y, rho)])[-MEMORY_SIZE:]
        # the two-loop product of the inverse-Hessian estimate and grad
        q, alphas = grad, []
        for s, y, rho in reversed(memory):
            alphas.append(rho * torch.dot(s, q))
            q = q - alphas[-1] * y
        q = gamma * q
        for (s, y, rho), alpha in zip(memory, reversed(alphas)):
            q = q + (alpha - rho * torch.dot(y, q)) * s
        prev = (x, grad)
        x, value, grad = _zoom_linesearch(value_and_grad, x, value, grad, -q)
    return x, value


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through ``(a, fa)`` with slope
    ``fpa`` there, ``(b, fb)`` and ``(c, fc)``; NaN where there is none."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    rb, rc = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc ** 2 * rb - db ** 2 * rc) / denom
    B = (-(dc ** 3) * rb + db ** 3 * rc) / denom
    return a + (-B + np.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through ``(a, fa)`` with slope
    ``fpa`` there and ``(b, fb)``."""
    db = b - a
    return a - fpa / (2.0 * ((fb - fa - fpa * db) / db ** 2))


def _zoom_linesearch(value_and_grad, x, value, grad, u):
    """``optax.scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy="one")`` along ``u`` from ``x``: the interval
    search from a unit step, doubling, then the zoom by cubic, quadratic
    or bisection points (Nocedal and Wright, algorithms 3.5 and 3.6). A
    step is accepted on the strong-Wolfe curvature condition with either
    Armijo's decrease or, within 1e-6 of the start's loss, Hager and
    Zhang's approximate decrease on the slope: near the optimum a float32
    loss cannot resolve Armijo's decrease, and a search that asks for it
    alone stalls there. After 20 trials, or once the interval is under
    1e-5 with a decrease found, it takes the lowest trial that decreased.
    Returns the new parameters with their loss and gradient; the scalars
    are float32, as optax's."""
    def f32(v):
        return np.float32(float(v))

    v0, s0 = f32(value), f32(torch.dot(u, grad))

    def on_line(eta):
        v, g = value_and_grad(x + float(eta) * u)
        return f32(v), g, f32(torch.dot(g, u))

    def errors(eta, v, s):
        decrease = v - v0 - f32(_SLOPE_RTOL) * eta * s0
        approx = np.maximum(s - f32(2 * _SLOPE_RTOL - 1) * s0,
                            v - v0 - f32(_APPROX_DEC_RTOL) * abs(v0))
        decrease = np.maximum(np.minimum(approx, decrease), f32(0))
        curvature = np.maximum(abs(s) - f32(_CURV_RTOL) * abs(s0), f32(0))
        return tuple(f32(np.inf) if np.isnan(e) else e
                     for e in (decrease, curvature))

    zero = f32(0)
    eta, v, g, s = zero, v0, grad, s0
    low, high = (zero, v0, s0), (zero, v0, s0)  # (step, value, slope)
    cubic_ref = (zero, v0)
    safe = (zero, v0, grad)
    found = False
    with np.errstate(all="ignore"):
        for count in range(_LS_STEPS):
            if not found:  # the interval search
                prev = (eta, v, s)
                eta = f32(1) if count == 0 else f32(_INCREASE) * eta
                v, g, s = on_line(eta)
                dec, curv = errors(eta, v, s)
                if dec <= 0:
                    safe = (eta, v, g)
                to_high = dec > 0 or (v >= prev[1] and count > 0)
                to_low = s >= 0 and not to_high
                low, high = ((eta, v, s), prev) if to_low else (prev,
                                                                (eta, v, s))
                cubic_ref = low[:2]
                found = to_high or to_low or max(dec, curv) <= 0
                small = False
            else:  # the zoom
                delta = abs(high[0] - low[0])
                left, right = min(high[0], low[0]), max(high[0], low[0])
                small = delta <= _INTERVAL_THRESHOLD
                cubic = _cubicmin(*low, *high[:2], *cubic_ref)
                quad = _quadmin(*low, *high[:2])
                if left + f32(0.2) * delta < cubic < right - f32(0.2) * delta:
                    eta = cubic
                elif left + f32(0.1) * delta < quad < right - f32(0.1) * delta:
                    eta = quad
                else:
                    eta = (low[0] + high[0]) / f32(2)
                v, g, s = on_line(eta)
                dec, curv = errors(eta, v, s)
                if dec <= 0 and v < safe[1]:
                    safe = (eta, v, g)
                to_high = dec > 0 or v >= low[1]
                cubic_ref = high[:2] if to_high or s * (
                    high[0] - low[0]) >= 0 else low[:2]
                if to_high:
                    high = (eta, v, s)
                else:
                    if s * (high[0] - low[0]) >= 0:
                        high = low
                    low = (eta, v, s)
            if max(dec, curv) <= 0:
                break
            if count + 1 >= _LS_STEPS or (small and safe[0] > 0):
                if safe[0] > 0 or np.isinf(dec):
                    eta, v, g = safe
                break
    return x + float(eta) * u, torch.as_tensor(v), g
