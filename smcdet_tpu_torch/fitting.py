"""Model-hyperparameter fitting, the data-prep MLE stage (port of
``smcdet_tpu/fitting.py``):

- ``fit_truncated_pareto_flux``: the truncated-Pareto flux-prior MLE
  (``scipy.stats.truncpareto.fit``), a copy;
- ``fit_poisson_rate``: the Poisson count-rate MLE, a copy;
- ``fit_image_model``: the joint MLE of the six SDSS PSF parameters, the
  Gaussian noise model (additive + multiplicative) and the nmgy -> ADU
  calibration against an image with known star positions and fluxes, by
  ``torch.optim.LBFGS`` with a strong-Wolfe line search on the gradient
  that autograd takes of the port's M71 log-likelihood (the JAX package
  runs ``optax.lbfgs`` on ``jax.grad``), under the same
  log-parameterisation.

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


# the loss a line-search trial point gets when the model overflows there
_OVERFLOW_LOSS = 1e30


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


def _model(p, height, width, psf_radius, background, device):
    """The M71 image model at the log-parameters ``p``, built from tensors
    so that autograd reaches every parameter."""
    psf = SDSSPSF(*torch.exp(p["log_psf"]), wing_beta3=False, device=device)
    side = 32 * int(psf_radius)
    # the normalising sum of SDSSPSF.create, over the same grid
    coords = (torch.arange(side, dtype=torch.float32, device=device)
              - side / 2.0 + 0.5)
    psf.normalizing_constant = psf.unnormalized(
        coords[:, None] ** 2 + coords[None, :] ** 2).sum()
    return ImageModel(
        height, width, psf_radius, psf, noise="gaussian",
        background=background,
        adu_per_nmgy=torch.exp(p["log_adu"]),
        noise_additive=torch.exp(p["log_add"]),
        noise_multiplicative=torch.exp(p["log_mult"]),
        device=device,
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
    the M71 image model with ``num_steps`` L-BFGS iterations (history 10,
    strong-Wolfe line search from a tenth of the quasi-Newton step) on
    ``device``; positivity by
    log-parameterisation. Raises ``FloatingPointError`` if the loss
    diverges (a line-search trial point where the model overflows counts
    as a huge loss, so the search steps back from it). ``final_loss`` is
    the loss at the start of the last step.
    """
    device = torch.device(device)
    image = _f32(image, device)
    locs = _f32(locs, device)
    fluxes = _f32(fluxes_nmgy, device)
    background = _f32(background_init, device)
    H, W = image.shape

    def leaf(v):
        return torch.log(_f32(v, device)).clone().requires_grad_(True)

    p = {
        "log_psf": leaf(psf_params_init),
        "log_adu": leaf(adu_per_nmgy_init),
        "log_add": leaf(noise_additive_init),
        "log_mult": leaf(noise_multiplicative_init),
    }
    if fit_background:
        p["log_bkg"] = leaf(float(background.mean()))

    def model_at():
        bkg = torch.exp(p["log_bkg"]) if fit_background else background
        return _model(p, H, W, psf_radius, bkg, device)

    # the first trial of each line search at a tenth of the quasi-Newton
    # step: at the full step the first iterations' trials overshoot, and
    # the search, unable to tell float32 losses apart at the tiny steps it
    # then tries, ends with no step (the fit does not move from its start)
    opt = torch.optim.LBFGS(list(p.values()), lr=0.1, max_iter=1,
                            history_size=10,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = -model_at().loglikelihood(image, locs, fluxes) / (H * W)
        if not torch.isfinite(loss):
            # a trial step of the line search overflowed the model: a huge
            # finite loss with a zero gradient brackets the step, where a
            # NaN would fail every comparison and extrapolate further
            return torch.tensor(_OVERFLOW_LOSS, device=device)
        loss.backward()
        return loss

    value = float("inf")
    for _ in range(num_steps):
        value = float(opt.step(closure).detach())
        if not value < _OVERFLOW_LOSS:  # the model overflows where it stands
            raise FloatingPointError("image-model fit diverged")

    with torch.no_grad():
        model = model_at()
        return FittedImageModel(
            psf_params=tuple(float(v) for v in torch.exp(p["log_psf"])),
            # a scalar summary even when a background map was given
            background=float(model.background.mean()),
            adu_per_nmgy=float(torch.exp(p["log_adu"])),
            noise_additive=float(torch.exp(p["log_add"])),
            noise_multiplicative=float(torch.exp(p["log_mult"])),
            final_loss=value,
        )
