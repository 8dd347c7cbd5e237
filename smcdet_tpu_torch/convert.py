"""Build the port's objects from plain hyperparameters.

Each function takes a dict of floats, ints and numpy arrays (the
hyperparameters of a ``smcdet_tpu`` prior, image model, MH or MALA kernel) and
returns the matching ``smcdet_tpu_torch`` object on ``device``, so that the
two packages can be run on exactly the same model.

Dict layouts::

    prior:  min_objects, max_objects, image_height, image_width, pad,
            counts = {"kind": "poisson", "rate"} | {"kind": "uniform",
                     "low", "high"} | {"kind": "geometric", "prob"},
            flux = None | {"kind": "truncated_pareto", "alpha", "lower",
                   "upper"} | {"kind": "pareto", "scale", "alpha"}
                   | {"kind": "normal", "mean", "stdev"}
    model:  height, width, psf_radius, noise, background, adu_per_nmgy,
            noise_additive, noise_multiplicative, normal_tail_threshold,
            psf = {"kind": "sdss", "params" (6), "normalizing_constant",
                   "wing_beta3"} | {"kind": "gaussian", "stdev"}
    kernel: num_iters, locs_stdev, fluxes_stdev, fluxes_min, fluxes_max
            (MALA: locs_step, fluxes_step in place of the stdevs)

``m71_model_from_fit`` builds the M71 image model of a fitted
``FittedImageModel`` (either package's), and ``history_from_arrays`` an
``SMCResult.history`` of arrays (the JAX package's) as the port's dict of
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from smcdet_tpu_torch.distributions import TruncatedPareto
from smcdet_tpu_torch.inference.kernels import (
    SingleComponentMALA,
    SingleComponentMH,
)
from smcdet_tpu_torch.models.imaging import ImageModel, M71ImageModel
from smcdet_tpu_torch.models.priors import (
    GeometricCounts,
    NormalFlux,
    ParetoFlux,
    PoissonCounts,
    PointProcessPrior,
    UniformCounts,
)
from smcdet_tpu_torch.models.psf import SDSSPSF, GaussianPSF

__all__ = ["prior_from_params", "image_model_from_params",
           "mh_kernel_from_params", "mala_kernel_from_params",
           "m71_model_from_fit", "history_from_arrays"]


def _counts(d, device):
    if d["kind"] == "poisson":
        return PoissonCounts(d["rate"], device=device)
    if d["kind"] == "uniform":
        return UniformCounts(d["low"], d["high"])
    if d["kind"] == "geometric":
        return GeometricCounts(d["prob"], device=device)
    raise ValueError(f"unknown count family {d['kind']!r}")


def _flux(d, device):
    if d is None:
        return None
    kind = d["kind"]
    if kind == "truncated_pareto":
        return TruncatedPareto(d["alpha"], d["lower"], d["upper"],
                               device=device)
    if kind == "pareto":
        return ParetoFlux(d["scale"], d["alpha"], device=device)
    if kind == "normal":
        return NormalFlux(d["mean"], d["stdev"], device=device)
    raise ValueError(f"unknown flux family {kind!r}")


def prior_from_params(d: dict, device="cuda") -> PointProcessPrior:
    return PointProcessPrior(
        min_objects=d["min_objects"],
        max_objects=d["max_objects"],
        image_height=d["image_height"],
        image_width=d["image_width"],
        pad=d["pad"],
        counts=_counts(d["counts"], device),
        flux=_flux(d["flux"], device),
        device=device,
    )


def image_model_from_params(d: dict, device="cuda") -> ImageModel:
    p = d["psf"]
    if p["kind"] == "sdss":
        psf = SDSSPSF(*p["params"],
                      normalizing_constant=p["normalizing_constant"],
                      wing_beta3=p["wing_beta3"], device=device)
    elif p["kind"] == "gaussian":
        psf = GaussianPSF(p["stdev"], device=device)
    else:
        raise ValueError(f"unknown PSF {p['kind']!r}")
    return ImageModel(
        height=d["height"],
        width=d["width"],
        psf_radius=d["psf_radius"],
        psf=psf,
        noise=d["noise"],
        background=d["background"],
        adu_per_nmgy=d["adu_per_nmgy"],
        noise_additive=d["noise_additive"],
        noise_multiplicative=d["noise_multiplicative"],
        normal_tail_threshold=d["normal_tail_threshold"],
        device=device,
    )


def mh_kernel_from_params(d: dict, device="cuda",
                          backend="auto") -> SingleComponentMH:
    return SingleComponentMH(
        num_iters=d["num_iters"],
        locs_stdev=d["locs_stdev"],
        fluxes_stdev=d["fluxes_stdev"],
        fluxes_min=d["fluxes_min"],
        fluxes_max=d["fluxes_max"],
        backend=backend,
        device=device,
    )


def mala_kernel_from_params(d: dict, device="cuda",
                            backend="auto") -> SingleComponentMALA:
    return SingleComponentMALA(
        num_iters=d["num_iters"],
        locs_step=d["locs_step"],
        fluxes_step=d["fluxes_step"],
        fluxes_min=d["fluxes_min"],
        fluxes_max=d["fluxes_max"],
        backend=backend,
        device=device,
    )


def m71_model_from_fit(fit, height, width, psf_radius=8, background=None,
                       device="cuda"):
    """The M71 image model of a ``FittedImageModel`` on a ``height x
    width`` tile (its scalar background unless ``background`` is given)."""
    return M71ImageModel(
        height, width, fit.background if background is None else background,
        fit.adu_per_nmgy, fit.psf_params, psf_radius, fit.noise_additive,
        fit.noise_multiplicative, device=device)


def history_from_arrays(history, device="cuda"):
    """``{temperature, ess, acc_rate}`` arrays as float32 tensors on
    ``device`` (``None`` stays ``None``)."""
    if history is None:
        return None
    return {k: torch.as_tensor(np.array(v), dtype=torch.float32,
                               device=device) for k, v in history.items()}
