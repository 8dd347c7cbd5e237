"""Helpers for the parity tests between ``smcdet_tpu`` and its PyTorch port.

``*_params`` read a JAX object's hyperparameters into the plain dicts that
``smcdet_tpu_torch.convert`` builds the port's objects from, so both
packages compute the same function.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smcdet_tpu import distributions as jdist
from smcdet_tpu.models import priors as jpriors
from smcdet_tpu.models import psf as jpsf
from smcdet_tpu_torch import convert


def _f(x):
    return float(np.asarray(x))


def prior_params(prior) -> dict:
    c = prior.counts
    if isinstance(c, jpriors.PoissonCounts):
        counts = {"kind": "poisson", "rate": _f(c.rate)}
    elif isinstance(c, jpriors.UniformCounts):
        counts = {"kind": "uniform", "low": c.low, "high": c.high}
    elif isinstance(c, jpriors.GeometricCounts):
        counts = {"kind": "geometric", "prob": _f(c.prob)}
    else:
        raise NotImplementedError(type(c))
    f = prior.flux
    if f is None:
        flux = None
    elif isinstance(f, jdist.TruncatedPareto):
        flux = {"kind": "truncated_pareto", "alpha": _f(f.alpha),
                "lower": _f(f.lower), "upper": _f(f.upper)}
    elif isinstance(f, jpriors.ParetoFlux):
        flux = {"kind": "pareto", "scale": _f(f.scale), "alpha": _f(f.alpha)}
    elif isinstance(f, jpriors.NormalFlux):
        flux = {"kind": "normal", "mean": _f(f.mean), "stdev": _f(f.stdev)}
    else:
        raise NotImplementedError(type(f))
    return {
        "min_objects": prior.min_objects, "max_objects": prior.max_objects,
        "image_height": prior.image_height,
        "image_width": prior.image_width, "pad": float(prior.pad),
        "counts": counts, "flux": flux,
    }


def model_params(model) -> dict:
    p = model.psf
    if isinstance(p, jpsf.SDSSPSF):
        psf = {"kind": "sdss",
               "params": [_f(v) for v in (p.sigma1, p.sigma2, p.sigmap,
                                          p.beta, p.b, p.p0)],
               "normalizing_constant": _f(p.normalizing_constant),
               "wing_beta3": bool(p.wing_beta3)}
    else:
        psf = {"kind": "gaussian", "stdev": _f(p.stdev)}
    return {
        "height": model.height, "width": model.width,
        "psf_radius": model.psf_radius, "noise": model.noise,
        "background": np.array(model.background, dtype=np.float32),
        "adu_per_nmgy": _f(model.adu_per_nmgy),
        "noise_additive": _f(model.noise_additive),
        "noise_multiplicative": _f(model.noise_multiplicative),
        "normal_tail_threshold": float(model.normal_tail_threshold),
        "psf": psf,
    }


def kernel_params(kernel) -> dict:
    """An MH kernel's scales, or a MALA kernel's step sizes."""
    scales = (("locs_step", "fluxes_step") if hasattr(kernel, "locs_step")
              else ("locs_stdev", "fluxes_stdev"))
    return {
        "num_iters": kernel.num_iters,
        **{name: _f(getattr(kernel, name)) for name in scales},
        "fluxes_min": _f(kernel.fluxes_min),
        "fluxes_max": _f(kernel.fluxes_max),
    }


def port_prior(prior, device="cpu"):
    return convert.prior_from_params(prior_params(prior), device)


def port_model(model, device="cpu"):
    return convert.image_model_from_params(model_params(model), device)


def port_kernel(kernel, device="cpu", backend="auto"):
    """The port's ``SingleComponentMH`` or ``SingleComponentMALA`` of a JAX
    kernel of the same kind."""
    d = kernel_params(kernel)
    build = (convert.mala_kernel_from_params if "locs_step" in d
             else convert.mh_kernel_from_params)
    return build(d, device, backend)


def t(x, dtype=torch.float32):
    """numpy / JAX array -> CPU torch tensor."""
    return torch.from_numpy(np.array(x)).to(dtype)


def m71_problem(max_objects=6, tile=8):
    """The bench's M71 prior, image model and MH kernel (JAX objects)."""
    import jax.numpy as jnp

    from smcdet_tpu.inference.kernels import SingleComponentMH
    from smcdet_tpu.models.imaging import M71ImageModel

    prior = jpriors.M71Prior(
        min_objects=0, max_objects=max_objects, counts_rate=0.03,
        image_height=tile, image_width=tile, flux_alpha=0.214,
        flux_lower=0.252, flux_upper=1804.679, pad=1.0,
    )
    model = M71ImageModel(
        image_height=tile, image_width=tile, background=179.0,
        adu_per_nmgy=155.0, psf_params=(1.33, 4.82, 3.15, 3.0, 0.06, 0.002),
        psf_radius=8, noise_additive=0.0, noise_multiplicative=1.94,
    )
    kernel = SingleComponentMH(
        num_iters=100, locs_stdev=jnp.float32(0.25),
        fluxes_stdev=jnp.float32(5.0), fluxes_min=jnp.float32(0.252),
        fluxes_max=jnp.float32(1804.679),
    )
    return prior, model, kernel


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run each torch test module on one intra-op thread.

    The parity tests launch thousands of small ops; with several test
    processes on one host, each op's thread pool fights the others' and a
    test slows down by an order of magnitude. Module scope, so that the
    module-scoped fixtures that run a whole pipeline are covered too.
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
