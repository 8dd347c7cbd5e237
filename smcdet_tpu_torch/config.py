"""Typed experiment configuration (port of ``smcdet_tpu/config.py``).

The same dataclass tree and YAML layout as the JAX package, so one
``experiments/<suite>/config.yaml`` drives either package;
``build_prior``, ``build_image_model`` and ``build_kernel`` return the
port's objects on an explicit ``device``. Imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import yaml

__all__ = [
    "PriorConfig",
    "ImageModelConfig",
    "KernelConfig",
    "SamplerConfig",
    "MCMCExperimentConfig",
    "AggregationConfig",
    "ExperimentConfig",
    "build_prior",
    "build_image_model",
    "build_kernel",
    "apply_fitted_params",
    "load_config",
    "save_config",
]


@dataclass
class PriorConfig:
    family: str = "m71"  # m71 | pareto_star | star | poisson | geometric
    min_objects: int = 0
    max_objects: int = 10
    image_height: int = 8
    image_width: int = 8
    pad: float = 1.0
    counts_rate: float = 0.03  # poisson/m71
    flux_mean: float = 1000.0  # star
    flux_stdev: float = 100.0  # star
    flux_scale: float = 570.0  # pareto_star
    flux_alpha: float = 0.214  # pareto_star / m71
    flux_lower: float = 0.252  # m71
    flux_upper: float = 1804.679  # m71


@dataclass
class ImageModelConfig:
    kind: str = "m71"  # m71 | gaussian
    image_height: int = 8
    image_width: int = 8
    background: float = 179.0
    psf_radius: int = 8
    psf_stdev: float = 1.0  # gaussian
    psf_params: tuple = (1.51, 4.85, 1.32, 3.0, 0.09, 0.002)  # m71
    adu_per_nmgy: float = 155.0
    noise_additive: float = 0.0
    noise_multiplicative: float = 1.94


@dataclass
class KernelConfig:
    kind: str = "mh"  # mh | mala
    num_iters: int = 100
    locs_stdev: float = 0.25
    fluxes_stdev: float = 5.0
    fluxes_min: float = 0.252
    fluxes_max: float = 1804.679
    # stop a mutation's sweeps early below this mean squared location jump
    # (None = fixed num_iters); on the card one kernel launch a sweep
    sqjumpdist_tol: float | None = None


@dataclass
class SamplerConfig:
    num_catalogs: int = 2048
    ess_threshold_prop: float = 0.5
    resample_method: str = "systematic"
    max_smc_iters: int = 100
    flux_detection_threshold: float = 0.7
    tile_dim: int = 8
    # prior-draw relocation sweeps per mutation (many-object mixing fix)
    relocate_sweeps: int = 0
    # coordinated two-star pair-redistribute sweeps per mutation
    pair_sweeps: int = 0
    # Accepted and ignored: the JAX package splits its one-program SMC loop
    # into dispatches of this many iterations to stay under a TPU program
    # time limit; the port's loop already runs on the host, one iteration
    # at a time.
    dispatch_iters: int | None = None
    # independent repetitions per image, pooled (aggregation pipeline only)
    replicates: int = 1
    # process tiles in total-flux order so chunks temper alike (exact)
    sort_tiles: bool = True
    # streaming tile pool instead of fixed chunks (inference/streaming.py;
    # streaming_pool 0: the memory model's pool size)
    streaming: bool = False
    streaming_pool: int = 0


@dataclass
class MCMCExperimentConfig:
    """Saturated-MH baseline settings (``method="mcmc"``): 50k samples,
    30k burn-in, thinning 2, and proposal scales smaller than the SMC
    mutation kernel's (the reference ``run_mcmc.py``'s)."""

    num_samples_total: int = 50_000
    num_samples_burnin: int = 30_000
    keep_every_k: int = 2
    locs_stdev: float = 0.1
    fluxes_stdev: float = 2.5


@dataclass
class AggregationConfig:
    enabled: bool = False
    ess_threshold_prop: float = 0.5
    resample_method: str = "multinomial"
    max_smc_iters: int = 100
    max_objects_cap: Optional[int] = None
    relocate_sweeps: int = 8
    pair_sweeps: int = 0


@dataclass
class ExperimentConfig:
    name: str = "experiment"
    seed: int = 0
    num_images: int = 100
    batch_size: int = 10
    output_dir: str = "output"
    data_path: Optional[str] = None  # None => simulate
    # fitted-hyperparameter YAML overlaid at load time (apply_fitted_params)
    params_path: Optional[str] = None
    # per-tile background maps from tiles.npz (aggregation pipeline only)
    use_tile_backgrounds: bool = False
    prior: PriorConfig = field(default_factory=PriorConfig)
    image_model: ImageModelConfig = field(default_factory=ImageModelConfig)
    kernel: KernelConfig = field(default_factory=KernelConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    aggregation: AggregationConfig = field(default_factory=AggregationConfig)
    mcmc: MCMCExperimentConfig = field(default_factory=MCMCExperimentConfig)


def build_prior(cfg: PriorConfig, device="cuda"):
    from smcdet_tpu_torch.models.priors import (
        GeometricProcessPrior,
        M71Prior,
        ParetoStarPrior,
        PoissonProcessPrior,
        StarPrior,
    )

    common = dict(
        min_objects=cfg.min_objects,
        max_objects=cfg.max_objects,
        image_height=cfg.image_height,
        image_width=cfg.image_width,
        pad=cfg.pad,
        device=device,
    )
    if cfg.family == "m71":
        return M71Prior(counts_rate=cfg.counts_rate,
                        flux_alpha=cfg.flux_alpha,
                        flux_lower=cfg.flux_lower,
                        flux_upper=cfg.flux_upper, **common)
    if cfg.family == "pareto_star":
        return ParetoStarPrior(flux_scale=cfg.flux_scale,
                               flux_alpha=cfg.flux_alpha, **common)
    if cfg.family == "star":
        return StarPrior(flux_mean=cfg.flux_mean, flux_stdev=cfg.flux_stdev,
                         **common)
    if cfg.family == "poisson":
        return PoissonProcessPrior(counts_rate=cfg.counts_rate, **common)
    if cfg.family == "geometric":
        return GeometricProcessPrior(**common)
    raise ValueError(f"unknown prior family {cfg.family!r}")


def build_image_model(cfg: ImageModelConfig, device="cuda"):
    """``kind: m71`` is the SDSS PSF with Gaussian noise; ``kind:
    gaussian`` is a Gaussian PSF with *Poisson* noise (the generic model:
    the name refers to the PSF)."""
    from smcdet_tpu_torch.models.imaging import ImageModel, M71ImageModel
    from smcdet_tpu_torch.models.psf import GaussianPSF

    if cfg.kind == "m71":
        return M71ImageModel(
            image_height=cfg.image_height,
            image_width=cfg.image_width,
            background=cfg.background,
            adu_per_nmgy=cfg.adu_per_nmgy,
            psf_params=tuple(cfg.psf_params),
            psf_radius=cfg.psf_radius,
            noise_additive=cfg.noise_additive,
            noise_multiplicative=cfg.noise_multiplicative,
            device=device,
        )
    if cfg.kind == "gaussian":
        return ImageModel(
            height=cfg.image_height,
            width=cfg.image_width,
            psf_radius=cfg.psf_radius,
            psf=GaussianPSF(cfg.psf_stdev, device=device),
            noise="poisson",
            background=cfg.background,
            device=device,
        )
    raise ValueError(f"unknown image model kind {cfg.kind!r}")


def build_kernel(cfg: KernelConfig, device="cuda"):
    """``kind: mh`` or ``kind: mala``; MALA takes its step sizes from
    ``locs_stdev`` / ``fluxes_stdev``, as the JAX package does."""
    from smcdet_tpu_torch.inference.kernels import (
        SingleComponentMALA,
        SingleComponentMH,
    )

    if cfg.kind == "mala":
        return SingleComponentMALA(
            num_iters=cfg.num_iters,
            locs_step=cfg.locs_stdev,
            fluxes_step=cfg.fluxes_stdev,
            fluxes_min=cfg.fluxes_min,
            fluxes_max=cfg.fluxes_max,
            sqjumpdist_tol=cfg.sqjumpdist_tol,
            device=device,
        )
    if cfg.kind != "mh":
        raise ValueError(f"unknown kernel kind {cfg.kind!r}")
    return SingleComponentMH(
        num_iters=cfg.num_iters,
        locs_stdev=cfg.locs_stdev,
        fluxes_stdev=cfg.fluxes_stdev,
        fluxes_min=cfg.fluxes_min,
        fluxes_max=cfg.fluxes_max,
        sqjumpdist_tol=cfg.sqjumpdist_tol,
        device=device,
    )


def _to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {
            f.name: _to_dict(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (tuple, list)):
        return [_to_dict(v) for v in obj]
    return obj


_SUBCONFIGS = {
    "prior": PriorConfig,
    "image_model": ImageModelConfig,
    "kernel": KernelConfig,
    "sampler": SamplerConfig,
    "aggregation": AggregationConfig,
    "mcmc": MCMCExperimentConfig,
}


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = _SUBCONFIGS.get(f.name)
        if sub is not None and isinstance(v, dict):
            kwargs[f.name] = _from_dict(sub, v)
        elif f.name == "psf_params" and isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def save_config(cfg: ExperimentConfig, path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(_to_dict(cfg), f, sort_keys=False)


def apply_fitted_params(cfg: ExperimentConfig, params: dict) -> None:
    """Overlay a fitted-params dict (``prepare_data.py``'s params.yaml)
    onto the config in place: flux prior and kernel truncation bounds,
    count rate, pad, the fitted image model and the detection threshold."""
    p = cfg.prior
    if "flux_alpha" in params:
        p.flux_alpha = float(params["flux_alpha"])
    if "flux_lower" in params:
        p.flux_lower = float(params["flux_lower"])
        cfg.kernel.fluxes_min = float(params["flux_lower"])
    if "flux_upper" in params:
        p.flux_upper = float(params["flux_upper"])
        cfg.kernel.fluxes_max = float(params["flux_upper"])
    if "counts_rate" in params:
        p.counts_rate = float(params["counts_rate"])
    if "pad" in params:
        p.pad = float(params["pad"])
    im = cfg.image_model
    for key in ("background", "adu_per_nmgy", "noise_additive",
                "noise_multiplicative"):
        if key in params:
            setattr(im, key, float(params[key]))
    if "psf_params" in params:
        im.psf_params = tuple(float(v) for v in params["psf_params"])
    if "psf_radius" in params:
        im.psf_radius = int(params["psf_radius"])
    if "flux_detection_threshold" in params:
        cfg.sampler.flux_detection_threshold = float(
            params["flux_detection_threshold"]
        )


def load_config(path, apply_params: bool = True) -> ExperimentConfig:
    """Load an ExperimentConfig from YAML; ``apply_params=False`` skips the
    fitted-params overlay (``params_path``, looked up relative to the
    config file's directory first, then the working directory)."""
    with open(path) as f:
        d = yaml.safe_load(f)
    cfg = _from_dict(ExperimentConfig, d)
    if apply_params and cfg.params_path is not None:
        for c in (Path(path).parent / cfg.params_path,
                  Path(cfg.params_path)):
            if c.exists():
                with open(c) as f:
                    apply_fitted_params(cfg, yaml.safe_load(f))
                break
    return cfg
