"""Prior-predictive checks of the simulator against the m71 fixture's tiles
(port of ``experiments/m71/simulator_checks.py``, without JAX):

    python -m smcdet_tpu_torch.studies.simulator_checks [--seed 0]
        [--output-dir output] [--device cuda] [--figure]

1. Simulate one tile per fixture tile from the fitted model (the m71 prior
   truncated at ``MAX_OBJECTS`` stars with the flux floor at the
   detection threshold), each over its real tile's background
   (``models/simulate.generate_images``; the plain render, no sweep
   kernel).
2. Compare the 0.1-quantile, median and 0.9-quantile of each tile's log
   pixel intensity, synthetic against real, by the two-sample KS statistic.
3. Run CS-SMC (``SMCSampler``, N = ``NUM_CATALOGS`` per stratum) on one
   synthetic tile, picked as the JAX script picks it, and report the
   truth's quantile in the posterior predictive of the total observed flux
   and the posterior mean count.

Writes ``{output-dir}/m71/simulator_checks.json`` with the JAX
script's keys, and the figure's arrays to
``{output-dir}/m71/figure_data/simulator_checks.npz``: each tile's
quantiles of log intensity (``sq_<name>`` synthetic, ``rq_<name>`` real,
unrounded), ``ppflux`` (every particle's posterior predictive, float32 as
the sampler gives it), ``true_observed``, ``img_idx`` and ``T``. ``python
-m smcdet_tpu_torch.figures`` draws ``figures/simulator_checks.png`` from
it; ``--figure`` draws it at once (matplotlib needed). The synthetic
tiles are a torch draw (seeded generators on ``--device``, default
``cuda``), not the JAX package's, so the figures agree with the committed
ones in distribution only.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from smcdet_tpu_torch.figures import (
    draw,
    require_matplotlib,
    save_figure_data,
)
from smcdet_tpu_torch.studies.m71_fixture import M71

__all__ = ["ks_statistic", "quantiles", "quantile_checks", "simulation_prior",
           "simulate", "posterior_predictive", "main"]

QUANTILES = {"q10": 0.1, "median": 0.5, "q90": 0.9}
# the simulation's count truncation (64 covers the padded 16x16 region at
# rate 0.03 to over 8 sigma) and the posterior run's particles per stratum
MAX_OBJECTS = 64
NUM_CATALOGS = 2048


def ks_statistic(a, b):
    """Two-sample Kolmogorov-Smirnov statistic: the largest distance
    between the two empirical CDFs."""
    a = np.sort(np.asarray(a, dtype=np.float64))
    b = np.sort(np.asarray(b, dtype=np.float64))
    both = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, both, side="right") / a.size
    cdf_b = np.searchsorted(b, both, side="right") / b.size
    return float(np.abs(cdf_a - cdf_b).max())


def quantiles(syn, real):
    """Per quantile name of ``QUANTILES``, each tile's quantile of log
    intensity (floored at 1e-3), synthetic and real: ``{name: (sq [T],
    rq [T])}``."""
    T = real.shape[0]
    syn_flat = np.log(np.maximum(np.asarray(syn, np.float64)
                                 .reshape(T, -1), 1e-3))
    real_flat = np.log(np.maximum(np.asarray(real, np.float64)
                                  .reshape(T, -1), 1e-3))
    return {name: (np.quantile(syn_flat, q, axis=-1),
                   np.quantile(real_flat, q, axis=-1))
            for name, q in QUANTILES.items()}


def quantile_checks(syn, real):
    """Per quantile of ``QUANTILES``, the KS statistic between the
    synthetic and real tiles' per-tile quantiles of log intensity (floored
    at 1e-3), with each side's mean and standard deviation."""
    out = {}
    for name, (sq, rq) in quantiles(syn, real).items():
        out[name] = {
            "ks_statistic": round(ks_statistic(sq, rq), 4),
            "synthetic_mean": round(float(sq.mean()), 4),
            "real_mean": round(float(rq.mean()), 4),
            "synthetic_std": round(float(sq.std()), 4),
            "real_std": round(float(rq.std()), 4),
        }
    return out


def simulation_prior(cfg, max_objects, device):
    """The simulation's prior: the config's m71 prior from 0 to
    ``max_objects`` stars with its flux floor raised to the detection
    threshold."""
    from smcdet_tpu_torch.models.priors import M71Prior

    p = cfg.prior
    return M71Prior(
        min_objects=0, max_objects=max_objects,
        image_height=p.image_height, image_width=p.image_width, pad=p.pad,
        counts_rate=p.counts_rate, flux_alpha=p.flux_alpha,
        flux_lower=max(p.flux_lower, cfg.sampler.flux_detection_threshold),
        flux_upper=p.flux_upper, device=device)


def simulate(cfg, backgrounds, seed, max_objects, device):
    """One synthetic tile over each of ``backgrounds [T, h, w]``."""
    from smcdet_tpu_torch.config import build_image_model
    from smcdet_tpu_torch.models.simulate import generate_images

    model = build_image_model(cfg.image_model, device).with_background(
        torch.as_tensor(backgrounds, dtype=torch.float32, device=device))
    gen = torch.Generator(device=device).manual_seed(seed)
    return generate_images(
        gen, simulation_prior(cfg, max_objects, device), model,
        flux_threshold=cfg.sampler.flux_detection_threshold,
        loc_threshold_lower=0.0,
        loc_threshold_upper=float(cfg.prior.image_height),
        num_images=backgrounds.shape[0])


def posterior_predictive(cfg, image, background, num_catalogs, seed,
                         device):
    """CS-SMC on one tile with the config's prior, image model (over
    ``background``) and kernel; returns the sampler and the posterior
    predictive total observed flux of every particle (numpy)."""
    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
    )
    from smcdet_tpu_torch.inference.smc import SMCSampler

    s = cfg.sampler
    sampler = SMCSampler(
        image=torch.as_tensor(image, dtype=torch.float32, device=device),
        tile_dim=s.tile_dim, Prior=build_prior(cfg.prior, device),
        ImageModel=build_image_model(cfg.image_model, device)
        .with_background(torch.as_tensor(background, dtype=torch.float32,
                                         device=device)),
        MutationKernel=build_kernel(cfg.kernel, device),
        num_catalogs=num_catalogs, ess_threshold_prop=s.ess_threshold_prop,
        resample_method=s.resample_method,
        flux_detection_threshold=s.flux_detection_threshold,
        max_smc_iters=s.max_smc_iters)
    sampler.run(torch.Generator(device=device).manual_seed(seed + 1))
    pp = sampler.posterior_predictive_total_observed_flux(
        torch.Generator(device=device).manual_seed(seed + 2))
    return sampler, pp.reshape(-1).cpu().numpy()


def main(argv=None):
    from smcdet_tpu_torch.run_experiment import (
        _check_device,
        load_suite_config,
    )

    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.simulator_checks",
        description="Prior-predictive checks of the simulator against the "
                    "m71 fixture's tiles.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output-dir", default=None,
                        help="replaces the config's output_dir")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--figure", action="store_true",
                        help="also draw figures/simulator_checks.png "
                             "(needs matplotlib)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    _check_device(device)
    if args.figure:
        require_matplotlib("--figure")

    cfg = load_suite_config(str(M71))
    out_dir = Path(args.output_dir or cfg.output_dir) / cfg.name
    out_dir.mkdir(parents=True, exist_ok=True)
    with np.load(cfg.data_path) as tiles:
        real = np.asarray(tiles["images"], dtype=np.float64)
        backgrounds = np.asarray(tiles["background"], dtype=np.float32)
    T = real.shape[0]

    sim = simulate(cfg, backgrounds, args.seed, MAX_OBJECTS, device)
    syn = sim.images.cpu().numpy().astype(np.float64)

    img_idx = int(np.random.default_rng(args.seed).integers(0, T))
    sampler, ppflux = posterior_predictive(
        cfg, syn[img_idx], backgrounds[img_idx], NUM_CATALOGS, args.seed,
        device)
    true_observed = float(syn[img_idx].sum())
    report = {
        "tiles": int(T),
        "sim_max_objects": MAX_OBJECTS,
        "pixel_log_intensity_quantiles": quantile_checks(syn, real),
        "posterior_predictive_image": {
            "index": img_idx,
            "true_pruned_count": int(sim.pruned_counts[img_idx]),
            "posterior_mean_count": round(
                float(sampler.posterior_mean_count()[0]), 3),
            "true_total_observed_flux": round(true_observed, 1),
            "pp_flux_quantile_of_truth": round(
                float((ppflux < true_observed).mean()), 4),
        },
    }
    (out_dir / "simulator_checks.json").write_text(
        json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    per_tile = {}
    for name, (sq, rq) in quantiles(syn, real).items():
        per_tile[f"sq_{name}"], per_tile[f"rq_{name}"] = sq, rq
    data = save_figure_data(out_dir, "simulator_checks", ppflux=ppflux,
                            true_observed=true_observed, img_idx=img_idx,
                            T=T, **per_tile)
    if args.figure:
        for png in draw(data):
            print(f"figure: {png}")
    return report


if __name__ == "__main__":
    main()
