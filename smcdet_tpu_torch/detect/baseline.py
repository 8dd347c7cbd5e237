"""The tuned source-extractor baseline over an experiment config (port of
``smcdet_tpu/detect/baseline.py``):

    python -m smcdet_tpu_torch.detect.baseline experiments/m71 \\
        [--config config.yaml] [--num-tune 50] [--num-images N]
        [--device cuda]

Grid-search the extractor's hyperparameters by F1 on a tuning split, run
the tuned extractor on the evaluation split and write
``{output_dir}/{name}/sep_results.npz`` (the JAX script's keys), which
``smcdet_tpu_torch.analyze`` reads as the baseline. ``--device`` defaults
to ``cuda`` and is never swapped for another device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from smcdet_tpu_torch.config import ExperimentConfig, build_image_model
from smcdet_tpu_torch.detect.extractor import extract_batch, tune_extractor
from smcdet_tpu_torch.utils.units import convert_nmgy_to_mag

__all__ = ["run_sep_baseline", "run_sep_cli"]


def _psf_flux_scale(model) -> float:
    """Total image flux of one unit of intrinsic flux: the PSF integral
    times the calibration. Extractor fluxes are divided by it to land in
    the prior's units (a survey PSF integrates to about 1, the Gaussian PSF
    to about ``stdev * sqrt(2 pi)``)."""
    center = torch.tensor([model.height / 2.0, model.width / 2.0],
                          device=model.device)
    psf_total = float(model.star_image(center).sum())
    return psf_total * float(model.adu_per_nmgy)


def run_sep_baseline(cfg: ExperimentConfig, tiles: dict, num_tune: int = 50,
                     thresh_grid=np.arange(1.0, 8.5, 1.5),
                     minarea_grid=(1, 3, 5), deblend_cont_grid=(1e-6, 1e-3),
                     clean_param_grid=(0.0, 1.0), device="cuda"):
    """Tune and run the extractor on ``device``; returns ``(best_f1,
    best_params, results)``.

    ``tiles`` holds the images and ``true_*`` arrays (``runner``'s tiles).
    The split: the ``checkerboard`` column when present (True = the tuning
    half), else even tiles tune and odd tiles are evaluated. Per-tile
    ``background`` maps are subtracted when present, else the configured
    scalar background."""
    device = torch.device(device)
    model = build_image_model(cfg.image_model, device)
    flux_scale = _psf_flux_scale(model)

    n = tiles["images"].shape[0]
    if "checkerboard" in tiles:
        cb = np.asarray(tiles["checkerboard"]).astype(bool)
        tune_idx = np.flatnonzero(cb)[:num_tune]
        eval_idx = np.flatnonzero(~cb)
    else:
        tune_idx = np.arange(0, n, 2)[:num_tune]
        eval_idx = np.arange(1, n, 2)
    arrays = {k: v for k, v in tiles.items() if getattr(v, "ndim", 0) >= 1}
    tune = {k: v[tune_idx] for k, v in arrays.items()}
    eval_ = {k: v[eval_idx] for k, v in arrays.items()}

    if "background" in tiles:
        bkg_tune = np.asarray(tune["background"])
        bkg_eval = np.asarray(eval_["background"])
        err = float(np.sqrt(bkg_tune.mean()))  # in the maps' own dtype
    else:
        bkg_tune = bkg_eval = cfg.image_model.background
        err = float(np.sqrt(cfg.image_model.background))

    det_thresh_mag = float(convert_nmgy_to_mag(torch.tensor(
        cfg.sampler.flux_detection_threshold, dtype=torch.float32)))
    # one magnitude bin: everything brighter than the detection limit
    mag_bins = [det_thresh_mag]

    def on_device(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    score, best = tune_extractor(
        on_device(tune["images"], torch.float32),
        on_device(tune["true_counts"]), on_device(tune["true_locs"]),
        on_device(tune["true_fluxes"]), background=on_device(
            bkg_tune, torch.float32),
        err=err, adu_per_nmgy=flux_scale, mag_bins=mag_bins,
        thresh_grid=thresh_grid, minarea_grid=minarea_grid,
        deblend_cont_grid=deblend_cont_grid,
        clean_param_grid=clean_param_grid)

    counts, locs, fluxes = extract_batch(
        on_device(eval_["images"], torch.float32)
        - on_device(bkg_eval, torch.float32),
        thresh=best["thresh"], err=err, minarea=best["minarea"],
        deblend_cont=best["deblend_cont"], clean_param=best["clean_param"])
    results = {
        "counts": counts.cpu().numpy(),
        "locs": locs.cpu().numpy(),
        "fluxes": fluxes.cpu().numpy() / flux_scale,
        "eval_true_counts": np.asarray(eval_["true_counts"]),
        "eval_true_locs": np.asarray(eval_["true_locs"]),
        "eval_true_fluxes": np.asarray(eval_["true_fluxes"]),
        # the tiles the eval rows are, so that the analysis compares the
        # sampler and the baseline on the same subset
        "eval_indices": eval_idx,
    }
    return score, best, results


def run_sep_cli(argv=None):
    """The command line: tune, run and save ``sep_results.npz`` for a
    suite (a config file, or a suite directory with ``--config``)."""
    from smcdet_tpu_torch.run_experiment import load_suite_config
    from smcdet_tpu_torch.runner import _load_tiles

    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.detect.baseline",
        description="Tune the source-extractor baseline by F1 and run it "
                    "on the evaluation tiles, writing sep_results.npz.")
    parser.add_argument("experiment",
                        help="config YAML, or a suite directory")
    parser.add_argument("--config", default=None,
                        help="config file in the suite directory (default "
                             "config.yaml)")
    parser.add_argument("--num-tune", type=int, default=50)
    parser.add_argument("--num-images", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    cfg = load_suite_config(args.experiment, args.config)
    if args.num_images is not None:
        cfg.num_images = args.num_images
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available "
                         "(torch.cuda.is_available() is False)")
    out_dir = Path(cfg.output_dir) / cfg.name
    out_dir.mkdir(parents=True, exist_ok=True)
    # the tiles the sampler runs on: data_path, a staged tiles.npz, or
    # the simulation
    tiles = _load_tiles(cfg)
    score, best, results = run_sep_baseline(cfg, tiles,
                                            num_tune=args.num_tune,
                                            device=device)
    print(f"best F1 = {score:.3f} with {best}")
    path = out_dir / "sep_results.npz"
    np.savez_compressed(path, **results, tuned_f1=np.asarray(score))
    print(f"saved {path}")
    return path


if __name__ == "__main__":
    run_sep_cli()
