"""MH against MALA on the basic suite's tiles (port of
``experiments/basic/compare_kernels.py``, without JAX):

    python -m smcdet_tpu_torch.studies.compare_kernels [--num-images 100]
        [--num-catalogs 512] [--mala-locs-step 0.05]
        [--mala-fluxes-step 20] [--seed 1] [--dump FILE] [--device cuda]

Runs CS-SMC over the first ``--num-images`` tiles of
``output/basic/tiles.npz`` (write them first: ``python -m
smcdet_tpu_torch.run_experiment experiments/basic --generate``, or the JAX
package's draw) once with ``SingleComponentMH`` and once with
``SingleComponentMALA``, with the suite's prior, image model and
``SMCConfig``, and reports per kernel the wall, the SMC iterations, the mean
acceptance and the posterior-mean total flux, and the count-pmf TVD between
the two posteriors. Each kernel runs twice from a generator seeded with
``--seed``; its wall is the second run's (the first warms the kernel library
and the allocator), synchronised. Writes
``output/basic/kernel_comparison.json`` with the JAX script's keys;
``--dump FILE`` also saves each kernel's per-image count pmfs (``mh`` and
``mala`` ``[1, I, K]``, ``seeds [1]``).
``--device`` defaults to ``cuda`` and is never swapped for another device:
pass ``--device cpu`` for the plain PyTorch versions of the kernels.
``--sweeps`` cuts both kernels' sweeps per SMC iteration (a short run);
``--output-dir`` replaces the config's ``output_dir``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from smcdet_tpu_torch.runner import _sync
from smcdet_tpu_torch.studies import REPO, tvd_stats, weighted_pmf

__all__ = ["build_kernels", "kernel_summary", "kernel_report", "main"]


def build_kernels(k, locs_step, fluxes_step, device, sweeps=None):
    """The two mutation kernels of the comparison from the suite's kernel
    config ``k``: MH at its proposal scales, MALA at the given steps, both
    at ``k.num_iters`` sweeps (or ``sweeps``) and the same flux box."""
    from smcdet_tpu_torch.inference.kernels import (
        SingleComponentMALA,
        SingleComponentMH,
    )

    n = k.num_iters if sweeps is None else sweeps
    return {
        "mh": SingleComponentMH(n, k.locs_stdev, k.fluxes_stdev,
                                k.fluxes_min, k.fluxes_max, device=device),
        "mala": SingleComponentMALA(n, locs_step, fluxes_step, k.fluxes_min,
                                    k.fluxes_max, device=device),
    }


def kernel_summary(res, wall, K):
    """One kernel's entry of the report and its count pmfs ``[I, K]``, from
    a result with numpy fields ``pruned_counts``, ``weights``,
    ``pruned_fluxes``, ``acc_rate`` and ``num_iters``."""
    w = np.asarray(res["weights"])
    pmf = weighted_pmf(res["pruned_counts"], w, K)
    total = (np.asarray(res["pruned_fluxes"]).sum(-1) * w).sum(-1)
    return {
        "wall_s": round(wall, 2),
        "smc_iterations": int(res["num_iters"]),
        "acceptance_rate_mean": round(
            float(np.asarray(res["acc_rate"]).mean()), 4),
        "mean_total_flux": round(float(total.mean()), 2),
    }, pmf


def kernel_report(n, num_catalogs, results, pmfs):
    """The report: per-kernel entries and the count-pmf TVD between the MH
    and MALA posteriors, per image summarised by ``tvd_stats``."""
    tvd = 0.5 * np.abs(pmfs["mh"] - pmfs["mala"]).sum(-1)
    return {
        "images": int(n),
        "num_catalogs": num_catalogs,
        "kernels": results,
        "count_pmf_tvd": tvd_stats(tvd),
    }


def main(argv=None):
    from smcdet_tpu_torch.config import build_image_model, build_prior
    from smcdet_tpu_torch.inference.smc import SMCConfig, run_csmc_chunked
    from smcdet_tpu_torch.run_experiment import (
        _check_device,
        load_suite_config,
    )

    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.compare_kernels",
        description="CS-SMC with MH and with MALA over the basic suite's "
                    "tiles: acceptance, SMC iterations, wall and the "
                    "count-pmf TVD between the two posteriors.")
    parser.add_argument("--num-images", type=int, default=100)
    parser.add_argument("--num-catalogs", type=int, default=512)
    parser.add_argument("--mala-locs-step", type=float, default=0.05)
    parser.add_argument("--mala-fluxes-step", type=float, default=20.0)
    parser.add_argument("--seed", type=int, default=1,
                        help="both kernels' generator seed")
    parser.add_argument("--dump", default=None,
                        help="save the per-image count pmfs to this .npz")
    parser.add_argument("--sweeps", type=int, default=None,
                        help="sweeps per SMC iteration for both kernels "
                             "(default the config's)")
    parser.add_argument("--output-dir", default=None,
                        help="replaces the config's output_dir")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    _check_device(device)

    cfg = load_suite_config(str(REPO / "experiments" / "basic"))
    out_dir = Path(args.output_dir or cfg.output_dir) / cfg.name
    tiles = np.load(out_dir / "tiles.npz")
    n = min(args.num_images, tiles["images"].shape[0])
    images = torch.as_tensor(tiles["images"][:n], dtype=torch.float32,
                             device=device)

    prior = build_prior(cfg.prior, device)
    model = build_image_model(cfg.image_model, device)
    kernels = build_kernels(cfg.kernel, args.mala_locs_step,
                            args.mala_fluxes_step, device, args.sweeps)
    s = cfg.sampler
    smc_cfg = SMCConfig(
        num_catalogs=args.num_catalogs,
        ess_threshold_prop=s.ess_threshold_prop,
        resample_method=s.resample_method,
        max_smc_iters=s.max_smc_iters,
        flux_detection_threshold=s.flux_detection_threshold,
    )
    if device.type == "cuda":
        from smcdet_tpu_torch import _build

        _build.load_library()

    K = prior.max_objects + 2
    results, pmfs = {}, {}
    for name, kernel in kernels.items():
        for _ in range(2):  # a warm run, then the timed one
            gen = torch.Generator(device=device).manual_seed(args.seed)
            _sync(device)
            start = time.perf_counter()
            res = run_csmc_chunked(gen, images, prior, model, kernel,
                                   smc_cfg)
            _sync(device)
            wall = time.perf_counter() - start
        res = {f: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
               for f, v in res._asdict().items()}
        results[name], pmfs[name] = kernel_summary(res, wall, K)
        print(name, results[name], flush=True)

    report = kernel_report(n, args.num_catalogs, results, pmfs)
    if args.dump:
        np.savez_compressed(args.dump, seeds=np.asarray([args.seed]),
                            **{k: v[None] for k, v in pmfs.items()})
    with open(out_dir / "kernel_comparison.json", "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
