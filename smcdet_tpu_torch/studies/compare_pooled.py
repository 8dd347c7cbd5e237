"""Pooled divide-and-conquer against single-tile comparison (port of
``experiments/divideandconquer/compare_pooled.py``, without JAX):

    python -m smcdet_tpu_torch.studies.compare_pooled [--num-images 30]
        [--reps 4] [--agg-iters N] [--relocate N] [--pair-sweeps 0]
        [--suffix S] [--dump] [--device cuda]

The count posterior p(s|x) is softmax(log Z); with finite particles the
per-run log Z noise makes each run's pmf overconfident, so two unbiased
pipelines can disagree by a whole count on one run. Pooling ``--reps``
independent repetitions of each pipeline estimates the expected posterior;
agreement of the pooled pmfs is the unbiasedness check of the aggregation
tree.

For each rep, on the first ``--num-images`` images of
``output/divideandconquer/tiles.npz``: one single-tile CS-SMC batch over
all of them (the 16x16 images, ``config_singletile.yaml``'s sampler), then
per image the divide-and-conquer pipeline (``SMCSampler`` on the 2x2 grid
of 8x8 tiles, then ``Aggregate.from_smc(...).run`` with the config's
aggregation settings and the bridge-effort knobs). Writes
``pooled_comparison<suffix>.json`` with the JAX script's keys and, with
``--dump``, ``pooled_pmfs<suffix>.npz`` (``st_pmfs`` and ``dc_pmfs [R, I,
K]``, ``true_counts [I]``), which ``experiments/divideandconquer/
attribute_pooled.py`` and ``truth_score_pooled.py`` (numpy only) read.

Seeds: rep r's single-tile batch draws from ``runner.batch_generator(100 +
r, 0)``, image i's tile SMC from ``batch_generator(200 + r, i)`` and its
aggregation from ``batch_generator(300 + r, i)``. The JAX script's
``key(100 + r)`` and ``fold_in(key(200 + r), i)`` streams cannot be
reproduced in PyTorch, so a run is another draw of the same study.
``--device`` defaults to ``cuda`` and is never swapped for another device.
``--num-catalogs`` (the tile stage's N; the single-tile run keeps its
config's ratio to it) and ``--sweeps`` cut a run; ``--output-dir`` replaces
the config's ``output_dir``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from smcdet_tpu_torch.runner import _sync, batch_generator
from smcdet_tpu_torch.studies import REPO, tvd_stats, weighted_pmf

__all__ = ["pooled_pmfs", "pooled_report", "main"]

SUITE = REPO / "experiments" / "divideandconquer"


def pooled_pmfs(images, cfg, st_cfg, reps, device, agg_kwargs):
    """Both pipelines' count pmfs ``[R, I, K]`` (``K = 4 max_objects +
    1``) over ``images [I, 16, 16]`` on ``device``: ``cfg`` is the
    divide-and-conquer suite's config, ``st_cfg`` the single-tile one's
    (its sampler), ``agg_kwargs`` the ``Aggregate.from_smc`` overrides.
    Prints each rep's walls. Returns ``(st_pmfs, dc_pmfs)``."""
    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
    )
    from smcdet_tpu_torch.inference.aggregate import Aggregate, expand_prior
    from smcdet_tpu_torch.inference.smc import (
        SMCConfig,
        SMCSampler,
        run_csmc_chunked,
    )
    prior = build_prior(cfg.prior, device)
    model = build_image_model(cfg.image_model, device)
    kernel = build_kernel(cfg.kernel, device)
    td = cfg.sampler.tile_dim
    tile_prior = expand_prior(prior, td, td, prior.max_objects)
    tile_model = model.with_shape(td, td)
    s, st = cfg.sampler, st_cfg.sampler
    st_smc = SMCConfig(
        num_catalogs=st.num_catalogs,
        ess_threshold_prop=st.ess_threshold_prop,
        resample_method=st.resample_method,
        max_smc_iters=st.max_smc_iters,
        flux_detection_threshold=st.flux_detection_threshold,
    )
    K = 4 * prior.max_objects + 1
    n = images.shape[0]
    st_pmfs, dc_pmfs = [], []
    for r in range(reps):
        _sync(device)
        start = time.perf_counter()
        res = run_csmc_chunked(batch_generator(100 + r, 0, device), images,
                               prior, model, kernel, st_smc)
        st_pmfs.append(weighted_pmf(res.pruned_counts.cpu().numpy(),
                                    res.weights.cpu().numpy(), K))
        _sync(device)
        st_wall = time.perf_counter() - start
        print(f"single-tile rep {r} done in {st_wall:.3f} s", flush=True)

        dc_pmf = np.zeros((n, K))
        for i in range(n):
            sampler = SMCSampler(
                image=images[i], tile_dim=td, Prior=tile_prior,
                ImageModel=tile_model, MutationKernel=kernel,
                num_catalogs=s.num_catalogs,
                ess_threshold_prop=s.ess_threshold_prop,
                resample_method=s.resample_method,
                flux_detection_threshold=s.flux_detection_threshold,
                max_smc_iters=s.max_smc_iters,
            )
            sampler.run(batch_generator(200 + r, i, device))
            agg = Aggregate.from_smc(sampler, **agg_kwargs)
            agg.run(batch_generator(300 + r, i, device))
            dc_pmf[i] = weighted_pmf(
                agg.pruned_counts[0, 0][None].cpu().numpy(),
                agg.state.weights[0, 0][None].cpu().numpy(), K)[0]
        dc_pmfs.append(dc_pmf)
        _sync(device)
        print(f"D&C rep {r} done in "
              f"{time.perf_counter() - start - st_wall:.3f} s", flush=True)
    return np.asarray(st_pmfs), np.asarray(dc_pmfs)


def pooled_report(st_pmfs, dc_pmfs, bridge_effort):
    """The JAX script's report from both pipelines' pmfs ``[R, I, K]``:
    the first rep's and the pooled cross-pipeline TVD, the pooled mean
    count's absolute difference, and with two reps or more each pipeline's
    half-split self floor and their quadrature cross floor."""
    reps, n, K = st_pmfs.shape
    st_pool, dc_pool = st_pmfs.mean(0), dc_pmfs.mean(0)

    def self_halves(pmfs):
        return 0.5 * np.abs(pmfs[: reps // 2].mean(0)
                            - pmfs[reps // 2:].mean(0)).sum(-1)

    tvd_single = 0.5 * np.abs(dc_pmfs[0] - st_pmfs[0]).sum(-1)
    tvd_pool = 0.5 * np.abs(dc_pool - st_pool).sum(-1)
    ks = np.arange(K)
    report = {
        "images": int(n),
        "reps": int(reps),
        "tvd_single_run": tvd_stats(tvd_single),
        "tvd_pooled": tvd_stats(tvd_pool),
        "mean_count_abs_diff_pooled": round(float(np.abs(
            (dc_pool * ks).sum(-1) - (st_pool * ks).sum(-1)).mean()), 4),
        "bridge_effort": dict(bridge_effort),
    }
    if reps >= 2:
        st_half, dc_half = self_halves(st_pmfs), self_halves(dc_pmfs)
        # two reps-pooled means differ by half the quadrature sum of the
        # half-split floors (compare_pooled.py's derivation)
        cross = 0.5 * np.sqrt(st_half ** 2 + dc_half ** 2)
        report["tvd_singletile_self_halves"] = tvd_stats(st_half)
        report["tvd_dc_self_halves"] = tvd_stats(dc_half)
        report["tvd_cross_floor_quadrature"] = tvd_stats(cross)
    return report


def main(argv=None):
    from smcdet_tpu_torch.config import load_config
    from smcdet_tpu_torch.run_experiment import _check_device

    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.compare_pooled",
        description="Pooled count-pmf agreement of the divide-and-conquer "
                    "and single-tile pipelines over repetitions.")
    parser.add_argument("--num-images", type=int, default=30)
    parser.add_argument("--reps", type=int, default=4)
    parser.add_argument("--agg-iters", type=int, default=None)
    parser.add_argument("--relocate", type=int, default=None)
    parser.add_argument("--pair-sweeps", type=int, default=0)
    parser.add_argument("--suffix", type=str, default="")
    parser.add_argument("--dump", action="store_true",
                        help="also save the per-rep per-image count pmfs of "
                             "both pipelines (pooled_pmfs<suffix>.npz)")
    parser.add_argument("--num-catalogs", type=int, default=None,
                        help="the tile stage's N (default the config's)")
    parser.add_argument("--sweeps", type=int, default=None,
                        help="sweeps per SMC and bridge iteration (default "
                             "the config's)")
    parser.add_argument("--output-dir", default=None,
                        help="replaces the config's output_dir")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    _check_device(device)

    cfg = load_config(SUITE / "config.yaml")
    st_cfg = load_config(SUITE / "config_singletile.yaml")
    if args.num_catalogs is not None:
        ratio = st_cfg.sampler.num_catalogs // cfg.sampler.num_catalogs
        cfg.sampler.num_catalogs = args.num_catalogs
        st_cfg.sampler.num_catalogs = ratio * args.num_catalogs
    if args.sweeps is not None:
        cfg.kernel.num_iters = args.sweeps
    out_dir = Path(args.output_dir or cfg.output_dir) / cfg.name
    tiles = np.load(out_dir / "tiles.npz")
    n = min(args.num_images, tiles["images"].shape[0])
    images = torch.as_tensor(tiles["images"][:n], dtype=torch.float32,
                             device=device)
    effort = {
        "max_smc_iters": args.agg_iters or cfg.aggregation.max_smc_iters,
        "relocate_sweeps": (args.relocate if args.relocate is not None
                            else cfg.aggregation.relocate_sweeps),
        "pair_sweeps": args.pair_sweeps,
    }
    agg_kwargs = dict(resample_method=cfg.aggregation.resample_method,
                      ess_threshold_prop=cfg.aggregation.ess_threshold_prop,
                      **effort)
    if device.type == "cuda":
        from smcdet_tpu_torch import _build

        _build.load_library()
    st_pmfs, dc_pmfs = pooled_pmfs(images, cfg, st_cfg, args.reps, device,
                                   agg_kwargs)
    report = pooled_report(st_pmfs, dc_pmfs, effort)
    with open(out_dir / f"pooled_comparison{args.suffix}.json", "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    if args.dump:
        np.savez_compressed(
            out_dir / f"pooled_pmfs{args.suffix}.npz", st_pmfs=st_pmfs,
            dc_pmfs=dc_pmfs,
            true_counts=np.asarray(tiles["true_counts"][:n]))
    return report


if __name__ == "__main__":
    main()
