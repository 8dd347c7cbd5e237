"""Divide-and-conquer against single-tile posterior agreement (port of
``experiments/divideandconquer/compare_singletile.py``, without JAX):

    python -m smcdet_tpu_torch.studies.compare_singletile [--config C]
        [--figure]

The tree merge's criterion: per-tile CS-SMC and the binary-tree
aggregation over a 2x2 grid must reproduce the posterior of one CS-SMC run
on the whole 16x16 image. Run both pipelines over the same tiles first:

    python -m smcdet_tpu_torch.run_experiment experiments/divideandconquer
    python -m smcdet_tpu_torch.run_experiment experiments/divideandconquer \\
        --config config_singletile.yaml

(the single-tile config reads ``output/divideandconquer/tiles.npz``;
``--config`` names another tree config, such as the 32x32 one
``studies/dnc_grid.py`` writes, whose ``output_dir`` holds both runs). From
``output/divideandconquer`` and ``output/divideandconquer_singletile`` (the
port's ``load_results``; either package's batch files) it writes
``output/divideandconquer/singletile_comparison.json`` with the JAX
script's keys: the count-pmf TVD per image (mean, median, p90) and the
posterior mean count's mean and largest absolute difference; and the
figure's arrays, per image the two posterior mean counts and the TVD
(``mean_dc``, ``mean_st``, ``tvd``), to
``output/divideandconquer/figure_data/singletile_comparison.npz``, from
which ``python -m smcdet_tpu_torch.figures`` draws
``figures/singletile_comparison.png`` (``--figure``: at once, matplotlib
needed; the card has none).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from smcdet_tpu_torch.figures import (
    draw,
    require_matplotlib,
    save_figure_data,
)
from smcdet_tpu_torch.studies import REPO, tvd_stats, weighted_pmf

__all__ = ["singletile_arrays", "singletile_report", "main"]


def singletile_arrays(dc, st):
    """Per image both pipelines' results (``load_results`` dicts with
    ``pruned_counts`` and ``weights``) hold: the tree's and the single
    tile's posterior mean count and their count pmfs' TVD."""
    n = min(dc["pruned_counts"].shape[0], st["pruned_counts"].shape[0])
    K = int(max(dc["pruned_counts"].max(), st["pruned_counts"].max())) + 2
    dc_pmf = weighted_pmf(dc["pruned_counts"][:n], dc["weights"][:n], K)
    st_pmf = weighted_pmf(st["pruned_counts"][:n], st["weights"][:n], K)
    return {"mean_dc": (dc_pmf * np.arange(K)).sum(-1),
            "mean_st": (st_pmf * np.arange(K)).sum(-1),
            "tvd": 0.5 * np.abs(dc_pmf - st_pmf).sum(-1)}


def singletile_report(arrays):
    """The report from ``singletile_arrays``."""
    mean_dc, mean_st, tvd = arrays["mean_dc"], arrays["mean_st"], arrays[
        "tvd"]
    n = tvd.shape[0]
    return {
        "images": int(n),
        "count_pmf_tvd": tvd_stats(tvd),
        "mean_count": {
            "mean_abs_diff": round(float(np.abs(mean_dc - mean_st).mean()),
                                   4),
            "max_abs_diff": round(float(np.abs(mean_dc - mean_st).max()), 4),
        },
    }


def main(argv=None):
    from smcdet_tpu_torch.config import load_config
    from smcdet_tpu_torch.runner import load_results

    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.compare_singletile",
        description="Count-pmf agreement of the divide-and-conquer and "
                    "single-tile runs over the same images.")
    parser.add_argument(
        "--config", default=str(REPO / "experiments" / "divideandconquer"
                                / "config.yaml"),
        help="the tree's config, whose output_dir holds both runs (default "
             "the committed suite's; smcdet_tpu_torch.studies.dnc_grid "
             "writes one for a larger image)")
    parser.add_argument("--figure", action="store_true",
                        help="also draw figures/singletile_comparison.png "
                             "(needs matplotlib)")
    args = parser.parse_args(argv)
    if args.figure:
        require_matplotlib("--figure")
    cfg = load_config(args.config)
    out_dc = Path(cfg.output_dir) / "divideandconquer"
    out_st = Path(cfg.output_dir) / "divideandconquer_singletile"
    dc, st = load_results(out_dc, "smc"), load_results(out_st, "smc")
    arrays = singletile_arrays(dc, st)
    report = singletile_report(arrays)
    with open(out_dc / "singletile_comparison.json", "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    data = save_figure_data(out_dc, "singletile_comparison", **arrays)
    if args.figure:
        for png in draw(data):
            print(f"figure: {png}")
    return report


if __name__ == "__main__":
    main()
