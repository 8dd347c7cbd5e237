"""Divide-and-conquer against single-tile posterior agreement (port of
``experiments/divideandconquer/compare_singletile.py``, without JAX):

    python -m smcdet_tpu_torch.studies.compare_singletile

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
posterior mean count's mean and largest absolute difference. It draws no
figure (the JAX script's ``singletile_comparison.png``): the port has no
plotting dependency, and matplotlib is not installed beside it everywhere.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from smcdet_tpu_torch.studies import REPO, tvd_stats, weighted_pmf

__all__ = ["singletile_report", "main"]


def singletile_report(dc, st):
    """The report from the two pipelines' results (``load_results`` dicts
    with ``pruned_counts`` and ``weights``), over the images both hold."""
    n = min(dc["pruned_counts"].shape[0], st["pruned_counts"].shape[0])
    K = int(max(dc["pruned_counts"].max(), st["pruned_counts"].max())) + 2
    dc_pmf = weighted_pmf(dc["pruned_counts"][:n], dc["weights"][:n], K)
    st_pmf = weighted_pmf(st["pruned_counts"][:n], st["weights"][:n], K)
    tvd = 0.5 * np.abs(dc_pmf - st_pmf).sum(-1)
    mean_dc = (dc_pmf * np.arange(K)).sum(-1)
    mean_st = (st_pmf * np.arange(K)).sum(-1)
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
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    out_dc = Path(cfg.output_dir) / "divideandconquer"
    out_st = Path(cfg.output_dir) / "divideandconquer_singletile"
    report = singletile_report(load_results(out_dc, "smc"),
                               load_results(out_st, "smc"))
    with open(out_dc / "singletile_comparison.json", "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
