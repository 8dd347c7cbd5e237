"""PSF misspecification: the control, elliptical and varying renders (port
of ``experiments/m71/misspec_study.py``, without JAX):

    python -m smcdet_tpu_torch.studies.misspec_study [--output-dir output]
        [--figure]

Three fixtures share one star field: ``control`` (the well-specified render,
``data``, run ``m71``), ``elliptical`` (an anisotropic PSF outside the
circular inference family, ``data_mis``, run ``m71_mis``) and ``varying``
(core widths drifting across the region, ``data_vary``, run ``m71_vary``).
Per variant: the total-flux coverage at 0.5 / 0.8 / 0.95 over tiles with
truth above zero, the posterior count's mean excess over the truth (all
tiles, and the tiles with no true star), and the coverage at 0.95 by band
of region rows (distance from the fit patch, which sits before row
0). Reads ``{output-dir}/<run>`` (either package's batch files) and the
fixtures' ``tiles.npz``; writes ``{output-dir}/m71/misspec_study.json``
with the JAX script's keys. A variant without results is reported as
missing. The figure reads that report alone: ``python -m
smcdet_tpu_torch.figures`` draws ``{output-dir}/m71/figures/
misspec_study.png`` from it (``--figure``: at once, matplotlib needed),
given at least two finished variants, as the JAX script.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from smcdet_tpu_torch.figures import draw, require_matplotlib
from smcdet_tpu_torch.studies.m71_fixture import M71

__all__ = ["VARIANTS", "weighted_coverage", "coverage_by_region_row",
           "variant_report", "main"]

VARIANTS = {
    "control": ("data", "m71"),
    "elliptical": ("data_mis", "m71_mis"),
    "varying": ("data_vary", "m71_vary"),
}
LEVELS = (0.5, 0.8, 0.95)
LEVEL = 0.95  # of the coverage by region row
REGION_TILE_ROWS = 40  # 320-px region / 8-px tiles
TILE_COLS = 20  # 160-px region width / 8
MISSING = "missing (run the queue first)"


def weighted_coverage(true_vals, samples, weights, level):
    from smcdet_tpu_torch.validation import credible_interval_coverage

    return float(credible_interval_coverage(true_vals, samples, [level],
                                            weights=weights)[0])


def coverage_by_region_row(rows, inside):
    """Coverage (the share of ``inside``) in four equal bands of region
    tile rows, ``rows`` the tile row of each scored tile."""
    edges = np.linspace(0, REGION_TILE_ROWS, 5).astype(int)
    out = []
    for a, b in zip(edges[:-1], edges[1:]):
        m = (rows >= a) & (rows < b)
        out.append({"rows": [int(a), int(b)], "n": int(m.sum()),
                    "coverage": round(float(inside[m].mean()), 4)
                    if m.any() else None})
    return out


def variant_report(res, tiles):
    """One variant's entry from its results (``load_results``) and tiles."""
    from smcdet_tpu_torch.validation import credible_interval_contains

    n = res["pruned_counts"].shape[0]
    truth_flux = tiles["true_fluxes"][:n].sum(-1)
    truth_count = tiles["true_counts"][:n]
    flux_samp = res["pruned_fluxes"][:n].sum(-1)
    cnt_samp = res["pruned_counts"][:n].astype(np.float64)
    w = res["weights"][:n]

    pos = truth_flux > 0
    mean_count = (cnt_samp * w).sum(-1) / w.sum(-1)
    excess = mean_count - truth_count
    out = {
        "images": int(n),
        "total_flux_coverage": {
            str(lv): round(weighted_coverage(truth_flux[pos], flux_samp[pos],
                                             w[pos], lv), 4)
            for lv in LEVELS},
        "posterior_count_excess_mean": round(float(excess.mean()), 4),
        "posterior_count_excess_on_truth0": round(
            float(excess[truth_count == 0].mean()), 4)
        if (truth_count == 0).any() else None,
    }
    rows = (tiles["tile_index"][:n] // TILE_COLS).astype(int)
    inside = credible_interval_contains(truth_flux[pos], flux_samp[pos],
                                        LEVEL, weights=w[pos])
    out[f"coverage_{LEVEL}_by_region_row"] = coverage_by_region_row(
        rows[pos], inside)
    return out


def main(argv=None):
    from smcdet_tpu_torch.runner import load_results

    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.misspec_study",
        description="Coverage and count excess of the m71 run and its two "
                    "misspecified-PSF variants.")
    parser.add_argument("--output-dir", default="output")
    parser.add_argument("--figure", action="store_true",
                        help="also draw figures/misspec_study.png (needs "
                             "matplotlib)")
    args = parser.parse_args(argv)
    if args.figure:
        require_matplotlib("--figure")

    report = {"variants": {}}
    for name, (data_dir, run) in VARIANTS.items():
        tiles_path = M71 / data_dir / "m71" / "tiles.npz"
        try:
            res = load_results(Path(args.output_dir) / run, "smc")
        except FileNotFoundError:
            report["variants"][name] = MISSING
            continue
        with np.load(tiles_path) as t:
            report["variants"][name] = variant_report(
                res, {k: t[k] for k in t.files})
    out = Path(args.output_dir) / "m71" / "misspec_study.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    if args.figure:
        for png in draw(out):
            print(f"figure: {png}")
    return report


if __name__ == "__main__":
    main()
