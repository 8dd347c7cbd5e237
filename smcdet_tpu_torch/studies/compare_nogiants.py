"""The saturated giants' share of the m71 coverage gap (port of
``experiments/m71/compare_nogiants.py``, without JAX):

    python -m smcdet_tpu_torch.studies.compare_nogiants [--base output/m71]
        [--ablat output/m71_nogiants] [--out output/nogiants_comparison.json]

Compares the m71 run against the no-giants run (``config_nogiants.yaml``:
the same seed and star field without the four giants, so every tile
outside the giants' render reach has the same pixels):

- the geometry: the max-norm distance from every kept m71 tile to the
  nearest giant against the radius-8 render reach;
- the total-flux coverage at 0.5 / 0.8 / 0.95 on the kept tiles both runs
  hold (truth above zero), where a difference bounds all the giants'
  influence, and each run's coverage over all its tiles;
- whether the shared tiles' images are bit-equal.

The results are read from the run directories (either package's batch
files); the tiles from the fixtures the configs name
(``experiments/m71/data{,_nogiants}/m71/tiles.npz``), since the port's
runner does not copy them into its output. The giants' positions come from
``m71_fixture.default_truth_stars`` (the default fixture's star list is
not committed).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from smcdet_tpu_torch.studies import m71_fixture as fx

__all__ = ["geometry", "coverage_on", "run_metrics", "nogiants_report",
           "main"]

LEVELS = [0.5, 0.8, 0.95]


def geometry(truth_stars, tile_index):
    """The giants (fluxes above the Pareto support) against the kept tiles
    ``tile_index``: their number, how many tiles lie within the render
    reach of one (max-norm distance from the tile's pixel box at most
    ``PSF_RADIUS``), and the least such distance."""
    g = np.asarray(truth_stars["fluxes"]) > fx.FLUX_UPPER
    g_rows = np.asarray(truth_stars["rows"])[g] - fx.REGION_Y0
    g_cols = np.asarray(truth_stars["cols"])[g] - fx.REGION_X0
    ty, tx = fx.tile_origins(tile_index)
    dy = np.maximum(ty[:, None] - g_rows[None, :],
                    g_rows[None, :] - (ty[:, None] + fx.TILE))
    dx = np.maximum(tx[:, None] - g_cols[None, :],
                    g_cols[None, :] - (tx[:, None] + fx.TILE))
    cheb = np.maximum(np.maximum(dy, 0.0), np.maximum(dx, 0.0))
    return {
        "num_giants": int(g.sum()),
        "kept_tiles_within_render_reach": int(
            (cheb <= fx.PSF_RADIUS).any(1).sum()),
        "min_kept_tile_giant_distance_px": round(float(cheb.min(1).min()),
                                                 2),
    }


def coverage_on(idx, truth_total, est_total, weights):
    """Coverage at ``LEVELS`` over the images ``idx``."""
    from smcdet_tpu_torch.validation import credible_interval_coverage

    return [round(float(c), 4) for c in credible_interval_coverage(
        truth_total[idx], est_total[idx], LEVELS,
        weights=weights[idx] if weights is not None else None)]


def run_metrics(res, tiles, n, sel):
    """One run's coverage on its shared tiles ``sel`` and on all its tiles,
    both where the true total flux is above zero."""
    truth_total = tiles["true_fluxes"][:n].sum(-1)
    est_total = res["pruned_fluxes"].sum(-1)
    weights = res.get("weights")
    nz = truth_total > 0
    keep_nz = sel[nz[sel]]
    return {
        "coverage_shared_nz": coverage_on(keep_nz, truth_total, est_total,
                                          weights),
        "coverage_all_nz": coverage_on(np.flatnonzero(nz), truth_total,
                                       est_total, weights),
        "images_all": int(n),
        "images_shared_nz": int(keep_nz.size),
    }


def nogiants_report(base_res, base_tiles, abl_res, abl_tiles, truth_stars):
    """The report (the JAX script's keys) from the two runs' results and
    tiles (mappings of arrays) and the default fixture's star list."""
    nb, na = base_res["counts"].shape[0], abl_res["counts"].shape[0]
    bi = np.asarray(base_tiles["tile_index"][:nb])
    ai = np.asarray(abl_tiles["tile_index"][:na])
    shared = np.intersect1d(bi, ai)
    b_pos = {t: i for i, t in enumerate(bi)}
    a_pos = {t: i for i, t in enumerate(ai)}
    bsel = np.asarray([b_pos[t] for t in shared], dtype=np.int64)
    asel = np.asarray([a_pos[t] for t in shared], dtype=np.int64)
    return {
        "levels": LEVELS,
        "geometry": geometry(truth_stars, bi),
        "shared_tiles": int(shared.size),
        "base": run_metrics(base_res, base_tiles, nb, bsel),
        "nogiants": run_metrics(abl_res, abl_tiles, na, asel),
        "shared_images_identical": bool(np.array_equal(
            base_tiles["images"][:nb][bsel],
            abl_tiles["images"][:na][asel])),
    }


def main(argv=None):
    from smcdet_tpu_torch.runner import load_results

    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.compare_nogiants",
        description="Coverage of the m71 run against the no-giants run on "
                    "their shared tiles, and the giants' geometry.")
    parser.add_argument("--base", default="output/m71")
    parser.add_argument("--ablat", default="output/m71_nogiants")
    parser.add_argument("--base-tiles",
                        default=str(fx.M71 / "data" / "m71" / "tiles.npz"))
    parser.add_argument("--ablat-tiles", default=str(
        fx.M71 / "data_nogiants" / "m71" / "tiles.npz"))
    parser.add_argument("--out", default="output/nogiants_comparison.json")
    args = parser.parse_args(argv)

    stars = fx.default_truth_stars()
    with np.load(args.base_tiles) as bt, np.load(args.ablat_tiles) as at:
        report = nogiants_report(
            load_results(args.base, "smc"), {k: bt[k] for k in bt.files},
            load_results(args.ablat, "smc"), {k: at[k] for k in at.files},
            stars)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
