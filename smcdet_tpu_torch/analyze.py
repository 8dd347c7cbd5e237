"""Score a finished experiment with the PyTorch port (the report of
``experiments/analyze.py``, without JAX):

    python -m smcdet_tpu_torch.analyze output/<name> [--method smc]
        [--mag-bins 15 18 21 24] [--num-match 50] [--locs-tol 0.5]
        [--mags-tol 0.5] [--bootstrap 1000] [--tiles PATH]
        [--out-suffix S] [--device cuda] [--no-figures]

From ``output/<name>/<method>_batch*.npz`` and the truth in ``tiles.npz``
(or ``--tiles``) it computes the posterior count confusion matrix and its
asymmetry, the count accuracy, the credible-interval coverage of the total
flux, the SBC rank uniformity, and detection precision / recall / F1 by
magnitude bin by catalog matching, with bootstrap intervals over images
(and the extractor baseline's when ``sep_results.npz`` exists). It writes
``<method>_analysis<suffix>.json`` with the JAX script's keys and rounding.
Matching runs on ``--device`` (default ``cuda``, never swapped for another
device). As the JAX script, it draws the report's figures
(``smcdet_tpu_torch/figures.py:save_all``) into
``<results_dir>/figures<suffix>`` (``figures_<method><suffix>`` for another
method than smc) and lists them under ``figures``, unless ``--no-figures``
is given; where matplotlib does not import (the H100 machine) that is an
error naming ``--no-figures``, never a silent skip. Draw them on a machine
with matplotlib from the card run's result files:
``python -m smcdet_tpu_torch.analyze output/<name> --device cpu``.

The sampled catalogs of the matching are drawn on the CPU from
``torch.Generator().manual_seed(k)`` (k = 0, 1, 2 where the JAX script uses
``jax.random.key(k)``), so the detection numbers are another draw of the
50 catalogs than the JAX script's, and the same on every device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from smcdet_tpu_torch.metrics import (
    compute_precision_recall_f1,
    match_catalogs,
)
from smcdet_tpu_torch.ops.resampling import multinomial_indices
from smcdet_tpu_torch.runner import load_results
from smcdet_tpu_torch.validation import (
    confusion_asymmetry,
    count_confusion_matrix,
    credible_interval_coverage,
    sbc_ranks,
    sbc_uniformity_pvalue,
)

__all__ = ["COVERAGE_LEVELS", "bootstrap_prf", "ci_summary",
           "catalog_indices", "analyze", "main"]

COVERAGE_LEVELS = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95]
_METRICS = ("precision", "recall", "f1")


def bootstrap_prf(mc, n_boot: int, seed: int = 0):
    """Bootstrap P/R/F1 over images (the tile axis of ``MatchCounts``):
    resampling the T images with replacement is a draw of multinomial
    weights over images followed by the sum over images, one ``[n_boot, T]
    x [T, S*B]`` product. Returns ``{metric: [n_boot, n_bins]}`` with the
    sampled-catalog axis averaged out."""
    tt, tm, et, em = (np.asarray(torch.as_tensor(a).cpu(), dtype=np.float64)
                      for a in mc)
    T = tt.shape[0]
    rng = np.random.default_rng(seed)
    w = rng.multinomial(T, np.full(T, 1.0 / T), size=n_boot).astype(
        np.float64)

    def agg(a):  # [T, S, B] -> [n_boot, S, B]
        return np.tensordot(w, a.reshape(T, -1), axes=(1, 0)).reshape(
            (n_boot,) + a.shape[1:])

    btt, btm, bet, bem = agg(tt), agg(tm), agg(et), agg(em)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.nan_to_num(bem / bet)
        recall = np.nan_to_num(btm / btt)
        f1 = np.nan_to_num(2 * precision * recall / (precision + recall))
    return {"precision": precision.mean(1), "recall": recall.mean(1),
            "f1": f1.mean(1)}


def ci_summary(point, boot, alpha=0.05):
    """``[3, n_bins]`` (lo, point, hi) from a bootstrap sample."""
    lo = np.quantile(boot, alpha / 2, axis=0)
    hi = np.quantile(boot, 1 - alpha / 2, axis=0)
    return np.stack([lo, np.asarray(point), hi])


def catalog_indices(seed: int, weights, num: int):
    """The ``[T, num]`` posterior catalogs to match, drawn with ``weights
    [T, N]`` from a CPU generator seeded with ``seed``."""
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32)
    return multinomial_indices(w, num,
                               generator=torch.Generator().manual_seed(seed))


def _match(draw, seed, device, truth, est, num, weights=None, **tols):
    """``match_catalogs`` on ``device`` for the truth ``(counts, locs,
    fluxes)`` and the flat posterior ``est``, the catalogs drawn by
    ``draw(seed, weights, num)``; fluxes floored at 1e-6 as the JAX script
    does. ``tols``: ``locs_tol``, ``mags_tol``, ``mag_bins``."""
    T, N = est[0].shape[:2]
    if weights is None:
        weights = np.full((T, N), 1.0 / N, np.float32)

    def dev(x, floor=False):
        x = np.asarray(x)
        if floor:
            x = np.maximum(x, 1e-6)
        return torch.as_tensor(x, device=device)

    return match_catalogs(
        dev(truth[0]), dev(truth[1]), dev(truth[2], True),
        dev(est[0]), dev(est[1]), dev(est[2], True),
        num_est_catalogs_to_match=num, indices=draw(seed, weights, num),
        **tols)


def _point(mc):
    p, r, f1 = compute_precision_recall_f1(mc)
    return {m: x.cpu().numpy().mean(0) for m, x in zip(_METRICS, (p, r, f1))}


def _by_bin(ci):
    return {f"{m}_by_bin": {"point": np.round(ci[m][1], 4).tolist(),
                            "ci95_lo": np.round(ci[m][0], 4).tolist(),
                            "ci95_hi": np.round(ci[m][2], 4).tolist()}
            for m in _METRICS}


def analyze(results_dir, *, method="smc", mag_bins=(15.0, 18.0, 21.0, 24.0),
            num_match=50, locs_tol=0.5, mags_tol=0.5, bootstrap=1000,
            tiles=None, device="cuda", draw=catalog_indices, figures=True,
            out_suffix=""):
    """The report of ``results_dir`` (a dict with the JAX script's keys).
    ``draw(seed, weights, num)`` gives the sampled catalogs of each
    matching. With ``figures`` the report's figures are drawn into
    ``results_dir/figures<out_suffix>`` (``figures_<method>...`` for another
    method than smc) and listed under ``figures``; where matplotlib does
    not import that raises ``RuntimeError`` naming ``--no-figures``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA card is available "
                           "(torch.cuda.is_available() is False)")
    if figures:
        from smcdet_tpu_torch.figures import require_matplotlib

        require_matplotlib("--no-figures")
    tols = dict(locs_tol=locs_tol, mags_tol=mags_tol,
                mag_bins=list(mag_bins))
    out_dir = Path(results_dir)
    res = load_results(out_dir, method)
    tiles_path = Path(tiles) if tiles else out_dir / "tiles.npz"
    if not tiles_path.exists():
        raise FileNotFoundError(
            f"{tiles_path} missing: write the tiles first "
            "(python -m smcdet_tpu_torch.run_experiment ... --generate)")
    truth_npz = np.load(tiles_path)
    n = res["counts"].shape[0]
    truth_counts = truth_npz["true_counts"][:n]
    truth_locs = truth_npz["true_locs"][:n]
    truth_fluxes = truth_npz["true_fluxes"][:n]

    report = {"images": int(n)}
    weights = res.get("weights")
    est_counts = res["pruned_counts"]
    M = count_confusion_matrix(truth_counts, est_counts, weights=weights)
    report["count_confusion"] = np.round(M, 4).tolist()
    report["confusion_asymmetry"] = round(confusion_asymmetry(M), 4)
    report["count_accuracy"] = round(float(np.trace(M)), 4)

    truth_total = truth_fluxes.sum(-1)
    est_total = res["pruned_fluxes"].sum(-1)
    # coverage over images with at least one true source: zero-truth images
    # put a posterior atom at the true value and cover at every level
    nz = truth_counts > 0
    cov = credible_interval_coverage(
        truth_total[nz], est_total[nz], COVERAGE_LEVELS,
        weights=weights[nz] if weights is not None else None)
    report["total_flux_coverage"] = {
        str(level): round(float(c), 4)
        for level, c in zip(COVERAGE_LEVELS, cov)}
    ranks = sbc_ranks(truth_total, est_total, weights=weights)
    report["sbc_total_flux_ks_pvalue"] = round(sbc_uniformity_pvalue(ranks),
                                               5)

    truth = (truth_counts, truth_locs, truth_fluxes)
    est = (res["pruned_counts"], res["pruned_locs"], res["pruned_fluxes"])
    mc = _match(draw, 0, device, truth, est, num_match, weights, **tols)
    point = _point(mc)
    boot = bootstrap_prf(mc, bootstrap)
    smc_ci = {m: ci_summary(point[m], boot[m]) for m in point}
    report["detection"] = _by_bin(smc_ci)

    sep, sep_ci = None, None
    sep_path = out_dir / "sep_results.npz"
    if sep_path.exists():
        sep = np.load(sep_path)
        if "eval_true_counts" not in sep:
            print(f"warning: {sep_path} has no eval_true_* arrays "
                  "(an artifact from before they were embedded); skipping "
                  "the baseline comparison", file=sys.stderr)
            sep = None
    if sep is not None:
        ns = sep["counts"].shape[0]
        # the truth of the evaluated tiles rides in the SEP artifact
        mc_sep = _match(
            draw, 1, device,
            (sep["eval_true_counts"], sep["eval_true_locs"],
             sep["eval_true_fluxes"]),
            (sep["counts"][:, None], sep["locs"][:, None],
             sep["fluxes"][:, None]), 1, **tols)
        sep_point = _point(mc_sep)
        sep_boot = bootstrap_prf(mc_sep, bootstrap, seed=1)
        sep_ci = {m: ci_summary(sep_point[m], sep_boot[m])
                  for m in sep_point}
        report["sep_baseline"] = _by_bin(sep_ci)

        # head to head on the same eval tiles: the SMC detection metrics
        # restricted to the SEP eval subset
        if "eval_indices" in sep:
            idx = np.asarray(sep["eval_indices"])
            idx = idx[idx < n][:ns]
            mc_eval = _match(
                draw, 2, device,
                tuple(a[idx] for a in truth), tuple(a[idx] for a in est),
                num_match, weights[idx] if weights is not None else None,
                **tols)
            eval_point = _point(mc_eval)
            eval_boot = bootstrap_prf(mc_eval, bootstrap, seed=2)
            report["detection_eval_subset"] = {
                "images": int(idx.size),
                **_by_bin({m: ci_summary(eval_point[m], eval_boot[m])
                           for m in eval_point})}

    per_image = res.get("runtime_per_image")
    report["runtime_s"] = {
        "total": round(float(res["runtime"].sum()), 2),
        "per_batch_mean": round(float(res["runtime"].mean()), 2)}
    if per_image is not None:
        report["runtime_s"]["per_image_mean"] = round(
            float(np.mean(per_image)), 4)
        report["runtime_s"]["per_image_max"] = round(
            float(np.max(per_image)), 4)

    if figures:
        from smcdet_tpu_torch.figures import save_all

        # detected stars per magnitude bin: truth, the posterior's spread
        tt = mc.num_true_total.cpu().numpy()
        et = mc.num_est_total.cpu().numpy()
        report["figures"] = save_all(
            out_dir / (("figures" if method == "smc" else f"figures_{method}")
                       + out_suffix),
            mag_bins=list(mag_bins), smc_ci=smc_ci, sep_ci=sep_ci,
            confusion=M, levels=COVERAGE_LEVELS, coverage=cov,
            n_images=int(nz.sum()), ranks=ranks, true_counts=truth_counts,
            runtimes=per_image, classified=(tt[:, 0, :].sum(0), et.sum(0)))
    return report


def main(argv=None, *, draw=catalog_indices):
    """The command line; ``draw`` replaces the catalog draw (a test
    hook)."""
    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.analyze",
        description="Score a finished experiment with the PyTorch port: "
                    "count confusion, total-flux coverage, SBC and "
                    "detection P/R/F1, written to "
                    "<results_dir>/<method>_analysis<suffix>.json, with "
                    "the report's figures (unless --no-figures).")
    parser.add_argument("results_dir")
    parser.add_argument("--method", default="smc")
    parser.add_argument("--mag-bins", type=float, nargs="+",
                        default=[15.0, 18.0, 21.0, 24.0])
    parser.add_argument("--num-match", type=int, default=50)
    parser.add_argument("--locs-tol", type=float, default=0.5)
    parser.add_argument("--mags-tol", type=float, default=0.5)
    parser.add_argument("--bootstrap", type=int, default=1000)
    parser.add_argument("--tiles", default=None,
                        help="the truth-tiles artifact (default "
                             "<results_dir>/tiles.npz)")
    parser.add_argument("--out-suffix", default="",
                        help="suffix of the analysis JSON, so that a "
                             "truth-variant analysis keeps the main one")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the matching (default cuda)")
    parser.add_argument("--no-figures", action="store_true",
                        help="draw no figures (needed where matplotlib "
                             "does not import, as on the H100 machine)")
    args = parser.parse_args(argv)
    if args.tiles and not args.out_suffix:
        stem = Path(args.tiles).stem
        if stem != "tiles":
            # a truth variant never overwrites the primary analysis
            args.out_suffix = "_" + stem.removeprefix("tiles_")
            print(f"--tiles given without --out-suffix: writing with "
                  f"derived suffix {args.out_suffix!r} to protect the "
                  f"primary analysis")
    report = analyze(
        args.results_dir, method=args.method, mag_bins=args.mag_bins,
        num_match=args.num_match, locs_tol=args.locs_tol,
        mags_tol=args.mags_tol, bootstrap=args.bootstrap, tiles=args.tiles,
        device=args.device, draw=draw, figures=not args.no_figures,
        out_suffix=args.out_suffix)
    print(json.dumps(report, indent=2))
    path = Path(args.results_dir) / (
        f"{args.method}_analysis{args.out_suffix}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
