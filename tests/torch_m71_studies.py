"""Run the M71 studies with the PyTorch port on the card, and hold each
figure against the JAX package's committed analysis:

    python3 tests/torch_m71_studies.py [--only crowded oracle ...]
        [--report DIR] [--split-samples N] [--device cuda]

Each step is the command a user runs, from the repository's root; a
finished batch file is skipped, so a cut run resumes. The studies
(``STUDIES``), each a module of ``smcdet_tpu_torch.studies``:

- ``crowded``: ``crowded_budget_probe --run`` (the m71_seed2 suite, then
  its hiN and hiS arms on the 156 crowded tiles), against
  ``docs/results/m71/crowded_budget_probe.json``;
- ``oracle``: ``run_smc_oracle`` (the m71 fixture under its generating
  hyperparameters; K1), then ``python -m smcdet_tpu_torch.analyze
  output/m71oracle``, against ``oracle_smc_analysis.json``;
- ``nogiants``: the m71 and m71_nogiants suites, then
  ``compare_nogiants``, against ``nogiants_comparison.json``;
- ``misspec``: the m71, m71_mis and m71_vary suites, then
  ``misspec_study``, against ``misspec_study.json``;
- ``simulator``: ``simulator_checks``, against ``simulator_checks.json``;
- ``repeated``: the m71synthetic suite on the JAX package's tiles
  (``tests/data/m71synthetic_tiles.npz``, staged as
  ``output/m71synthetic/tiles.npz``; its run gives the entropy pick, printed
  beside the committed image), then ``repeated_runs`` on the committed
  images (498 at true count 1, 190 at 3), against
  ``m71synthetic/repeatedruns_s{1,3}_summary.json``;
- ``split``: ``split_mode_study`` on the same tiles, against
  ``m71synthetic/split_mode_study.json``; ``--split-samples N`` cuts its
  samples to N and its burn-in to N / 2 (printed beside the committed
  size).

Bands (``BANDS``), fixed before the first run on the card: the crowded
mean SBC rank within 1.96 sqrt(se_port^2 + se_committed^2) of the committed
one in each arm, its coverage at 0.95 within 0.05; the oracle's count
accuracy and coverage at 0.95 within 0.05 and its F1 inside the committed
interval in every bin; nogiants' geometry exact and each coverage within
0.05; misspec's coverages within 0.05 and count excesses within 0.15; each
simulator KS statistic inside the range of the current JAX script over
seeds 0-3 on the CPU (``tests/torch_studies_reference.py simulator-ks
--seeds 0 1 2 3``) widened by 0.03; each repeated-runs width within 30% of
the committed one and ``shrinks_with_N_and_steps`` equal; split_mode's
chains stuck and modal within 10 of the committed counts, pooled mean
count within 0.3 and acceptance within 0.03. Everything else is printed.
A missed band is not widened, and any miss makes the run exit 1. Every
study's output and ``summary.json`` are copied to ``--report`` (default
``output/m71_studies``), each figure's data file under its path below
``output/`` (``python -m smcdet_tpu_torch.figures REPORT`` draws them on
a machine with matplotlib).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
M71 = "experiments/m71"
COMMITTED = REPO / "docs" / "results"
# the M71 suites the scoring studies read, by run name: their config
SUITE_CONFIGS = {"m71": "config.yaml", "m71_seed2": "config_seed2.yaml",
                 "m71_nogiants": "config_nogiants.yaml",
                 "m71_mis": "config_mis.yaml", "m71_vary": "config_vary.yaml"}
STUDIES = ("crowded", "oracle", "nogiants", "misspec", "simulator",
           "repeated", "split")
NEEDS = {"nogiants": ("m71", "m71_nogiants"),
         "misspec": ("m71", "m71_mis", "m71_vary")}
BANDS = {
    "crowded_coverage95": 0.05,
    "oracle": 0.05,
    "nogiants_coverage": 0.05,
    "misspec_coverage": 0.05,
    "misspec_excess": 0.15,
    # the current JAX script over seeds 0-3, CPU (torch_studies_reference.py
    # simulator-ks --seeds 0 1 2 3), each end widened by this
    "simulator_ks": 0.03,
    "repeated_width_rel": 0.30,
    "split_chains": 10,
    "split_mean_count": 0.3,
    "split_acceptance": 0.03,
}
SIMULATOR_KS_JAX = {"q10": (0.1119, 0.1468), "median": (0.0887, 0.1686),
                    "q90": (0.0727, 0.1206)}
REPEATED_IMAGES = {1: 498, 3: 190}  # the committed summaries' images


def _run(args, cwd=REPO):
    cmd = [sys.executable, "-m", *args]
    print("+", " ".join(cmd), flush=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    start = time.perf_counter()
    subprocess.run(cmd, check=True, cwd=cwd, env=env)
    return time.perf_counter() - start


def _committed(path):
    return json.loads((COMMITTED / path).read_text())


def hold(port, committed, band):
    """``port`` beside ``committed``: ``held`` within ``band``."""
    ok = port is not None and committed is not None and abs(
        port - committed) <= band
    return {"port": port, "committed": committed, "band": band,
            "verdict": "held" if ok else "missed"}


def inside(port, lo, hi):
    ok = lo <= port <= hi
    return {"port": port, "range": [lo, hi],
            "verdict": "held" if ok else "missed"}


def _ok(tree):
    """No ``missed`` verdict anywhere in ``tree``."""
    if isinstance(tree, dict):
        return tree.get("verdict") != "missed" and all(
            _ok(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_ok(v) for v in tree)
    return True


def score_crowded(got, ref):
    """Per arm: the mean SBC rank within 1.96 sqrt(se_p^2 + se_c^2) of the
    committed one, coverage at 0.95 within its band; the KS p-value and the
    other coverages printed. An arm not run misses."""
    row = {"tiles": {"port": got["tiles"], "committed": ref["tiles"]}}
    for arm, r in ref["arms"].items():
        g = got["arms"].get(arm)
        if not isinstance(g, dict):
            row[arm] = {"verdict": "missed", "port": g}
            continue
        band = 1.96 * math.hypot(g["sbc_rank_stderr"], r["sbc_rank_stderr"])
        row[arm] = {
            "mean_sbc_rank": dict(hold(g["mean_sbc_rank"], r["mean_sbc_rank"],
                                       round(band, 4)),
                                  stderr_port=g["sbc_rank_stderr"],
                                  stderr_committed=r["sbc_rank_stderr"]),
            "coverage95": hold(g["coverage"]["0.95"], r["coverage"]["0.95"],
                               BANDS["crowded_coverage95"]),
            "printed": {"sbc_ks_pvalue": [g["sbc_ks_pvalue"],
                                          r["sbc_ks_pvalue"]],
                        "coverage": [g["coverage"], r["coverage"]]},
        }
    return row


def score_oracle(got, ref):
    band = BANDS["oracle"]
    f1, ref_f1 = got["detection"]["f1_by_bin"], ref["detection"]["f1_by_bin"]
    return {
        "images": got["images"],
        "count_accuracy": hold(got["count_accuracy"], ref["count_accuracy"],
                               band),
        "coverage95": hold(got["total_flux_coverage"]["0.95"],
                           ref["total_flux_coverage"]["0.95"], band),
        "f1_by_bin": [inside(p, lo, hi) for p, lo, hi in zip(
            f1["point"], ref_f1["ci95_lo"], ref_f1["ci95_hi"])],
        "printed": {k: [got[k], ref[k]] for k in (
            "confusion_asymmetry", "sbc_total_flux_ks_pvalue")},
    }


def score_nogiants(got, ref):
    band = BANDS["nogiants_coverage"]
    row = {"geometry": {k: {"port": got["geometry"][k], "committed": v,
                            "verdict": "held" if got["geometry"][k] == v
                            else "missed"}
                        for k, v in ref["geometry"].items()},
           "printed": {k: [got[k], ref[k]] for k in (
               "shared_tiles", "shared_images_identical")}}
    for run in ("base", "nogiants"):
        row[run] = {key: [hold(p, c, band) for p, c in zip(
            got[run][key], ref[run][key])]
            for key in ("coverage_shared_nz", "coverage_all_nz")}
        row[run]["printed"] = {k: [got[run][k], ref[run][k]] for k in (
            "images_all", "images_shared_nz")}
    return row


def score_misspec(got, ref):
    row = {}
    for name, r in ref["variants"].items():
        g = got["variants"].get(name)
        if not isinstance(g, dict):
            row[name] = {"verdict": "missed", "port": g}
            continue
        key = "coverage_0.95_by_region_row"
        row[name] = {
            "total_flux_coverage": {
                lv: hold(g["total_flux_coverage"][lv], c,
                         BANDS["misspec_coverage"])
                for lv, c in r["total_flux_coverage"].items()},
            "count_excess": {
                k: hold(g[k], r[k], BANDS["misspec_excess"])
                for k in ("posterior_count_excess_mean",
                          "posterior_count_excess_on_truth0")},
            key: [dict(hold(a["coverage"], b["coverage"],
                            BANDS["misspec_coverage"]), rows=b["rows"],
                       n=[a["n"], b["n"]]) for a, b in zip(g[key], r[key])],
        }
    return row


def score_simulator(got, ref):
    pad = BANDS["simulator_ks"]
    q = got["pixel_log_intensity_quantiles"]
    return {
        "ks_statistic": {
            name: dict(inside(q[name]["ks_statistic"], round(lo - pad, 4),
                              round(hi + pad, 4)),
                       committed=ref["pixel_log_intensity_quantiles"][name][
                           "ks_statistic"])
            for name, (lo, hi) in SIMULATOR_KS_JAX.items()},
        "printed": {"posterior_predictive_image": [
            got["posterior_predictive_image"],
            ref["posterior_predictive_image"]],
            "quantiles": [q, ref["pixel_log_intensity_quantiles"]]},
    }


def score_repeated(got, ref):
    rel = BANDS["repeated_width_rel"]
    row = {"image_index": [got["image_index"], ref["image_index"]],
           "entropy_pick": got.get("entropy_pick")}
    for key in ("logpx_mid90_width_at_true_count",
                "count_prob_mid90_width_at_true_count"):
        row[key] = [[hold(p, c, round(rel * abs(c), 4))
                     for p, c in zip(gr, rr)]
                    for gr, rr in zip(got[key], ref[key])]
    same = got["shrinks_with_N_and_steps"] == ref["shrinks_with_N_and_steps"]
    row["shrinks_with_N_and_steps"] = {
        "port": got["shrinks_with_N_and_steps"],
        "committed": ref["shrinks_with_N_and_steps"],
        "verdict": "held" if same else "missed"}
    return row


def score_split(got, ref):
    row = {"image_index": [got["image_index"], ref["image_index"]],
           "samples": [got["samples"], ref["samples"]],
           "chains": [got["chains"], ref["chains"]]}
    scale = got["chains"] / ref["chains"]
    for name, r in ref["anchors"].items():
        g = got["anchors"][name]
        row[name] = {
            "chains_stuck_above": hold(g["chains_stuck_above"],
                                       r["chains_stuck_above"] * scale,
                                       BANDS["split_chains"] * scale),
            "chains_modal_at_true": hold(g["chains_modal_at_true"],
                                         r["chains_modal_at_true"] * scale,
                                         BANDS["split_chains"] * scale),
            "pooled_mean_count": hold(g["pooled_mean_count"],
                                      r["pooled_mean_count"],
                                      BANDS["split_mean_count"]),
            "acc_rate_mean": hold(g["acc_rate_mean"], r["acc_rate_mean"],
                                  BANDS["split_acceptance"]),
            "printed": {"pooled_count_pmf": [g["pooled_count_pmf"],
                                             r["pooled_count_pmf"]],
                        "wall_s": g.get("wall_s")},
        }
    return row


def run_suites(names, walls, device):
    for name in names:
        walls[name] = _run(["smcdet_tpu_torch.run_experiment", M71,
                            "--config", SUITE_CONFIGS[name],
                            "--device", device])


def stage_m71synthetic():
    """The JAX package's m71synthetic tiles as
    ``output/m71synthetic/tiles.npz``: what the committed studies ran on."""
    import numpy as np

    src = REPO / "tests" / "data" / "m71synthetic_tiles.npz"
    dst = REPO / "output" / "m71synthetic" / "tiles.npz"
    if dst.exists():
        with np.load(dst) as a, np.load(src) as b:
            if not all(np.array_equal(a[k], b[k]) for k in b.files):
                raise SystemExit(f"{dst} holds other tiles than {src}")
        return
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(src, dst)


def keep_figure_data(path, report_dir):
    """Copy a study's figure-data file from under ``output/`` to the same
    place under ``report_dir``, where ``python -m smcdet_tpu_torch.figures
    REPORT_DIR`` draws it (the card has no matplotlib)."""
    dst = Path(report_dir) / Path(path).relative_to(REPO / "output")
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(path, dst)


def study(name, report_dir, walls, device, split_samples=None):
    """Study ``name``: its runs, its output (copied to ``report_dir``) and
    its row of held and printed figures."""
    out = REPO / "output"
    dev = ["--device", device]
    mod = "smcdet_tpu_torch.studies."
    if name in NEEDS:
        run_suites(NEEDS[name], walls, device)
    if name == "crowded":
        walls[name] = _run([mod + "crowded_budget_probe", "--run", *dev])
        path = out / "m71" / "crowded_budget_probe.json"
        row = score_crowded(json.loads(path.read_text()),
                            _committed("m71/crowded_budget_probe.json"))
    elif name == "oracle":
        walls[name] = _run([mod + "run_smc_oracle", *dev])
        walls["analyze oracle"] = _run([
            "smcdet_tpu_torch.analyze", "output/m71oracle", "--tiles",
            f"{M71}/data/m71/tiles.npz", "--no-figures", *dev])
        path = out / "m71oracle" / "smc_analysis.json"
        row = score_oracle(json.loads(path.read_text()),
                           _committed("m71/oracle_smc_analysis.json"))
    elif name == "nogiants":
        walls[name] = _run([mod + "compare_nogiants"])
        path = out / "nogiants_comparison.json"
        row = score_nogiants(json.loads(path.read_text()),
                             _committed("m71/nogiants_comparison.json"))
    elif name == "misspec":
        walls[name] = _run([mod + "misspec_study"])
        path = out / "m71" / "misspec_study.json"
        keep_figure_data(path, report_dir)
        row = score_misspec(json.loads(path.read_text()),
                            _committed("m71/misspec_study.json"))
    elif name == "simulator":
        walls[name] = _run([mod + "simulator_checks", *dev])
        path = out / "m71" / "simulator_checks.json"
        keep_figure_data(out / "m71" / "figure_data" / "simulator_checks.npz",
                         report_dir)
        row = score_simulator(json.loads(path.read_text()),
                              _committed("m71/simulator_checks.json"))
    elif name == "repeated":
        stage_m71synthetic()
        walls["m71synthetic"] = _run([
            "smcdet_tpu_torch.run_experiment", "experiments/m71synthetic",
            "--num-images", "1000", *dev])
        row = {}
        for s, idx in REPEATED_IMAGES.items():
            walls[f"{name} s{s}"] = _run([
                mod + "repeated_runs", "--true-count", str(s),
                "--image-index", str(idx), *dev])
            path = out / "m71synthetic" / f"repeatedruns_s{s}_summary.json"
            shutil.copy(path, report_dir / path.name)
            keep_figure_data(path.parent / f"repeatedruns_s{s}.npz",
                             report_dir)
            row[f"s{s}"] = score_repeated(
                json.loads(path.read_text()),
                _committed(f"m71synthetic/repeatedruns_s{s}_summary.json"))
        path = None
    elif name == "split":
        stage_m71synthetic()
        cut = ([] if split_samples is None
               else ["--num-samples", str(split_samples), "--burnin",
                     str(split_samples // 2)])
        walls[name] = _run([mod + "split_mode_study", *cut, *dev])
        path = out / "m71synthetic" / "split_mode_study.json"
        keep_figure_data(path.parent / "figure_data"
                         / "split_mode_study.npz", report_dir)
        row = score_split(json.loads(path.read_text()),
                          _committed("m71synthetic/split_mode_study.json"))
    if path is not None:
        shutil.copy(path, report_dir / f"{name}_{path.name}")
    row["ok"] = _ok(row)
    print(f"[m71 studies] {name}: {json.dumps(row)}", flush=True)
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="+", choices=STUDIES,
                        default=list(STUDIES))
    parser.add_argument("--report", default="output/m71_studies")
    parser.add_argument("--split-samples", type=int, default=None,
                        help="cut split_mode's --num-samples to N and its "
                             "--burnin to N / 2 (printed beside the "
                             "committed 20,000 and 10,000)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    report_dir = Path(args.report)
    report_dir.mkdir(parents=True, exist_ok=True)
    walls, summary = {}, {}

    def save():
        (report_dir / "summary.json").write_text(json.dumps(
            dict(summary, walls_s=walls), indent=2))

    for name in args.only:
        summary[name] = study(name, report_dir, walls, args.device,
                              args.split_samples)
        save()
    summary["ok"] = all(row["ok"] for row in summary.values())
    save()
    print(json.dumps(dict(summary, walls_s=walls)))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
