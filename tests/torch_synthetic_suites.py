"""Run and score the synthetic suites and the divide-and-conquer studies with
the PyTorch port on the card, and hold them against the JAX package's
committed analyses:

    python3 tests/torch_synthetic_suites.py [--only NAME ...] [--pooled]
        [--kernels] [--dnc4] [--report DIR] [--num-images N]
        [--device cuda]

Each step is the command a user runs; a finished batch file is skipped, so
a cut run resumes.

- ``basic`` (1000 images; K2, Gaussian PSF, Poisson noise):
  ``python -m smcdet_tpu_torch.run_experiment experiments/basic
  --num-images 1000``, the extractor (``python -m
  smcdet_tpu_torch.detect.baseline experiments/basic``), then ``python -m
  smcdet_tpu_torch.analyze output/basic``;
- ``divideandconquer`` (100 16x16 images; tiles through K1, bridges
  through K3), then the single-tile run on the same images
  (``--config config_singletile.yaml``: K2 on 16x16 with the M71 model
  and a Pareto flux) and ``python -m
  smcdet_tpu_torch.studies.compare_singletile``;
- ``m71synthetic`` (1000 images, N = 2048, K1): CS-SMC, ``--method mcmc``
  and the extractor, each analysed;
- ``--kernels``: ``python -m smcdet_tpu_torch.studies.compare_kernels``
  on basic's first 100 images (K2 against K4);
- ``--pooled``: ``python -m smcdet_tpu_torch.studies.compare_pooled
  --num-images 30 --reps 8 --dump --suffix _dump``, then the numpy-only
  ``experiments/divideandconquer/attribute_pooled.py`` and
  ``truth_score_pooled.py`` on its dump;
- ``--dnc4``: divideandconquer on 32x32 images, a 4x4 grid of 8x8 tiles
  (K1 tiles, K3 at levels 0-1, K3g at 32x16 and 32x32), with the configs
  ``python -m smcdet_tpu_torch.studies.dnc_grid output/dnc4/configs``
  derives (the committed files with the image 32x32; the single tile's
  ``tile_dim`` 32, N 8192, max_objects 32), on the JAX package's draw of
  its 100 images (``tests/data/divideandconquer32_tiles.npz``, from
  ``tests/torch_dnc4_tiles.py``) staged as
  ``output/dnc4/divideandconquer/tiles.npz``: ``run_experiment`` on
  ``output/dnc4/configs/config.yaml`` and ``config_singletile.yaml`` (K2g),
  ``compare_singletile --config output/dnc4/configs/config.yaml`` and the
  analyzer. No committed analysis exists at 32x32: the count accuracy, the
  coverage at 0.95, the F1 and the singletile TVD are printed beside the
  16x16 suite's committed figures, and the posterior mean count within +-1
  of the truth is held to ``binomial_floor`` of the JAX runner's share on
  the same images (``DNC4_JAX_WITHIN``). The single tile runs on the
  first ``--dnc4-single-images`` (default 4; 0 skips it; about 96 s an
  image, and it ends below temperature 1: its TVD is printed, not held).
  On the card one tree image then runs under ``torch.profiler``: device
  time by range and the card's idle share (``chip_smoke.phase_profile``).

The tiles are the JAX package's own draw, the ones the committed analyses
scored: ``tests/data/<suite>_tiles.npz``, written on a machine with JAX by
``JAX_PLATFORMS=cpu python experiments/<suite>/generate_images.py
--num-images <n>`` from the repository's root (seconds; then copied from
``output/<suite>/tiles.npz``). They are staged as
``output/<suite>/tiles.npz``; each file's ``sha256`` (of its bytes) is in
the summary, with whether its true-count histogram equals the committed
confusion matrix's row sums. The port's own draw (``run_experiment --generate``, in
``output/synthetic_port_draw``; ``port_<suite>`` in ``--only``) is run and
printed beside the committed analyses, not held.

Bars (``BAND``, ``STUDY_BANDS``): count accuracy and total-flux coverage
at 0.95 within 0.05 of the committed value; the F1 in every magnitude bin
inside the committed bootstrap 95% interval where the JSON has one (the
SMC detection and ``sep_baseline``; each suite analysed with the bins its
committed analysis was scored with, ``SUITES``); the singletile TVD mean
within 0.10 and its mean-count |delta| within 0.15; the pooled TVD mean
within 0.10; compare_kernels' acceptance within 0.03 and TVD mean within
0.05. The confusion asymmetry, the SBC p-value, the MCMC chain's F1 and
compare_kernels' iterations and walls are printed, not held. The committed
``runtime_s`` figures are the JAX runs' walls on a TPU, printed as such.

A missed band is not widened, and any miss makes the run exit 1. Whether
a miss is a stale committed analysis is settled apart from the run, by the
current JAX runner on the same tiles (``tests/torch_cells_localise.py``,
``tests/torch_studies_reference.py``). Every analysis and
``summary.json`` are copied to ``--report`` (default
``output/synthetic_suites``), and compare_singletile's figure data under
its path below ``output/`` (``python -m smcdet_tpu_torch.figures REPORT``
draws it on a machine with matplotlib).
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
BAND = 0.05
# (committed figure, band) of each study's held statistic
STUDY_BANDS = {
    "singletile_tvd_mean": (0.4503, 0.10),
    "singletile_mean_count_abs_diff": (0.7779, 0.15),
    "pooled_tvd_mean": (0.2458, 0.10),
    "kernels_mh_acceptance": (0.2484, 0.03),
    "kernels_mala_acceptance": (0.4633, 0.03),
    "kernels_tvd_mean": (0.094, 0.05),
}
# name: images, methods, extractor, the committed analyses' magnitude bins
# (docs/results/RESULTS.md; divideandconquer's from the axis of
# docs/results/divideandconquer/detection.png)
SUITES = {
    "basic": (1000, ("smc",), True, ["13.5", "14.5", "15.5", "16.5"]),
    "divideandconquer": (100, ("smc",), False, ["14", "16", "18", "20.5"]),
    "m71synthetic": (1000, ("smc", "mcmc"), True,
                     ["18", "19.5", "21", "22.5", "24"]),
}
PORT_DRAW = "output/synthetic_port_draw"
PORT = {f"port_{name}": name for name in SUITES}
DNC = "experiments/divideandconquer"
# --dnc4: the JAX runner's images within +-1 of the truth, of the first n
# of divideandconquer32_tiles.npz (CPU, the config's seed 5, in two runs
# of 8 images, 72-73 min each on 3 cores: images 0-7 within 6, means
# [8.001, 7.322, 9.0, 7.282, 6.406, 7.197, 6.064, 8.171] against
# [8, 7, 7, 7, 6, 7, 6, 7]; images 8-15 within 4, means [9.281, 9.632,
# 8.76, 6.449, 10.252, 7.67, 8.193, 7.619] against [8, 8, 7, 6, 7, 7, 8,
# 7]): JAX_PLATFORMS=cpu python tests/torch_reference_bars.py
# output/dnc4/configs/config.yaml --num-images 8 --seeds 5 --tiles T,
# T the file's images 0-7, then 8-15
DNC4_JAX_WITHIN = (10, 16)
DNC4_OUT = "output/dnc4"
# the single 32x32 tile (N 8192 x 33 strata) takes about 96 s an image on
# the card, most of it the SMC's eager re-render, and ends its 100 SMC
# iterations far below temperature 1 (PERF.md): by default it runs on the
# first 4 images, and compare_singletile compares those
DNC4_SINGLE_IMAGES = 4


def _run(args, cwd=REPO, module=True):
    cmd = [sys.executable, *(["-m"] if module else []), *args]
    print("+", " ".join(cmd), flush=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    start = time.perf_counter()
    subprocess.run(cmd, check=True, cwd=cwd, env=env)
    return time.perf_counter() - start


def keep_figure_data(path, report_dir):
    """Copy a study's figure-data file from under ``output/`` to the same
    place under ``report_dir``, where ``python -m smcdet_tpu_torch.figures
    REPORT_DIR`` draws it (the card has no matplotlib)."""
    dst = Path(report_dir) / Path(path).relative_to(REPO / "output")
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(path, dst)


def tiles_record(path, committed=None):
    """The tiles file's image count and ``sha256``; with a ``committed``
    analysis, whether the true-count histogram equals its confusion
    matrix's row sums (to the matrix's rounding)."""
    with np.load(path) as t:
        record = {"path": str(path), "images": int(t["images"].shape[0]),
                  "sha256": hashlib.sha256(
                      Path(path).read_bytes()).hexdigest()}
        if committed is not None:
            rows = np.asarray(committed["count_confusion"]).sum(-1)
            n = committed["images"]
            hist = np.bincount(t["true_counts"][:n], minlength=len(rows))
            record["committed_truth_histogram_matches"] = bool(
                len(hist) == len(rows)
                and np.allclose(hist / n, rows, atol=5e-4 * len(rows)))
    return record


def hold(port, committed, band):
    """A held figure: the port's beside the committed one, ``held`` if it
    lies within ``band``, else ``missed``."""
    return {"port": port, "committed": committed, "band": band,
            "verdict": "held" if abs(port - committed) <= band
            else "missed"}


def f1_inside(got, ref):
    """Per magnitude bin, whether the port's F1 lies inside the committed
    bootstrap 95% interval."""
    return [lo <= p <= hi for p, lo, hi in zip(
        got["f1_by_bin"]["point"], ref["f1_by_bin"]["ci95_lo"],
        ref["f1_by_bin"]["ci95_hi"])]


def score_analysis(got, ref, hold_f1=True):
    """The port's analysis ``got`` against the committed one ``ref``:
    count accuracy and coverage at 0.95 held (``hold``), the F1 by bin of
    the detection (with ``hold_f1``) and of ``sep_baseline`` (where ``ref``
    has one) held inside the committed intervals, the rest printed.
    Returns (row, every bar met)."""
    row, ok = {"images": got["images"]}, True
    for key in ("count_accuracy", "coverage95"):
        a, b = ((r["total_flux_coverage"]["0.95"] if key == "coverage95"
                 else r[key]) for r in (got, ref))
        row[key] = hold(a, b, BAND)
        ok &= row[key]["verdict"] == "held"
    for key in ("confusion_asymmetry", "sbc_total_flux_ks_pvalue"):
        row[key] = {"port": got[key], "committed": ref[key]}
    for key, held in (("detection", hold_f1), ("sep_baseline", True)):
        if key not in ref:
            continue
        if key not in got:  # the port's run had no extractor
            row[key] = "not in the port's analysis"
            ok &= not held
            continue
        row[key] = {"f1_port": got[key]["f1_by_bin"],
                    "f1_committed": ref[key]["f1_by_bin"]}
        if held:
            inside = f1_inside(got[key], ref[key])
            row[key]["f1_inside_committed_ci"] = inside
            ok &= all(inside)
    row["runtime_s"] = {"port": got["runtime_s"],
                        "the JAX run's, on a TPU": ref["runtime_s"]}
    row["ok"] = bool(ok)
    return row, bool(ok)


def score_singletile(got):
    rows = {
        "singletile_tvd_mean": got["count_pmf_tvd"]["mean"],
        "singletile_mean_count_abs_diff": got["mean_count"]["mean_abs_diff"],
    }
    return _score_study(rows, {"report": got})


def score_pooled(got):
    return _score_study({"pooled_tvd_mean": got["tvd_pooled"]["mean"]},
                        {"report": got})


def score_kernels(got):
    k = got["kernels"]
    rows = {"kernels_mh_acceptance": k["mh"]["acceptance_rate_mean"],
            "kernels_mala_acceptance": k["mala"]["acceptance_rate_mean"],
            "kernels_tvd_mean": got["count_pmf_tvd"]["mean"]}
    printed = {name: {"smc_iterations": k[name]["smc_iterations"],
                      "wall_s": k[name]["wall_s"]} for name in k}
    return _score_study(rows, {"printed": printed})


def _score_study(values, extra):
    """Each of ``values`` held to ``STUDY_BANDS`` (``hold``)."""
    row, ok = dict(extra), True
    for key, value in values.items():
        row[key] = hold(value, *STUDY_BANDS[key])
        ok &= row[key]["verdict"] == "held"
    row["ok"] = bool(ok)
    return row, bool(ok)


def _committed(path):
    return json.loads((REPO / path).read_text())


def stage_tiles(name):
    """The JAX package's tiles of suite ``name`` as
    ``output/<name>/tiles.npz``; refuses if another draw's tiles are there
    (a resumed run would mix batches of both)."""
    src = REPO / "tests" / "data" / f"{name}_tiles.npz"
    if not src.exists():
        raise SystemExit(
            f"{src} missing: write the JAX package's tiles first "
            f"(JAX_PLATFORMS=cpu python experiments/{name}/generate_images.py "
            f"--num-images {SUITES[name][0]}, from the repository's root)")
    dst = REPO / "output" / name / "tiles.npz"
    if dst.exists():
        with np.load(dst) as a, np.load(src) as b:
            same = sorted(a.files) == sorted(b.files) and all(
                np.array_equal(a[k], b[k]) for k in a.files)
        if not same:
            raise SystemExit(f"{dst} holds other tiles than {src}: move "
                             f"output/{name} away first")
        return dst
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(src, dst)
    return dst


def _analyze(name, method, cwd, report_dir, walls, label, device):
    bins = SUITES[name][3]
    walls[f"analyze {label} {method}"] = _run(
        ["smcdet_tpu_torch.analyze", f"output/{name}", "--method", method,
         "--mag-bins", *bins, "--device", device, "--no-figures"], cwd)
    out = Path(cwd) / "output" / name / f"{method}_analysis.json"
    shutil.copy(out, report_dir / f"{label}_{method}_analysis.json")
    return json.loads(out.read_text())


def suite(name, report_dir, walls, device, cap=None):
    """Suite ``name`` on the JAX package's tiles (its first ``cap``
    images), scored per method against its committed analysis;
    divideandconquer adds the single-tile run and compare_singletile.
    Returns (rows, every bar met)."""
    images, methods, extractor, _ = SUITES[name]
    tiles = stage_tiles(name)
    rows, ok = {}, True
    n = ["--num-images", str(min(images, cap or images))]
    dev = ["--device", device]
    for method in methods:
        walls[f"{name} {method}"] = _run(
            ["smcdet_tpu_torch.run_experiment", f"experiments/{name}", *n,
             "--method", method, *dev])
    if extractor:
        walls[f"{name} extractor"] = _run(
            ["smcdet_tpu_torch.detect.baseline", f"experiments/{name}", *dev])
    for method in methods:
        ref = _committed(f"docs/results/{name}/{method}_analysis.json")
        got = _analyze(name, method, REPO, report_dir, walls, name, device)
        row, held = score_analysis(got, ref, hold_f1=method == "smc")
        row["tiles"] = tiles_record(tiles, ref)
        rows[method], ok = row, ok and held
        print(f"[suites] {name} {method}: {json.dumps(row)}", flush=True)
    if name == "divideandconquer":
        walls["divideandconquer_singletile"] = _run(
            ["smcdet_tpu_torch.run_experiment", DNC, "--config",
             "config_singletile.yaml", *n, *dev])
        walls["compare_singletile"] = _run(
            ["smcdet_tpu_torch.studies.compare_singletile"])
        out = REPO / "output" / name / "singletile_comparison.json"
        shutil.copy(out, report_dir / out.name)
        keep_figure_data(out.parent / "figure_data"
                         / "singletile_comparison.npz", report_dir)
        row, held = score_singletile(json.loads(out.read_text()))
        rows["singletile"], ok = row, ok and held
        print(f"[suites] singletile: {json.dumps(row)}", flush=True)
    return rows, ok


def dnc4(report_dir, walls, device, cap=None, single=DNC4_SINGLE_IMAGES):
    """divideandconquer on 32x32 images (``--dnc4``): the tree on the JAX
    package's draw and the single tile on its first ``single`` images,
    compare_singletile on those and the analyzer on the tree, printed
    beside the 16x16 suite's committed figures; the count within +-1 held
    to ``binomial_floor`` of the JAX runner's share. Returns (row, the bar
    met)."""
    sys.path.insert(0, str(REPO))
    import torch

    from chip_smoke import binomial_floor, phase_profile
    from smcdet_tpu_torch.run_experiment import load_suite_config
    from smcdet_tpu_torch.runner import load_results, run_experiment
    from smcdet_tpu_torch.studies.dnc_grid import derived_configs

    cfgs = derived_configs(REPO / DNC4_OUT / "configs", 32,
                           output_dir=DNC4_OUT)
    src = REPO / "tests" / "data" / "divideandconquer32_tiles.npz"
    dst = REPO / DNC4_OUT / "divideandconquer" / "tiles.npz"
    if dst.exists():
        if dst.read_bytes() != src.read_bytes():
            raise SystemExit(f"{dst} holds other tiles than {src}: move "
                             f"{dst.parent} away first")
    else:
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    with np.load(dst) as t:
        images = t["images"].shape[0]
    images = min(images, cap or images)
    single = min(images, single)
    dev = ["--device", device]
    for name, path, k in (("dnc4", cfgs["dnc"], images),
                          ("dnc4_singletile", cfgs["singletile"], single)):
        if k:
            walls[name] = _run(["smcdet_tpu_torch.run_experiment",
                                str(path), "--num-images", str(k), *dev])
    out = dst.parent
    if device == "cuda":
        # one image under the profiler, after one unprofiled run that
        # builds and warms up: device time by range and the idle share
        cfg = load_suite_config(str(cfgs["dnc"]))
        cfg.data_path = str(dst)
        cfg.num_images = cfg.batch_size = 1
        with tempfile.TemporaryDirectory() as tmp:
            cfg.output_dir = tmp
            run_experiment(cfg, device=torch.device(device), verbose=False)
        phase_profile(torch.device(device), cfg, "suites dnc4 profile",
                      "one 32x32 image (warm)")
    comparison = None
    if single:
        walls["dnc4 compare_singletile"] = _run(
            ["smcdet_tpu_torch.studies.compare_singletile", "--config",
             str(cfgs["dnc"])])
        comparison = json.loads(
            (out / "singletile_comparison.json").read_text())
        shutil.copy(out / "singletile_comparison.json",
                    report_dir / "dnc4_singletile_comparison.json")
        keep_figure_data(out / "figure_data" / "singletile_comparison.npz",
                         report_dir)
    walls["dnc4 analyze"] = _run(
        ["smcdet_tpu_torch.analyze", str(out), "--mag-bins",
         *SUITES["divideandconquer"][3], "--device", device,
         "--no-figures"])
    got = json.loads((out / "smc_analysis.json").read_text())
    shutil.copy(out / "smc_analysis.json", report_dir /
                "dnc4_smc_analysis.json")
    ref = _committed("docs/results/divideandconquer/smc_analysis.json")
    res = load_results(out, "smc")
    with np.load(dst) as t:
        truth = t["true_counts"][:len(res["pruned_counts"])]
    mean = (res["weights"] * res["pruned_counts"]).sum(-1)
    within = int((np.abs(mean - truth) <= 1.0).sum())
    hits, n_ref = DNC4_JAX_WITHIN
    floor = binomial_floor(len(truth), hits, n_ref=n_ref)
    row = {
        "images": len(truth),
        "count_within_1": {"port": within, "floor": floor,
                           "jax_within": hits, "jax_images": n_ref,
                           "verdict": "held" if within >= floor
                           else "missed"},
        "count_accuracy": {"port": got["count_accuracy"],
                           "16x16 committed": ref["count_accuracy"]},
        "coverage95": {
            "port": got["total_flux_coverage"]["0.95"],
            "16x16 committed": ref["total_flux_coverage"]["0.95"]},
        "f1_by_bin": {"port": got["detection"]["f1_by_bin"],
                      "16x16 committed": ref["detection"]["f1_by_bin"]},
        "tiles": tiles_record(dst),
    }
    if comparison is not None:
        row["singletile_tvd_mean"] = {
            "port": comparison["count_pmf_tvd"]["mean"], "images": single,
            "16x16 committed": STUDY_BANDS["singletile_tvd_mean"][0]}
        row["singletile_mean_count_abs_diff"] = {
            "port": comparison["mean_count"]["mean_abs_diff"],
            "16x16 committed":
                STUDY_BANDS["singletile_mean_count_abs_diff"][0]}
    ok = within >= floor
    row["ok"] = ok
    print(f"[suites] dnc4: {json.dumps(row)}", flush=True)
    return row, ok


def port_draw(name, report_dir, walls, device, cap=None):
    """CS-SMC of suite ``name`` on the port's own draw of its tiles, run
    from ``PORT_DRAW``: scores printed beside the committed ones."""
    images = str(min(SUITES[name][0], cap or SUITES[name][0]))
    cwd = REPO / PORT_DRAW
    cwd.mkdir(parents=True, exist_ok=True)
    suite_dir = str(REPO / "experiments" / name)
    if not (cwd / "output" / name / "tiles.npz").exists():
        walls[f"generate port {name}"] = _run(
            ["smcdet_tpu_torch.run_experiment", suite_dir, "--generate",
             "--num-images", images], cwd)
    walls[f"port {name}"] = _run(
        ["smcdet_tpu_torch.run_experiment", suite_dir, "--num-images",
         images, "--device", device], cwd)
    got = _analyze(name, "smc", cwd, report_dir, walls, f"port_{name}",
                   device)
    row, _ = score_analysis(
        got, _committed(f"docs/results/{name}/smc_analysis.json"))
    row["tiles"] = tiles_record(cwd / "output" / name / "tiles.npz")
    row["held"] = False
    print(f"[suites] port draw {name}: {json.dumps(row)}", flush=True)
    return row


def kernels(report_dir, walls, device, cap=None):
    stage_tiles("basic")
    walls["compare_kernels"] = _run(
        ["smcdet_tpu_torch.studies.compare_kernels", "--num-images",
         str(min(100, cap or 100)), "--device", device])
    out = REPO / "output" / "basic" / "kernel_comparison.json"
    shutil.copy(out, report_dir / out.name)
    row, ok = score_kernels(json.loads(out.read_text()))
    print(f"[suites] compare_kernels: {json.dumps(row)}", flush=True)
    return row, ok


def pooled(report_dir, walls, device, cap=None):
    """compare_pooled at its committed size with the dump, then the two
    numpy scripts on the dump (from the repository's root, where they read
    ``output/divideandconquer``)."""
    stage_tiles("divideandconquer")
    walls["compare_pooled"] = _run(
        ["smcdet_tpu_torch.studies.compare_pooled", "--num-images",
         str(min(30, cap or 30)), "--reps", "8", "--dump", "--suffix",
         "_dump", "--device", device])
    out_dir = REPO / "output" / "divideandconquer"
    for script in ("attribute_pooled.py", "truth_score_pooled.py"):
        walls[script] = _run([f"{DNC}/{script}"], module=False)
    for name in ("pooled_comparison_dump.json",
                 "pooled_attribution_dump.json", "truth_score_dump.json"):
        shutil.copy(out_dir / name, report_dir / name)
    row, ok = score_pooled(json.loads(
        (out_dir / "pooled_comparison_dump.json").read_text()))
    truth = json.loads((out_dir / "truth_score_dump.json").read_text())
    ref = _committed("docs/results/divideandconquer/truth_score_dump.json")
    row["truth_score"] = {
        arm: {k: {"port": truth[arm][k], "committed": ref[arm][k]}
              for k in ref[arm]} for arm in ("singletile", "dc")}
    print(f"[suites] compare_pooled: {json.dumps(row)}", flush=True)
    return row, ok


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="*", choices=[*SUITES, *PORT],
                        default=[*SUITES, *PORT],
                        help="the suites to run; with no name, only the "
                             "studies flagged (--dnc4 --only)")
    parser.add_argument("--kernels", action="store_true",
                        help="also run compare_kernels (100 basic images)")
    parser.add_argument("--pooled", action="store_true",
                        help="also run compare_pooled (30 images x 8 reps) "
                             "and the two numpy scripts on its dump")
    parser.add_argument("--dnc4", action="store_true",
                        help="also run divideandconquer on 32x32 images "
                             "(a 4x4 tile grid) and its single tile")
    parser.add_argument("--dnc4-single-images", type=int,
                        default=DNC4_SINGLE_IMAGES,
                        help="--dnc4's single-tile run on its first N "
                             "images (about 96 s an image on the card)")
    parser.add_argument("--report", default="output/synthetic_suites")
    parser.add_argument("--num-images", type=int, default=None,
                        help="cut every suite and study to its first N "
                             "images (a rehearsal; the bars are still "
                             "printed and held)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    report_dir = Path(args.report)
    report_dir.mkdir(parents=True, exist_ok=True)
    walls, summary, ok = {}, {}, True

    def save():
        (report_dir / "summary.json").write_text(json.dumps(
            dict(summary, walls_s=walls), indent=2))

    for name in args.only:
        if name in PORT:
            summary[name] = port_draw(PORT[name], report_dir, walls,
                                      args.device, args.num_images)
        else:
            summary[name], held = suite(name, report_dir, walls,
                                        args.device, args.num_images)
            ok &= held
        save()
    for flag, study in (("kernels", kernels), ("pooled", pooled),
                        ("dnc4", functools.partial(
                            dnc4, single=args.dnc4_single_images))):
        if getattr(args, flag):
            summary[flag], held = study(
                report_dir, walls, args.device, args.num_images)
            ok &= held
            save()
    summary["ok"] = bool(ok)
    save()
    print(json.dumps(dict(summary, walls_s=walls)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
