"""Run and score the M71 suites with the PyTorch port on the card, and hold
their scores against the JAX package's committed analyses:

    python3 tests/torch_m71_suites.py [--only NAME ...] [--report DIR]

Steps for each suite, each the command a user runs:

1. ``python -m smcdet_tpu_torch.run_experiment <suite> --config <file>``:
   CS-SMC with the per-image pipeline on every tile (N = 2048, C = 11, 100
   MH sweeps; the fitted ``params.yaml``, per-tile backgrounds; K2's
   general-wing branch); a finished batch file is skipped, so a cut run
   resumes;
2. ``python -m smcdet_tpu_torch.analyze output/<name> --tiles <tiles>``:
   the analyzer's default magnitude bins, those of the committed analyses.

The suites (``SUITES``): the m71 fixture (688 tiles, the same tiles and
config as the committed analysis, so only the sampler's draw differs); the
three m71semisynthetic suites on the JAX package's own renders, which
``JAX_PLATFORMS=cpu python experiments/m71semisynthetic/generate_images.py
[--config config_nospill.yaml --catalog intile | --config config_reach.yaml
--catalog reach]`` writes to ``output/<name>/tiles.npz`` from the
repository's root on a machine with JAX (seconds; the committed analyses
scored those renders); and the variants m71_mis, m71_vary, m71_nogiants
and m71_seed2 on their committed fixtures. Each is held to its committed
analysis: count accuracy and total-flux coverage at 0.95 within ``BAND``,
and for the m71 fixture the F1 in every magnitude bin inside the committed
bootstrap 95% interval; the confusion asymmetry and the SBC p-value are
printed beside the committed values, not held.

Then the three m71semisynthetic suites on the port's own renders
(``run_experiment --generate --catalog``, in ``output/m71_port_renders``;
``port_<name>`` in ``--only``): scores printed beside the committed ones,
not held (another draw of the noise than the committed analyses scored).

Exits non-zero if a band is missed. Every analysis and the summary are
copied to ``--report`` (default ``output/m71_suites``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
BAND = 0.05
SS = "experiments/m71semisynthetic"
# name: suite directory, config, committed analysis, tiles scored
SUITES = {
    "m71": ("experiments/m71", "config.yaml",
            "docs/results/m71/smc_analysis.json",
            "experiments/m71/data/m71/tiles.npz"),
    "m71semisynthetic": (SS, "config.yaml",
                         "docs/results/m71semisynthetic/smc_analysis.json",
                         "output/m71semisynthetic/tiles.npz"),
    "m71ss_nospill": (SS, "config_nospill.yaml",
                      "docs/results/m71semisynthetic/"
                      "smc_analysis_nospill.json",
                      "output/m71ss_nospill/tiles.npz"),
    "m71ss_reach": (SS, "config_reach.yaml",
                    "docs/results/m71semisynthetic/smc_analysis_reach.json",
                    "output/m71ss_reach/tiles.npz"),
    "m71_mis": ("experiments/m71", "config_mis.yaml",
                "docs/results/m71_mis/smc_analysis.json",
                "experiments/m71/data_mis/m71/tiles.npz"),
    "m71_vary": ("experiments/m71", "config_vary.yaml",
                 "docs/results/m71_vary/smc_analysis.json",
                 "experiments/m71/data_vary/m71/tiles.npz"),
    "m71_nogiants": ("experiments/m71", "config_nogiants.yaml",
                     "docs/results/m71/nogiants_smc_analysis.json",
                     "experiments/m71/data_nogiants/m71/tiles.npz"),
    "m71_seed2": ("experiments/m71", "config_seed2.yaml",
                  "docs/results/m71/smc_analysis_seed2.json",
                  "experiments/m71/data_seed2/m71/tiles.npz"),
}
# the m71semisynthetic suites: the fixture catalog each renders
CATALOGS = {"m71semisynthetic": "padded", "m71ss_nospill": "intile",
            "m71ss_reach": "reach"}
F1_HELD = ("m71",)
PORT_RENDERS = "output/m71_port_renders"
# the semisynthetic suites on the port's own renders, by --only name
PORT = {f"port_{name}": name for name in CATALOGS}


def _run(args, cwd=REPO):
    cmd = [sys.executable, "-m", *args]
    print("+", " ".join(cmd), flush=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    start = time.perf_counter()
    subprocess.run(cmd, check=True, cwd=cwd, env=env)
    return time.perf_counter() - start


def _tiles_record(path):
    with np.load(path) as t:
        return {"path": str(path), "images": int(t["images"].shape[0]),
                "sha256": hashlib.sha256(t["images"].tobytes()).hexdigest()}


def _scores(got, ref, held):
    """The port's scores beside the committed ones; ``held`` adds whether
    each lies in its band. Returns (row, all held)."""
    row, ok = {"images": got["images"]}, True
    for key in ("count_accuracy", "coverage95"):
        a, b = ((r["total_flux_coverage"]["0.95"] if key == "coverage95"
                 else r[key]) for r in (got, ref))
        row[key] = {"port": a, "committed": b}
        if held:
            row[key].update(band=BAND, held=abs(a - b) <= BAND)
            ok &= row[key]["held"]
    for key in ("confusion_asymmetry", "sbc_total_flux_ks_pvalue"):
        row[key] = {"port": got[key], "committed": ref[key]}
    row["f1_by_bin"] = {"port": got["detection"]["f1_by_bin"],
                        "committed": ref["detection"]["f1_by_bin"]}
    row["runtime_s"] = got["runtime_s"]
    return row, ok


def _suite(name, report_dir, walls):
    suite, config, committed, tiles = SUITES[name]
    if not (REPO / tiles).exists():
        raise SystemExit(
            f"{tiles} missing: write the JAX package's renders first "
            f"(JAX_PLATFORMS=cpu python {SS}/generate_images.py --config "
            f"{config} --catalog {CATALOGS[name]}, from the repository's "
            "root)")
    record = _tiles_record(REPO / tiles)
    print(f"[suites] {name} tiles: {json.dumps(record)}", flush=True)
    walls[name] = _run(["smcdet_tpu_torch.run_experiment", suite,
                        "--config", config])
    walls[f"analyze {name}"] = _run(["smcdet_tpu_torch.analyze",
                                     f"output/{name}", "--tiles", tiles,
                                     "--no-figures"])
    out = REPO / "output" / name / "smc_analysis.json"
    got = json.loads(out.read_text())
    shutil.copy(out, report_dir / f"{name}_smc_analysis.json")
    ref = json.loads((REPO / committed).read_text())
    row, ok = _scores(got, ref, held=True)
    row["tiles"] = record
    if name in F1_HELD:
        f1, ref_f1 = got["detection"]["f1_by_bin"], ref["detection"][
            "f1_by_bin"]
        inside = [lo <= p <= hi for p, lo, hi in zip(
            f1["point"], ref_f1["ci95_lo"], ref_f1["ci95_hi"])]
        row["f1_inside_committed_ci"] = inside
        ok &= all(inside)
    row["ok"] = bool(ok)
    print(f"[suites] {name}: {json.dumps(row)}", flush=True)
    return row, ok


def _port_render(name, report_dir, walls):
    """A semisynthetic suite on the port's own render, run from
    ``PORT_RENDERS`` (its ``output/`` holds the tiles and results)."""
    suite, config, committed, _ = SUITES[name]
    cwd = REPO / PORT_RENDERS
    cwd.mkdir(parents=True, exist_ok=True)
    tiles = cwd / "output" / name / "tiles.npz"
    if not tiles.exists():
        walls[f"generate port {name}"] = _run(
            ["smcdet_tpu_torch.run_experiment", str(REPO / suite),
             "--config", config, "--generate", "--catalog", CATALOGS[name]],
            cwd)
    walls[f"port {name}"] = _run(["smcdet_tpu_torch.run_experiment",
                                  str(REPO / suite), "--config", config],
                                 cwd)
    walls[f"analyze port {name}"] = _run(
        ["smcdet_tpu_torch.analyze", f"output/{name}", "--tiles",
         f"output/{name}/tiles.npz", "--no-figures"], cwd)
    out = cwd / "output" / name / "smc_analysis.json"
    shutil.copy(out, report_dir / f"port_render_{name}_smc_analysis.json")
    row, _ = _scores(json.loads(out.read_text()),
                     json.loads((REPO / committed).read_text()), held=False)
    row["tiles"] = _tiles_record(tiles)
    print(f"[suites] port render {name}: {json.dumps(row)}", flush=True)
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="+", choices=[*SUITES, *PORT],
                        default=[*SUITES, *PORT])
    parser.add_argument("--report", default="output/m71_suites")
    args = parser.parse_args(argv)
    report_dir = Path(args.report)
    report_dir.mkdir(parents=True, exist_ok=True)
    walls, summary, ok = {}, {}, True
    for name in args.only:
        if name in PORT:
            summary[name] = _port_render(PORT[name], report_dir, walls)
        else:
            summary[name], held = _suite(name, report_dir, walls)
            ok &= held
        (report_dir / "summary.json").write_text(json.dumps(
            dict(summary, walls_s=walls), indent=2))
    summary["walls_s"] = walls
    summary["ok"] = bool(ok)
    (report_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
