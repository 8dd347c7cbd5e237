"""Run and score the baselines on the whole m71 fixture with the PyTorch
port on the card, and hold their scores against the JAX package's
committed analysis:

    python3 tests/torch_baseline_suites.py [--report DIR]

Steps, each the command a user runs:

1. ``python -m smcdet_tpu_torch.run_experiment experiments/m71 --method
   mcmc``: the saturated MH chain on all 688 tiles (per-tile backgrounds,
   the fitted ``params.yaml``; 50,000 sweeps a chain); a finished batch file
   is skipped, so a cut run resumes;
2. ``python -m smcdet_tpu_torch.detect.baseline experiments/m71``: the
   tuned extractor, ``output/m71/sep_results.npz``;
3. ``python -m smcdet_tpu_torch.analyze output/m71 --method mcmc --tiles
   experiments/m71/data/m71/tiles.npz``: the analyzer's default magnitude
   bins, as the committed analysis.

Held against ``docs/results/m71/mcmc_analysis.json`` (the same 688 tiles):
count accuracy and total-flux coverage at 0.95 within ``BAND``, and the
extractor's F1 in every magnitude bin inside the committed bootstrap 95%
interval. The confusion asymmetry, SBC p-value and the chain's F1 are
printed beside the committed values, not held. Exits non-zero if a bar is
missed. The summary and the analysis are copied to ``--report`` (default
``output/baseline_suites``).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

BAND = 0.05
SUITE = "experiments/m71"
TILES = "experiments/m71/data/m71/tiles.npz"
COMMITTED = "docs/results/m71/mcmc_analysis.json"
OUT = "output/m71"


def _run(args):
    cmd = [sys.executable, "-m", *args]
    print("+", " ".join(cmd), flush=True)
    start = time.perf_counter()
    subprocess.run(cmd, check=True)
    return time.perf_counter() - start


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--report", default="output/baseline_suites")
    args = parser.parse_args(argv)
    report_dir = Path(args.report)
    report_dir.mkdir(parents=True, exist_ok=True)
    walls = {
        "mcmc": _run(["smcdet_tpu_torch.run_experiment", SUITE, "--method",
                      "mcmc"]),
        "sep": _run(["smcdet_tpu_torch.detect.baseline", SUITE]),
        "analyze": _run(["smcdet_tpu_torch.analyze", OUT, "--method",
                         "mcmc", "--tiles", TILES, "--no-figures"]),
    }
    got = json.loads(Path(f"{OUT}/mcmc_analysis.json").read_text())
    shutil.copy(f"{OUT}/mcmc_analysis.json",
                report_dir / "m71_mcmc_analysis.json")
    ref = json.loads(Path(COMMITTED).read_text())
    summary, ok = {"walls_s": walls, "images": got["images"]}, True
    for key in ("count_accuracy", "coverage95"):
        a, b = ((r["total_flux_coverage"]["0.95"] if key == "coverage95"
                 else r[key]) for r in (got, ref))
        held = abs(a - b) <= BAND
        ok &= held
        summary[key] = {"port": a, "committed": b, "band": BAND,
                        "held": held}
    f1, ref_f1 = (r["sep_baseline"]["f1_by_bin"] for r in (got, ref))
    inside = [lo <= p <= hi for p, lo, hi in zip(
        f1["point"], ref_f1["ci95_lo"], ref_f1["ci95_hi"])]
    ok &= all(inside)
    summary["sep_f1_by_bin"] = {"port": f1, "committed": ref_f1,
                                "inside_committed_ci": inside}
    for key in ("confusion_asymmetry", "sbc_total_flux_ks_pvalue"):
        summary[key] = {"port": got[key], "committed": ref[key]}
    summary["mcmc_f1_by_bin"] = {
        "port": got["detection"]["f1_by_bin"],
        "committed": ref["detection"]["f1_by_bin"]}
    summary["runtime_s"] = got["runtime_s"]
    summary["ok"] = bool(ok)
    (report_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
