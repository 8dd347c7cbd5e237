"""Run and score both cells suites with the PyTorch port on the card, and
hold their scores against the JAX package's committed analyses:

    python3 tests/torch_cells_suites.py [--num-images 200] [--report DIR]
        [--tiles PATH]

Steps, each the command a user runs:

1. ``python -m smcdet_tpu_torch.run_experiment experiments/cells/config.yaml
   --generate`` (the port's tiles in ``output/cells/tiles.npz``), or, with
   ``--tiles``, those tiles copied there instead;
2. ``python -m smcdet_tpu_torch.run_experiment`` on
   ``experiments/cells/config.yaml`` and on ``config_pair.yaml`` (which reads
   the same tiles); a finished batch file is skipped, so a cut run resumes;
3. ``python -m smcdet_tpu_torch.analyze output/cells`` and
   ``output/cells_pair --tiles output/cells/tiles.npz``, each with the
   magnitude bins of its committed analysis (``SUITES``).

The port's tiles are another draw of the suite's simulator than the JAX
package's. The committed analyses were scored on the JAX package's own
tiles, which ``JAX_PLATFORMS=cpu python experiments/cells/generate_images.py``
writes to ``output/cells/tiles.npz`` in seconds on a machine with JAX;
``--tiles`` runs the port on those, so that both runs score the same
images. Either way the comparison is statistical: count accuracy within
``ACCURACY_BAND`` and coverage at 0.95 within ``COVERAGE_BAND`` of
``docs/results/cells/smc_analysis.json`` and ``pair_smc_analysis.json``
(about 2.5 standard errors over 200 images, 196 of them with a star). The
confusion asymmetry and F1 are printed beside the committed values and not
held. Exits non-zero if a band is missed. The summary and both analyses
are copied to ``--report`` (default ``output/cells_suites``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ACCURACY_BAND = 0.06
COVERAGE_BAND = 0.05
# config, committed analysis, and the magnitude bins it was scored with (the
# cells one's from the axis of docs/results/cells/detection.png, the
# cells_pair one's the analyzer's default)
SUITES = {"cells": ("config.yaml", "smc_analysis.json",
                    ["11", "13", "15", "17.5"]),
          "cells_pair": ("config_pair.yaml", "pair_smc_analysis.json",
                         ["15", "18", "21", "24"])}
TILES = "output/cells/tiles.npz"


def _run(args):
    cmd = [sys.executable, "-m", *args]
    print("+", " ".join(cmd), flush=True)
    start = time.perf_counter()
    subprocess.run(cmd, check=True)
    return time.perf_counter() - start


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num-images", type=int, default=200)
    parser.add_argument("--report", default="output/cells_suites")
    parser.add_argument("--tiles", default=None,
                        help="run on these tiles (e.g. the JAX package's) "
                        "instead of the port's simulation")
    args = parser.parse_args(argv)
    report_dir = Path(args.report)
    report_dir.mkdir(parents=True, exist_ok=True)
    n = ["--num-images", str(args.num_images)]
    if args.tiles is None:
        walls = {"generate": _run(["smcdet_tpu_torch.run_experiment",
                                   "experiments/cells/config.yaml",
                                   "--generate", *n])}
    else:
        walls = {}
        Path(TILES).parent.mkdir(parents=True, exist_ok=True)
        if Path(args.tiles).resolve() != Path(TILES).resolve():
            shutil.copy(args.tiles, TILES)
    with np.load(TILES) as t:
        images = t["images"][:args.num_images]
        tiles = {"source": args.tiles or "the port's simulation",
                 "sha256": hashlib.sha256(images.tobytes()).hexdigest(),
                 "true_count_histogram": np.bincount(
                     t["true_counts"][:args.num_images]).tolist()}
    print(f"[suites] tiles: {json.dumps(tiles)}", flush=True)
    for name, (config, _, _) in SUITES.items():
        walls[name] = _run(["smcdet_tpu_torch.run_experiment",
                            f"experiments/cells/{config}", *n])
    summary, ok = {"walls_s": walls, "tiles": tiles}, True
    for name, (_, committed, bins) in SUITES.items():
        walls[f"analyze {name}"] = _run(["smcdet_tpu_torch.analyze",
                                         f"output/{name}", "--tiles", TILES,
                                         "--mag-bins", *bins,
                                         "--no-figures"])
        got = json.loads(Path(f"output/{name}/smc_analysis.json").read_text())
        shutil.copy(f"output/{name}/smc_analysis.json",
                    report_dir / f"{name}_smc_analysis.json")
        ref = json.loads(Path(f"docs/results/cells/{committed}").read_text())
        row = {"images": got["images"], "mag_bins": bins}
        for key, band in (("count_accuracy", ACCURACY_BAND),
                          ("coverage95", COVERAGE_BAND)):
            a, b = ((r["total_flux_coverage"]["0.95"] if key == "coverage95"
                     else r[key]) for r in (got, ref))
            held = abs(a - b) <= band
            ok &= held
            row[key] = {"port": a, "committed": b, "band": band,
                        "held": held}
        row["confusion_asymmetry"] = {"port": got["confusion_asymmetry"],
                                      "committed": ref["confusion_asymmetry"]}
        row["sbc_total_flux_ks_pvalue"] = {
            "port": got["sbc_total_flux_ks_pvalue"],
            "committed": ref["sbc_total_flux_ks_pvalue"]}
        row["f1_by_bin"] = {"port": got["detection"]["f1_by_bin"],
                            "committed": ref["detection"]["f1_by_bin"]}
        row["runtime_s"] = got["runtime_s"]
        summary[name] = row
        print(f"[suites] {name}: {json.dumps(row)}", flush=True)
    summary["ok"] = bool(ok)
    (report_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
