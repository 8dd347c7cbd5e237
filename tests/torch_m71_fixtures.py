"""Regenerate the five M71 fixtures with the PyTorch port on the card, hold
each against its committed files, and carry the default one from the
survey's bytes to a scored posterior:

    python3 tests/torch_m71_fixtures.py [--only data data_mis ...]
        [--no-suite] [--out DIR] [--device cuda]

Each step is the command a user runs, from the repository's root:

1. per fixture (``FIXTURES``: ``data``, ``data_mis``, ``data_vary``,
   ``data_nogiants``, ``data_seed2``), ``python -m
   smcdet_tpu_torch.data_prep.make_fixture --data-dir OUT/<name> <flags>``
   then ``python -m smcdet_tpu_torch.data_prep.prepare_data --data-dir
   OUT/<name> --no-download`` (the star render and the L-BFGS fit on the
   card), each timed; then every committed file under
   ``experiments/m71/<name>/m71`` held by ``data_prep.compare`` (arrays
   and keys equal, images to one float32 ulp, the closed-form parameters
   to 1e-9, the fit where the likelihood pins it; the crowded probe's
   ``tiles_crowded*.npz`` skipped);
2. ``python -m smcdet_tpu_torch.studies.sky_exactness_probe`` on
   ``OUT/data`` against ``docs/results/m71/sky_exactness.json`` (the same
   text) and ``python -m smcdet_tpu_torch.studies.psf_comparison`` for
   m71, m71_mis and m71_vary on the regenerated ``data``, ``data_mis`` and
   ``data_vary`` against ``docs/results/<name>/psf_comparison.json``;
3. the whole m71 suite (688 tiles) through ``python -m
   smcdet_tpu_torch.run_experiment`` on a copy of
   ``experiments/m71/config.yaml`` that reads the port's prepared
   ``OUT/data/m71/tiles.npz`` and its fitted ``params.yaml`` (name
   ``m71_port_fixture``; a finished batch is skipped, so a cut run
   resumes), then ``python -m smcdet_tpu_torch.analyze``, against
   ``docs/results/m71/smc_analysis.json``: count accuracy and total-flux
   coverage at 0.95 within ``BAND``, the F1 by bin printed.

Exits 1 if anything is missed; ``OUT/summary.json`` (default
``output/m71_fixtures``) holds every comparison and wall.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import yaml

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from smcdet_tpu_torch.data_prep import compare  # noqa: E402

BAND = 0.05
M71 = REPO / "experiments" / "m71"
RESULTS = REPO / "docs" / "results"
# name: make_fixture's flags
FIXTURES = {
    "data": [],
    "data_mis": ["--psf-misspec", "elliptical"],
    "data_vary": ["--psf-misspec", "varying"],
    "data_nogiants": ["--no-giants"],
    "data_seed2": ["--seed", "6839"],
}
# psf_comparison: run name -> (config, fixture)
PSF_CONFIGS = {"m71": ("config.yaml", "data"),
               "m71_mis": ("config_mis.yaml", "data_mis"),
               "m71_vary": ("config_vary.yaml", "data_vary")}
SUITE_NAME = "m71_port_fixture"


def _run(args):
    cmd = [sys.executable, "-m", *args]
    print("+", " ".join(cmd), flush=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    start = time.perf_counter()
    subprocess.run(cmd, check=True, cwd=REPO, env=env)
    return time.perf_counter() - start


def fixture(name, out, device, walls):
    """Regenerate one fixture and hold it; returns the failures."""
    data_dir = out / name
    walls[f"make_fixture {name}"] = _run(
        ["smcdet_tpu_torch.data_prep.make_fixture", "--data-dir",
         str(data_dir), "--device", device, *FIXTURES[name]])
    walls[f"prepare_data {name}"] = _run(
        ["smcdet_tpu_torch.data_prep.prepare_data", "--data-dir",
         str(data_dir), "--no-download", "--device", device])
    got = yaml.safe_load((data_dir / "m71" / "params.yaml").read_text())
    return compare.hold_fixture(
        data_dir / "m71", M71 / name / "m71", name,
        compare.patch_loss(data_dir, got, device),
        exact_images=device == "cpu", device=device)


def studies(out, device, walls):
    fails = []
    report = out / "studies"
    walls["sky_exactness"] = _run(
        ["smcdet_tpu_torch.studies.sky_exactness_probe", "--data-dir",
         str(out / "data"), "--out", str(report / "sky_exactness.json")])
    same = (report / "sky_exactness.json").read_text() == (
        RESULTS / "m71" / "sky_exactness.json").read_text()
    print(f"[fixtures] sky_exactness equal to the committed JSON: {same}",
          flush=True)
    fails += [] if same else ["sky_exactness.json differs"]
    for name, (config, data) in PSF_CONFIGS.items():
        walls[f"psf_comparison {name}"] = _run(
            ["smcdet_tpu_torch.studies.psf_comparison", "--config", config,
             "--data-root", str(out / data), "--output-dir", str(report),
             "--device", device])
        got = json.loads((report / name / "psf_comparison.json").read_text())
        want = json.loads((RESULTS / name / "psf_comparison.json")
                          .read_text())
        fails += compare.hold_psf_comparison(got, want, name)
    return fails


def suite(out, device, walls):
    """The whole m71 suite on the port's prepared default fixture and
    fitted parameters, scored against the committed analysis."""
    sys.path.insert(0, str(REPO / "tests"))
    from torch_m71_suites import _scores

    raw = yaml.safe_load((M71 / "config.yaml").read_text())
    tiles = out / "data" / "m71" / "tiles.npz"
    raw.update(name=SUITE_NAME, data_path=str(tiles),
               params_path=str(out / "data" / "m71" / "params.yaml"),
               output_dir="output")
    config = out / "config_port_fixture.yaml"
    config.write_text(yaml.safe_dump(raw, sort_keys=False))
    walls["m71 suite"] = _run(["smcdet_tpu_torch.run_experiment",
                               str(config), "--device", device])
    walls["analyze"] = _run(["smcdet_tpu_torch.analyze",
                             f"output/{SUITE_NAME}", "--tiles", str(tiles),
                             "--device", device, "--no-figures"])
    got = json.loads((REPO / "output" / SUITE_NAME / "smc_analysis.json")
                     .read_text())
    (out / "smc_analysis.json").write_text(json.dumps(got, indent=2))
    ref = json.loads((RESULTS / "m71" / "smc_analysis.json").read_text())
    row, ok = _scores(got, ref, held=True)
    print(f"[fixtures] m71 suite on the port's fixture and fit: "
          f"{json.dumps(row)}", flush=True)
    return row, ok


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="+", choices=list(FIXTURES),
                        default=list(FIXTURES))
    parser.add_argument("--no-suite", action="store_true",
                        help="stop after the fixtures and the studies")
    parser.add_argument("--out", default="output/m71_fixtures")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    out = (REPO / args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    walls, failures, summary = {}, {}, {}
    for name in args.only:
        failures[name] = fixture(name, out, args.device, walls)
    if {"data", "data_mis", "data_vary"} <= set(args.only):
        failures["studies"] = studies(out, args.device, walls)
    ok = not any(failures.values())
    if not args.no_suite and "data" in args.only:
        summary["m71 suite"], held = suite(out, args.device, walls)
        ok &= held
    summary.update(failures=failures, walls_s=walls, ok=bool(ok))
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    print(f"[fixtures] {'held' if ok else 'MISSED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
