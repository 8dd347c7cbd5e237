"""Run the SMC-versus-MCMC anchor with the PyTorch port on the card and
hold it against the committed ``docs/results/m71synthetic/
mcmc_comparison.json``:

    python3 tests/torch_mcmc_anchor.py [--num-images 200]
        [--num-samples 50000] [--burnin 30000] [--reps 4] [--measure]
        [--no-anchor] [--report DIR] [--device cuda]

1. Stages the JAX package's m71synthetic tiles (``tests/data/
   m71synthetic_tiles.npz``, the committed analyses' draw) as
   ``output/m71synthetic/tiles.npz`` and prints their ``sha256``.
2. Runs the port's m71synthetic CS-SMC on the first ``--num-images``
   images (``python -m smcdet_tpu_torch.run_experiment
   experiments/m71synthetic``) unless their batches are there already.
3. With ``--measure``: the reversible-jump sweep's wall at 32, 200 and 800
   chains, and the anchor's wall predicted from it.
4. Unless ``--no-anchor``: ``python -m
   smcdet_tpu_torch.studies.compare_mcmc`` at the given length (by default
   the committed one: 200 images x 4 reps x 50,000 sweeps, MH and RJ), its
   report held to the committed one with the bands ``BANDS`` (fixed before
   the first run on the card; the two ``max_abs_diff`` keys and the
   well-mixed p90 are printed, not held).

A missed band is not widened: the runner exits 1, and the miss is sorted
apart from the run (the current JAX script's formulas and ``run_mh`` /
``run_rjmh`` on a subset on the CPU). The report, the measurement, the
figure's data (``m71synthetic/figure_data/mcmc_comparison.npz``, drawn by
``python -m smcdet_tpu_torch.figures REPORT``) and ``summary.json`` are
copied to ``--report`` (default
``output/mcmc_anchor``).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_synthetic_suites import (  # noqa: E402
    _run,
    keep_figure_data,
    stage_tiles,
    tiles_record,
)

REPO = Path(__file__).resolve().parents[1]
SUITE = "m71synthetic"
COMMITTED = REPO / "docs" / "results" / SUITE / "mcmc_comparison.json"
# (path of the key in the report, band)
BANDS = (
    (("count_pmf_tvd", "mean"), 0.05),
    (("count_pmf_tvd", "median"), 0.05),
    (("count_pmf_tvd", "p90"), 0.10),
    (("well_mixed_chains", "n"), 15),
    (("well_mixed_chains", "count_pmf_tvd_mean"), 0.05),
    (("mean_count_agreement", "mean_abs_diff"), 0.15),
    (("median_total_flux_mean_abs_rel_diff",), 0.03),
    (("mcmc_acc_rate_range", 0), 0.03),
    (("mcmc_acc_rate_range", 1), 0.05),
    (("rjmh", "count_pmf_tvd_mean"), 0.05),
    (("rjmh", "count_pmf_tvd_median"), 0.05),
    (("rjmh", "count_pmf_tvd_p90"), 0.10),
    (("rjmh", "mean_count_mean_abs_diff"), 0.15),
)
PRINTED = ((("mean_count_agreement", "max_abs_diff"),),
           (("rjmh", "mean_count_max_abs_diff"),),
           (("well_mixed_chains", "count_pmf_tvd_p90"),))
MEASURE_CHAINS = (32, 200, 800)


def _get(report, path):
    for k in path:
        report = report[k]
    return report


def hold_report(got, ref):
    """Each of ``BANDS`` held: the port's figure beside the committed one,
    ``held`` within the band, else ``missed`` (a missing figure misses).
    Returns (rows, every band held)."""
    rows, ok = {}, True
    for path, band in BANDS:
        a, b = _get(got, path), _get(ref, path)
        held = a is not None and abs(a - b) <= band
        rows[".".join(map(str, path))] = {
            "port": a, "committed": b, "band": band,
            "verdict": "held" if held else "missed"}
        ok &= held
    for (path,) in PRINTED:
        rows[".".join(path)] = {"port": _get(got, path),
                                "committed": _get(ref, path)}
    return rows, bool(ok)


def _smc_ready(n):
    """Whether the m71synthetic CS-SMC batches cover the first ``n``
    images."""
    out = REPO / "output" / SUITE
    have = 0
    for p in sorted(out.glob("smc_batch*.npz")):
        with np.load(p) as b:
            idx = b["image_index"]
        have = max(have, int(idx.max()) + 1 if idx.size else 0)
    return have >= n


def measure(device, num_images):
    """The RJ sweep's wall a sweep at ``MEASURE_CHAINS`` chains (the
    first ``num_images`` m71synthetic tiles cycled)."""
    import torch

    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
    )
    from smcdet_tpu_torch.run_experiment import load_suite_config
    from smcdet_tpu_torch.runner import mcmc_chain
    from smcdet_tpu_torch.studies.compare_mcmc import rj_sweep_ms

    cfg = load_suite_config(f"experiments/{SUITE}")
    dev = torch.device(device)
    with np.load(REPO / "output" / SUITE / "tiles.npz") as t:
        images = torch.as_tensor(t["images"][:num_images],
                                 dtype=torch.float32, device=dev)
    prior = build_prior(cfg.prior, dev)
    model = build_image_model(cfg.image_model, dev)
    chain, _ = mcmc_chain(cfg, build_kernel(cfg.kernel, dev), dev)
    rec = {}
    for chains in MEASURE_CHAINS:
        rec[chains] = rj_sweep_ms(images, prior, model, chain, chains)
        print(f"[measure] RJ sweep (birth/death) at {chains} chains: "
              f"{rec[chains]:.3f} ms a sweep", flush=True)
    return rec


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num-images", type=int, default=200)
    parser.add_argument("--num-samples", type=int, default=50_000)
    parser.add_argument("--burnin", type=int, default=30_000)
    parser.add_argument("--reps", type=int, default=4)
    parser.add_argument("--measure", action="store_true",
                        help="time the RJ sweep at 32 / 200 / 800 chains")
    parser.add_argument("--no-anchor", action="store_true",
                        help="stop after the measurement")
    parser.add_argument("--report", default="output/mcmc_anchor")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    report_dir = Path(args.report)
    report_dir.mkdir(parents=True, exist_ok=True)
    summary, walls = {}, {}

    def save():
        (report_dir / "summary.json").write_text(json.dumps(
            dict(summary, walls_s=walls), indent=2))

    ref = json.loads(COMMITTED.read_text())
    tiles = stage_tiles(SUITE)
    summary["tiles"] = tiles_record(tiles)
    print(f"[anchor] tiles {json.dumps(summary['tiles'])}", flush=True)
    if not _smc_ready(args.num_images):
        walls["m71synthetic smc"] = _run(
            ["smcdet_tpu_torch.run_experiment", f"experiments/{SUITE}",
             "--num-images", str(args.num_images), "--device", args.device])
    if args.measure:
        ms = measure(args.device, args.num_images)
        chains = args.num_images * args.reps
        per = ms[min(MEASURE_CHAINS, key=lambda c: abs(c - chains))]
        summary["rj_sweep_ms"] = ms
        summary["rj_predicted_s"] = per * args.num_samples / 1e3
        print(f"[measure] predicted RJ wall at {chains} chains x "
              f"{args.num_samples} sweeps: {summary['rj_predicted_s']:.0f} s",
              flush=True)
        save()
    ok = True
    if not args.no_anchor:
        walls["compare_mcmc"] = _run(
            ["smcdet_tpu_torch.studies.compare_mcmc", "--num-images",
             str(args.num_images), "--num-samples", str(args.num_samples),
             "--burnin", str(args.burnin), "--reps", str(args.reps),
             "--device", args.device])
        out = REPO / "output" / SUITE / "mcmc_comparison.json"
        shutil.copy(out, report_dir / out.name)
        keep_figure_data(out.parent / "figure_data" / "mcmc_comparison.npz",
                         report_dir)
        got = json.loads(out.read_text())
        rows, ok = hold_report(got, ref)
        summary["anchor"] = {"report": got, "bands": rows}
        for key, row in rows.items():
            print(f"[anchor] {key}: {json.dumps(row)}", flush=True)
    summary["ok"] = bool(ok)
    save()
    print(json.dumps(dict(summary, walls_s=walls)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
