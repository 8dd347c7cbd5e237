"""Budget probe of the crowded-tile flux underestimate (port of
``experiments/m71/crowded_budget_probe.py``, without JAX):

    python -m smcdet_tpu_torch.studies.crowded_budget_probe [--run]
        [--output-dir output] [--device cuda]

On the seed-6839 fixture (``experiments/m71/data_seed2``) the posterior
underestimates the total flux of the tiles whose exact truth holds 3-4
stars (mean SBC rank above the uniform 0.5). The probe scores three arms on
those tiles against the exact truth, to tell sampler under-resolution (the
rank falls with budget) from a property of the model and fixture (it stays
flat):

- ``base_n2048_s100``: the m71_seed2 run (``config_seed2.yaml``) restricted
  to the crowded tiles;
- ``hiN_n8192_s100``: ``config_seed2_crowded_hiN.yaml`` (4x particles);
- ``hiS_n2048_s200``: ``config_seed2_crowded_hiS.yaml`` (2x sweeps).

Each arm's mean SBC rank of the total flux with its standard error, the KS
p-value of the ranks' uniformity and the coverage at 0.5 / 0.8 / 0.95, with
the JAX script's keys, go to ``{output-dir}/m71/crowded_budget_probe.json``.
The committed subsets ``tiles_crowded{,_exact}.npz`` are checked, key by
key, against the selection from ``tiles_exact.npz``; they are never
rewritten.

``--run`` first runs every arm whose batches are missing, through the
port's ``run_experiment`` on ``--device`` (default ``cuda``; never swapped
for another device). ``run_arms`` / ``compare`` with ``num_tiles=N`` cut
every arm to the first N crowded tiles: the base arm then runs
``config_seed2.yaml`` on the crowded subset itself (as
``m71_seed2_crowded_base``), which differs from the restricted full run
only in the draw. Results are read from
``{output-dir}/<name>`` (relative to the working directory, as the runner
writes them).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from smcdet_tpu_torch.studies.m71_fixture import M71

__all__ = ["ARMS", "crowded_mask", "subsets_match", "score", "compare",
           "run_arms", "main"]

DATA = M71 / "data_seed2" / "m71"
LEVELS = [0.5, 0.8, 0.95]
# arm: (config in experiments/m71, output name)
ARMS = {
    "base_n2048_s100": ("config_seed2.yaml", "m71_seed2"),
    "hiN_n8192_s100": ("config_seed2_crowded_hiN.yaml",
                       "m71_seed2_crowded_hiN"),
    "hiS_n2048_s200": ("config_seed2_crowded_hiS.yaml",
                       "m71_seed2_crowded_hiS"),
}
CUT_BASE = "m71_seed2_crowded_base"  # the base arm under --num-tiles
SUBSETS = (("tiles.npz", "tiles_crowded.npz"),
           ("tiles_exact.npz", "tiles_crowded_exact.npz"))


def crowded_mask(true_counts):
    """The tiles whose exact truth count is 3 or 4."""
    true_counts = np.asarray(true_counts)
    return (true_counts >= 3) & (true_counts <= 4)


def subsets_match(data_dir=DATA):
    """Per committed subset file, whether every key equals the full file's
    rows under ``crowded_mask`` of the exact truth (and no key is missing
    or extra)."""
    data_dir = Path(data_dir)
    with np.load(data_dir / "tiles_exact.npz") as exact:
        keep = crowded_mask(exact["true_counts"])
    out = {}
    for src, dst in SUBSETS:
        with np.load(data_dir / src) as full, np.load(data_dir / dst) as sub:
            out[dst] = sorted(full.files) == sorted(sub.files) and all(
                np.array_equal(full[k][keep], sub[k]) for k in full.files)
    return out


def score(est_total, weights, truth_total):
    """One arm's scores (the JAX script's ``_score``): mean SBC rank of the
    truth among the weighted posterior samples, its standard error, the KS
    p-value of uniformity and the credible-interval coverage."""
    from smcdet_tpu_torch.validation import (
        credible_interval_coverage,
        sbc_ranks,
        sbc_uniformity_pvalue,
    )

    ranks = sbc_ranks(truth_total, est_total, weights=weights)
    cov = credible_interval_coverage(truth_total, est_total, LEVELS,
                                     weights=weights)
    return {
        "mean_sbc_rank": round(float(ranks.mean()), 4),
        "sbc_rank_stderr": round(
            float(ranks.std(ddof=1) / np.sqrt(ranks.size)), 4),
        "sbc_ks_pvalue": round(sbc_uniformity_pvalue(ranks), 6),
        "coverage": {str(lv): round(float(c), 4)
                     for lv, c in zip(LEVELS, cov)},
    }


def _arm_totals(out_dir, keep, n):
    """An arm's posterior total fluxes and weights on the first ``n``
    crowded tiles: a run over the whole fixture is restricted by ``keep``,
    a run over the crowded subset is taken as it is."""
    from smcdet_tpu_torch.runner import load_results

    res = load_results(out_dir, "smc")
    total, weights = res["pruned_fluxes"].sum(-1), res.get("weights")
    if total.shape[0] == keep.size:
        total = total[keep]
        weights = None if weights is None else weights[keep]
    if total.shape[0] < n:
        raise ValueError(f"{out_dir} holds {total.shape[0]} crowded tiles, "
                         f"fewer than {n}")
    return total[:n], None if weights is None else weights[:n]


def compare(output_dir="output", data_dir=DATA, num_tiles=None):
    """The report over every arm with batches under ``output_dir`` (an arm
    without is ``"not run"``), on the first ``num_tiles`` crowded tiles (all
    by default)."""
    with np.load(Path(data_dir) / "tiles_exact.npz") as exact:
        keep = crowded_mask(exact["true_counts"])
        truth_total = exact["true_fluxes"][keep].sum(-1)
    n = truth_total.size if num_tiles is None else min(num_tiles,
                                                       truth_total.size)
    report = {"tiles": int(n), "arms": {}}
    for arm, (_, name) in ARMS.items():
        if arm.startswith("base") and num_tiles is not None:
            name = CUT_BASE
        out_dir = Path(output_dir) / name
        if not any(out_dir.glob("smc_batch*.npz")):
            report["arms"][arm] = "not run"
            continue
        total, weights = _arm_totals(out_dir, keep, n)
        report["arms"][arm] = score(total, weights, truth_total[:n])
    return report


def run_arms(output_dir="output", device="cuda", num_tiles=None,
             arms=None, verbose=True):
    """Run ``arms`` (default every arm) through ``run_experiment`` (a
    finished batch is skipped). With ``num_tiles`` each arm runs the first
    ``num_tiles`` crowded tiles in one batch, the base arm
    ``config_seed2.yaml`` on the crowded subset. Returns the output
    directories by arm."""
    from smcdet_tpu_torch.run_experiment import load_suite_config
    from smcdet_tpu_torch.runner import run_experiment

    dirs = {}
    for arm in arms or ARMS:
        cfg = load_suite_config(str(M71), ARMS[arm][0])
        cfg.output_dir = str(output_dir)
        if num_tiles is not None:
            if arm.startswith("base"):
                cfg.name = CUT_BASE
                cfg.data_path = str(DATA / "tiles_crowded.npz")
            cfg.num_images = cfg.batch_size = num_tiles
        dirs[arm] = run_experiment(cfg, device=device, verbose=verbose)
    return dirs


def main(argv=None):
    from smcdet_tpu_torch.run_experiment import _check_device

    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.crowded_budget_probe",
        description="Mean SBC rank of the total flux on the seed-6839 "
                    "fixture's crowded tiles under three sampler budgets.")
    parser.add_argument("--run", action="store_true",
                        help="run the arms whose batches are missing first")
    parser.add_argument("--output-dir", default="output")
    parser.add_argument("--device", default="cuda",
                        help="torch device of --run (default cuda)")
    args = parser.parse_args(argv)

    matches = subsets_match()
    if not all(matches.values()):
        raise SystemExit(f"committed crowded subsets differ from the "
                         f"selection: {matches}")
    if args.run:
        import torch

        _check_device(torch.device(args.device))
        run_arms(args.output_dir, args.device)
    report = compare(args.output_dir)
    out = Path(args.output_dir) / "m71" / "crowded_budget_probe.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
