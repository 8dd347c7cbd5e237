"""Monte Carlo stability of CS-SMC: repeated runs on one image (port of
``experiments/m71synthetic/repeated_runs.py``, without JAX):

    python -m smcdet_tpu_torch.studies.repeated_runs [--true-count 3]
        [--reps 100] [--num-catalogs 512 2048 8192] [--mh-steps 10 50 100]
        [--image-index I] [--output-dir output] [--device cuda] [--figure]

Runs CS-SMC ``--reps`` times on one m71synthetic image with the given true
count, for every pair of particles per stratum N and MH sweeps per SMC
iteration, and reports the middle-90% width over the runs of the per-stratum
log p(x|s) and of the posterior count probability p(s|x) at the true
count, and whether both shrink from the weakest setting to the strongest.

The runs ride the tile axis of one ``run_csmc`` call (every tile draws its
own stream from the call's generator). A call holds at most as many runs as
``run_csmc_chunked``'s memory estimate fits in its budget (13 rate-cache
copies a particle, a quarter of the card), the largest divisor of
``--reps`` that fits, so every call of one setting has the same shape.

The image: among the tiles of ``{output-dir}/m71synthetic/tiles.npz`` with
the true count, the one whose posterior count is most uncertain (largest
entropy) in the m71synthetic run under ``{output-dir}/m71synthetic``
(either package's batch files), or the first such tile without a run;
``--image-index`` overrides the pick (printed beside it). Writes
``repeatedruns_s{count}.npz`` and ``repeatedruns_s{count}_summary.json``
(the JAX script's keys) under ``{output-dir}/m71synthetic``. The
figures, ``figures/repeatedruns_{logpx,countprob}_s{count}.png``, are
drawn from that ``.npz`` alone by ``python -m smcdet_tpu_torch.figures``
(``--figure``: at once, matplotlib needed). ``--device`` defaults to
``cuda`` and is never swapped for another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from smcdet_tpu_torch.figures import draw, require_matplotlib
from smcdet_tpu_torch.studies import REPO

__all__ = ["reps_per_call", "run_grid", "interval_width", "entropy_pick",
           "summarize", "main"]

M71SYNTHETIC = REPO / "experiments" / "m71synthetic"


def reps_per_call(prior, num_catalogs, reps, tile_hw, budget_bytes):
    """The largest divisor of ``reps`` whose runs fit ``budget_bytes`` by
    ``chunk_bytes_per_tile``."""
    from smcdet_tpu_torch.inference.smc import max_tiles_per_chunk

    cap = max_tiles_per_chunk(prior, num_catalogs, tile_hw, budget_bytes)
    return max(d for d in range(1, reps + 1) if reps % d == 0 and d <= cap)


def run_grid(img, prior, model, kernel, base_cfg, Ns, steps_list, reps,
             seed=0, budget_bytes=None, verbose=True):
    """``reps`` runs of ``run_csmc`` on ``img [h, w]`` (on the prior's
    device) for every N in ``Ns`` and sweeps in ``steps_list``. Returns
    ``logpx``, ``pmf`` (the softmax of ``logpx`` over strata), both ``[n_N,
    n_steps, reps, C]``, and ``iters [n_N, n_steps, reps]``, the SMC
    iterations of each run's call. ``reps_per_call`` sizes the calls by
    ``budget_bytes`` (default ``default_budget_bytes``). Call ``done`` of
    setting (a, b) draws from a generator seeded ``seed * 10**7 + (a * 97 +
    b) * 1009 + done``."""
    from smcdet_tpu_torch.inference.mcmc import with_iters
    from smcdet_tpu_torch.inference.smc import default_budget_bytes, run_csmc

    img = torch.as_tensor(img, dtype=torch.float32, device=prior.device)
    if budget_bytes is None:
        budget_bytes = default_budget_bytes(prior.device)
    C = prior.num_counts
    logpx = np.zeros((len(Ns), len(steps_list), reps, C))
    pmf = np.zeros_like(logpx)
    iters = np.zeros((len(Ns), len(steps_list), reps))
    for a, N in enumerate(Ns):
        r_call = reps_per_call(prior, int(N), reps, img.numel(),
                               budget_bytes)
        for b, steps in enumerate(steps_list):
            cfg = dataclasses.replace(base_cfg, num_catalogs=int(N))
            kern = with_iters(kernel, int(steps))
            done = 0
            while done < reps:
                r = min(r_call, reps - done)
                gen = torch.Generator(device=prior.device).manual_seed(
                    seed * 10**7 + (a * 97 + b) * 1009 + done)
                batch = img[None].expand((r,) + img.shape).contiguous()
                res = run_csmc(gen, batch, prior, model, kern, cfg)
                lz = res.log_normalizing_constant
                logpx[a, b, done:done + r] = lz.double().cpu().numpy()
                pmf[a, b, done:done + r] = torch.softmax(
                    lz.double(), -1).cpu().numpy()
                iters[a, b, done:done + r] = float(res.num_iters)
                done += r
            if verbose:
                print(f"N={N} steps={steps}: {reps} runs in calls of "
                      f"{r_call}, smc_iters={iters[a, b].max():.0f}",
                      flush=True)
    return logpx, pmf, iters


def interval_width(x, lo=0.05, hi=0.95, axis=-2):
    """Middle-90% spread across the repetition axis."""
    return np.quantile(x, hi, axis=axis) - np.quantile(x, lo, axis=axis)


def entropy_pick(true_counts, true_count, smc=None):
    """The JAX script's image: among the tiles with ``true_count`` true
    stars, the one whose posterior count (from ``smc``, a ``load_results``
    dict with ``weights`` and ``pruned_counts``) has the largest entropy;
    the first such tile without ``smc``. Returns (index, that entropy or
    None)."""
    cand = np.flatnonzero(np.asarray(true_counts) == true_count)
    if smc is None:
        return int(cand[0]), None
    ent = np.zeros(len(cand))
    for j, i in enumerate(cand):
        if i >= smc["pruned_counts"].shape[0]:
            continue
        w, c = smc["weights"][i], smc["pruned_counts"][i]
        pmf = np.bincount(c, weights=w, minlength=10)
        pmf = pmf / pmf.sum()
        ent[j] = -(pmf[pmf > 0] * np.log(pmf[pmf > 0])).sum()
    return int(cand[np.argmax(ent)]), float(ent.max())


def summarize(logpx, pmf, idx, s, Ns, steps_list):
    """The summary (the JAX script's keys): the middle-90% widths of log
    p(x|s) and p(s|x) at the true count ``s`` per setting, and whether the
    strongest setting is tighter than the weakest in both (a width already
    about 0 at the weakest counts as shrunk)."""
    w_logpx = interval_width(logpx)[..., s]
    w_pmf = interval_width(pmf)[..., s]
    return {
        "image_index": int(idx),
        "true_count": int(s),
        "num_catalogs": [int(n) for n in Ns],
        "mh_steps": [int(n) for n in steps_list],
        "logpx_mid90_width_at_true_count": np.round(w_logpx, 4).tolist(),
        "count_prob_mid90_width_at_true_count": np.round(w_pmf,
                                                         4).tolist(),
        "shrinks_with_N_and_steps": bool(
            (w_logpx[-1, -1] < w_logpx[0, 0] or w_logpx[0, 0] <= 1e-4)
            and (w_pmf[-1, -1] < w_pmf[0, 0] or w_pmf[0, 0] <= 1e-4)),
    }


def main(argv=None):
    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
        load_config,
    )
    from smcdet_tpu_torch.inference.smc import SMCConfig
    from smcdet_tpu_torch.run_experiment import _check_device
    from smcdet_tpu_torch.runner import load_results

    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.repeated_runs",
        description="Spread of log p(x|s) and p(s|x) over repeated CS-SMC "
                    "runs on one m71synthetic image.")
    parser.add_argument("--true-count", type=int, default=3)
    parser.add_argument("--reps", type=int, default=100)
    parser.add_argument("--num-catalogs", type=int, nargs="+",
                        default=[512, 2048, 8192])
    parser.add_argument("--mh-steps", type=int, nargs="+",
                        default=[10, 50, 100])
    parser.add_argument("--image-index", type=int, default=None,
                        help="run on this tile instead of the entropy pick")
    parser.add_argument("--output-dir", default=None,
                        help="replaces the config's output_dir")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--figure", action="store_true",
                        help="also draw figures/repeatedruns_*.png (needs "
                             "matplotlib)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    _check_device(device)
    if args.figure:
        require_matplotlib("--figure")

    cfg = load_config(M71SYNTHETIC / "config.yaml")
    out_dir = Path(args.output_dir or cfg.output_dir) / cfg.name
    with np.load(out_dir / "tiles.npz") as tiles:
        true_counts, images = tiles["true_counts"], tiles["images"]
    try:
        smc = load_results(out_dir, "smc")
    except FileNotFoundError:
        smc = None
    pick, ent = entropy_pick(true_counts, args.true_count, smc)
    idx = pick if args.image_index is None else args.image_index
    print(f"entropy pick: image {pick}"
          + ("" if ent is None else f" (posterior count entropy {ent:.3f})")
          + ("" if smc is not None else " (no m71synthetic run: the first "
             "candidate)") + f"; running image {idx}: true count "
          f"{int(true_counts[idx])}", flush=True)
    if int(true_counts[idx]) != args.true_count:
        raise SystemExit(f"image {idx} has true count "
                         f"{int(true_counts[idx])}, not {args.true_count}")

    prior = build_prior(cfg.prior, device)
    model = build_image_model(cfg.image_model, device)
    kernel = build_kernel(cfg.kernel, device)
    s = cfg.sampler
    base_cfg = SMCConfig(
        num_catalogs=s.num_catalogs,
        ess_threshold_prop=s.ess_threshold_prop,
        resample_method=s.resample_method,
        max_smc_iters=s.max_smc_iters,
        flux_detection_threshold=s.flux_detection_threshold,
    )
    logpx, pmf, iters = run_grid(
        images[idx], prior, model, kernel, base_cfg, args.num_catalogs,
        args.mh_steps, args.reps)

    t = args.true_count
    grid = out_dir / f"repeatedruns_s{t}.npz"
    np.savez_compressed(
        grid, logpx=logpx, count_pmf=pmf,
        smc_iters=iters, num_catalogs=np.asarray(args.num_catalogs),
        mh_steps=np.asarray(args.mh_steps), image_index=idx)
    summary = summarize(logpx, pmf, idx, t, args.num_catalogs,
                        args.mh_steps)
    summary["entropy_pick"] = pick
    (out_dir / f"repeatedruns_s{t}_summary.json").write_text(
        json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    if args.figure:
        for png in draw(grid):
            print(f"figure: {png}")
    return summary


if __name__ == "__main__":
    main()
