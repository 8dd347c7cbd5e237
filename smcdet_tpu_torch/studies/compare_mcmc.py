"""The SMC-versus-MCMC anchor on m71synthetic (port of
``experiments/m71synthetic/compare_mcmc.py``, without JAX):

    python -m smcdet_tpu_torch.studies.compare_mcmc [--num-images 200]
        [--num-samples 50000] [--burnin 30000] [--thin 2] [--reps 4]
        [--split-merge] [--output-dir output] [--seed 0] [--device cuda]
        [--figure]

On the first ``--num-images`` m71synthetic tiles it runs the saturated MH
chain (``run_mh``: on the card K1 at N = 1 a chain, one burn-in launch and
one launch a kept sample) and the reversible-jump birth/death chain
(``run_rjmh``, plain PyTorch; split and merge moves with
``--split-merge``), ``--reps`` chains an image each, and compares their
pruned-count pmfs, mean counts and median total fluxes with the finished
CS-SMC run's posteriors (``load_results(out_dir, "smc")``).

The script runs its reps one after another on keys ``key0 + r``; here the
first ``n`` images are stacked ``reps`` times, rep-major, on the tile axis,
and one ``run_mh`` and one ``run_rjmh`` call run every chain, from
generators seeded ``11 + seed`` (MH) and ``1011 + seed`` (RJ). The rep axis
is then folded into the sample axis exactly as the script's ``pooled``:
counts and fluxes concatenated rep after rep on axis 1, the acceptance
averaged over reps.

Reads ``{output-dir}/m71synthetic/tiles.npz`` and the ``smc`` batches there
and writes ``mcmc_comparison.json`` beside them (the script's keys and
rounding, plus ``wall_s``), and the figure's arrays (``stats``' mean
counts, well-mixed chains and TVDs, and ``num_samples``) to
``figure_data/mcmc_comparison.npz``, from which ``python -m
smcdet_tpu_torch.figures`` draws ``figures/mcmc_comparison.png``
(``--figure``: at once; matplotlib needed). ``--device`` defaults to
``cuda`` and is never swapped for another device.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from smcdet_tpu_torch.figures import (
    MCMC_STATS,
    draw,
    require_matplotlib,
    save_figure_data,
)
from smcdet_tpu_torch.studies import REPO

__all__ = ["MIXED_ACC", "count_pmf", "stack_reps", "fold_reps", "stats",
           "report", "run_anchors", "rj_sweep_ms", "main"]

# a chain below this acceptance is stuck in a split mode (the script's
# well-mixed threshold)
MIXED_ACC = 0.15
PROB_SPLIT = PROB_MERGE = 0.15


def count_pmf(counts, weights, K):
    """Weighted pmf over 0..K-1 per image; ``counts``, ``weights [I, S]``
    (the script's ``count_pmf``)."""
    counts, weights = np.asarray(counts), np.asarray(weights)
    pmf = np.zeros((counts.shape[0], K))
    for k in range(K):
        pmf[:, k] = ((counts == k) * weights).sum(-1)
    return pmf / pmf.sum(-1, keepdims=True)


def stack_reps(images, reps: int):
    """``images [n, h, w]`` repeated ``reps`` times on the tile axis,
    rep-major: chain ``r * n + i`` is rep ``r`` of image ``i``."""
    return images.repeat((reps,) + (1,) * (images.dim() - 1))


def fold_reps(pruned_counts, pruned_fluxes, acc_rate, reps: int):
    """The ``[reps * n, K(, M)]`` results of the stacked chains folded as
    the script's ``pooled``: counts and fluxes ``[n, reps * K(, M)]``,
    rep after rep on axis 1; the acceptance ``[n]`` averaged over reps."""
    counts = np.asarray(pruned_counts)
    fluxes = np.asarray(pruned_fluxes)
    acc = np.asarray(acc_rate)
    n = counts.shape[0] // reps

    def fold(a):
        a = a.reshape((reps, n) + a.shape[1:])
        return np.concatenate(list(a), axis=1)

    return fold(counts), fold(fluxes), acc.reshape(reps, n).mean(0)


def stats(mc_counts, mc_fluxes, mc_acc, rj_counts, smc_counts, smc_weights,
          smc_fluxes, K):
    """The script's per-image arrays: the MH, RJ and SMC count pmfs, the
    TVDs to SMC, the mean counts, the median total fluxes (SMC's weighted)
    and the well-mixed chains."""
    mc_counts = np.asarray(mc_counts)
    mc_pmf = count_pmf(mc_counts, np.full(mc_counts.shape,
                                          1.0 / mc_counts.shape[1]), K)
    smc_w = np.asarray(smc_weights)
    smc_pmf = count_pmf(smc_counts, smc_w, K)
    rj_counts = np.asarray(rj_counts)
    rj_pmf = count_pmf(rj_counts, np.full(rj_counts.shape,
                                          1.0 / rj_counts.shape[1]), K)
    n = mc_counts.shape[0]
    mc_flux = np.asarray(mc_fluxes).sum(-1)
    smc_flux = np.asarray(smc_fluxes).sum(-1)
    med_smc = np.zeros(n)
    for i in range(n):
        order = np.argsort(smc_flux[i])
        cdf = np.cumsum(smc_w[i][order])
        med_smc[i] = smc_flux[i][order][np.searchsorted(cdf / cdf[-1], 0.5)]
    return {
        "tvd": 0.5 * np.abs(mc_pmf - smc_pmf).sum(-1),
        "rj_tvd": 0.5 * np.abs(rj_pmf - smc_pmf).sum(-1),
        "mean_mc": (mc_pmf * np.arange(K)).sum(-1),
        "mean_smc": (smc_pmf * np.arange(K)).sum(-1),
        "mean_rj": (rj_pmf * np.arange(K)).sum(-1),
        "med_mc": np.median(mc_flux, axis=-1),
        "med_smc": med_smc,
        "mixed": np.asarray(mc_acc) >= MIXED_ACC,
    }


def report(mc_counts, mc_fluxes, mc_acc, rj_counts, smc_counts,
           smc_weights, smc_fluxes, K, num_samples, reps):
    """``mcmc_comparison.json`` (the script's keys and rounding) from the
    pooled chains ``mc_counts [n, S]``, ``mc_fluxes [n, S, M]``, ``mc_acc
    [n]``, ``rj_counts [n, S']`` and the SMC posterior ``smc_counts``,
    ``smc_weights [n, P]``, ``smc_fluxes [n, P, M]``, over counts
    0..K-1."""
    s = stats(mc_counts, mc_fluxes, mc_acc, rj_counts, smc_counts,
              smc_weights, smc_fluxes, K)
    tvd, rj_tvd, mixed = s["tvd"], s["rj_tvd"], s["mixed"]
    diff = np.abs(s["mean_mc"] - s["mean_smc"])
    rj_diff = np.abs(s["mean_rj"] - s["mean_smc"])
    med_mc, med_smc = s["med_mc"], s["med_smc"]
    acc = np.asarray(mc_acc)
    return {
        "images": int(tvd.shape[0]),
        "mcmc_samples": num_samples,
        "mcmc_chains_per_image": reps,
        "count_pmf_tvd": {
            "mean": round(float(tvd.mean()), 4),
            "median": round(float(np.median(tvd)), 4),
            "p90": round(float(np.quantile(tvd, 0.9)), 4),
        },
        "well_mixed_chains": {
            "n": int(mixed.sum()),
            "acc_rate_threshold": MIXED_ACC,
            "count_pmf_tvd_mean": round(float(tvd[mixed].mean()), 4)
            if mixed.any() else None,
            "count_pmf_tvd_p90": round(float(np.quantile(tvd[mixed], 0.9)),
                                       4) if mixed.any() else None,
        },
        "mean_count_agreement": {
            "max_abs_diff": round(float(diff.max()), 4),
            "mean_abs_diff": round(float(diff.mean()), 4),
        },
        "median_total_flux_mean_abs_rel_diff": round(float(np.mean(
            np.abs(med_mc - med_smc)
            / np.maximum(np.maximum(med_mc, med_smc), 1e-3))), 4),
        "mcmc_acc_rate_range": [round(float(acc.min()), 3),
                                round(float(acc.max()), 3)],
        "rjmh": {
            "count_pmf_tvd_mean": round(float(rj_tvd.mean()), 4),
            "count_pmf_tvd_median": round(float(np.median(rj_tvd)), 4),
            "count_pmf_tvd_p90": round(float(np.quantile(rj_tvd, 0.9)), 4),
            "mean_count_max_abs_diff": round(float(rj_diff.max()), 4),
            "mean_count_mean_abs_diff": round(float(rj_diff.mean()), 4),
        },
    }


def _rj_kernel(chain, split_merge):
    from smcdet_tpu_torch.inference.transdimensional import BirthDeathMH

    return BirthDeathMH(num_iters=1, move=chain,
                        prob_split=PROB_SPLIT if split_merge else 0.0,
                        prob_merge=PROB_MERGE if split_merge else 0.0)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_anchors(images, prior, model, chain, mc_cfg, reps, seed=0,
                split_merge=False):
    """Both anchors' chains on ``images [n, h, w]``, ``reps`` an image,
    stacked rep-major on the tile axis, one call of each. Returns ``{"mh":
    (counts, fluxes, acc), "rj": (...)}`` folded by ``fold_reps`` and each
    anchor's wall in seconds."""
    from smcdet_tpu_torch.inference.mcmc import run_mh, run_rjmh

    dev = images.device
    stacked = stack_reps(images, reps)
    out, walls = {}, {}
    for name, base, runner, kernel in (
            ("mh", 11, run_mh, chain),
            ("rj", 1011, run_rjmh, _rj_kernel(chain, split_merge))):
        gen = torch.Generator(device=dev).manual_seed(base + seed)
        _sync(dev)
        start = time.perf_counter()
        res = runner(gen, stacked, prior, model, kernel, mc_cfg)
        _sync(dev)
        walls[name] = time.perf_counter() - start
        out[name] = fold_reps(res.pruned_counts.cpu().numpy(),
                              res.pruned_fluxes.cpu().numpy(),
                              res.acc_rate.cpu().numpy(), reps)
    return out, walls


def rj_sweep_ms(images, prior, model, chain, chains: int, sweeps: int = 100,
                warm: int = 20, seed: int = 0, split_merge=False):
    """The reversible-jump sweep's wall in ms (synchronised) at ``chains``
    chains, copies of ``images`` cycled to that many, from the empty start
    burnt in ``warm`` sweeps, over ``sweeps`` sweeps."""
    from smcdet_tpu_torch.inference.kernels import init_kernel_state
    from smcdet_tpu_torch.inference.mcmc import _context
    from smcdet_tpu_torch.inference.transdimensional import TDKernelState

    dev = images.device
    idx = torch.arange(chains, device=dev) % images.shape[0]
    imgs = images[idx]
    kernel = _rj_kernel(chain, split_merge)
    M = prior.max_objects
    counts = torch.zeros((chains, 1), dtype=torch.int32, device=dev)
    ctx = _context(prior, model, imgs)
    state = TDKernelState(counts=counts, inner=init_kernel_state(
        ctx, counts, torch.zeros((chains, 1, M, 2), device=dev),
        torch.zeros((chains, 1, M), device=dev)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(warm):
        state, _ = kernel.sweep(gen, ctx, state)
    _sync(dev)
    start = time.perf_counter()
    for _ in range(sweeps):
        state, _ = kernel.sweep(gen, ctx, state)
    _sync(dev)
    return (time.perf_counter() - start) * 1e3 / sweeps


def main(argv=None):
    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
        load_config,
    )
    from smcdet_tpu_torch.inference.mcmc import MCMCConfig
    from smcdet_tpu_torch.run_experiment import _check_device
    from smcdet_tpu_torch.runner import load_results, mcmc_chain

    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.compare_mcmc",
        description="CS-SMC against the MH and reversible-jump MCMC "
                    "anchors on the first m71synthetic images.")
    parser.add_argument("--num-images", type=int, default=200)
    parser.add_argument("--num-samples", type=int, default=50_000)
    parser.add_argument("--burnin", type=int, default=30_000)
    parser.add_argument("--thin", type=int, default=2)
    parser.add_argument("--reps", type=int, default=4,
                        help="independent chains per image (pooled)")
    parser.add_argument("--split-merge", action="store_true",
                        help="enable the split/merge proposals in the RJ "
                             "anchor")
    parser.add_argument("--seed", type=int, default=0,
                        help="offset of the anchors' generator seeds")
    parser.add_argument("--output-dir", default=None,
                        help="replaces the config's output_dir")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--figure", action="store_true",
                        help="also draw figures/mcmc_comparison.png "
                             "(needs matplotlib)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    _check_device(device)
    if args.figure:
        require_matplotlib("--figure")

    cfg = load_config(REPO / "experiments" / "m71synthetic" / "config.yaml")
    out_dir = Path(args.output_dir or cfg.output_dir) / cfg.name
    smc = load_results(out_dir, "smc")
    n = min(args.num_images, smc["pruned_counts"].shape[0])
    with np.load(out_dir / "tiles.npz") as tiles:
        images = torch.as_tensor(tiles["images"][:n], dtype=torch.float32,
                                 device=device)
    prior = build_prior(cfg.prior, device)
    model = build_image_model(cfg.image_model, device)
    chain, _ = mcmc_chain(cfg, build_kernel(cfg.kernel, device), device)
    mc_cfg = MCMCConfig(
        num_samples_total=args.num_samples,
        num_samples_burnin=args.burnin,
        keep_every_k=args.thin,
        flux_detection_threshold=cfg.sampler.flux_detection_threshold,
    )
    print(f"MCMC: {n} images x {args.reps} chains x {args.num_samples} "
          f"samples, on the tile axis ...", flush=True)
    runs, walls = run_anchors(images, prior, model, chain, mc_cfg,
                              args.reps, args.seed, args.split_merge)
    K = prior.max_objects + 2
    mc_counts, mc_fluxes, mc_acc = runs["mh"]
    smc_args = (smc["pruned_counts"][:n], smc["weights"][:n],
                smc["pruned_fluxes"][:n], K)
    out = report(mc_counts, mc_fluxes, mc_acc, runs["rj"][0], *smc_args,
                 args.num_samples, args.reps)
    out["wall_s"] = {k: round(v, 2) for k, v in walls.items()}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mcmc_comparison.json").write_text(json.dumps(out, indent=2))
    print(json.dumps(out, indent=2))
    s = stats(mc_counts, mc_fluxes, mc_acc, runs["rj"][0], *smc_args)
    data = save_figure_data(out_dir, "mcmc_comparison",
                            num_samples=args.num_samples,
                            **{k: s[k] for k in MCMC_STATS})
    if args.figure:
        for png in draw(data):
            print(f"figure: {png}")
    return out


if __name__ == "__main__":
    main()
