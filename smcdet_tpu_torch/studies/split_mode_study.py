"""The bright-star split mode of the MCMC baselines (port of
``experiments/m71synthetic/split_mode_study.py``, without JAX):

    python -m smcdet_tpu_torch.studies.split_mode_study [--chains 64]
        [--num-samples 20000] [--burnin 10000] [--output-dir output]
        [--device cuda] [--figure]

On the brightest single-star m71synthetic image, the saturated single-site
MH chain latches several slots onto the one star and cannot leave, and
the plain birth/death reversible-jump chain is as stuck; coordinated
split/merge moves are the cure. Runs ``--chains`` independent chains of
each anchor on that image:

- ``mh``: ``run_mh`` (one fused sweep-kernel launch for the burn-in, then
  one a kept sample, at N = 1 a chain);
- ``rj``: ``run_rjmh`` with ``BirthDeathMH`` (plain PyTorch);
- ``rj_splitmerge``: the same with split and merge moves (each with
  probability 0.15 a sweep).

Every chain keeps every second sweep after the burn-in. Each anchor's
chains start from a generator seeded ``1000 +`` its position in that list.
Reports per anchor the pooled pruned-count pmf and mean, the
chains whose modal count is the true 1 or above it, the mean acceptance and
the wall, under ``{output-dir}/m71synthetic/split_mode_study.json`` (the
JAX script's keys, and ``wall_s``), from
``{output-dir}/m71synthetic/tiles.npz``; the figure's arrays (each
anchor's pooled pmf unrounded, ``pmf_<anchor>``, with ``image_index``,
``true_flux`` and ``chains``) under
``{output-dir}/m71synthetic/figure_data/split_mode_study.npz``, from which
``python -m smcdet_tpu_torch.figures`` draws
``figures/split_mode_study.png`` (``--figure``: at once, matplotlib
needed). ``--device`` defaults to ``cuda`` and is never swapped for
another device.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from smcdet_tpu_torch.figures import (
    draw,
    require_matplotlib,
    save_figure_data,
)
from smcdet_tpu_torch.studies import REPO

__all__ = ["ANCHORS", "brightest_single", "pooled_pmf", "anchor_summary",
           "run_anchor", "main"]

ANCHORS = ("mh", "rj", "rj_splitmerge")
PROB_SPLIT = PROB_MERGE = 0.15
THIN = 2


def brightest_single(true_counts, true_fluxes):
    """The single-star tile with the brightest star: (index, its flux)."""
    single = np.flatnonzero(np.asarray(true_counts) == 1)
    bright = np.asarray(true_fluxes)[single].max(-1)
    return int(single[np.argmax(bright)]), float(bright.max())


def pooled_pmf(pruned_counts, K):
    """The pmf over 0..K-1 of every chain's kept pruned counts pooled."""
    pooled = np.bincount(np.asarray(pruned_counts).ravel(), minlength=K)[:K]
    return pooled / pooled.sum()


def anchor_summary(pruned_counts, acc_rate, K):
    """One anchor's entry from its chains' pruned counts ``[chains,
    kept]`` and acceptance rates: the pooled pmf over 0..K-1, its mean, the
    chains whose modal count is 1 and those above 1, the mean acceptance."""
    counts = np.asarray(pruned_counts)
    pooled = pooled_pmf(counts, K)
    modal = np.array([np.bincount(c, minlength=K).argmax() for c in counts])
    return {
        "pooled_count_pmf": [round(float(p), 4) for p in pooled],
        "pooled_mean_count": round(float((pooled * np.arange(K)).sum()), 3),
        "chains_modal_at_true": int((modal == 1).sum()),
        "chains_stuck_above": int((modal > 1).sum()),
        "acc_rate_mean": round(float(np.asarray(acc_rate).mean()), 3),
    }


def run_anchor(name, images, prior, model, chain, mc_cfg, seed):
    """Anchor ``name``'s chains, one per image of ``images [chains, h, w]``,
    from a generator seeded ``seed`` on the images' device; ``chain`` is the
    one-sweep MH kernel of the chains' moves. Returns the ``MCMCResult``."""
    from smcdet_tpu_torch.inference.mcmc import run_mh, run_rjmh
    from smcdet_tpu_torch.inference.transdimensional import BirthDeathMH

    gen = torch.Generator(device=images.device).manual_seed(seed)
    if name == "mh":
        return run_mh(gen, images, prior, model, chain, mc_cfg)
    split = name == "rj_splitmerge"
    kernel = BirthDeathMH(num_iters=1, move=chain,
                          prob_split=PROB_SPLIT if split else 0.0,
                          prob_merge=PROB_MERGE if split else 0.0)
    return run_rjmh(gen, images, prior, model, kernel, mc_cfg)


def main(argv=None):
    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
        load_config,
    )
    from smcdet_tpu_torch.inference.mcmc import MCMCConfig
    from smcdet_tpu_torch.run_experiment import _check_device
    from smcdet_tpu_torch.runner import _sync, mcmc_chain

    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.split_mode_study",
        description="MH and reversible-jump chains on the brightest "
                    "single-star m71synthetic image.")
    parser.add_argument("--chains", type=int, default=64)
    parser.add_argument("--num-samples", type=int, default=20_000)
    parser.add_argument("--burnin", type=int, default=10_000)
    parser.add_argument("--output-dir", default=None,
                        help="replaces the config's output_dir")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--figure", action="store_true",
                        help="also draw figures/split_mode_study.png (needs "
                             "matplotlib)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    _check_device(device)
    if args.figure:
        require_matplotlib("--figure")

    cfg = load_config(REPO / "experiments" / "m71synthetic" / "config.yaml")
    out_dir = Path(args.output_dir or cfg.output_dir) / cfg.name
    with np.load(out_dir / "tiles.npz") as tiles:
        idx, true_flux = brightest_single(tiles["true_counts"],
                                          tiles["true_fluxes"])
        image = torch.as_tensor(tiles["images"][idx], dtype=torch.float32,
                                device=device)
    images = image.expand((args.chains,) + image.shape).contiguous()

    prior = build_prior(cfg.prior, device)
    model = build_image_model(cfg.image_model, device)
    chain, _ = mcmc_chain(cfg, build_kernel(cfg.kernel, device), device)
    mc_cfg = MCMCConfig(
        num_samples_total=args.num_samples,
        num_samples_burnin=args.burnin,
        keep_every_k=THIN,
        flux_detection_threshold=cfg.sampler.flux_detection_threshold,
    )
    K = prior.max_objects + 2
    report = {
        "image_index": idx,
        "true_count": 1,
        "true_flux_nmgy": round(true_flux, 2),
        "chains": args.chains,
        "samples": args.num_samples,
        "burnin": args.burnin,
        "anchors": {},
    }
    pmfs = {}
    for name in ANCHORS:
        print(f"running {name} ({args.chains} chains x {args.num_samples})",
              flush=True)
        _sync(device)
        start = time.perf_counter()
        res = run_anchor(name, images, prior, model, chain, mc_cfg,
                         1000 + ANCHORS.index(name))
        _sync(device)
        wall = time.perf_counter() - start
        counts = res.pruned_counts.cpu().numpy()
        pmfs[f"pmf_{name}"] = pooled_pmf(counts, K)
        entry = anchor_summary(counts, res.acc_rate.cpu().numpy(), K)
        entry["wall_s"] = round(wall, 2)
        report["anchors"][name] = entry
        print(json.dumps(entry), flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "split_mode_study.json").write_text(
        json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    data = save_figure_data(out_dir, "split_mode_study", image_index=idx,
                            true_flux=true_flux, chains=args.chains, **pmfs)
    if args.figure:
        for png in draw(data):
            print(f"figure: {png}")
    return report


if __name__ == "__main__":
    main()
