"""The current JAX package's figures for a study, on the CPU, on the same
tiles as the port's run: the reference that tells a port fault from a
stale committed analysis where ``tests/torch_synthetic_suites.py`` misses
a committed figure.

    JAX_PLATFORMS=cpu python tests/torch_studies_reference.py kernels \\
        [--num-images 30] [--seeds 1 2] [--tiles tests/data/basic_tiles.npz]
    python tests/torch_studies_reference.py kernels-port [--device cuda] \\
        [--num-images 30] [--seeds 1 2]
    python tests/torch_studies_reference.py singletile --dc A --st B

``kernels``: ``experiments/basic/compare_kernels.py``'s runs (``run_csmc``
with ``SingleComponentMH`` and ``SingleComponentMALA`` at its steps, the
basic suite's prior, model and sampler, N = 512) on the first
``--num-images`` tiles, once per JAX key in ``--seeds`` (the script itself
reports key 1), each scored by the port's ``kernel_summary`` /
``kernel_report`` (the script's formulas, held equal by
``tests/test_torch_studies.py``). Prints one JSON line per seed, then the
mean over seeds of each held figure. ``kernels-port [--device cuda]``: the
same runs through the port, ``python -m
smcdet_tpu_torch.studies.compare_kernels --seed S`` for each seed (no
JAX). ``--dump F.npz`` keeps each seed's per-image count pmfs per kernel;
``pmf-spread --dc A.npz --st B.npz`` prints, per kernel, the mean per-image
TVD between runs within each dump and across the two (which kernel's
posterior differs between two runners).

``simulator-ks [--seeds 0 1 2 3]``: ``experiments/m71/simulator_checks.py``'s
prior-predictive simulation (its lines 93-135: the m71 config with the
fitted overlay, ``max_objects`` 64, the fixture's per-tile backgrounds) for
each JAX key in ``--seeds``, and the KS statistic of each log-intensity
quantile against the fixture's tiles; prints one JSON line per seed, then
each statistic's range over the seeds (the band of
``tests/torch_m71_studies.py``).

``anchor-mh [--num-images 200] [--seeds 11 21] [--port-seeds 0 1]
[--top 8] [--device cpu]``: ``experiments/m71synthetic/compare_mcmc.py``'s
MH anchor (``anchor_mh``) under the current JAX package, each ``key0``'s
acceptance range and highest-acceptance images, then the port's anchor on
those images (where ``tests/torch_mcmc_anchor.py`` misses the
acceptance range).

``singletile --dc A --st B``: compare_singletile's report (count-pmf TVD
and mean-count difference per image) from two
``tests/torch_cells_localise.py`` summaries (``<runner>_summary.npz``, the
per-image count pmf over 0..max_objects), or two results directories
(``compare_singletile.singletile_report`` of ``singletile_arrays`` on
their batch files, over the images both hold), of the divide-and-conquer
and the single-tile config on the same tiles, by either runner, on the
first ``--num-images`` images they hold; no JAX needed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def kernels(args):
    import jax
    import jax.numpy as jnp

    from smcdet_tpu.config import build_image_model, build_prior, load_config
    from smcdet_tpu.inference.kernels import (
        SingleComponentMALA,
        SingleComponentMH,
    )
    from smcdet_tpu.inference.smc import SMCConfig, run_csmc

    jax.config.update("jax_platforms", "cpu")
    cfg = load_config(REPO / "experiments" / "basic" / "config.yaml")
    tiles = np.load(args.tiles or REPO / "tests" / "data" / "basic_tiles.npz")
    n = min(args.num_images, tiles["images"].shape[0])
    images = jnp.asarray(tiles["images"][:n], dtype=jnp.float32)
    prior = build_prior(cfg.prior)
    model = build_image_model(cfg.image_model)
    k = cfg.kernel
    box = dict(fluxes_min=jnp.float32(k.fluxes_min),
               fluxes_max=jnp.float32(k.fluxes_max))
    kernels_ = {
        "mh": SingleComponentMH(num_iters=k.num_iters,
                                locs_stdev=jnp.float32(k.locs_stdev),
                                fluxes_stdev=jnp.float32(k.fluxes_stdev),
                                **box),
        "mala": SingleComponentMALA(num_iters=k.num_iters,
                                    locs_step=jnp.float32(0.05),
                                    fluxes_step=jnp.float32(20.0), **box),
    }
    s = cfg.sampler
    smc_cfg = SMCConfig(num_catalogs=512,
                        ess_threshold_prop=s.ess_threshold_prop,
                        resample_method=s.resample_method,
                        max_smc_iters=s.max_smc_iters,
                        flux_detection_threshold=s.flux_detection_threshold)
    runs = {name: jax.jit(lambda key, im, kn=kn: run_csmc(
        key, im, prior, model, kn, smc_cfg))
        for name, kn in kernels_.items()}

    def run(name, seed):
        res = jax.block_until_ready(runs[name](jax.random.key(seed), images))
        return {f: np.asarray(getattr(res, f)) for f in _FIELDS}

    _kernel_reports(args, n, prior.max_objects + 2, run)


_FIELDS = ("pruned_counts", "weights", "pruned_fluxes", "acc_rate",
           "num_iters")


def _kernel_reports(args, n, K, run):
    """compare_kernels' report per seed from ``run(kernel, seed)`` (numpy
    results), one JSON line each, then the mean of the held figures."""
    from smcdet_tpu_torch.studies.compare_kernels import (
        kernel_report,
        kernel_summary,
    )

    reports, dumped = [], {"mh": [], "mala": []}
    for seed in args.seeds:
        results, pmfs = {}, {}
        for name in ("mh", "mala"):
            start = time.perf_counter()
            res = run(name, seed)
            wall = time.perf_counter() - start
            results[name], pmfs[name] = kernel_summary(res, wall, K)
            dumped[name].append(pmfs[name])
        report = kernel_report(n, 512, results, pmfs)
        report["seed"] = seed
        print(json.dumps(report), flush=True)
        reports.append(report)
    if args.dump:
        np.savez_compressed(args.dump, seeds=np.asarray(args.seeds),
                            **{k: np.asarray(v) for k, v in dumped.items()})
    _print_mean(n, args.seeds, reports)


def _print_mean(n, seeds, reports):
    """The mean over seeds of each held figure of compare_kernels'
    ``reports``, as one JSON line."""
    mean = {f"{name} acceptance": float(np.mean(
        [r["kernels"][name]["acceptance_rate_mean"] for r in reports]))
        for name in ("mh", "mala")}
    mean["tvd_mean"] = float(np.mean([r["count_pmf_tvd"]["mean"]
                                      for r in reports]))
    print(json.dumps({"images": n, "seeds": seeds,
                      "mean_over_seeds": mean}))


def kernels_port(args):
    """``compare_kernels.main`` once per seed in ``--seeds`` (its
    ``--seed``) on ``--device``, over the first ``--num-images`` of
    ``--tiles`` staged in a directory of its own: the port's spread from
    seed to seed. Imports no JAX."""
    import shutil
    import tempfile

    from smcdet_tpu_torch.studies import compare_kernels

    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "basic").mkdir()
        shutil.copy(args.tiles or REPO / "tests" / "data" / "basic_tiles.npz",
                    Path(tmp) / "basic" / "tiles.npz")
        reports, dumps = [], []
        for seed in args.seeds:
            dumps.append(Path(tmp) / f"pmfs{seed}.npz")
            report = compare_kernels.main([
                "--num-images", str(args.num_images), "--seed", str(seed),
                "--dump", str(dumps[-1]), "--output-dir", tmp, "--device",
                args.device])
            report["seed"] = seed
            print(json.dumps(report), flush=True)
            reports.append(report)
        if args.dump:
            files = [np.load(d) for d in dumps]
            np.savez_compressed(args.dump, **{k: np.concatenate(
                [f[k] for f in files]) for k in ("seeds", "mh", "mala")})
    _print_mean(reports[0]["images"], args.seeds, reports)


def singletile(args):
    from smcdet_tpu_torch.runner import load_results
    from smcdet_tpu_torch.studies import tvd_stats
    from smcdet_tpu_torch.studies.compare_singletile import (
        singletile_arrays,
        singletile_report,
    )

    if Path(args.dc).is_dir():
        print(json.dumps(singletile_report(singletile_arrays(
            load_results(args.dc), load_results(args.st)))))
        return
    dc, st = (np.load(p)["count_pmf"] for p in (args.dc, args.st))
    n = min(len(dc), len(st), args.num_images)
    dc, st = dc[:n], st[:n]
    tvd = 0.5 * np.abs(dc - st).sum(-1)
    ks = np.arange(dc.shape[-1])
    diff = np.abs((dc * ks).sum(-1) - (st * ks).sum(-1))
    print(json.dumps({"images": n, "count_pmf_tvd": tvd_stats(tvd),
                      "mean_count": {
                          "mean_abs_diff": round(float(diff.mean()), 4),
                          "max_abs_diff": round(float(diff.max()), 4)}}))


def pmf_spread(args):
    """Per kernel, the mean per-image count-pmf TVD between the runs of two
    sets of ``--dump`` files (``--dc`` and ``--st``, each a comma-separated
    list): within each set's seeds and across the two."""
    from itertools import combinations, product

    def load(paths):  # comma-separated dumps, their seeds joined
        files = [np.load(p) for p in paths.split(",")]
        return {k: np.concatenate([f[k] for f in files])
                for k in ("mh", "mala")}

    a, b = load(args.dc), load(args.st)

    def mean_tvd(pairs):
        return round(float(np.mean([0.5 * np.abs(x - y).sum(-1).mean()
                                    for x, y in pairs])), 4)

    out = {}
    for k in ("mh", "mala"):
        n = min(a[k].shape[1], b[k].shape[1])
        x, y = a[k][:, :n], b[k][:, :n]
        out[k] = {"images": n, "within_first": mean_tvd(combinations(x, 2)),
                  "within_second": mean_tvd(combinations(y, 2)),
                  "across": mean_tvd(product(x, y))}
    print(json.dumps(out))


def simulator_ks(args):
    import jax
    import jax.numpy as jnp

    from smcdet_tpu.config import build_image_model, load_config
    from smcdet_tpu.models.priors import M71Prior
    from smcdet_tpu.models.simulate import generate_images
    from smcdet_tpu_torch.studies.simulator_checks import quantile_checks

    here = REPO / "experiments" / "m71"
    cfg = load_config(here / "config.yaml")
    with np.load(here / cfg.data_path) as tiles:
        real = np.asarray(tiles["images"], dtype=np.float64)
        backgrounds = np.asarray(tiles["background"], dtype=np.float32)
    p = cfg.prior
    prior = M71Prior(
        min_objects=0, max_objects=64, image_height=p.image_height,
        image_width=p.image_width, pad=p.pad, counts_rate=p.counts_rate,
        flux_alpha=p.flux_alpha,
        flux_lower=max(p.flux_lower, cfg.sampler.flux_detection_threshold),
        flux_upper=p.flux_upper)
    model = build_image_model(cfg.image_model).replace(
        background=jnp.asarray(backgrounds))
    per_seed = {}
    for seed in args.seeds:
        sim = generate_images(
            jax.random.key(seed), prior, model,
            flux_threshold=cfg.sampler.flux_detection_threshold,
            loc_threshold_lower=0.0,
            loc_threshold_upper=float(p.image_height),
            num_images=real.shape[0])
        checks = quantile_checks(np.asarray(sim.images, np.float64), real)
        per_seed[seed] = {q: c["ks_statistic"] for q, c in checks.items()}
        print(json.dumps({"seed": seed, "ks_statistic": per_seed[seed]}),
              flush=True)
    print(json.dumps({"range": {
        q: [min(v[q] for v in per_seed.values()),
            max(v[q] for v in per_seed.values())]
        for q in next(iter(per_seed.values()))}}))


def anchor_mh(args):
    """``experiments/m71synthetic/compare_mcmc.py``'s MH anchor under the
    current JAX package (the script's kernel and ``MCMCConfig``, its
    ``pooled`` reps on keys ``key0 + r``) on the first ``--num-images``
    m71synthetic images, once per ``key0`` in ``--seeds``: the acceptance
    range as the script rounds it and the images of highest pooled
    acceptance. Then the port's ``run_anchors`` (``--device``, the plain
    version on the CPU) on the ``--top`` images of highest acceptance under
    the first key, once per ``--port-seeds`` value, beside JAX's pooled
    acceptance of the same images."""
    import jax
    import jax.numpy as jnp
    import torch

    from smcdet_tpu.config import (
        build_image_model,
        build_kernel,
        build_prior,
        load_config,
    )
    from smcdet_tpu.inference.mcmc import MCMCConfig, run_mh

    cfg = load_config(REPO / "experiments" / "m71synthetic" / "config.yaml")
    tiles = args.tiles or REPO / "tests" / "data" / "m71synthetic_tiles.npz"
    with np.load(tiles) as t:
        images = np.asarray(t["images"][:args.num_images], np.float32)
    prior = build_prior(cfg.prior)
    model = build_image_model(cfg.image_model)
    kernel = build_kernel(cfg.kernel).replace(
        num_iters=1, locs_stdev=jnp.float32(cfg.mcmc.locs_stdev),
        fluxes_stdev=jnp.float32(cfg.mcmc.fluxes_stdev))
    mc = dict(num_samples_total=args.num_samples,
              num_samples_burnin=args.burnin, keep_every_k=2,
              flux_detection_threshold=cfg.sampler.flux_detection_threshold)
    run = jax.jit(lambda k, im: run_mh(k, im, prior, model, kernel,
                                       MCMCConfig(**mc)))
    acc = {}
    for key0 in args.seeds:
        start = time.perf_counter()
        acc[key0] = np.stack([np.asarray(run(jax.random.key(key0 + r),
                                             jnp.asarray(images)).acc_rate)
                              for r in range(args.reps)]).mean(0)
        top = np.argsort(-acc[key0])[:args.top]
        print(json.dumps({
            "runner": "jax", "key0": key0,
            "mcmc_acc_rate_range": [round(float(acc[key0].min()), 3),
                                    round(float(acc[key0].max()), 3)],
            "top_images": top.tolist(),
            "top_acc": np.round(acc[key0][top], 4).tolist(),
            "wall_s": round(time.perf_counter() - start, 1)}), flush=True)
    if not args.port_seeds:
        return
    from smcdet_tpu_torch import config as tcfg
    from smcdet_tpu_torch.inference.mcmc import MCMCConfig as TConfig
    from smcdet_tpu_torch.runner import mcmc_chain
    from smcdet_tpu_torch.studies.compare_mcmc import run_anchors

    dev = torch.device(args.device)
    pc = tcfg.load_config(REPO / "experiments" / "m71synthetic"
                          / "config.yaml")
    pprior = tcfg.build_prior(pc.prior, dev)
    pmodel = tcfg.build_image_model(pc.image_model, dev)
    chain, _ = mcmc_chain(pc, tcfg.build_kernel(pc.kernel, dev), dev)
    top = np.argsort(-acc[args.seeds[0]])[:args.top]
    sub = torch.as_tensor(images[top], device=dev)
    for seed in args.port_seeds:
        start = time.perf_counter()
        runs, _ = run_anchors(sub, pprior, pmodel, chain, TConfig(**mc),
                              args.reps, seed)
        got = runs["mh"][2]
        print(json.dumps({
            "runner": "torch", "seed": seed, "images": top.tolist(),
            "acc": np.round(got, 4).tolist(),
            "jax_acc": {k: np.round(v[top], 4).tolist()
                        for k, v in acc.items()},
            "max": round(float(got.max()), 3),
            "wall_s": round(time.perf_counter() - start, 1)}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("study", choices=("kernels", "kernels-port",
                                          "singletile", "pmf-spread",
                                          "simulator-ks", "anchor-mh"))
    parser.add_argument("--dump", default=None,
                        help="kernels, kernels-port: save each seed's count "
                             "pmfs per kernel to this .npz")
    parser.add_argument("--device", default="cuda",
                        help="kernels-port: the port's device")
    parser.add_argument("--num-images", type=int, default=30)
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    parser.add_argument("--tiles", default=None)
    parser.add_argument("--dc", help="singletile: the tree's summary")
    parser.add_argument("--st", help="singletile: the single-tile summary")
    parser.add_argument("--num-samples", type=int, default=50_000,
                        help="anchor-mh: sweeps a chain")
    parser.add_argument("--burnin", type=int, default=30_000,
                        help="anchor-mh: burn-in sweeps")
    parser.add_argument("--reps", type=int, default=4,
                        help="anchor-mh: chains an image, pooled")
    parser.add_argument("--top", type=int, default=8,
                        help="anchor-mh: images of highest acceptance")
    parser.add_argument("--port-seeds", type=int, nargs="*", default=[],
                        help="anchor-mh: the port's runs on the top images")
    args = parser.parse_args()
    {"kernels": kernels, "kernels-port": kernels_port,
     "singletile": singletile, "pmf-spread": pmf_spread,
     "simulator-ks": simulator_ks, "anchor-mh": anchor_mh}[args.study](args)


if __name__ == "__main__":
    main()
