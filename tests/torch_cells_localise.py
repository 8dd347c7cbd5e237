"""The JAX runner and the port's runner on the same cells tiles at the same
configuration, both on the CPU, scored alike: is a gap between the port's
suite score and the JAX package's committed one the port's, or the tiles'?

    JAX_PLATFORMS=cpu python tests/torch_cells_localise.py \\
        [--config experiments/cells/config.yaml] [--num-images 200] \\
        [--set sampler.num_catalogs=256 kernel.num_iters=50] \\
        [--out DIR] [--only jax|torch] [--device cpu|cuda] [--plain]
        [--tiles PATH]

It simulates the suite's first ``--num-images`` tiles with the port's
``simulate_tiles`` (the tiles the port's suite run scores), or takes them
from ``--tiles`` (e.g. the JAX package's draw in ``tests/data``), runs the JAX
runner (``smcdet_tpu.runner.run_experiment``, on the CPU) and the port's
(``smcdet_tpu_torch.runner.run_experiment`` on ``--device``: ``cpu`` runs
the kernels' plain versions) on them with the overrides given, and prints
for each the
count accuracy, the confusion asymmetry, the total-flux coverage at every
level (images with a true star) and the SBC p-value, computed by the same
functions (``smcdet_tpu_torch.validation``). Results are kept under
``--out`` (one directory per runner); a finished batch is skipped, so a
cut run resumes. It imports both packages, as the parity tests do;
``--only torch`` imports no JAX, so that side runs on a machine without it.
``--plain`` runs the port's MH sweeps through their plain PyTorch version
(``backend="torch"``) on any device, to tell the kernel from the rest of
the port. Each runner's per-image posterior count pmf, mean total flux,
log Z per stratum and acceptance go to ``<out>/<runner>_summary.npz``
(small enough to copy off the card).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1])]

from torch_reference_bars import _override  # noqa: E402

COVERAGE_LEVELS = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95]


def score(res, tiles):
    """Count accuracy, asymmetry, coverage and SBC p of ``res`` against the
    truth in ``tiles`` (the analyzers' definitions)."""
    from smcdet_tpu_torch.validation import (
        confusion_asymmetry,
        count_confusion_matrix,
        credible_interval_coverage,
        sbc_ranks,
        sbc_uniformity_pvalue,
    )

    n = res["counts"].shape[0]
    tc = tiles["true_counts"][:n]
    tf = tiles["true_fluxes"][:n].sum(-1)
    w = res["weights"]
    M = count_confusion_matrix(tc, res["pruned_counts"], weights=w)
    ef = res["pruned_fluxes"].sum(-1)
    nz = tc > 0
    cov = credible_interval_coverage(tf[nz], ef[nz], COVERAGE_LEVELS,
                                     weights=w[nz])
    return {"images": int(n), "with_stars": int(nz.sum()),
            "count_accuracy": round(float(np.trace(M)), 4),
            "confusion_asymmetry": round(confusion_asymmetry(M), 4),
            "coverage": {str(k): round(float(c), 4)
                         for k, c in zip(COVERAGE_LEVELS, cov)},
            "sbc_total_flux_ks_pvalue": round(sbc_uniformity_pvalue(
                sbc_ranks(tf, ef, weights=w)), 5),
            # the per-image pipeline's results carry neither
            **({"num_iters": np.asarray(res["num_iters"]).ravel().tolist(),
                "acc_rate_mean": float(np.mean(res["acc_rate"]))}
               if "num_iters" in res else {})}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", default="experiments/cells/config.yaml")
    parser.add_argument("--num-images", type=int, default=200)
    parser.add_argument("--set", nargs="*", default=[],
                        help="overrides such as sampler.num_catalogs=256")
    parser.add_argument("--out", default="output/cells_localise")
    parser.add_argument("--only", choices=["jax", "torch"], default=None,
                        help="run and score one runner only")
    parser.add_argument("--device", default="cpu",
                        help="the port's device (default cpu)")
    parser.add_argument("--plain", action="store_true",
                        help="the port's plain MH sweep, not the kernel")
    parser.add_argument("--tiles", default=None,
                        help="run on these tiles instead of the port's "
                             "simulation")
    args = parser.parse_args()

    from smcdet_tpu_torch import config as tcfg
    from smcdet_tpu_torch import runner as trunner

    if args.plain:
        build = trunner.build_kernel

        def plain_kernel(cfg, device):
            kernel = build(cfg, device)
            kernel.backend = "torch"
            return kernel

        trunner.build_kernel = plain_kernel

    def jax_side():
        import jax

        jax.config.update("jax_platforms", "cpu")
        from smcdet_tpu import config as jcfg
        from smcdet_tpu import runner as jrunner

        return jcfg, jrunner

    out = Path(args.out)
    pcfg = tcfg.load_config(args.config)
    pcfg.num_images = args.num_images
    out.mkdir(parents=True, exist_ok=True)
    tiles_path = out / "tiles.npz"
    if args.tiles is not None:
        with np.load(args.tiles) as t:
            np.savez(tiles_path, **{k: t[k][:args.num_images]
                                    for k in t.files})
    elif not tiles_path.exists():
        np.savez(tiles_path, **trunner.simulate_tiles(pcfg))
    tiles = dict(np.load(tiles_path))

    report = {"config": args.config, "set": args.set,
              "num_images": args.num_images}
    for name in ("jax", "torch"):
        if args.only not in (None, name):
            continue
        cfg_mod, runner = jax_side() if name == "jax" else (tcfg, trunner)
        cfg = cfg_mod.load_config(args.config)
        for a in args.set:
            _override(cfg, a)
        cfg.num_images = args.num_images
        cfg.output_dir = str(out / name)
        cfg.data_path = str(tiles_path)
        res_dir = out / name / cfg.name
        start = time.perf_counter()
        kw = {"device": args.device} if name == "torch" else {}
        runner.run_experiment(cfg, verbose=True, **kw)
        print(f"[{name}] runner wall {time.perf_counter() - start:.1f} s",
              flush=True)
        res = trunner.load_results(res_dir)
        report[name] = score(res, tiles)
        onehot = res["pruned_counts"][..., None] == np.arange(
            cfg.prior.max_objects + 1)
        np.savez(out / f"{name}_summary.npz",
                 count_pmf=(res["weights"][..., None] * onehot).sum(1),
                 mean_total_flux=(res["weights"]
                                  * res["pruned_fluxes"].sum(-1)).sum(1),
                 log_z=res["log_normalizing_constant"],
                 **{k: res[k] for k in ("acc_rate",) if k in res})
        print(f"[{name}] {json.dumps(report[name])}", flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
