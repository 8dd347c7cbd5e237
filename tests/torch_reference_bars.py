"""The JAX runner's detection and convergence shares on the port's tiles.

``chip_smoke.py`` holds each suite batch the port runs on the card to the
share the JAX reference (``smcdet_tpu.runner.run_experiment``) reaches on
the CPU on the same tiles. This script computes those bars: it simulates the
suite's first ``--num-images`` tiles with the port's ``simulate_tiles`` (the
suite's own seed), or for an m71semisynthetic suite renders them with the
port's generate step on the CPU (``semisynthetic.render_tiles``, the
padded catalogs; the same tiles the card renders), stages them as the
JAX runner's ``tiles.npz`` and runs the JAX runner on them once per
``--seeds`` value, with the overrides given.

    JAX_PLATFORMS=cpu python tests/torch_reference_bars.py \\
        experiments/basic/config.yaml --num-images 20 --seeds 0 1 \\
        --set kernel.kind=mala kernel.locs_stdev=0.05 \\
        kernel.fluxes_stdev=20.0

With the config ``bench`` it runs the JAX package's own bench instead:
``bench.py``'s ``build_problem`` (its tiles, ``generate_images`` with key 7)
through ``run_csmc`` on the tiles sorted by summed pixel value, in chunks of
``BENCH_CHUNK`` (the last one padded with the last tile), with
``jax.random.key(seed + c)`` for chunk c (the bar of ``chip_smoke.py
[bench]``):

    JAX_PLATFORMS=cpu python tests/torch_reference_bars.py bench \
        --num-images 16 --seeds 1 2

``--tiles`` runs the first ``--num-images`` images of a tiles file
instead, such as the 32x32 divideandconquer draw (configs from
``smcdet_tpu_torch.studies.dnc_grid``):

    JAX_PLATFORMS=cpu python tests/torch_reference_bars.py \
        /tmp/dnc4/config.yaml --num-images 8 --seeds 5 \
        --tiles tests/data/divideandconquer32_tiles.npz

For each seed it prints the share of images whose posterior-mean pruned
count lies within +-1 of the true pruned count, the mean acceptance rate
(``acc_rate``) and the SMC iterations of each batch (``num_iters``) and, for
an aggregation suite, each image's bridge iterations, final temperatures
and last bridge iteration's mean acceptance per level.
It imports both packages, as the parity tests do.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _override(cfg, assignment: str):
    path, value = assignment.split("=", 1)
    *parents, leaf = path.split(".")
    obj = cfg
    for p in parents:
        obj = getattr(obj, p)
    old = getattr(obj, leaf)
    if isinstance(old, bool):
        value = value.lower() in ("1", "true", "yes")
    elif isinstance(old, int):
        value = int(value)
    elif isinstance(old, float):
        value = float(value)
    setattr(obj, leaf, value)


# tiles a run_csmc call, as bench.py's --quick
BENCH_CHUNK = 16


def bench_bars(args):
    """The JAX package's bench problem at ``--num-images`` tiles, sorted by
    summed pixel value and run in chunks of ``BENCH_CHUNK`` (padded with
    the last tile), once per seed."""
    import jax
    import jax.numpy as jnp

    import bench
    from smcdet_tpu.inference.smc import run_csmc
    from smcdet_tpu.models.simulate import generate_images

    n = args.num_images
    images, prior, model, kernel, cfg = bench.build_problem(num_tiles=n)
    truth = np.asarray(generate_images(
        jax.random.key(7), prior, model, flux_threshold=0.7,
        loc_threshold_lower=0.0, loc_threshold_upper=float(model.width),
        num_images=n).pruned_counts)
    print(f"true pruned counts {truth.tolist()}", flush=True)
    order = np.argsort(np.asarray(jnp.sum(images, axis=(1, 2))),
                       kind="stable")
    chunk = BENCH_CHUNK
    n_chunks = -(-n // chunk)
    padded = np.concatenate([order, np.full(n_chunks * chunk - n,
                                            order[-1])])
    run = jax.jit(run_csmc)
    report = {}
    for seed in args.seeds:
        start = time.perf_counter()
        mean, iters = np.zeros(n), []
        for c in range(n_chunks):
            idx = padded[c * chunk:(c + 1) * chunk]
            res = run(jax.random.key(seed + c), images[idx], prior, model,
                      kernel, cfg)
            m = np.asarray((res.weights * res.pruned_counts).sum(-1))
            assert np.all(np.asarray(res.temperature) == 1.0)
            real = min(chunk, n - c * chunk)
            mean[idx[:real]] = m[:real]
            iters.append(int(res.num_iters))
        within = np.abs(mean - truth) <= 1.0
        entry = {"count_share": float(within.mean()),
                 "within": int(within.sum()),
                 "mean": [round(float(x), 3) for x in mean],
                 "num_iters": iters,
                 "wall_s": round(time.perf_counter() - start, 1)}
        report[seed] = entry
        print(f"seed {seed}: {json.dumps(entry)}", flush=True)
    print(json.dumps({"config": "bench", "num_images": n, "chunk": chunk,
                      "truth": truth.tolist(), "seeds": report}))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--num-images", type=int, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--set", nargs="*", default=[],
                        help="overrides such as kernel.kind=mala")
    parser.add_argument("--tiles", default=None,
                        help="run on the first --num-images images of this "
                             "tiles.npz instead of simulating them")
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.config == "bench":
        bench_bars(args)
        return
    from smcdet_tpu import config as jcfg
    from smcdet_tpu import runner as jrunner
    from smcdet_tpu.inference.aggregate import Aggregate
    from smcdet_tpu_torch import semisynthetic
    from smcdet_tpu_torch.run_experiment import load_suite_config
    from smcdet_tpu_torch.runner import simulate_tiles

    pcfg = load_suite_config(args.config)
    pcfg.num_images = args.num_images
    if args.tiles is not None:
        with np.load(args.tiles) as t:
            tiles = {k: t[k][:args.num_images] for k in t.files}
    elif semisynthetic.renders_fixture(pcfg):
        tiles = semisynthetic.render_tiles(pcfg, "padded", args.num_images,
                                           device="cpu")
    else:
        tiles = simulate_tiles(pcfg)
    truth = tiles["true_counts"]
    print(f"true pruned counts {truth.tolist()}", flush=True)

    levels = []
    run = Aggregate.run

    def recorded(agg, *a, **kw):
        out = run(agg, *a, **kw)
        levels.append([(int(d["iterations"]),
                        np.asarray(d["temperature"]).ravel().tolist(),
                        round(float(np.mean(d["acc_rate"])), 4))
                       for d in agg.diagnostics])
        return out

    Aggregate.run = recorded
    report = {}
    for seed in args.seeds:
        cfg = jcfg.load_config(args.config)
        for a in args.set:
            _override(cfg, a)
        cfg.seed = seed
        cfg.num_images = args.num_images
        cfg.batch_size = min(cfg.batch_size, args.num_images)
        levels.clear()
        with tempfile.TemporaryDirectory() as tmp:
            cfg.output_dir = tmp
            cfg.data_path = None
            stage = Path(tmp) / cfg.name
            stage.mkdir(parents=True)
            np.savez(stage / "tiles.npz", **tiles)
            start = time.perf_counter()
            jrunner.run_experiment(cfg, verbose=False)
            wall = time.perf_counter() - start
            res = jrunner.load_results(stage)
        mean = (res["weights"] * res["pruned_counts"]).sum(-1)
        within = np.abs(mean - truth) <= 1.0
        entry = {"count_share": float(within.mean()),
                 "mean": [round(float(x), 3) for x in mean],
                 "wall_s": round(wall, 1)}
        for key in ("acc_rate", "num_iters"):
            if key in res:
                values = np.asarray(res[key]).ravel()
                entry[key] = (float(values.mean()) if key == "acc_rate"
                              else values.tolist())
        if cfg.aggregation.enabled:
            # a replicate's aggregation runs once untimed to warm the jit
            per_image = levels[-args.num_images:]
            cap = cfg.aggregation.max_smc_iters
            ok = [all(it < cap and all(x == 1.0 for x in t)
                      for it, t, _ in lv) for lv in per_image]
            entry["converged_share"] = float(np.mean(ok))
            entry["levels"] = per_image
        report[seed] = entry
        print(f"seed {seed}: {json.dumps(entry)}", flush=True)
    print(json.dumps({"config": args.config, "set": args.set,
                      "num_images": args.num_images, "truth": truth.tolist(),
                      "seeds": report}))


if __name__ == "__main__":
    main()
