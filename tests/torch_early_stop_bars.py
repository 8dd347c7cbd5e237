"""The ``sqjumpdist_tol`` early stop: the JAX runner against the port's
plain path on the same tiles.

Both runners run the ``basic`` suite's first ``--num-images`` tiles (the
port's ``simulate_tiles``, staged as each runner's ``tiles.npz``) with
``kernel.sqjumpdist_tol`` set, at ``--num-catalogs`` catalogs per stratum,
once per ``--seeds`` value: the JAX runner (``smcdet_tpu.runner``) and the
port's (``smcdet_tpu_torch.runner``, ``device="cpu"``: the plain sweep).
Each run reports the tiles' final temperatures, the SMC iterations and the
sweeps of each mutation. The JAX sweeps are counted by host callbacks in
``SingleComponentMH.sweep`` and after ``_run_sweeps_early_stop`` (the
early-stop loop itself is JAX's), the port's by wrapping
``inference.kernels.early_stop_sweeps``. The port's figures are set
beside the JAX seeds' range (how many lie inside it):

    JAX_PLATFORMS=cpu python tests/torch_early_stop_bars.py \\
        --num-images 20 --num-catalogs 512 --seeds 0 1 2 3 4 5 6 7

``--history 12`` prints instead the mean temperature of the first 12 SMC
iterations per seed under both packages' ``run_csmc``, ``--levels 0.5
1.0`` the statistic and the acceptance a sweep at equilibrium at those
temperatures, from the same catalogs, and ``--turn [--turn-keys K]`` the
statistic sweep by sweep through the turning mutation and the one before
it, from each seed's JAX state, under both packages (``turn_statistic``).

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
sys.path.insert(0, str(Path(__file__).resolve().parent))

CONFIG = "experiments/basic/config.yaml"
# the JAX runs' sweeps: a count since the last mutation, and per mutation
_JAX_SWEEPS = [0, []]


def _bump():
    _JAX_SWEEPS[0] += 1


def _mutation_done():
    _JAX_SWEEPS[1].append(_JAX_SWEEPS[0])
    _JAX_SWEEPS[0] = 0


def _configure(cfg, args, seed, out):
    cfg.seed = seed
    cfg.num_images = cfg.batch_size = args.num_images
    cfg.sampler.num_catalogs = args.num_catalogs
    cfg.kernel.sqjumpdist_tol = args.tol
    cfg.output_dir = out
    cfg.data_path = None
    stage = Path(out) / cfg.name
    stage.mkdir(parents=True, exist_ok=True)
    return stage


def _summary(res, sweeps):
    """``sweeps``: the sweeps of each mutation, in order."""
    return {"temperature": np.asarray(res["temperature"]).ravel().tolist(),
            "mean_temperature": float(np.mean(res["temperature"])),
            "num_iters": int(np.asarray(res["num_iters"]).ravel()[0]),
            "sweeps_per_mutation": float(np.mean(sweeps)),
            "sweeps": [int(n) for n in sweeps]}


def run_jax(args, tiles, seed):
    import jax

    from smcdet_tpu import config as jcfg
    from smcdet_tpu import runner as jrunner
    from smcdet_tpu.inference import kernels as jk

    # one counter for the process: the jitted program is traced once and
    # reused by later seeds, callbacks and all
    _JAX_SWEEPS[:] = [0, []]
    sweep, early = jk.SingleComponentMH.sweep, jk._run_sweeps_early_stop

    def counted(self, key, ctx, counts, state):
        out = sweep(self, key, ctx, counts, state)
        jax.debug.callback(_bump, ordered=True)
        return out

    def mutation(*args):
        out = early(*args)
        jax.debug.callback(_mutation_done, ordered=True)
        return out

    jk.SingleComponentMH.sweep = counted
    jk._run_sweeps_early_stop = mutation
    try:
        cfg = jcfg.load_config(CONFIG)
        with tempfile.TemporaryDirectory() as tmp:
            stage = _configure(cfg, args, seed, tmp)
            np.savez(stage / "tiles.npz", **tiles)
            jrunner.run_experiment(cfg, verbose=False)
            res = jrunner.load_results(stage)
    finally:
        jk.SingleComponentMH.sweep = sweep
        jk._run_sweeps_early_stop = early
    return _summary(res, _JAX_SWEEPS[1])


def run_port(args, tiles, seed):
    import torch

    from smcdet_tpu_torch import config as tcfg
    from smcdet_tpu_torch import runner as trunner
    from smcdet_tpu_torch.inference import kernels as tk

    torch.set_num_threads(args.threads)
    counts = []
    early = tk.early_stop_sweeps

    def counted(*a, **kw):
        out = early(*a, **kw)
        counts.append(out[2])
        return out

    tk.early_stop_sweeps = counted
    try:
        cfg = tcfg.load_config(CONFIG)
        with tempfile.TemporaryDirectory() as tmp:
            stage = _configure(cfg, args, seed, tmp)
            np.savez(stage / "tiles.npz", **tiles)
            trunner.run_experiment(cfg, device="cpu", verbose=False)
            res = trunner.load_results(stage)
    finally:
        tk.early_stop_sweeps = early
    return _summary(res, counts)


def _objects(args, tiles):
    """Both packages' prior, model and MH kernel from the config, the
    tiles, and the JAX and port ``SMCConfig`` at ``--history`` iterations
    with the history recorded."""
    import torch

    from smcdet_tpu import config as jcfg
    from smcdet_tpu.inference import smc as jsmc
    from smcdet_tpu_torch import config as tcfg
    from smcdet_tpu_torch.inference import smc as tsmc

    jc, pc = jcfg.load_config(CONFIG), tcfg.load_config(CONFIG)
    for c in (jc, pc):
        c.kernel.sqjumpdist_tol = args.tol
    s = jc.sampler
    kw = dict(num_catalogs=args.num_catalogs,
              ess_threshold_prop=s.ess_threshold_prop,
              resample_method=s.resample_method,
              max_smc_iters=args.history,
              flux_detection_threshold=s.flux_detection_threshold,
              record_history=True)
    return ((jcfg.build_prior(jc.prior), jcfg.build_image_model(
                jc.image_model), jcfg.build_kernel(jc.kernel),
             jsmc.SMCConfig(**kw)),
            (tcfg.build_prior(pc.prior, "cpu"),
             tcfg.build_image_model(pc.image_model, "cpu"),
             tcfg.build_kernel(pc.kernel, "cpu"), tsmc.SMCConfig(**kw)),
            torch.as_tensor(tiles["images"]))


def temperature_history(args, tiles):
    """The tiles' mean temperature after each of the first ``--history``
    SMC iterations, per seed, under JAX's ``run_csmc`` and the port's."""
    import jax
    import torch

    from smcdet_tpu.inference import smc as jsmc
    from smcdet_tpu_torch.inference import smc as tsmc

    torch.set_num_threads(args.threads)
    jax_side, port_side, images = _objects(args, tiles)
    run = jax.jit(jsmc.run_csmc, static_argnums=5)
    for seed in args.seeds:
        j = run(jax.random.key(seed), images.numpy(), *jax_side)
        t = tsmc.run_csmc(torch.Generator().manual_seed(seed), images,
                          *port_side)
        for side, h in (("jax", np.asarray(j.history["temperature"])),
                        ("torch", t.history["temperature"].numpy())):
            print(f"{side} seed {seed}: mean temperature by iteration "
                  f"{h.mean(1, dtype=np.float64).round(4).tolist()}",
                  flush=True)


def statistic_levels(args, tiles, sweeps=40, keys=4):
    """The squared-jump statistic and the acceptance a sweep at
    equilibrium, temperature fixed at each of ``--levels``: JAX's
    ``SingleComponentMH.sweep`` and the port's one-sweep plain run, from
    the same catalogs (JAX's prior draw burnt in 80 sweeps), ``keys`` runs
    of ``sweeps`` sweeps each."""
    import copy

    import jax
    import jax.numpy as jnp
    import torch
    from torch_parity import port_kernel, port_model, port_prior, t

    from smcdet_tpu.inference import kernels as jk
    from smcdet_tpu_torch.inference import kernels as tk

    torch.set_num_threads(args.threads)
    (prior, model, kernel, _), _, images = _objects(args, tiles)
    T, C, N = images.shape[0], prior.num_counts, args.num_catalogs
    strata, locs, fluxes = jax.jit(
        lambda k: prior.sample_stratified(k, N, (T,)))(jax.random.key(0))
    counts = jnp.broadcast_to(strata[None, :, None], (T, C, N))
    for temp in args.levels:
        ctx = jk.TargetContext(prior=prior, model=model,
                               image=jnp.asarray(images.numpy())[:, None,
                                                                 None],
                               temperature=jnp.full((T, 1, 1), temp))

        @jax.jit
        def run(key, st, ctx=ctx):
            def body(st, k):
                new, acc = kernel.sweep(k, ctx, counts, st)
                return new, (((new.locs - st.locs) ** 2).sum((-1, -2))
                             .mean(), acc.astype(jnp.float32).mean())
            return jax.lax.scan(body, st, jax.random.split(key, sweeps))

        st = jk.init_kernel_state(ctx, counts, locs, fluxes)
        for k in (1, 2):
            st, _ = run(jax.random.key(k), st)
        out = {"jax": [run(jax.random.key(10 + r), st)[1]
                       for r in range(keys)]}
        pctx = tk.TargetContext(port_prior(prior), port_model(model),
                                t(ctx.image), t(ctx.temperature))
        pcounts = t(counts, torch.int32)
        one = copy.copy(port_kernel(kernel, backend="torch"))
        one.num_iters, one.sqjumpdist_tol = 1, None
        out["torch"] = []
        for r in range(keys):
            g = torch.Generator().manual_seed(100 + r)
            pst = tk.init_kernel_state(pctx, pcounts, t(st.locs),
                                       t(st.fluxes))
            sq, ac = [], []
            for _ in range(sweeps):
                new, acc = one.run_from_state(g, pctx, pcounts, pst)
                sq.append(float(((new.locs - pst.locs) ** 2)
                                .sum((-1, -2)).mean()))
                ac.append(float(acc.mean()))
                pst = new
            out["torch"].append((sq, ac))
        for side, runs in out.items():
            sq = np.mean([np.asarray(a) for a, _ in runs])
            ac = np.mean([np.asarray(b) for _, b in runs])
            print(f"{side} temperature {temp}: statistic {sq:.5f} a sweep, "
                  f"acceptance {ac:.5f}", flush=True)


def _first_below(stat, tol):
    """The sweeps the early stop runs on a statistic trajectory: through
    the first sweep whose statistic falls below ``tol`` (all of them if
    none does)."""
    below = np.flatnonzero(~(np.asarray(stat) >= tol))
    return int(below[0]) + 1 if below.size else len(stat)


def turn_statistic(args, tiles, sweeps=100):
    """The squared-jump statistic sweep by sweep through the turning
    mutation: the first mutation whose early stop ends before
    ``num_iters``. For each of ``--seeds`` the JAX package's ``csmc_init``
    and ``csmc_step`` run to that mutation (located by replaying each
    mutation's sweeps on the step's own keys), and its input (JAX's
    resampled catalogs, re-rendered, at the state's temperatures) is the
    start of ``--turn-keys`` trajectories of ``sweeps`` sweeps each under
    JAX's ``SingleComponentMH.sweep`` (keys ``fold_in(key, i)``, as
    ``_run_sweeps_early_stop``) and under the port's one-sweep plain run
    (a fresh key a sweep from a ``torch.Generator``, as
    ``early_stop_sweeps``), none stopped. Prints per seed the sweeps each
    trajectory would run before the stop, the mean statistic at chosen
    sweeps, and the pooled first-passage counts of both packages."""
    import copy
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch
    from scipy.stats import mannwhitneyu
    from torch_parity import port_kernel, port_model, port_prior, t

    from smcdet_tpu.inference import kernels as jk
    from smcdet_tpu.inference import smc as jsmc
    from smcdet_tpu.ops.resampling import gather_particles, resample_indices
    from smcdet_tpu_torch.inference import kernels as tk

    torch.set_num_threads(args.threads)
    (prior, model, kernel, cfg), _, images = _objects(args, tiles)
    cfg = dataclasses.replace(cfg, max_smc_iters=100, record_history=False)
    imgs = jnp.asarray(images.numpy())
    T, C, N = imgs.shape[0], prior.num_counts, args.num_catalogs
    counts = jnp.broadcast_to(jsmc._strata(prior)[None, :, None], (T, C, N))
    tol = args.tol

    @jax.jit
    def mutation_input(state):
        # csmc_step's resample and re-render, on the step's own keys
        _, k_res, k_mut = jax.random.split(state.key, 3)
        keep = (state.temperature >= 1.0)[:, None, None]
        idx = resample_indices(k_res, state.weights, N, cfg.resample_method)
        locs, fluxes = gather_particles(idx, state.locs, state.fluxes,
                                        particle_axis=2)
        locs = jnp.where(keep[..., None, None], state.locs, locs)
        fluxes = jnp.where(keep[..., None], state.fluxes, fluxes)
        ctx = jk.TargetContext(prior=prior, model=model,
                               image=imgs[:, None, None],
                               temperature=state.temperature[:, None, None])
        return k_mut, ctx, jk.init_kernel_state(ctx, counts, locs, fluxes)

    @jax.jit
    def trajectory(key, ctx, st):
        def body(st, i):
            new, _ = kernel.sweep(jax.random.fold_in(key, i), ctx, counts,
                                  st)
            return new, ((new.locs - st.locs) ** 2).sum((-1, -2)).mean()
        return jax.lax.scan(body, st, jnp.arange(sweeps))[1]

    step = jax.jit(lambda st: jsmc.csmc_step(imgs, prior, model, kernel,
                                             cfg, st))
    one = copy.copy(port_kernel(kernel, backend="torch"))
    one.num_iters, one.sqjumpdist_tol = 1, None
    marks = [0, 1, 4, 9, 19, 49, sweeps - 1]
    pooled = {}
    for seed in args.seeds:
        state = jax.jit(lambda k: jsmc.csmc_init(k, imgs, prior, model,
                                                 cfg))(jax.random.key(seed))
        capped, before = 0, None
        while True:
            k_mut, ctx, kin = mutation_input(state)
            n = _first_below(trajectory(k_mut, ctx, kin), tol)
            if n < kernel.num_iters:
                break
            capped += 1
            before = (ctx, kin)
            state = step(state)
        temps = np.asarray(state.temperature)
        print(f"seed {seed}: the turn is mutation {capped + 1} (the JAX "
              f"run's own keys stop it after {n} sweeps); temperatures "
              f"mean {temps.mean():.4f}, min {temps.min():.4f}, "
              f"{int((temps >= 1).sum())}/{T} at 1", flush=True)
        for label, start in (("the last capped mutation", before),
                             ("the turning mutation", (ctx, kin))):
            if start is None:
                continue
            c, k = start
            runs = {"jax": [np.asarray(trajectory(
                jax.random.key(1000 + r), c, k)) for r in
                range(args.turn_keys)]}
            pctx = tk.TargetContext(port_prior(prior), port_model(model),
                                    t(c.image), t(c.temperature))
            pcounts = t(counts, torch.int32)
            runs["torch"] = []
            for r in range(args.turn_keys):
                g = torch.Generator().manual_seed(2000 + r)
                pst = tk.init_kernel_state(pctx, pcounts, t(k.locs),
                                           t(k.fluxes))
                stat = []
                for _ in range(sweeps):
                    new, _ = one.run_from_state(g, pctx, pcounts, pst)
                    stat.append(float(((new.locs - pst.locs) ** 2)
                                      .sum((-1, -2)).mean()))
                    pst = new
                runs["torch"].append(np.asarray(stat))
            for side, trajs in runs.items():
                first = [_first_below(x, tol) for x in trajs]
                pooled.setdefault((label, side), []).extend(first)
                mean = np.mean(trajs, axis=0)
                sd = float(np.mean([np.std(x[10:]) for x in trajs]))
                print(f"seed {seed} {label} {side}: sweeps before the stop "
                      f"{first} (mean {np.mean(first):.2f}); mean statistic "
                      f"at sweeps "
                      + ", ".join(f"{i + 1}: {mean[i]:.5f}" for i in marks)
                      + f"; its sd over sweeps 11-{sweeps} {sd:.3e}; share "
                      f"of sweeps below {tol}: "
                      f"{float(np.mean(np.asarray(trajs) < tol)):.4f}",
                      flush=True)
    for label in ("the last capped mutation", "the turning mutation"):
        a, b = pooled.get((label, "jax")), pooled.get((label, "torch"))
        if not a:
            continue
        p = mannwhitneyu(a, b).pvalue if len(set(a + b)) > 1 else 1.0
        print(f"{label}, pooled over the seeds x {args.turn_keys} keys: jax "
              f"mean {np.mean(a):.3f}, torch mean {np.mean(b):.3f} sweeps "
              f"before the stop; Mann-Whitney p {p:.4g}", flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-images", type=int, default=8)
    parser.add_argument("--num-catalogs", type=int, default=128)
    parser.add_argument("--tol", type=float, default=1e-2)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--history", type=int, default=0,
                        help="instead: the mean temperature of the first "
                             "HISTORY iterations per seed")
    parser.add_argument("--levels", type=float, nargs="*", default=[],
                        help="instead: the statistic and acceptance a "
                             "sweep at equilibrium at these temperatures")
    parser.add_argument("--turn", action="store_true",
                        help="instead: the statistic sweep by sweep "
                             "through the turning mutation, from each "
                             "seed's JAX state, under both packages")
    parser.add_argument("--turn-keys", type=int, default=8,
                        help="with --turn: trajectories per package and "
                             "seed")
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from smcdet_tpu_torch.run_experiment import load_suite_config
    from smcdet_tpu_torch.runner import simulate_tiles

    pcfg = load_suite_config(CONFIG)
    pcfg.num_images = args.num_images
    tiles = simulate_tiles(pcfg)
    print(f"true pruned counts {tiles['true_counts'].tolist()}", flush=True)
    if args.history:
        return temperature_history(args, tiles)
    if args.levels:
        return statistic_levels(args, tiles)
    if args.turn:
        return turn_statistic(args, tiles)
    report = {}
    for side, run in (("jax", run_jax), ("torch", run_port)):
        report[side] = {}
        for seed in args.seeds:
            start = time.perf_counter()
            entry = run(args, tiles, seed)
            entry["wall_s"] = round(time.perf_counter() - start, 1)
            report[side][seed] = entry
            print(f"{side} seed {seed}: {json.dumps(entry)}", flush=True)
    for key in ("mean_temperature", "num_iters", "sweeps_per_mutation"):
        ref = [e[key] for e in report["jax"].values()]
        got = [e[key] for e in report["torch"].values()]
        inside = sum(min(ref) <= g <= max(ref) for g in got)
        print(f"{key}: jax {ref} (mean {np.mean(ref):.4g}), torch {got} "
              f"(mean {np.mean(got):.4g}): {inside}/{len(got)} inside the "
              f"JAX seeds' range [{min(ref):.4g}, {max(ref):.4g}]")
    print(json.dumps({"config": CONFIG, "num_images": args.num_images,
                      "num_catalogs": args.num_catalogs, "tol": args.tol,
                      "report": report}))


if __name__ == "__main__":
    main()
