"""The sweep kernels as they stand against an earlier checkout's, on the card,
in one process.

    python3 tests/torch_kernel_compare.py --parent DIR --kernel K1 K4 \\
        [--end-to-end]

``DIR`` holds an earlier checkout of the repository (``git archive`` of a
commit unpacked into a directory that ``.gitignore`` lists, such as
``.scratch/parent``), or a copy of this one with a constant changed (a
variant). ``--kernel`` names the kernels under comparison (K1 to K5, K2g,
K3g, K4g). The
script builds that checkout's kernel library with its own ``_build.py`` and
this checkout's library, both at once, and runs each library through its
own checkout's wrappers (``ops/mh_sweep.py`` and ``ops/mala_sweep.py``, with
their plain versions), everything else from this checkout. Then it prints:

- each build's registers and spills of the named kernels' instantiations
  (``nvcc -Xptxas -v``);
- from ``cuobjdump -sass``: whether every kernel not named has the same
  machine code in both checkouts (the script fails if one differs), and for
  each build the named kernels' instruction counts: the whole kernel, its
  largest loop and the largest loop inside that, the largest loop's most
  frequent opcodes and its FCHK, MUFU.RCP and CALL (``torch_sass.py``
  beside this script);
- each named kernel's time at the launch shapes of its paths (``SHAPES``),
  the libraries timed in turns (earlier, this checkout's, this checkout's,
  earlier), beside the bound at the data sheet's peaks and at K5's measured
  ones, with each library's blocks and waves per launch and its share of
  particles that agree with its plain version after 20 same-stream sweeps
  (``chip_smoke.launch_agreement``);
- with ``--end-to-end``: the paths of the named kernels (``END_TO_END``)
  under the earlier library and this checkout's (earlier, this, this,
  earlier; the cells batch earlier, this); K2g's, K3g's and K4g's are one
  image of chip_smoke.py's ``[dnc4]``: through the single 32x32 tile, cut
  to ``DNC4_SINGLE_ITERS`` SMC iterations, and through the 4x4 tree under
  MH and under MALA;
- with ``--dnc-seeds S ...``: chip_smoke.py's batch of 4 divideandconquer
  images (the images of the config's seed) with the sampler seeded by each
  S, under MH if K1 or K3 is named and under MALA if K4 is, under both
  libraries: per seed, how many images converge and how many put the
  posterior mean pruned count within +-1 of the truth. One seed is one
  realisation of the sampler; the seeds show its spread.

It needs a CUDA card, nvcc and cuobjdump.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KERNELS = ("K1", "K2", "K3", "K4", "K5", "K2g", "K3g", "K4g")
# The launch shapes each kernel is timed at: the paths whose launches
# chip_smoke.py's [paths] counts (K5, the chains, has none); K2g's, K3g's
# and K4g's are the first launches of one [dnc4] image (dnc4_captures; K4g
# at level 3 at the MH run's state where the MALA run launched nothing
# there, and on the single tile's first groups at its MH state, as
# chip_smoke.py's [dnc4])
SHAPES = {
    "K1": ("quick cell", "divideandconquer tile"),
    "K2": ("cells", "basic"),
    "K3": ("bridge level 0", "bridge level 1"),
    "K4": ("basic under MALA", "divideandconquer tile under MALA",
           "bridge level 0 under MALA", "bridge level 1 under MALA",
           "cells under MALA"),
    "K2g": ("dnc4 single tile", "off-path 16x16 tile"),
    "K3g": ("dnc4 bridge level 2", "dnc4 bridge level 3",
            "off-path 16x16 bridge"),
    "K4g": ("dnc4 bridge level 2 under MALA", "dnc4 bridge level 3 under MALA",
            "dnc4 single tile's first groups under MALA"),
}
# A class of K2g and K3g below those the paths launch (which keep their
# caches in registers): (height, width, slots), on [dnc4]'s model and prior
OFF_PATH = {"K2g": (16, 16, 24), "K3g": (16, 16, 48)}
# MALA's steps on the cells target (tests/test_torch_mala.py: _STEPS); no
# path runs cells under MALA, but it is K4's 16x16 tile target at a
# suite's launch shape
CELLS_MALA_STEPS = (0.05, 5.0)
# The paths run end to end for each kernel
END_TO_END = {
    "K1": ("quick cell", "divideandconquer image"),
    "K2": ("cells", "basic", "m71"),
    "K3": ("divideandconquer image",),
    "K4": ("basic under MALA", "divideandconquer image under MALA"),
    "K2g": ("dnc4 single tile run",),
    "K3g": ("dnc4 image",),
    "K4g": ("dnc4 image under MALA",),
}
# [dnc4]'s bridge levels 2 and 3: (height, width, slots)
DNC4_LEVELS = {2: (32, 16, 64), 3: (32, 32, 128)}
_OPS = ("mh_sweep", "mala_sweep")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="an earlier checkout of the repository")
    parser.add_argument("--kernel", nargs="+", required=True,
                        choices=KERNELS, help="the kernels to compare")
    parser.add_argument("--end-to-end", action="store_true")
    parser.add_argument("--dnc-seeds", nargs="*", type=int, default=[],
                        help="sampler seeds of the divideandconquer batch")
    return parser.parse_args(argv)


def _build_earlier(parent: Path) -> dict:
    """The earlier checkout's library, built by its own ``_build.py``."""
    code = ("import json; from smcdet_tpu_torch import _build; "
            "info = _build.build(); print(json.dumps({'path': "
            "str(info['path']), 'seconds': info['seconds'], "
            "'log': info['log']}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=parent,
                         env=dict(os.environ, PYTHONPATH=str(parent)),
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"the earlier build failed:\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def build_all(parent: Path) -> dict:
    """Both libraries, built at once: ``{name: {"path", "seconds",
    "log"}}``, names ``earlier`` and ``new``."""
    from smcdet_tpu_torch import _build

    jobs = {"earlier": functools.partial(_build_earlier, parent),
            "new": _build.build}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def _own_distributions(checkout: Path, tag: str):
    """The checkout's ``distributions.py`` as a module of its own, with this
    checkout's classes in place of its own (the priors are this
    checkout's, and the wrappers test their flux marks' classes), so that
    its truncated-normal functions, which its plain versions call, are
    its own."""
    import smcdet_tpu_torch.distributions as this

    spec = importlib.util.spec_from_file_location(
        f"{tag}_distributions", checkout / "smcdet_tpu_torch"
        / "distributions.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in vars(this).items():
        if isinstance(value, type) and hasattr(mod, name):
            setattr(mod, name, value)
    return mod


def load_wrappers(checkout: Path, tag: str) -> dict:
    """A checkout's kernel wrappers, ``{"mh_sweep": module, "mala_sweep":
    module}``: its ``ops/mh_sweep.py`` and ``ops/mala_sweep.py`` loaded
    from its files as modules of their own (``mala_sweep`` importing that
    checkout's ``mh_sweep``), both importing the checkout's own
    truncated-normal functions (``_own_distributions``); everything else
    they import comes from this checkout's package."""
    import smcdet_tpu_torch.distributions as this
    import smcdet_tpu_torch.ops as ops

    mods = {}
    saved = {name: getattr(ops, name) for name in _OPS}
    sys.modules["smcdet_tpu_torch.distributions"] = _own_distributions(
        checkout, tag)
    try:
        for name in _OPS:
            spec = importlib.util.spec_from_file_location(
                f"{tag}_{name}", checkout / "smcdet_tpu_torch" / "ops"
                / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            spec.loader.exec_module(mod)
            mods[name] = mod
            # the next module's imports of this one find this checkout's
            sys.modules[f"smcdet_tpu_torch.ops.{name}"] = mod
            setattr(ops, name, mod)
    finally:
        sys.modules["smcdet_tpu_torch.distributions"] = this
        for name, mod in saved.items():
            sys.modules[f"smcdet_tpu_torch.ops.{name}"] = mod
            setattr(ops, name, mod)
    return mods


def use_wrappers(mods: dict) -> None:
    """Route every later call through the wrappers ``mods``: the package's
    ``ops`` modules and the inference modules' references to them."""
    import smcdet_tpu_torch.inference.aggregate as aggregate
    import smcdet_tpu_torch.inference.kernels as kernels
    import smcdet_tpu_torch.ops as ops

    for name, mod in mods.items():
        sys.modules[f"smcdet_tpu_torch.ops.{name}"] = mod
        setattr(ops, name, mod)
        setattr(kernels, name, mod)
    aggregate.mh_sweep = mods["mh_sweep"]


def kernel_id(name):
    """``chip_smoke.kernel_id``, which also names K1 in a checkout that
    built it as the thread-per-particle ``mh_sweep_kernel``."""
    import chip_smoke as cs

    return "K1" if "mh_sweep_kernel" in name else cs.kernel_id(name)


def registers(log: str, label, kernel_id, kernels) -> dict:
    """``{kernel: [ptxas lines]}``: the registers and spills of the
    instantiations of ``kernels`` in an ``-Xptxas -v`` log."""
    out, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            kernel = label(line.split("'")[1])
        elif kernel and kernel_id(kernel) in kernels and (
                "registers" in line or "spill" in line):
            out.setdefault(kernel, []).append(line.strip())
    return out


def kernels_that_differ(earlier: dict, new: dict, asked, label,
                        kernel_id) -> list:
    """The kernel functions outside ``asked`` (K-ids) whose SASS is not the
    same in the two builds (``{name: body}`` each), or that one build
    lacks; a kernel whose id the earlier build has no function of (a kernel
    added since) is not among them."""
    added = ({kernel_id(label(n)) for n in new}
             - {kernel_id(label(n)) for n in earlier} - {None})
    return [name for name in sorted(set(earlier) | set(new))
            if kernel_id(label(name)) not in asked | added
            and earlier.get(name) != new.get(name)]


def compare_sass(builds: dict, asked, label, kernel_id) -> list:
    """Whether every kernel outside ``asked`` is identical in the earlier
    and the new library, and each library's counts of the asked kernels.
    Returns the kernels that differ."""
    import torch_sass as sass

    dumps = {name: sass.dump(info["path"]) for name, info in builds.items()}
    earlier, new = dumps["earlier"], dumps["new"]
    differ = kernels_that_differ(earlier, new, asked, label, kernel_id)
    for name in sorted(set(earlier) | set(new)):
        if kernel_id(label(name)) in asked:
            continue
        state = ("DIFFERENT from" if name in differ else "identical to"
                 if name in earlier else "added since")
        print(f"[sass] {label(name)}: "
              f"{sass.instructions(new.get(name, []))} instructions, "
              f"{state} the earlier build's")
    for lib, functions in dumps.items():
        for name in sorted(n for n in functions
                           if kernel_id(label(n)) in asked):
            body = functions[name]
            outer, inner = sass.loop_sizes(body)
            loops = sass.loops(body)
            mix = Counter()
            if loops:
                start, end, _ = loops[0]
                mix = Counter(line.split()[1] if line.startswith("@")
                              else line.split()[0]
                              for line in body[start:end + 1]
                              if not line.endswith(":"))
            slow = {op: sum(n for o, n in mix.items() if o.startswith(op))
                    for op in ("FCHK", "MUFU.RCP", "CALL")}
            print(f"[sass] {lib}: {kernel_id(label(name))} {label(name)}: "
                  f"{sass.instructions(body)} instructions; largest loop "
                  f"{outer}, the largest loop inside it {inner}; in the "
                  f"largest loop " + ", ".join(f"{op} {n}"
                                               for op, n in slow.items()))
            print(f"[sass] {lib}: {label(name)}: largest loop's opcodes "
                  + ", ".join(f"{op} {n}" for op, n in mix.most_common(16)))
    return differ


def _dnc4_configs(tmp: str, images: int) -> dict:
    """chip_smoke.py's ``[dnc4]`` configs under ``tmp``, with the first
    ``images`` of its images staged where they read them."""
    import numpy as np

    import chip_smoke as cs
    from smcdet_tpu_torch.studies.dnc_grid import derived_configs

    cfgs = derived_configs(f"{tmp}/configs", cs.DNC4_DIM, output_dir=tmp,
                           mala_steps=cs.MALA_DNC_STEPS)
    with np.load(cs.DNC4_TILES) as t:
        tiles = {k: t[k][:images] for k in t.files}
    staged = Path(tmp) / "divideandconquer" / "tiles.npz"
    staged.parent.mkdir(exist_ok=True)
    np.savez(staged, **tiles)
    return cfgs


def dnc4_run(dev, tmp, config: str, iters=None, capture=None):
    """One ``[dnc4]`` image of the derived ``config``: through the 4x4 tree
    under MH ("dnc") or MALA ("mala"), or through the single 32x32 tile
    ("singletile") cut to ``iters`` SMC iterations, its mutate calls
    captured into ``capture``; returns the wall per image (the runner's)."""
    import chip_smoke as cs
    from smcdet_tpu_torch.run_experiment import load_suite_config

    cfgs = _dnc4_configs(tmp, 1)
    cfg = load_suite_config(str(cfgs[config]))
    cfg.num_images = cfg.batch_size = 1
    if config == "singletile":
        cfg.sampler.max_smc_iters = iters
        _, _, res = cs._entry_batch(dev, cfg, "dnc4 single tile", tmp,
                                    capture, tempered=False)
        return float(res["runtime"][0])
    _, res, _, _ = cs._aggregation_batch(dev, cfg, "dnc4", capture)
    return float(res["runtime_per_image"].mean())


def off_path_problem(dev, kid, key):
    """``(args, child)`` of a launch of K2g or K3g at ``OFF_PATH[kid]``:
    [dnc4]'s model and prior on that tile, 4 tiles of prior catalogs at
    2048 particles a stratum (K2g), or 4 groups of 4608 particles with
    counts and origin tags drawn uniformly and a split at the middle row,
    as chip_smoke.py's off-path 24x24 bridge (K3g)."""
    import chip_smoke as cs
    from smcdet_tpu_torch.inference.aggregate import SideMask, expand_prior
    from smcdet_tpu_torch.inference.kernels import (
        TargetContext,
        init_kernel_state,
    )

    h, w, M = OFF_PATH[kid]
    _, tprior, tmodel, mh, _ = cs._dnc_problem(dev)
    prior, model = expand_prior(tprior, h, w, M), tmodel.with_shape(h, w)
    ctx, counts, state = cs._kernel_inputs(dev, prior, model, 4, 2048, 3)
    if kid == "K2g":
        return cs._sweep_args(key, mh, ctx, counts, state,
                              mh.num_iters), None
    g = torch.Generator(device=dev).manual_seed(4)
    shape = (1, 4, 4608)
    counts = torch.randint(0, M + 1, shape, generator=g, device=dev,
                           dtype=torch.int32)
    locs, fluxes = prior.sample_marks(g, counts, shape)
    tags = (torch.rand(shape + (M,), generator=g, device=dev) < 0.5).float()
    ctx = TargetContext(prior, model, ctx.image[:1, :1].expand(1, 4, 1, h, w),
                        torch.full((1, 4, 1), 0.5, device=dev),
                        child_model=model,
                        child_side_mask=SideMask(0, h // 2, h, w),
                        child_slot_side=tags)
    state = init_kernel_state(ctx, counts, locs, fluxes)
    return (cs._sweep_args(key, mh, ctx, counts, state, mh.num_iters),
            cs._flat_child(ctx, counts, state))


def dnc4_captures(dev, mala=False):
    """The first launch of each shape of one ``[dnc4]`` image: ``(tree,
    single)``, chip_smoke.py's captures (``{(kind, bridge, H, W, M):
    (kernel, ctx, counts, state)}``) of the 4x4 tree under MH (and with
    ``mala`` under MALA, into the same dict) and of one SMC iteration of
    the single 32x32 tile."""
    tree, single = {}, {}
    for config in ("dnc", "mala") if mala else ("dnc",):
        with tempfile.TemporaryDirectory() as tmp:
            dnc4_run(dev, tmp, config, capture=tree)
    with tempfile.TemporaryDirectory() as tmp:
        dnc4_run(dev, tmp, "singletile", iters=1, capture=single)
    return tree, single


def launch_problems(dev, kernels) -> dict:
    """``{(kernel, path): (args, child, mala)}``: the flattened launch
    arguments of each named kernel at each of its paths' shapes."""
    import chip_smoke as cs

    key = torch.tensor([12345, 67890], dtype=torch.int64, device=dev)
    out = {}
    if "K1" in kernels:
        _, prior, model, kernel, _ = cs.build_problem(dev)
        out["K1", "quick cell"] = (cs._sweep_args(
            key, kernel, *cs._kernel_inputs(dev, prior, model, 16, 2048, 0),
            100), None, False)
    if {"K1", "K4"} & set(kernels):
        _, tprior, tmodel, mh, _ = cs._dnc_problem(dev)
        problem = cs._kernel_inputs(dev, tprior, tmodel, 4, 512, 0)
        out["K1", "divideandconquer tile"] = (cs._sweep_args(
            key, mh, *problem, mh.num_iters), None, False)
        mala = cs.mala_kernel_for(mh, cs.MALA_DNC_STEPS, dev)
        out["K4", "divideandconquer tile under MALA"] = (cs._sweep_args(
            key, mala, *problem, mala.num_iters), None, True)
    for suite, tiles, N, steps in (("cells", 10, 4096, CELLS_MALA_STEPS),
                                   ("basic", 20, 512, cs.MALA_BASIC_STEPS)):
        if {"K2", "K4"} & set(kernels):
            prior, model, kernel, _ = cs.suite_problem(dev, suite)
            problem = cs._kernel_inputs(dev, prior, model, tiles, N, 0)
            if "K2" in kernels:
                out["K2", suite] = (cs._sweep_args(key, kernel, *problem,
                                                   100), None, False)
            if "K4" in kernels:
                mala = cs.mala_kernel_for(kernel, steps, dev)
                out["K4", f"{suite} under MALA"] = (cs._sweep_args(
                    key, mala, *problem, 100), None, True)
    if {"K3", "K4"} & set(kernels):
        mh, levels = cs.bridge_states(dev)
        mala = cs.mala_kernel_for(mh, cs.MALA_DNC_STEPS, dev)
        for i, (ctx, counts, state) in enumerate(levels):
            for kid, kernel, suffix in (("K3", mh, ""),
                                        ("K4", mala, " under MALA")):
                if kid in kernels:
                    args, child = cs._groups(
                        cs._sweep_args(key, kernel, ctx, counts, state,
                                       kernel.num_iters),
                        cs._flat_child(ctx, counts, state), counts.shape[1])
                    out[kid, f"bridge level {i}{suffix}"] = (args, child,
                                                             kid == "K4")
    if {"K2g", "K3g", "K4g"} & set(kernels):
        tree, single = dnc4_captures(dev, mala="K4g" in kernels)
        if "K2g" in kernels:
            kernel, ctx, counts, state = single[("mh", False, 32, 32, 32)]
            out["K2g", "dnc4 single tile"] = (cs._sweep_args(
                key, kernel, ctx, counts, state, kernel.num_iters), None,
                False)
        if "K3g" in kernels:
            for level, (h, w, M) in DNC4_LEVELS.items():
                kernel, ctx, counts, state = tree[("mh", True, h, w, M)]
                out["K3g", f"dnc4 bridge level {level}"] = (
                    cs._sweep_args(key, kernel, ctx, counts, state,
                                   kernel.num_iters),
                    cs._flat_child(ctx, counts, state), False)
        if "K4g" in kernels:
            mala = tree[("mala", False, 8, 8, 8)][0]
            for level, (h, w, M) in DNC4_LEVELS.items():
                # the MH run's state where the MALA run launched nothing
                _, ctx, counts, state = tree.get(("mala", True, h, w, M),
                                                 tree[("mh", True, h, w, M)])
                out["K4g", f"dnc4 bridge level {level} under MALA"] = (
                    cs._sweep_args(key, mala, ctx, counts, state,
                                   mala.num_iters),
                    cs._flat_child(ctx, counts, state), True)
            _, ctx, counts, state = single[("mh", False, 32, 32, 32)]
            out["K4g", "dnc4 single tile's first groups under MALA"] = (
                cs._groups(cs._sweep_args(key, mala, ctx, counts, state,
                                          mala.num_iters),
                           None, cs.DNC4_SINGLE_GROUPS)[0], None, True)
        for kid in {"K2g", "K3g"} & set(kernels):
            out[kid, f"off-path 16x16 {'bridge' if kid == 'K3g' else 'tile'}"
                ] = (*off_path_problem(dev, kid, key), False)
    return out


def time_kernels(dev, wrappers, use, peaks, kernels) -> None:
    """Each named kernel at its paths' launch shapes under every library,
    in turns, with its blocks, waves and agreement."""
    import chip_smoke as cs

    order = ["earlier", "new", "new", "earlier"]
    problems = launch_problems(dev, kernels)
    for kid in kernels:
        for path in SHAPES.get(kid, ()):
            args, child, mala = problems[kid, path]
            prior, model, sweeps = args[2], args[3], args[12]
            M = args[8].shape[-1]
            bound = [cs.sweep_bound(prior, model, args[6], args[9], M,
                                    sweeps, child=child is not None,
                                    mala=mala, peaks=p)[0]
                     for p in ((cs.PEAK_FP32, cs.PEAK_SFU), peaks)]

            def run(name):
                mod = wrappers[name]["mala_sweep" if mala else "mh_sweep"]
                return mod.mala_sweeps if mala else mod.mh_sweeps

            def plain(name):
                mod = wrappers[name]["mala_sweep" if mala else "mh_sweep"]
                return (mod.mala_sweeps_reference if mala
                        else mod.mh_sweeps_reference)

            times = {name: [] for name in wrappers}
            for name in order:
                use(name)
                times[name].append(cs._time_ms(
                    lambda: run(name)(*args, child=child), reps=5))
            geo, share = {}, {}
            for name in wrappers:
                use(name)
                geo[name] = cs.launch_geometry(
                    lambda: run(name)(*args, child=child))
                share[name], _ = cs.launch_agreement(
                    run(name), plain(name), args, child)
            G, N = args[6].shape
            shape = (f"{G} groups x {N}, {model.height}x{model.width}, "
                     f"M={M}, {sweeps} sweeps")
            ms = {name: sum(t) / len(t) for name, t in times.items()}
            for name in wrappers:
                print(f"[{kid} {path}] {name} at {shape}: {ms[name]:.3f} ms "
                      f"({', '.join(f'{t:.3f}' for t in times[name])}; "
                      f"{cs._geometry_text(geo[name])}), "
                      f"{ms[name] / bound[0]:.2f}x the bound "
                      f"{bound[0]:.4f} ms (at K5's rates {bound[1]:.4f} "
                      f"ms); {share[name]:.6f} of particles agree with the "
                      f"plain version after 20 same-stream sweeps")
            print(f"[{kid} {path}] earlier / new: "
                  f"{ms['earlier'] / ms['new']:.3f}x")


def end_to_end(dev, use, kernels) -> None:
    """The named kernels' paths (``END_TO_END``) under the earlier library
    and the new one: the wall of the quick cell, of one batch of basic,
    cells or basic under MALA, of one divideandconquer image under MH or
    MALA, per tile of the first 8 m71 fixture tiles, and of one ``[dnc4]``
    image through the tree or through the single tile cut to
    ``DNC4_SINGLE_ITERS`` SMC iterations."""
    import chip_smoke as cs

    paths = []
    for kid in kernels:
        paths += [p for p in END_TO_END.get(kid, ()) if p not in paths]
    walls = {}

    def wall(path, name):
        use(name)
        with tempfile.TemporaryDirectory() as tmp:
            if path == "quick cell":
                return cs.phase_main_path(dev)[1]
            if path.startswith("dnc4"):
                config = ("singletile" if "single tile" in path else "mala"
                          if path.endswith("under MALA") else "dnc")
                return dnc4_run(dev, tmp, config, iters=cs.DNC4_SINGLE_ITERS)
            mala = path.endswith("under MALA")
            suite = path.split()[0]
            steps = None
            if mala:
                steps = (cs.MALA_BASIC_STEPS if suite == "basic"
                         else cs.MALA_DNC_STEPS)
            cfg = cs._suite_config(suite, tmp, steps)
            if suite in ("cells", "basic"):
                _, _, res = cs._entry_batch(dev, cfg, f"{path} {name}", tmp)
                return float(res["runtime"][0])
            cfg.output_dir = tmp
            n = 8 if suite == "m71" else 1
            cfg.num_images = cfg.batch_size = n
            if suite == "m71":
                cfg.data_path = "experiments/m71/data/m71/tiles.npz"
            _, res, _ = cs._aggregation_batch(dev, cfg, f"{path} {name}")
            return float(res["runtime_per_image"].mean())

    for path in paths:
        order = (("earlier", "new") if path == "cells"
                 else ("earlier", "new", "new", "earlier"))
        for name in order:
            walls.setdefault((path, name), []).append(wall(path, name))
    for (path, name), w in walls.items():
        unit = ("s per tile" if path == "m71" else "s per image"
                if "image" in path else "s")
        print(f"[e2e] {path} {name}: {sum(w) / len(w):.3f} {unit} "
              f"({', '.join(f'{x:.3f}' for x in w)})")


def dnc_seeds(dev, use, kernels, seeds) -> None:
    """``chip_smoke.dnc_runs`` over ``seeds`` under MH and or MALA as
    ``kernels`` ask, under both libraries: per seed, how many images
    converge and how many are within +-1 of the truth."""
    import numpy as np

    import chip_smoke as cs

    kinds = []
    if {"K1", "K3"} & set(kernels):
        kinds.append(("MH", None))
    if "K4" in kernels:
        kinds.append(("MALA", cs.MALA_DNC_STEPS))
    for kind, steps in kinds:
        for name in ("earlier", "new"):
            use(name)
            with tempfile.TemporaryDirectory() as tmp:
                cfg = cs._suite_config("divideandconquer", tmp, steps)
                cfg.output_dir = tmp
                truth, runs = cs.dnc_runs(dev, cfg, f"dnc {kind} {name}",
                                          seeds)
            converged = [sum(r[2]) for r in runs]
            within = [int((np.abs(r[3] - truth) <= 1).sum()) for r in runs]
            for seed, c, w, r in zip(seeds, converged, within, runs):
                print(f"[dnc seeds] {kind} seed {seed} {name}: {c}/4 "
                      f"converged, {w}/4 within +-1, posterior mean pruned "
                      f"count {[round(float(x), 3) for x in r[3]]}")
            print(f"[dnc seeds] {kind} {name} over seeds {list(seeds)}: "
                  f"converged {converged}, within +-1 {within}")


def main():
    opts = parse_args()
    parent = opts.parent.resolve()
    asked = set(opts.kernel)
    os.chdir(ROOT)  # chip_smoke reads the suites' configs from the root
    import chip_smoke as cs
    from smcdet_tpu_torch import _build
    from smcdet_tpu_torch.ops import mala_sweep, mh_sweep

    smi = cs.phase_device()
    dev = torch.device("cuda")
    builds = build_all(parent)
    for name, info in builds.items():
        print(f"[build] {name}: {Path(info['path']).name} in "
              f"{info['seconds']:.1f} s")
        for kernel, lines in registers(info["log"], cs._kernel_label,
                                       kernel_id, asked).items():
            print(f"[build] {name}: {kernel}: {'; '.join(lines)}")
    differ = compare_sass(builds, asked, cs._kernel_label, kernel_id)
    libs = {name: ctypes.CDLL(str(info["path"]))
            for name, info in builds.items()}
    wrappers = {"earlier": load_wrappers(parent, "earlier"),
                "new": {"mh_sweep": mh_sweep, "mala_sweep": mala_sweep}}

    def use(name):
        # the wrappers find their entry points through load_library
        _build.load_library = lambda: libs[name]
        use_wrappers(wrappers[name])

    use("new")
    _, _, peaks = cs.phase_chain(dev)
    time_kernels(dev, wrappers, use, peaks, opts.kernel)
    if opts.end_to_end:
        end_to_end(dev, use, opts.kernel)
    if opts.dnc_seeds:
        dnc_seeds(dev, use, opts.kernel, opts.dnc_seeds)
    use("new")
    print(f"[done] on {smi}")
    assert not differ, f"machine code changed outside {sorted(asked)}: " \
        f"{[cs._kernel_label(n) for n in differ]}"


if __name__ == "__main__":
    main()
