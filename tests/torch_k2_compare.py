"""Kernel K2 as it stands against an earlier K2, on the card, in one
process.

    python3 tests/torch_k2_compare.py --parent DIR [--end-to-end]

``DIR`` holds an earlier checkout of the repository (``git archive`` of a
commit unpacked into a directory that ``.gitignore`` lists, such as
``.scratch/parent``). The script builds that checkout's kernel library with
its own ``_build.py`` and this checkout's library, both at once. Then it
prints:

- each build's registers and spills of its K2 instantiations (``nvcc
  -Xptxas -v``);
- from ``cuobjdump -sass``: whether every kernel other than K2 has the same
  machine code in both checkouts (the script fails if one differs), and
  each build's K2 instruction counts: the whole kernel, its largest loop
  and the largest loop inside that (``torch_sass.py`` beside this script);
- K2's time at the cells shapes (130 groups x 4096, 16x16, M = 12, 100
  sweeps) and at basic's (180 x 512, 8x8, M = 8, 100 sweeps), the
  libraries timed in turns (earlier, this checkout's, this checkout's,
  earlier), beside the bound at the data sheet's peaks and at
  K5's measured ones, and each library's share of particles that agree
  with the plain version after 20 same-stream sweeps;
- with ``--end-to-end``: the cells batch, the basic batch and the first 8
  m71 fixture tiles through ``run_experiment`` under the earlier library
  and this checkout's (cells: earlier, this; the others: earlier, this,
  this, earlier).

It needs a CUDA card, nvcc and cuobjdump.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
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

# tiles and particles per stratum of the timed shapes
SHAPES = {"cells": (10, 4096), "basic": (20, 512)}


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


def k2_registers(log: str, label) -> dict:
    """``{kernel: [ptxas lines]}``: the registers and spills of the K2
    instantiations in an ``-Xptxas -v`` log."""
    out, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            kernel = label(line.split("'")[1])
        elif kernel and "mh_sweep_k2" in kernel and (
                "registers" in line or "spill" in line):
            out.setdefault(kernel, []).append(line.strip())
    return out


def compare_sass(builds: dict, label) -> list:
    """Whether every kernel but K2 is identical in the earlier and the new
    library, and each library's K2 instruction counts. Returns the kernels
    that differ."""
    import torch_sass as sass

    dumps = {name: sass.dump(info["path"]) for name, info in builds.items()}
    earlier, new = dumps["earlier"], dumps["new"]
    differ = []
    for name in sorted(set(earlier) | set(new)):
        if "mh_sweep_k2" in name:
            continue
        same = earlier.get(name) == new.get(name)
        differ += [] if same else [name]
        print(f"[sass] {label(name)}: "
              f"{sass.instructions(new.get(name, []))} instructions, "
              f"{'identical to' if same else 'DIFFERENT from'} the earlier "
              f"build's")
    for lib, functions in dumps.items():
        for name in sorted(n for n in functions if "mh_sweep_k2" in n):
            body = functions[name]
            outer, inner = sass.loop_sizes(body)
            print(f"[sass] {lib}: {label(name)}: "
                  f"{sass.instructions(body)} instructions; largest loop "
                  f"{outer}, the largest loop inside it {inner}")
            start, end, _ = sass.loops(body)[0]
            mix = Counter(line.split()[1] if line.startswith("@")
                          else line.split()[0]
                          for line in body[start:end + 1]
                          if not line.endswith(":"))
            print(f"[sass] {lib}: {label(name)}: largest loop's opcodes "
                  + ", ".join(f"{op} {n}" for op, n in mix.most_common(16)))
    return differ


def time_k2(dev, libs, use, peaks) -> None:
    """K2 at the cells and basic shapes under every library, in turns."""
    import chip_smoke as cs
    from smcdet_tpu_torch.ops import mh_sweep

    key = torch.tensor([12345, 67890], dtype=torch.int64, device=dev)
    order = ["earlier", "new", "new", "earlier"]
    for suite, (tiles, N) in SHAPES.items():
        prior, model, kernel, _ = cs.suite_problem(dev, suite)
        ctx, counts, state = cs._kernel_inputs(dev, prior, model, tiles, N,
                                               0)
        args = cs._sweep_args(key, kernel, ctx, counts, state, 100)
        M = prior.max_objects
        bound = [cs.sweep_bound(prior, model, args[6], args[9], M, 100,
                                peaks=p)[0]
                 for p in ((cs.PEAK_FP32, cs.PEAK_SFU), peaks)]
        times = {name: [] for name in libs}
        for name in order:
            use(name)
            times[name].append(cs._time_ms(
                lambda: mh_sweep.mh_sweeps(*args), reps=5))
        share = {}
        for name in libs:
            use(name)
            share[name] = cs._same_stream(dev, kernel, ctx, counts, state)[0]
        shape = (f"{args[6].shape[0]} groups x {N}, "
                 f"{model.height}x{model.width}, M={M}, 100 sweeps")
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        for name in libs:
            print(f"[K2 {suite}] {name} at {shape}: {ms[name]:.3f} ms "
                  f"({', '.join(f'{t:.3f}' for t in times[name])}), "
                  f"{ms[name] / bound[0]:.2f}x the bound {bound[0]:.4f} ms "
                  f"(at K5's rates {bound[1]:.4f} ms); {share[name]:.6f} of "
                  f"particles agree with the plain version after 20 "
                  f"same-stream sweeps")
        print(f"[K2 {suite}] earlier / new: "
              f"{ms['earlier'] / ms['new']:.3f}x")


def end_to_end(dev, use) -> None:
    """The cells and basic batches and 8 m71 fixture tiles through
    ``run_experiment`` under the earlier library and the new one."""
    import chip_smoke as cs

    walls = {}

    def batch(suite, name):
        use(name)
        with tempfile.TemporaryDirectory() as tmp:
            cfg = cs._suite_config(suite)
            if suite == "m71":
                cfg.data_path = "experiments/m71/data/m71/tiles.npz"
                cfg.num_images = cfg.batch_size = 8
                cfg.output_dir = tmp
                _, res, _ = cs._aggregation_batch(dev, cfg,
                                                  f"m71 {name}")
                wall = float(res["runtime_per_image"].mean())
            else:
                _, _, res = cs._entry_batch(dev, cfg, f"{suite} {name}",
                                            tmp)
                wall = float(res["runtime"][0])
        walls.setdefault((suite, name), []).append(wall)

    for name in ("earlier", "new"):
        batch("cells", name)
    for suite in ("basic", "m71"):
        for name in ("earlier", "new", "new", "earlier"):
            batch(suite, name)
    for (suite, name), w in walls.items():
        unit = "s per tile" if suite == "m71" else "s per batch"
        print(f"[e2e] {suite} {name}: {sum(w) / len(w):.3f} {unit} "
              f"({', '.join(f'{x:.3f}' for x in w)})")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="an earlier checkout of the repository")
    parser.add_argument("--end-to-end", action="store_true")
    opts = parser.parse_args()
    parent = opts.parent.resolve()
    os.chdir(ROOT)  # chip_smoke reads the suites' configs from the root
    import chip_smoke as cs
    from smcdet_tpu_torch import _build

    smi = cs.phase_device()
    dev = torch.device("cuda")
    builds = build_all(parent)
    for name, info in builds.items():
        print(f"[build] {name}: {Path(info['path']).name} in "
              f"{info['seconds']:.1f} s")
        for kernel, lines in k2_registers(info["log"],
                                          cs._kernel_label).items():
            print(f"[build] {name}: {kernel}: {'; '.join(lines)}")
    differ = compare_sass(builds, cs._kernel_label)
    libs = {name: ctypes.CDLL(str(info["path"]))
            for name, info in builds.items()}

    def use(name):
        # the wrappers find their entry points through load_library
        _build.load_library = lambda: libs[name]

    use("new")
    _, _, peaks = cs.phase_chain(dev)
    time_k2(dev, libs, use, peaks)
    if opts.end_to_end:
        end_to_end(dev, use)
    print(f"[done] on {smi}")
    assert not differ, f"machine code changed outside K2: {differ}"


if __name__ == "__main__":
    main()
