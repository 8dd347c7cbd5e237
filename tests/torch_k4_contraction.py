"""What compiling K4 without FMA contraction costs, and what it buys.

K4 (``smcdet_tpu_torch/csrc/mala_sweep_k4.cu``) is compiled with
``-fmad=false`` (``smcdet_tpu_torch/_build.py:SOURCE_FLAGS``), so that each
of its multiplies and adds rounds on its own, as its plain version's tensor
ops do. This script builds a second kernel library with nvcc's default
contraction and runs both builds of K4 on the card, on the targets of
``chip_smoke.py``'s K4 phase (basic's batch shapes, divideandconquer's tile
target, K2's three branch problems, and both bridge levels of
divideandconquer in tag mode). For each target and build it prints the
share of particles that agree with the plain version after 20 same-stream
sweeps and the CUDA-event time of the sweeps, timed in the order
no-contraction, contraction, contraction, no-contraction.

    python3 tests/torch_k4_contraction.py

It needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BUILDS = ("-fmad=false", "contraction")


def main():
    os.chdir(ROOT)  # chip_smoke reads the suites' configs from the root
    import chip_smoke as cs
    from smcdet_tpu_torch import _build
    from smcdet_tpu_torch.ops import mala_sweep

    smi = cs.phase_device()
    dev = torch.device("cuda")
    libs = {}
    for name, flags in zip(BUILDS, (_build.SOURCE_FLAGS, {})):
        info = _build.build(source_flags=flags)
        libs[name] = ctypes.CDLL(str(info["path"]))
        label = ""
        print(f"[build] {name}: {info['path'].name} in "
              f"{info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "Compiling entry" in line:
                label = cs._kernel_label(line.split(chr(39))[1])
            elif "registers" in line and "mala_sweep_k4" in label:
                print(f"[build] {name}: {label}: {line.strip()}")

    def use(name):
        # the wrappers find their entry points through load_library
        _build.load_library = lambda: libs[name]

    problems = {}
    prior, model, mh, _ = cs.suite_problem(dev, "basic")
    problems["basic"] = (cs.mala_kernel_for(mh, cs.MALA_BASIC_STEPS, dev),
                         cs._kernel_inputs(dev, prior, model, 20, 512, 0),
                         100)
    _, tprior, tmodel, mh, _ = cs._dnc_problem(dev)
    dnc_kernel = cs.mala_kernel_for(mh, cs.MALA_DNC_STEPS, dev)
    problems["dnc tile"] = (
        dnc_kernel, cs._kernel_inputs(dev, tprior, tmodel, 16, 512, 0),
        dnc_kernel.num_iters)
    for name, (prior, model, mh) in cs.branch_problems(dev).items():
        problems[name] = (
            cs.mala_kernel_for(mh, cs.BRANCH_MALA_STEPS[name], dev),
            cs._kernel_inputs(dev, prior, model, 2, 1000, 0), 20)
    use(BUILDS[0])
    _, levels = cs.bridge_states(dev)
    for i, level in enumerate(levels):
        problems[f"level {i} tags"] = (dnc_kernel, level,
                                       dnc_kernel.num_iters)

    key = torch.tensor([12345, 67890], dtype=torch.int64, device=dev)
    for target, (kernel, (ctx, counts, state), sweeps) in problems.items():
        child = cs._flat_child(ctx, counts, state)
        args = cs._sweep_args(key, kernel, ctx, counts, state, sweeps)
        share, times = {}, {b: [] for b in BUILDS}
        for name in BUILDS:
            use(name)
            share[name] = cs._same_stream(dev, kernel, ctx, counts, state)[0]
        for name in (*BUILDS, *reversed(BUILDS)):
            use(name)
            times[name].append(cs._time_ms(
                lambda: mala_sweep.mala_sweeps(*args, child=child), 5))
        ms = {b: sum(t) / len(t) for b, t in times.items()}
        for b in BUILDS:
            print(f"[K4 {target}] {b}: {sweeps} sweeps over "
                  f"{counts.numel()} particles in {ms[b]:.3f} ms "
                  f"({', '.join(f'{t:.3f}' for t in times[b])}); "
                  f"{share[b]:.6f} agree with the plain version after 20 "
                  f"sweeps")
        print(f"[K4 {target}] -fmad=false costs "
              f"{ms[BUILDS[0]] / ms[BUILDS[1]] - 1:+.4f} of the time")
    print(f"[done] on {smi}")


if __name__ == "__main__":
    main()
