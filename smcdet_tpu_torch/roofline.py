"""Kernel K5: the card's FP32 and special-function rates from dependent
chains, and the chains' plain version.

Port of ``experiments/roofline.py:_chain_bench`` and ``_measure``. Each
element carries ``STREAMS`` independent chains of ``n_chain x UNROLL``
dependent steps of one kind (``STEP_OPS``); on a CUDA tensor ``chain``
launches K5 (``csrc/chain_k5.cu``), on a CPU tensor it runs the plain
PyTorch version, ``chain_reference``. ``measure`` times a launch that fills
the card at ``n`` and at ``2n`` chain iterations and takes the rate from the
difference, so a fixed cost per launch cancels; ``t(2n) / t(n)`` near 2
says it did. ``chip_smoke.py`` runs it (phase ``[K5]``).
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

__all__ = ["CHECK_N_CHAIN", "CHECK_RTOL", "KINDS", "STEP_OPS", "STREAMS",
           "UNROLL", "chain", "chain_reference", "chain_step", "measure",
           "sm_clock_mhz"]

KINDS = ("fma", "exp", "rsqrt", "log")
UNROLL = 8
STREAMS = 4  # independent chains per element (csrc/chain_k5.cu: kStreams)
# (FP32 flops, SFU operations) per chain step, as csrc/chain_k5.cu issues
# them: fma one FFMA; exp(-x) one FMUL and one ex2; rsqrt(x + 1.5) one FADD
# and one rsqrt; log(x + 2) one FADD, one lg2 and one FMUL
STEP_OPS = {"fma": (2, 0), "exp": (1, 1), "rsqrt": (1, 1), "log": (2, 1)}
# the fma step's constants as f32, as the kernel's fma.rn.f32 takes them
_FMA_MUL = 1.0 + 2.0**-23  # 1.0000001 rounded to f32
_FMA_ADD = 9.999999717180685e-10  # 1e-9 rounded to f32
# How K5 is held to its plain version (from x0 in [0, 10]): at a chain
# length where the plain chain one step shorter or longer lies beyond the
# tolerance, so a kernel that runs another number of steps fails. The
# contracting kinds reach their fixed points within a few dozen steps, so
# they are compared after one chain iteration (8 steps), where the last
# step still moves the output by 1.6e-6 (rsqrt, the fastest to contract)
# or more and the approximate instructions stay within 1e-6 (about 2^-22
# relative each); the fma chain rounds once per step in both versions and
# is compared after 800 steps at 2^-22 relative, against the 7.7e-7 that
# one step moves it by.
CHECK_N_CHAIN = {"fma": 100, "exp": 1, "rsqrt": 1, "log": 1}
CHECK_RTOL = {"fma": 2.0**-22, "exp": 1e-6, "rsqrt": 1e-6, "log": 1e-6}


def chain_step(kind: str, x):
    """One step of a chain (the reference's step functions). The fma step
    rounds once, as the kernel's fused multiply-add does: it is computed in
    float64 (the product exactly, the sum 29 bits finer than f32) and
    rounded to f32."""
    if kind == "fma":
        return (x.double() * _FMA_MUL + _FMA_ADD).float()
    if kind == "exp":
        return torch.exp(-x)  # fixed point ~0.567
    if kind == "rsqrt":
        return torch.rsqrt(x + 1.5)  # fixed point ~0.68
    if kind == "log":
        return torch.log(x + 2.0)  # fixed point ~1.15
    raise ValueError(f"unknown chain kind {kind!r}")


def chain_reference(kind: str, x0, n_chain: int, steps: int | None = None):
    """Plain PyTorch version of K5: chain ``s`` of element ``i`` starts at
    ``x0[i] + 0.001 s`` and takes ``n_chain * UNROLL`` steps (``steps``, if
    given); returns the sum of the ``STREAMS`` chains per element, added in
    the kernel's order."""
    start = torch.arange(STREAMS, dtype=torch.float32, device=x0.device)
    x = x0[None, :] + 0.001 * start[:, None]
    for _ in range(n_chain * UNROLL if steps is None else steps):
        x = chain_step(kind, x)
    acc = x[0]
    for s in range(1, STREAMS):
        acc = acc + x[s]
    return acc


def _entry():
    from smcdet_tpu_torch import _build

    fn = _build.load_library().smcdet_chain_k5_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def chain(kind: str, x0, n_chain: int):
    """The chains of ``chain_reference``: CPU tensors take the plain
    version; a CUDA tensor launches K5 on the current stream, without
    synchronising (``chain.launches`` counts the launches)."""
    if not x0.is_cuda:
        return chain_reference(kind, x0, n_chain)
    if kind not in KINDS:
        raise ValueError(f"unknown chain kind {kind!r}")
    if x0.dtype != torch.float32 or x0.ndim != 1 or not x0.is_contiguous():
        raise ValueError("x0 must be a contiguous 1-d float32 tensor")
    out = torch.empty_like(x0)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = _entry()(x0.data_ptr(), out.data_ptr(), x0.numel(),
                       KINDS.index(kind), n_chain, stream)
    if err != 0:
        raise RuntimeError(f"K5 chain kernel launch failed with CUDA error "
                           f"{err}")
    chain.launches += 1
    return out


chain.launches = 0


def sm_clock_mhz(device="cuda"):
    """The SM clock of the card behind ``device`` as ``nvidia-smi`` reads it
    now (MHz). The card is named by its PCI address, which
    ``CUDA_VISIBLE_DEVICES`` does not renumber."""
    props = torch.cuda.get_device_properties(torch.device(device))
    bus = (f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:"
           f"{props.pci_device_id:02X}.0")
    out = subprocess.run(
        ["nvidia-smi", f"--id={bus}", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True)
    return float(out.stdout.strip().splitlines()[0])


def measure(kind: str, target_s: float = 0.25, reps: int = 3,
            device="cuda"):
    """The rate of ``kind``'s chain steps on the card: K5 over one element
    per thread that the card can hold resident, ``n_chain`` scaled from a
    pilot until one launch takes about ``target_s``, then the best of
    ``reps`` timed launches (CUDA events) at ``n`` and at ``2n`` chain
    iterations, as the reference takes the best of its reps. Returns
    ``{"steps_per_s", "linearity", "n_chain", "elements", "t_n_s",
    "t_2n_s", "sm_clock_mhz"}``: the overhead-cancelled rate ``(steps(2n)
    - steps(n)) / (t(2n) - t(n))``, ``t(2n) / t(n)``, and the SM clock read
    while the best ``2n`` launch runs."""
    device = torch.device(device)
    props = torch.cuda.get_device_properties(device)
    per_sm = getattr(props, "max_threads_per_multi_processor", 2048)
    n = props.multi_processor_count * per_sm
    x0 = torch.full((n,), 0.5, dtype=torch.float32, device=device)

    def timed(n_chain, read_clock=False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = chain(kind, x0, n_chain)
        end.record()
        clock = sm_clock_mhz(device) if read_clock else None  # while it runs
        torch.cuda.synchronize(device)
        assert torch.isfinite(out).all(), f"{kind} chain is not finite"
        return start.elapsed_time(end) * 1e-3, clock

    n_chain = 1000
    timed(n_chain)  # warm-up
    for _ in range(4):
        t, _ = timed(n_chain)
        if 0.7 * target_s <= t <= 1.5 * target_s:
            break
        n_chain = max(int(n_chain * target_s / t), 100)
    t1 = min(timed(n_chain)[0] for _ in range(reps))
    t2, clock = min(timed(2 * n_chain, read_clock=True) for _ in range(reps))
    steps = n * STREAMS * n_chain * UNROLL
    return {"steps_per_s": steps / max(t2 - t1, 1e-9),
            "linearity": t2 / t1, "n_chain": n_chain, "elements": n,
            "t_n_s": t1, "t_2n_s": t2, "sm_clock_mhz": clock}

