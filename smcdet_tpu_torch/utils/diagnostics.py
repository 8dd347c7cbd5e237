"""Phase timing, profiling hooks and run diagnostics (port of
``smcdet_tpu/utils/diagnostics.py``).

- ``PhaseTimer`` collects named phase durations, waiting for the card at a
  phase's end when asked (``torch.cuda.synchronize``), and renders a table;
- ``trace_profile`` wraps ``torch.profiler`` (CPU and CUDA activity) and
  writes a Chrome trace;
- ``summarize_diagnostics`` renders the per-iteration history that
  ``run_csmc`` records when ``SMCConfig.record_history`` is on.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

__all__ = ["PhaseTimer", "trace_profile", "summarize_diagnostics"]


def _wait_for(sync):
    """Wait until the card has finished the work behind ``sync``: a tensor
    or device, or ``True`` for the current CUDA device."""
    if sync is True:
        device = None
    elif isinstance(sync, torch.Tensor):
        device = sync.device
    else:
        device = torch.device(sync)
    if device is None or device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase.

    >>> timer = PhaseTimer()
    >>> with timer("sampling", sync=images):
    ...     result = run(...)            # doctest: +SKIP
    >>> print(timer.report())            # doctest: +SKIP

    ``sync`` (a tensor, a device, or ``True`` for the current CUDA device)
    makes the phase end when the card has finished its work, not when the
    host has queued it.
    """

    def __init__(self):
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: "OrderedDict[str, int]" = OrderedDict()

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _wait_for(sync)
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{'phase':<24}{'total s':>10}{'calls':>8}{'share':>8}"]
        for name, t in self.totals.items():
            lines.append(
                f"{name:<24}{t:>10.3f}{self.counts[name]:>8}"
                f"{t / total:>8.1%}"
            )
        return "\n".join(lines)

    def as_dict(self):
        return dict(self.totals)


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when a card
    is present) and write a Chrome trace to ``log_dir/trace.json``
    (chrome://tracing, Perfetto). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def summarize_diagnostics(result) -> str:
    """Human-readable summary of an ``SMCResult`` with recorded history."""
    lines = []
    n = int(result.num_iters)
    temp = _np(result.temperature)
    lines.append(
        f"SMC finished in {n} iterations; final temperature range "
        f"[{float(temp.min()):.3f}, {float(temp.max()):.3f}]"
    )
    ess = _np(result.ess)
    lines.append(
        f"final per-stratum ESS: min {ess.min():.1f}, "
        f"median {np.median(ess):.1f}"
    )
    acc = _np(result.acc_rate)
    lines.append(
        f"final acceptance rate: min {acc.min():.3f}, max {acc.max():.3f}"
    )
    hist = getattr(result, "history", None)
    if hist is not None:
        temp_h = _np(hist["temperature"])[:n]
        acc_h = _np(hist["acc_rate"])[:n]
        for i in range(n):
            lines.append(
                f"  iter {i + 1:3d}: temperature "
                f"[{temp_h[i].min():.3f}, {temp_h[i].max():.3f}] "
                f"acc [{acc_h[i].min():.2f}, {acc_h[i].max():.2f}]"
            )
    return "\n".join(lines)
