"""Device discovery helpers (port of ``smcdet_tpu/utils/devices.py``).

The reference picks the CUDA device with the most free memory by parsing
``nvidia-smi``. The port places every tensor on an explicit
``torch.device``, so these are introspection helpers for the experiment
scripts and their logs: the first device of a platform, never another one
in its place, and one line per device.
"""

from __future__ import annotations

import torch

__all__ = ["select_device", "describe_devices"]


def select_device(platform: str | None = None) -> torch.device:
    """The first device of ``platform``: ``"cuda"`` (the default) is
    ``cuda:0``, ``"cpu"`` the CPU, which is only ever an explicit request.
    Raises ``RuntimeError`` when the platform has no device; it never
    substitutes another platform."""
    if platform is None:
        platform = "cuda"
    if platform == "cpu":
        return torch.device("cpu")
    if platform == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("no devices for platform 'cuda' "
                               "(torch.cuda.is_available() is False)")
        return torch.device("cuda", 0)
    raise RuntimeError(f"no devices for platform {platform!r}")


def describe_devices() -> str:
    """One line per device: its name, its index and, for a card, the
    memory in use and the total from ``torch.cuda.mem_get_info``."""
    if not torch.cuda.is_available():
        return "cpu id=0"
    lines = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        lines.append(f"{torch.cuda.get_device_name(i)} id={i} mem "
                     f"{(total - free) / 2**30:.2f}/{total / 2**30:.2f} GiB")
    return "\n".join(lines)
