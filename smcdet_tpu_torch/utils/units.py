"""SDSS photometric unit conversions on tensors (port of
``smcdet_tpu/utils/units.py``): nanomaggie <-> AB magnitude, zero point
22.5."""

from __future__ import annotations

import torch

__all__ = ["convert_mag_to_nmgy", "convert_nmgy_to_mag"]


def convert_mag_to_nmgy(mag):
    return 10 ** ((22.5 - mag) / 2.5)


def convert_nmgy_to_mag(nmgy):
    return 22.5 - 2.5 * torch.log10(nmgy)
