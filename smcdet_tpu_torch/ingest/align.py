"""Cross-band image alignment via WCS reprojection (port of
``smcdet_tpu/ingest/align.py``), on tensors on an explicit device.

Each band is resampled onto the reference band's WCS by mapping every
target pixel through target-WCS -> sky -> source-WCS and sampling the
source image bicubically (Catmull-Rom, the kernel family of reproject's
"bicubic" order). The 16 taps of every band's every pixel are one gather
over ``[bands, H, W]`` in float64. Out-of-footprint pixels are zeroed
across all bands so every band shares an identical footprint.
"""

from __future__ import annotations

import torch

__all__ = ["align", "bicubic_sample"]


def _cubic_kernel(t):
    """Catmull-Rom cubic (a = -0.5)."""
    a = -0.5
    t = t.abs()
    t2, t3 = t * t, t * t * t
    return torch.where(
        t <= 1.0,
        (a + 2.0) * t3 - (a + 3.0) * t2 + 1.0,
        torch.where(t < 2.0,
                    a * t3 - 5.0 * a * t2 + 8.0 * a * t - 4.0 * a,
                    torch.zeros_like(t)),
    )


def bicubic_sample(image, y, x):
    """Sample ``image [B, H, W]`` at fractional ``(y, x) [B, ...]`` (each
    of the ``B`` images at its own points); returns ``(values, inside)``,
    both ``[B, ...]``."""
    B, H, W = image.shape
    inside = (y >= 1) & (y < H - 2) & (x >= 1) & (x < W - 2)
    taps = torch.arange(-1, 3, device=image.device)
    rows = torch.floor(y).long().clamp(1, H - 3)[..., None] + taps
    cols = torch.floor(x).long().clamp(1, W - 3)[..., None] + taps
    wy = _cubic_kernel(y[..., None] - rows)  # [B, ..., 4]
    wx = _cubic_kernel(x[..., None] - cols)
    idx = rows[..., :, None] * W + cols[..., None, :]  # [B, ..., 4, 4]
    vals = torch.gather(image.reshape(B, H * W), 1,
                        idx.reshape(B, -1)).reshape(idx.shape)
    out = ((wy[..., :, None] * wx[..., None, :]) * vals).sum((-2, -1))
    return out, inside


def align(img, wcs_list, ref_band: int, ref_depth: int = 0, device="cuda"):
    """Reproject all bands onto ``wcs_list[ref_band]``'s pixel grid on
    ``device``.

    ``img``: ``[n_bands, H, W]`` (or ``[depth, n_bands, H, W]``), an array
    or a tensor; ``wcs_list``: matching list (of lists) of ``TanWCS``.
    Returns a float32 tensor on ``device`` with the joint footprint
    applied.
    """
    img = torch.as_tensor(img, dtype=torch.float64, device=device)
    squeeze = img.ndim == 3
    if squeeze:
        img = img[None]
    if not isinstance(wcs_list[0], (list, tuple)):
        wcs_list = [wcs_list]
    depth, n_bands, H, W = img.shape

    target = wcs_list[ref_depth][ref_band]
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float64, device=img.device),
        torch.arange(W, dtype=torch.float64, device=img.device),
        indexing="ij")
    ra, dec = target.pix2world(xx.reshape(-1), yy.reshape(-1))
    src = [wcs_list[d][b].world2pix(ra, dec)
           for d in range(depth) for b in range(n_bands)]
    sx = torch.stack([s[0] for s in src]).reshape(-1, H, W)
    sy = torch.stack([s[1] for s in src]).reshape(-1, H, W)
    vals, inside = bicubic_sample(img.reshape(-1, H, W), sy, sx)
    out = torch.where(inside.all(0), vals, 0.0).reshape(img.shape)
    if squeeze:
        out = out[0]
    return out.to(torch.float32)
