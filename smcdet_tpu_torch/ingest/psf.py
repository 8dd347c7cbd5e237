"""PSF image synthesis from survey parameters (port of
``smcdet_tpu/ingest/psf.py``), on tensors on an explicit device.

The 6-parameter SDSS profile is evaluated directly on a
``psf_slen x psf_slen`` grid in float64 and normalised to unit flux;
continuous evaluation at arbitrary offsets evaluates the radial profile
itself, which is exact rather than interpolated.
"""

from __future__ import annotations

import torch

__all__ = ["PSFConfig", "sdss_psf_profile", "render_psf_image", "ImagePSF"]


def PSFConfig(pixel_scale: float, psf_slen: int) -> dict:
    return {"pixel_scale": pixel_scale, "psf_slen": psf_slen}


def sdss_psf_profile(r, sigma1, sigma2, sigmap, beta, b, p0):
    """SDSS psField 2-Gaussian + power-law profile at radius ``r`` (a
    float64 tensor; the sigma* parameters are the squared widths, as
    ``read_psf_params`` loads them)."""
    r2 = r.to(torch.float64) ** 2
    term1 = torch.exp(-r2 / (2.0 * sigma1))
    term2 = b * torch.exp(-r2 / (2.0 * sigma2))
    term3 = p0 * (1.0 + r2 / (beta * sigmap)) ** (-beta / 2.0)
    return (term1 + term2 + term3) / (1.0 + b + p0)


def _params(params):
    return [float(p) for p in params]


def _grid_radius(psf_slen, device):
    offset = (psf_slen - 1) / 2
    grid = torch.arange(psf_slen, dtype=torch.float64, device=device) - offset
    return torch.hypot(grid[:, None], grid[None, :])


def render_psf_image(params, psf_slen: int, device="cuda") -> torch.Tensor:
    """Normalised ``psf_slen x psf_slen`` float32 PSF image for one band's
    params (odd side, star at the centre pixel), on ``device``."""
    if psf_slen % 2 != 1:
        raise ValueError("psf_slen must be odd")
    img = sdss_psf_profile(_grid_radius(psf_slen, device), *_params(params))
    return (img / img.sum()).to(torch.float32)


class ImagePSF:
    """Multi-band PSF bundle with continuous evaluation, on ``device``.

    ``psf_params``: ``[n_bands, 6]``. ``image(band)`` gives the discrete
    normalised stamp; ``at(band, dy, dx)`` evaluates the continuous
    profile (unit total flux over the stamp grid) at offsets from centre.
    """

    def __init__(self, psf_params, pixel_scale: float = 0.396,
                 psf_slen: int = 25, device="cuda"):
        self.psf_params = torch.as_tensor(psf_params, dtype=torch.float64)
        self.pixel_scale = pixel_scale
        self.psf_slen = psf_slen
        self.device = torch.device(device)
        r = _grid_radius(psf_slen, self.device)
        self._norms = [sdss_psf_profile(r, *_params(p)).sum()
                       for p in self.psf_params]

    @property
    def n_bands(self):
        return self.psf_params.shape[0]

    def image(self, band: int) -> torch.Tensor:
        return render_psf_image(self.psf_params[band], self.psf_slen,
                                self.device)

    def at(self, band: int, dy, dx) -> torch.Tensor:
        def t(v):
            return torch.as_tensor(v, dtype=torch.float64,
                                   device=self.device)

        r = torch.hypot(t(dy), t(dx))
        return (sdss_psf_profile(r, *_params(self.psf_params[band]))
                / self._norms[band])
