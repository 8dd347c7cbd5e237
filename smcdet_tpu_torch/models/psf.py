"""Point-spread-function models (port of ``smcdet_tpu/models/psf.py``).

Both PSFs are radially symmetric and parameterised by the squared radius
``r2``, which saves a ``sqrt`` per pixel in the render.
"""

from __future__ import annotations

import math

import torch

__all__ = ["GaussianPSF", "SDSSPSF"]


def _t(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


class GaussianPSF:
    """Isotropic Gaussian PSF evaluated as the one-dimensional normal pdf at
    the radius (the reference's convention: peak ``1 / (stdev sqrt(2 pi))``,
    no normalisation over the patch)."""

    def __init__(self, stdev, device="cuda"):
        self.stdev = _t(stdev, device)

    def normalized(self, r2):
        s = self.stdev
        return torch.exp(-0.5 * r2 / (s * s)) / (s * math.sqrt(2.0 * math.pi))


class SDSSPSF:
    """SDSS psField 6-parameter PSF: two Gaussians plus a power-law wing.

    ``unnormalized(r2) = (exp(-r2/(2 s1)) + b exp(-r2/(2 s2))
                          + p0 (1 + r2/(beta sp))^(-beta/2)) / (1 + b + p0)``

    ``normalizing_constant`` is the sum of the unnormalized profile over a
    ``(32 r) x (32 r)`` pixel grid centred on the star. ``wing_beta3``
    selects the ``rsqrt((1+x)^3)`` form of the wing, valid only at
    ``beta == 3``; construction checks the flag against ``beta``.
    """

    def __init__(self, sigma1, sigma2, sigmap, beta, b, p0,
                 normalizing_constant=1.0, wing_beta3=False, device="cuda"):
        self.sigma1 = _t(sigma1, device)
        self.sigma2 = _t(sigma2, device)
        self.sigmap = _t(sigmap, device)
        self.beta = _t(beta, device)
        self.b = _t(b, device)
        self.p0 = _t(p0, device)
        self.normalizing_constant = _t(normalizing_constant, device)
        self.wing_beta3 = bool(wing_beta3)
        if self.wing_beta3 and abs(float(self.beta) - 3.0) >= 1e-6:
            raise ValueError(
                f"SDSSPSF.wing_beta3 is set but beta={float(self.beta)} != 3;"
                " construct via SDSSPSF.create so the wing specialization "
                "stays consistent"
            )

    @classmethod
    def create(cls, psf_params, psf_radius: int, device="cuda") -> "SDSSPSF":
        params = [float(p) for p in psf_params]
        wing_beta3 = abs(params[3] - 3.0) < 1e-6
        unnorm = cls(*params, wing_beta3=wing_beta3, device=device)
        side = 32 * int(psf_radius)
        # star at (side/2, side/2); pixel centres at integer + 0.5
        coords = (torch.arange(side, dtype=torch.float32, device=device)
                  - side / 2.0 + 0.5)
        r2 = coords[:, None] ** 2 + coords[None, :] ** 2
        unnorm.normalizing_constant = unnorm.unnormalized(r2).sum()
        return unnorm

    @property
    def params(self):
        """``(sigma1, sigma2, sigmap, beta, b, p0)`` as 0-d tensors."""
        return (self.sigma1, self.sigma2, self.sigmap, self.beta, self.b,
                self.p0)

    def unnormalized(self, r2):
        term1 = torch.exp(-r2 / (2.0 * self.sigma1))
        term2 = self.b * torch.exp(-r2 / (2.0 * self.sigma2))
        q = 1.0 + r2 / (self.beta * self.sigmap)
        if self.wing_beta3:
            term3 = self.p0 * torch.rsqrt(q * q * q)
        else:
            term3 = self.p0 * q ** (-self.beta / 2.0)
        return (term1 + term2 + term3) / (1.0 + self.b + self.p0)

    def normalized(self, r2):
        return self.unnormalized(r2) / self.normalizing_constant
