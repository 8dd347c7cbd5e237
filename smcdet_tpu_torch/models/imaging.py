"""Image forward models: PSF render + pixel likelihood.

Port of ``smcdet_tpu/models/imaging.py``. Stars are rendered densely over
the whole tile; the reference's ``(2r+1)^2`` patch survives as a mask:
pixel ``(h, w)`` receives flux iff ``|h - floor(loc_h)| <= r`` and
``|w - floor(loc_w)| <= r``. Pixels are carried flat (``[..., H*W]``).

``noise="poisson"``: Poisson pixels with a Normal tail above
``normal_tail_threshold``. ``noise="gaussian"``: Gaussian pixels with
variance ``noise_additive + noise_multiplicative * rate``.
"""

from __future__ import annotations

import math

import torch

from smcdet_tpu_torch.models.psf import SDSSPSF

__all__ = ["ImageModel", "M71ImageModel"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _t(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


class ImageModel:
    """Dense PSF render + pixel likelihood over a ``height x width`` tile.

    ``locs[..., 0]`` is the row coordinate, ``locs[..., 1]`` the column;
    pixel ``(h, w)`` has its centre at ``(h + 0.5, w + 0.5)``.
    ``background`` is a scalar or a per-tile map ``[T, 1, 1, H, W]``.
    """

    def __init__(self, height, width, psf_radius, psf, noise="poisson",
                 background=0.0, adu_per_nmgy=1.0, noise_additive=0.0,
                 noise_multiplicative=1.0, normal_tail_threshold=50000.0,
                 device="cuda"):
        if noise not in ("poisson", "gaussian"):
            raise ValueError(f"unknown noise model {noise!r}")
        self.height = int(height)
        self.width = int(width)
        self.psf_radius = int(psf_radius)
        self.psf = psf
        self.noise = noise
        self.background = _t(background, device)
        self.adu_per_nmgy = _t(adu_per_nmgy, device)
        self.noise_additive = _t(noise_additive, device)
        self.noise_multiplicative = _t(noise_multiplicative, device)
        self.normal_tail_threshold = float(normal_tail_threshold)
        self.device = torch.device(device)

    def with_background(self, background) -> "ImageModel":
        """A copy sharing everything but ``background``."""
        out = object.__new__(ImageModel)
        out.__dict__.update(self.__dict__)
        out.background = background
        return out

    def with_shape(self, height, width) -> "ImageModel":
        """A copy on a ``height x width`` tile sharing everything else (the
        JAX package's ``model.replace(height=, width=)``)."""
        out = object.__new__(ImageModel)
        out.__dict__.update(self.__dict__)
        out.height, out.width = int(height), int(width)
        return out

    # ------------------------------------------------------------------
    def star_image_flat(self, loc):
        """Unit-flux PSF image of one star: ``loc [..., 2] -> [..., H*W]``."""
        ly = loc[..., 0:1]
        lx = loc[..., 1:2]
        p = torch.arange(self.height * self.width, device=loc.device)
        h = torch.div(p, self.width, rounding_mode="floor").to(torch.float32)
        w = (p % self.width).to(torch.float32)
        dy = (h + 0.5) - ly
        dx = (w + 0.5) - lx
        patch = ((h - torch.floor(ly)).abs() <= self.psf_radius) & (
            (w - torch.floor(lx)).abs() <= self.psf_radius
        )
        r2 = dy * dy + dx * dx
        return self.psf.normalized(r2) * patch

    def star_image(self, loc):
        return self.star_image_flat(loc).reshape(
            loc.shape[:-1] + (self.height, self.width)
        )

    def render(self, locs, fluxes):
        """Expected pixel intensities: ``locs [..., M, 2]``, ``fluxes
        [..., M]`` (inactive slots carry flux 0) -> ``[..., H, W]``."""
        eff = self.adu_per_nmgy * fluxes
        rate = (eff[..., None, None] * self.star_image(locs)).sum(-3)
        return rate + self.background

    # ------------------------------------------------------------------
    def pixel_loglik(self, image, rate):
        """Per-pixel log-likelihood of ``image`` under ``rate`` (the terms
        the likelihoods below sum)."""
        if self.noise == "poisson":
            logpmf = image * torch.log(rate) - rate - torch.lgamma(image + 1.0)
            z2 = (image - rate) ** 2 / rate
            lognorm = -0.5 * z2 - 0.5 * torch.log(rate) - _HALF_LOG_2PI
            return torch.where(rate > self.normal_tail_threshold, lognorm,
                               logpmf)
        var = self.noise_additive + self.noise_multiplicative * rate
        return -0.5 * (image - rate) ** 2 / var - 0.5 * torch.log(var) - (
            _HALF_LOG_2PI
        )

    def loglikelihood_from_rate_flat(self, image_flat, rate_flat):
        """Pixel log-likelihood summed over the trailing flat-pixel axis."""
        return self.pixel_loglik(image_flat, rate_flat).sum(-1)

    def loglikelihood_from_rate(self, image, rate):
        return self.pixel_loglik(image, rate).sum((-2, -1))

    def loglikelihood(self, image, locs, fluxes):
        return self.loglikelihood_from_rate(image, self.render(locs, fluxes))

    # ------------------------------------------------------------------
    def sample(self, generator, locs, fluxes):
        """Draw a noisy image given a catalog. The noise is drawn on the
        generator's device (a CPU generator gives the same image on every
        machine) and the image lies on the catalog's."""
        rate = self.render(locs, fluxes)
        gdev = generator.device
        if self.noise == "poisson":
            return torch.poisson(rate.to(gdev),
                                 generator=generator).to(rate.device)
        var = self.noise_additive + self.noise_multiplicative * rate
        noise = torch.randn(rate.shape, generator=generator, device=gdev)
        return rate + torch.sqrt(var) * noise.to(rate.device)


def M71ImageModel(image_height, image_width, background, adu_per_nmgy,
                  psf_params, psf_radius, noise_additive=0.0,
                  noise_multiplicative=1.0, device="cuda") -> ImageModel:
    """SDSS 6-parameter PSF, Gaussian read-noise likelihood, nmgy->ADU
    calibration (the reference ``M71ImageModel`` signature)."""
    return ImageModel(
        height=image_height,
        width=image_width,
        psf_radius=psf_radius,
        psf=SDSSPSF.create(psf_params, psf_radius, device=device),
        noise="gaussian",
        background=background,
        adu_per_nmgy=adu_per_nmgy,
        noise_additive=noise_additive,
        noise_multiplicative=noise_multiplicative,
        device=device,
    )
