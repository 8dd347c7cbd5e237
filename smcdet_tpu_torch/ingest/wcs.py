"""TAN (gnomonic) world coordinate system (port of
``smcdet_tpu/ingest/wcs.py``), all of it in float64.

Converts between (RA, DEC) degrees and pixel coordinates of SDSS frames,
whose headers carry the standard CRPIX/CRVAL/CD TAN keywords. The same
formulas run on numpy arrays (catalogs, on the host: the JAX package's
arithmetic, so a catalog lands on the same pixels bit for bit) and on
tensors (pixel grids, on the tensor's device: ``align`` maps a whole frame).

Conventions:
- ``world2pix``/``pix2world`` use FITS 0-based pixel coordinates in
  (x, y) = (column, row) order, matching ``astropy`` with ``origin=0``.
- ``plocs_from_ra_dec`` returns BLISS-style coordinates: (row, col) order
  with a +0.5 shift so (0, 0) is the image corner.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["TanWCS", "plocs_from_ra_dec"]

DEG = np.pi / 180.0


def _xp(x):
    """The array namespace of ``x`` (torch for a tensor, else numpy) and
    ``x`` as float64 in it."""
    if isinstance(x, torch.Tensor):
        return torch, x.to(torch.float64)
    return np, np.asarray(x, dtype=np.float64)


def _quiet(xp):
    """numpy's warnings off for the TAN singularity at the reference
    pixel (the ``where`` picks the finite branch there)."""
    if xp is np:
        return np.errstate(invalid="ignore", divide="ignore")
    return contextlib.nullcontext()


def _matrix(xp, m, like):
    if xp is np:
        return m
    # a swapped-axes header's cd is a reversed (negative-stride) view
    return torch.as_tensor(np.ascontiguousarray(m), device=like.device)


@dataclass(frozen=True)
class TanWCS:
    crpix: np.ndarray  # [2] 0-based reference pixel (x, y)
    crval: np.ndarray  # [2] (ra0, dec0) degrees at the reference pixel
    cd: np.ndarray  # [2, 2] linear transform pixel -> intermediate degrees
    # True if header axis 1 is RA (CTYPE1='RA---TAN'); False if swapped.
    ra_first: bool = True

    @classmethod
    def from_header(cls, header: dict) -> "TanWCS":
        ctype1 = str(header.get("CTYPE1", "RA---TAN"))
        ra_first = ctype1.upper().startswith("RA")
        crpix = np.asarray(
            [header["CRPIX1"] - 1.0, header["CRPIX2"] - 1.0]
        )  # FITS CRPIX is 1-based
        crval = np.asarray([header["CRVAL1"], header["CRVAL2"]])
        if "CD1_1" in header:
            cd = np.asarray(
                [
                    [header["CD1_1"], header.get("CD1_2", 0.0)],
                    [header.get("CD2_1", 0.0), header["CD2_2"]],
                ]
            )
        else:  # CDELT (+ optional PC matrix)
            cdelt = np.asarray([header["CDELT1"], header["CDELT2"]])
            pc = np.asarray(
                [
                    [header.get("PC1_1", 1.0), header.get("PC1_2", 0.0)],
                    [header.get("PC2_1", 0.0), header.get("PC2_2", 1.0)],
                ]
            )
            cd = pc * cdelt[:, None]
        if not ra_first:
            # normalise to RA-first intermediate coords
            cd = cd[::-1]
            crval = crval[::-1]
        return cls(crpix=crpix, crval=crval, cd=cd, ra_first=ra_first)

    # ------------------------------------------------------------------
    def pix2world(self, x, y):
        """0-based pixel (x=col, y=row) -> (ra, dec) degrees; numpy arrays
        or tensors (on their device) in, the same kind out."""
        xp, x = _xp(x)
        _, y = _xp(y)
        dp = xp.stack([x - self.crpix[0], y - self.crpix[1]], axis=-1)
        interm = dp @ _matrix(xp, self.cd.T, dp)  # [..., 2] = (xi, eta)
        xi = interm[..., 0] * DEG
        eta = interm[..., 1] * DEG

        ra0 = self.crval[0] * DEG
        dec0 = self.crval[1] * DEG
        rho = xp.hypot(xi, eta)
        c = xp.arctan(rho)
        cos_c, sin_c = xp.cos(c), xp.sin(c)
        with _quiet(xp):
            dec = xp.arcsin(
                xp.where(
                    rho > 0,
                    cos_c * np.sin(dec0) + eta * sin_c * np.cos(dec0) / rho,
                    np.sin(dec0),
                )
            )
            ra = ra0 + xp.arctan2(
                xi * sin_c,
                rho * np.cos(dec0) * cos_c - eta * np.sin(dec0) * sin_c,
            )
        return (ra / DEG) % 360.0, dec / DEG

    def world2pix(self, ra, dec):
        """(ra, dec) degrees -> 0-based pixel (x=col, y=row); numpy arrays
        or tensors (on their device) in, the same kind out."""
        xp, ra = _xp(ra)
        _, dec = _xp(dec)
        ra = ra * DEG
        dec = dec * DEG
        ra0 = self.crval[0] * DEG
        dec0 = self.crval[1] * DEG

        dra = ra - ra0
        cos_c = np.sin(dec0) * xp.sin(dec) + np.cos(dec0) * xp.cos(
            dec
        ) * xp.cos(dra)
        xi = xp.cos(dec) * xp.sin(dra) / cos_c
        eta = (
            np.cos(dec0) * xp.sin(dec)
            - np.sin(dec0) * xp.cos(dec) * xp.cos(dra)
        ) / cos_c
        interm = xp.stack([xi / DEG, eta / DEG], axis=-1)
        dp = interm @ _matrix(xp, np.linalg.inv(self.cd).T, interm)
        return dp[..., 0] + self.crpix[0], dp[..., 1] + self.crpix[1]

    # astropy-compatible aliases (origin 0 only)
    def all_world2pix(self, ra, dec, origin=0):
        return self.world2pix(ra, dec)

    def all_pix2world(self, x, y, origin=0):
        return self.pix2world(x, y)


def plocs_from_ra_dec(ras, decs, wcs: TanWCS):
    """RA/DEC -> BLISS-style (row, col) pixel coords with the +0.5 corner
    shift (numpy)."""
    pt, pr = wcs.all_world2pix(np.asarray(ras), np.asarray(decs), 0)
    return np.stack([pr + 0.5, pt + 0.5], axis=-1)
