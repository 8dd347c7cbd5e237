"""The offline M71 archive stand-in (port of
``experiments/m71/make_fixture.py``):

    python -m smcdet_tpu_torch.data_prep.make_fixture --data-dir D
        [--seed S] [--psf-misspec {none,elliptical,varying}] [--no-giants]
        [--device cuda|cpu]

Writes the SDSS + Hubble product set that ``prepare_data --no-download``
reads, through the port's FITS layer (``ingest/fits.py``):

- ``D/sdss/6895/3/52/``: five 1489x2048 frames (TAN WCS, per-column flux
  calibration, an ALLSKY background grid) and a psField whose HDU-6 PSF
  parameters are a perturbed estimate of the generating PSF; the
  photoField (gains) one level up;
- ``D/m71/hubble_ngc6838.zpt``: an ACSGGCT-style catalog (3 header lines,
  23 whitespace columns, col 9 = mag, cols 21/22 = RA/DEC) of every star
  with small astrometric and photometric scatter;
- ``D/m71/truth_stars.npz`` (the exact generating star list) and
  ``fixture_truth.yaml`` (the generating model).

The stellar field follows the fitted M71 model: homogeneous Poisson
density 0.030 stars/px over the 320x160 target region, a 4-px ring around
it, the off-region 64x64 fit patch and one bright star in it;
truncated-Pareto fluxes; four giants above the Pareto support in two
clusters; the SDSS 6-parameter PSF; Gaussian noise with variance
``NOISE_ADD + NOISE_MULT * rate`` (electrons). ``--psf-misspec`` renders
with a PSF outside the circular 6-parameter family (elliptical, or core
widths that drift across the region); ``--no-giants`` leaves the giants
out. The same seed gives the same star field in every mode.

Every random draw is numpy's ``default_rng(seed)``, in the JAX script's
order, since the draws define the fixture. The star render (radius-8
17x17 patches around ``floor(loc)``, pixel centres at +0.5) runs in
float64 on ``device``, every star's patch at once, each pixel summed in
star order; the read
noise and the frames are numpy on the host. With the render on the CPU the
files are the JAX script's bit for bit; on the card a pixel's float64
``exp`` may round differently, which moves a frame pixel by at most one
float32 ulp.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from smcdet_tpu_torch.ingest import fits
from smcdet_tpu_torch.ingest.wcs import TanWCS

__all__ = ["make_fixture", "draw_stars", "render_stars",
           "sample_truncated_pareto", "generating_sky", "sky_interp",
           "main"]

RUN, CAMCOL, FIELD = 6895, 3, 52
FRAME_H, FRAME_W = 1489, 2048
BANDS = ("u", "g", "r", "i", "z")
RBAND = 2
GAINS = np.asarray([1.62, 3.32, 4.7, 5.16, 4.72], dtype=np.float32)

# target region + fit patch (prepare_data's conventions)
REGION_Y0, REGION_X0, REGION_H, REGION_W = 900, 1728, 320, 160
FIT_Y0, FIT_X0, FIT_HW = REGION_Y0 - 96, REGION_X0, 64

# generating model (the fitted M71 values)
SEED = 6838  # NGC 6838
MU_PER_PX = 0.030
FLUX_ALPHA, FLUX_LOWER, FLUX_UPPER = 0.214, 0.252, 1804.679
TRUE_PSF = (1.51, 4.85, 1.32, 3.0, 0.09, 0.002)  # squared-sigma convention
PSF_RADIUS = 8
NOISE_MULT, NOISE_ADD = 1.94, 0.01
CALIB_NMGY_PER_COUNT = GAINS[RBAND] / 856.0  # => nelec_per_nmgy = 856.0
SKY_COUNTS = 184.0  # * gain 4.7 => ~865 e- mean background
NUM_GIANTS = 4

WCS_CARDS = {
    "CTYPE1": "RA---TAN",
    "CTYPE2": "DEC--TAN",
    "CRPIX1": 1024.0,
    "CRPIX2": 744.0,
    "CRVAL1": 298.44,
    "CRVAL2": 18.78,
    "CD1_1": -6.0e-6,
    "CD1_2": 1.09e-4,
    "CD2_1": 1.09e-4,
    "CD2_2": 6.0e-6,
}

# Misspecified rendering PSFs (outside the inference family):
#  - "elliptical": a fixed anisotropic metric q*u^2 + v^2/q at angle
#    ELL_THETA, which no circular profile can absorb;
#  - "varying": the core VARIANCES (s1, s2) drift linearly by +-VARY_FRAC
#    down the target region (width drift ~+-7.2%), the off-region fit
#    patch at the -15% end.
ELL_Q = 1.15
ELL_THETA = np.deg2rad(30.0)
VARY_FRAC = 0.15
# stars a chunk for the varying PSF's per-star normalising sums
_VARY_CHUNK = 64


def sample_truncated_pareto(rng, n, alpha=FLUX_ALPHA, lo=FLUX_LOWER,
                            hi=FLUX_UPPER):
    """Inverse-CDF truncated-Pareto draw."""
    u = rng.uniform(size=n)
    la, ua = lo**-alpha, hi**-alpha
    return (la - u * (la - ua)) ** (-1.0 / alpha)


def sdss_psf_unnorm(r2, params=TRUE_PSF):
    """The 6-parameter SDSS profile at squared radius ``r2`` (an array or
    a tensor; the parameters scalars or tensors that broadcast)."""
    exp = torch.exp if isinstance(r2, torch.Tensor) else np.exp
    s1, s2, sp, beta, b, p0 = params
    t1 = exp(-r2 / (2.0 * s1))
    t2 = b * exp(-r2 / (2.0 * s2))
    t3 = p0 * (1.0 + r2 / (beta * sp)) ** (-beta / 2.0)
    return (t1 + t2 + t3) / (1.0 + b + p0)


def elliptical_metric(dy, dx, q=ELL_Q, theta=ELL_THETA):
    c, s = float(np.cos(theta)), float(np.sin(theta))
    u = c * dy + s * dx
    v = -s * dy + c * dx
    return q * u**2 + v**2 / q


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def _norm_grid(like):
    """The 32r x 32r grid's coordinate column and row (pixel centres at
    +0.5 about the star): numpy, or tensors on ``like``'s device."""
    side = 32 * PSF_RADIUS
    coords = np.arange(side, dtype=np.float64) - side / 2.0 + 0.5
    if isinstance(like, torch.Tensor):
        coords = torch.as_tensor(coords, device=like.device)
    return coords[:, None], coords[None, :]


def psf_eval_factory(misspec):
    """Returns ``psf(dy [n, 17, 1], dx [n, 1, 17], rows [n])`` -> the
    normalised patch values ``[n, 17, 17]`` (numpy arrays or tensors).

    Each profile is normalised by its sum over the 32r x 32r grid, on the
    same metric, so the rendered flux stays calibrated and the
    misspecification is purely in the shape. The fixed profiles' sums are
    numpy's, on the host; the varying one's, one a star, beside ``rows``.
    """
    gy, gx = _norm_grid(None)
    if misspec == "none":
        const = float(sdss_psf_unnorm(gy**2 + gx**2).sum())

        def psf(dy, dx, rows):
            return sdss_psf_unnorm(dy**2 + dx**2) / const

    elif misspec == "elliptical":
        const = float(sdss_psf_unnorm(elliptical_metric(gy, gx)).sum())

        def psf(dy, dx, rows):
            return sdss_psf_unnorm(elliptical_metric(dy, dx)) / const

    elif misspec == "varying":

        def psf(dy, dx, rows):
            # core variances scale with frame row: -VARY_FRAC at the
            # region top to +VARY_FRAC at the bottom (clipped outside)
            xp = _xp(rows)
            t = xp.clip((rows - REGION_Y0) / REGION_H, 0.0, 1.0)
            scale = (1.0 + VARY_FRAC * (2.0 * t - 1.0))[:, None, None]
            s1, s2, sp, beta, b, p0 = TRUE_PSF
            params = (s1 * scale, s2 * scale, sp, beta, b, p0)
            ty, tx = _norm_grid(rows)
            g2 = ty**2 + tx**2
            if xp is np:  # one star at a time, numpy's summation order
                const = np.asarray([
                    sdss_psf_unnorm(g2, (s1 * c, s2 * c, sp, beta, b, p0))
                    .sum() for c in scale[:, 0, 0]])
            else:
                const = torch.cat([
                    sdss_psf_unnorm(g2, (
                        s1 * scale[i:i + _VARY_CHUNK],
                        s2 * scale[i:i + _VARY_CHUNK], sp, beta, b, p0,
                    )).sum((-2, -1))
                    for i in range(0, len(rows), _VARY_CHUNK)])
            return sdss_psf_unnorm(dy**2 + dx**2, params) / const[:, None,
                                                                   None]

    else:
        raise ValueError(f"unknown misspec mode {misspec!r}")
    return psf


def _add_in_star_order(idx, vals, device):
    """A flat frame with ``vals`` added at pixels ``idx`` (entries in star
    order), each pixel's sum taken in star order as the JAX script's loop
    takes it. On the host ``np.add.at``, which adds in entry order; on a
    card by rank: entry e is its pixel's rank[e]-th in star order, and the
    entries of one rank touch distinct pixels, so adding rank by rank is
    race-free."""
    if isinstance(idx, np.ndarray):
        frame = np.zeros(FRAME_H * FRAME_W)
        np.add.at(frame, idx, vals)
        return frame
    order = torch.argsort(idx, stable=True)
    pos = torch.arange(idx.numel(), device=device)
    first = torch.ones_like(idx, dtype=torch.bool)
    first[1:] = idx[order[1:]] != idx[order[:-1]]
    rank = torch.empty_like(pos)
    rank[order] = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    frame = torch.zeros(FRAME_H * FRAME_W, dtype=torch.float64,
                        device=device)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == r
        frame[idx[sel]] += vals[sel]
    return frame.cpu().numpy()


def render_stars(rows, cols, fluxes_nmgy, nelec_per_nmgy, misspec="none",
                 device="cuda"):
    """The patch-truncated PSF render of every star into a full frame
    (electrons, float64 numpy): pixel (h, w) receives flux iff
    ``|h - floor(row)| <= r`` and ``|w - floor(col)| <= r``, distances to
    pixel centres at +0.5. Every star's patch at once, on ``device``: in
    numpy on the CPU (numpy's float64 ``pow``, so the frame is the JAX
    script's bit for bit), in torch on a card."""
    device = torch.device(device)
    psf = psf_eval_factory(misspec)
    on_card = device.type != "cpu"

    def f64(v):
        v = np.asarray(v, dtype=np.float64)
        return torch.as_tensor(v, device=device) if on_card else v

    rows, cols, fluxes = f64(rows), f64(cols), f64(fluxes_nmgy)
    off = np.arange(-PSF_RADIUS, PSF_RADIUS + 1)
    if on_card:
        off = torch.as_tensor(off, device=device)
        hh, ww = (torch.floor(v).long()[:, None] + off for v in (rows, cols))
    else:
        hh, ww = (np.floor(v).astype(np.int64)[:, None] + off
                  for v in (rows, cols))
    dy = (hh + 0.5) - rows[:, None]
    dx = (ww + 0.5) - cols[:, None]
    vals = (fluxes * nelec_per_nmgy)[:, None, None] * psf(
        dy[:, :, None], dx[:, None, :], rows)
    valid = (((hh >= 0) & (hh < FRAME_H))[:, :, None]
             & ((ww >= 0) & (ww < FRAME_W))[:, None, :])
    idx = (hh[:, :, None] * FRAME_W + ww[:, None, :])[valid]
    return _add_in_star_order(idx, vals[valid], device).reshape(FRAME_H,
                                                                FRAME_W)


def draw_stars(rng, no_giants):
    """The stellar field in the JAX script's draw order: the region, the
    giants (drawn even when left out, so every other star is the same),
    the ring, the fit patch; then the bright star at the patch centre.
    Returns ``(rows, cols, fluxes, n_region)``."""

    def draw_field(y0, x0, h, w):
        n = rng.poisson(MU_PER_PX * h * w)
        rows = rng.uniform(y0, y0 + h, n)
        cols = rng.uniform(x0, x0 + w, n)
        fluxes = sample_truncated_pareto(rng, n)
        return rows, cols, fluxes

    reg = draw_field(REGION_Y0, REGION_X0, REGION_H, REGION_W)
    # two clusters of giants, like the real core concentration (scattered
    # giants would let the 7x7 saturation dilation wipe most of the grid)
    centers = np.asarray([[REGION_Y0 + 70.0, REGION_X0 + 50.0],
                          [REGION_Y0 + 240.0, REGION_X0 + 105.0]])
    g_rows = np.repeat(centers[:, 0], 2) + rng.uniform(-9, 9, NUM_GIANTS)
    g_cols = np.repeat(centers[:, 1], 2) + rng.uniform(-9, 9, NUM_GIANTS)
    g_flux = np.exp(
        rng.uniform(np.log(2600.0), np.log(20000.0), NUM_GIANTS)
    )  # mag ~ 11.7 .. 14.0
    if not no_giants:
        reg = (
            np.concatenate([reg[0], g_rows]),
            np.concatenate([reg[1], g_cols]),
            np.concatenate([reg[2], g_flux]),
        )
    # pad ring around the region so tiles at the region boundary see
    # neighbour photons exactly like interior ones
    ring = [draw_field(y0, x0, h, w) for y0, x0, h, w in [
        (REGION_Y0 - 8, REGION_X0 - 8, 8, REGION_W + 16),
        (REGION_Y0 + REGION_H, REGION_X0 - 8, 8, REGION_W + 16),
        (REGION_Y0, REGION_X0 - 8, REGION_H, 8),
        (REGION_Y0, REGION_X0 + REGION_W, REGION_H, 8),
    ]]
    patch = draw_field(FIT_Y0, FIT_X0, FIT_HW, FIT_HW)
    # one bright (unsaturated) star near the fit-patch centre: the wing is
    # only identifiable against a high-S/N profile
    bright = (np.asarray([FIT_Y0 + 30.4]), np.asarray([FIT_X0 + 33.7]),
              np.asarray([500.0]))
    parts = [reg, *ring, patch, bright]
    return (*(np.concatenate([p[k] for p in parts]) for k in range(3)),
            reg[0].size)


def _sky_grid(band, gain):
    """A band's 6x8 ALLSKY grid (counts): the r band's with a smooth ~8%
    gradient, the others flat."""
    gy, gx = np.mgrid[0:6, 0:8]
    sky_small_r = (
        SKY_COUNTS * (1.0 + 0.05 * gy / 5.0 + 0.03 * np.sin(gx / 7.0 * np.pi))
    ).astype(np.float32)
    return (
        sky_small_r if band == "r"
        else np.full((6, 8), SKY_COUNTS, dtype=np.float32)
    ) * (gain / GAINS[RBAND])


def sky_interp():
    """The frame's ALLSKY interpolation coordinates and the nearest grid
    cell of every row and column (the reader's rule)."""
    yint = np.linspace(0, 5, FRAME_H, dtype=np.float32)
    xint = np.linspace(0, 7, FRAME_W, dtype=np.float32)
    iy = np.clip(np.rint(yint).astype(int), 0, 5)
    ix = np.clip(np.rint(xint).astype(int), 0, 7)
    return yint, xint, iy, ix


def generating_sky(band="r"):
    """A band's generating sky in electrons over the whole frame."""
    gain = float(GAINS[BANDS.index(band)])
    _, _, iy, ix = sky_interp()
    return _sky_grid(band, gain)[iy[:, None], ix[None, :]] * gain


def make_fixture(data_dir, seed=SEED, psf_misspec="none", no_giants=False,
                 device="cuda"):
    """Write the fixture under ``data_dir``; returns ``{"stars",
    "region_stars", "render_s", "wall_s"}`` (the render's wall includes
    a synchronise)."""
    start = time.perf_counter()
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    data_dir = Path(data_dir)
    d2 = data_dir / "sdss" / str(RUN) / str(CAMCOL)
    d3 = d2 / str(FIELD)
    d3.mkdir(parents=True, exist_ok=True)
    m71_dir = data_dir / "m71"
    m71_dir.mkdir(parents=True, exist_ok=True)

    # 1. the stellar field
    rows, cols, fluxes, n_region = draw_stars(rng, no_giants)
    print(f"{rows.size} stars ({n_region} in the target region)")

    # 2. frames: stars + spatially varying sky + Gaussian read noise
    nelec_per_nmgy = float(GAINS[RBAND] / CALIB_NMGY_PER_COUNT)
    mark = time.perf_counter()
    stars_e = render_stars(rows, cols, fluxes, nelec_per_nmgy, psf_misspec,
                           device)
    render_s = time.perf_counter() - mark
    yint, xint, iy, ix = sky_interp()
    for b, band in enumerate(BANDS):
        gain = float(GAINS[b])
        sky_small = _sky_grid(band, gain)
        sky_e = sky_small[iy[:, None], ix[None, :]] * gain

        rate_e = sky_e + (stars_e if band == "r" else 0.0)
        noisy_e = rate_e + np.sqrt(NOISE_ADD + NOISE_MULT * rate_e) * (
            rng.standard_normal((FRAME_H, FRAME_W))
        )
        calib = np.full(
            FRAME_W, CALIB_NMGY_PER_COUNT * gain / GAINS[RBAND],
            dtype=np.float32,
        )
        frame_nmgy = ((noisy_e - sky_e) / (gain / calib[None, :])).astype(
            np.float32
        )
        fits.write_hdus(
            d3 / f"frame-{band}-{RUN:06d}-{CAMCOL}-{FIELD:04d}.fits",
            [
                fits.image_hdu_bytes(frame_nmgy, WCS_CARDS, primary=True),
                fits.image_hdu_bytes(calib),
                fits.bintable_hdu_bytes(
                    {
                        "ALLSKY": sky_small[None],
                        "XINTERP": xint[None],
                        "YINTERP": yint[None],
                    }
                ),
            ],
        )

    fits.write_hdus(
        d2 / f"photoField-{RUN:06d}-{CAMCOL}.fits",
        [
            fits.image_hdu_bytes(primary=True),
            fits.bintable_hdu_bytes(
                {
                    "FIELD": np.asarray([FIELD], dtype=np.int32),
                    "GAIN": GAINS[None],
                }
            ),
        ],
    )

    # psField: a perturbed PSF estimate (sqrt convention on the sigma
    # fields; read_psf_params squares them on load)
    s1, s2, sp, beta, bb, p0 = TRUE_PSF
    est = {
        "psf_sigma1": np.sqrt(s1 * 1.10),
        "psf_sigma2": np.sqrt(s2 * 0.92),
        "psf_sigmap": np.sqrt(sp * 1.08),
        "psf_beta": beta,
        "psf_b": bb * 1.25,
        "psf_p0": p0 * 0.8,
    }
    psf_fields = {
        k: np.full((1, 5), v, dtype=np.float32) for k, v in est.items()
    }
    filler = fits.image_hdu_bytes()
    fits.write_hdus(
        d3 / f"psField-{RUN:06d}-{CAMCOL}-{FIELD:04d}.fits",
        [fits.image_hdu_bytes(primary=True)]
        + [filler] * 5
        + [fits.bintable_hdu_bytes(psf_fields)],
    )

    # 3. the Hubble-style .zpt truth catalog: ACS astrometry ~0.01 SDSS px,
    # photometry ~0.01 mag. rows/cols are model-locs (pixel centres at
    # +0.5); pix2world takes FITS pixel indices (centres at integers), and
    # plocs_from_ra_dec adds the +0.5 back on recovery.
    wcs = TanWCS.from_header(WCS_CARDS)
    cat_rows = rows + rng.normal(0.0, 0.01, rows.size)
    cat_cols = cols + rng.normal(0.0, 0.01, cols.size)
    mags = 22.5 - 2.5 * np.log10(fluxes) + rng.normal(0.0, 0.01, rows.size)
    ra, dec = wcs.pix2world(cat_cols - 0.5, cat_rows - 0.5)
    table = np.zeros((rows.size, 23))
    table[:, 9] = mags
    table[:, 21] = ra
    table[:, 22] = dec
    with open(m71_dir / "hubble_ngc6838.zpt", "w") as f:
        f.write(
            "# synthetic ACSGGCT-style catalog (offline fixture — see"
            " NETWORK.md)\n# generating model: manuscript.tex:564\n"
            f"# seed={seed}\n"
        )
        np.savetxt(f, table, fmt="%.8f")

    # the exact generating star list (frame pixel coords, nmgy), from
    # which prepare_data writes the scatter-free tiles_exact.npz
    np.savez_compressed(
        m71_dir / "truth_stars.npz", rows=rows, cols=cols, fluxes=fluxes
    )
    with open(m71_dir / "fixture_truth.yaml", "w") as f:
        yaml.safe_dump(
            {
                "mu_per_px": MU_PER_PX,
                "flux_alpha": FLUX_ALPHA,
                "flux_lower": FLUX_LOWER,
                "flux_upper": FLUX_UPPER,
                "psf_params": list(TRUE_PSF),
                "nelec_per_nmgy": nelec_per_nmgy,
                "noise_multiplicative": NOISE_MULT,
                "noise_additive": NOISE_ADD,
                "sky_counts": SKY_COUNTS,
                "seed": seed,
                "no_giants": bool(no_giants),
                "psf_misspec": psf_misspec,
                "psf_misspec_params": (
                    {"q": ELL_Q, "theta_deg": 30.0}
                    if psf_misspec == "elliptical"
                    else {"vary_frac": VARY_FRAC}
                    if psf_misspec == "varying"
                    else {}
                ),
            },
            f,
            sort_keys=False,
        )
    print(f"fixture written under {data_dir}")
    return {"stars": int(rows.size), "region_stars": int(n_region),
            "render_s": render_s, "wall_s": time.perf_counter() - start}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--psf-misspec",
                        choices=("none", "elliptical", "varying"),
                        default="none")
    parser.add_argument("--no-giants", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return make_fixture(args.data_dir, args.seed, args.psf_misspec,
                        args.no_giants, args.device)


if __name__ == "__main__":
    main()
