"""PSF model comparison (port of ``experiments/m71/psf_comparison.py``):
a Gaussian against the survey's psField PSF against the fitted model
against an empirical isolated star.

    python -m smcdet_tpu_torch.studies.psf_comparison [--config
        config.yaml|config_mis.yaml|config_vary.yaml] [--data-root D]
        [--output-dir output] [--device cuda|cpu] [--figure]

1. the generic Gaussian PSF stamp (the reference's fitted r-band seeing
   width);
2. the survey-provided SDSS PSF, the psField's 6-parameter profile
   evaluated on the stamp grid (``ingest/psf.py``);
3. the inference model's PSF (the L-BFGS fit in the config's
   ``params.yaml``) and its difference from the survey PSF;
4. an empirical isolated single-star tile against its noiseless model
   reconstruction (every catalog neighbour rendered, patch-truncated as
   the fixture renders), and the target's (loc, flux) refitted with the
   PSF fixed (``scipy.optimize.least_squares``), which isolates the PSF's
   share of the residual.

The config is read from ``experiments/m71``; ``--data-root`` (default: the
config's data directory there, e.g. ``experiments/m71/data``) holds what
``data_prep.make_fixture`` and ``prepare_data`` write: ``sdss/`` (the
frame's WCS, the psField), ``m71/hubble_ngc6838.zpt`` and the tiles at the
config's ``data_path`` below it. The stamps are computed on ``device``, the
star's refit on the host in float64.
Writes ``<output-dir>/<name>/psf_comparison.json`` and the figure's arrays,
``<output-dir>/<name>/figure_data/psf_comparison.npz``: the four stamps
(``gauss``, ``survey``, ``fitted``, ``diff``), the Gaussian's FWHM as the
report rounds it (``gaussian_fwhm_px``), and the star's ``tile``,
``recon``, ``resid``, ``sigma``, ``loc`` (tile pixels) and ``idx``.
``python -m smcdet_tpu_torch.figures`` draws ``figures/psf_comparison.png``
from it (``--figure``: at once, matplotlib needed).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from smcdet_tpu_torch.data_prep import prepare_data as P
from smcdet_tpu_torch.data_prep.make_fixture import PSF_RADIUS
from smcdet_tpu_torch.figures import (
    draw,
    require_matplotlib,
    save_figure_data,
)
from smcdet_tpu_torch.studies.m71_fixture import M71

__all__ = ["fwhm", "psf_comparison", "main"]

RBAND = 2
STAMP = 25
# the reference's fitted r-band seeing width
GAUSS_STDEV = 1.9273269405185427


def fwhm(stamp):
    """Full width at half max of a centred radial stamp, by interpolating
    the azimuthally-binned profile."""
    c = (stamp.shape[0] - 1) / 2
    yy, xx = np.mgrid[: stamp.shape[0], : stamp.shape[1]]
    r = np.hypot(yy - c, xx - c).ravel()
    v = stamp.ravel()
    order = np.argsort(r)
    r, v = r[order], v[order]
    half = v[0] / 2.0
    below = np.nonzero(v < half)[0]
    if below.size == 0:
        return float("nan")
    i = below[0]
    # linear interpolation between the straddling samples
    r0, r1, v0, v1 = r[i - 1], r[i], v[i - 1], v[i]
    return float(2.0 * (r0 + (v0 - half) / max(v0 - v1, 1e-12) * (r1 - r0)))


def _psf_summary(cfg, psfield, r2, device):
    """Parts 1-3: the three stamps' FWHMs, the survey and fitted
    parameters, and the survey-fitted difference; and the four stamps."""
    from smcdet_tpu_torch.ingest.psf import render_psf_image
    from smcdet_tpu_torch.ingest.sdss import read_psf_params
    from smcdet_tpu_torch.models.psf import GaussianPSF, SDSSPSF

    r2_t = torch.as_tensor(r2, device=device)
    gauss = GaussianPSF(stdev=GAUSS_STDEV, device=device).normalized(
        r2_t).cpu().numpy()
    gauss = gauss / gauss.sum()

    survey_params = read_psf_params(str(psfield), bands=[RBAND])[0]
    survey = render_psf_image(survey_params, STAMP, device).cpu().numpy()

    fitted_params = np.asarray(cfg.image_model.psf_params, dtype=np.float64)
    fitted_psf = SDSSPSF.create(fitted_params, cfg.image_model.psf_radius,
                                device)
    fitted = fitted_psf.unnormalized(r2_t).cpu().numpy()
    fitted = fitted / fitted.sum()

    diff = survey - fitted
    stamps = {"gauss": gauss, "survey": survey, "fitted": fitted,
              "diff": diff}
    return stamps, {
        "gaussian_fwhm_px": round(fwhm(gauss), 3),
        "survey_psfield_fwhm_px": round(fwhm(survey), 3),
        "fitted_model_fwhm_px": round(fwhm(fitted), 3),
        "survey_params": [round(float(x), 6) for x in survey_params],
        "fitted_params": [round(float(x), 6) for x in fitted_params],
        "survey_vs_fitted": {
            "max_abs_diff_over_peak": round(
                float(np.abs(diff).max() / survey.max()), 4
            ),
            "l2_over_l2": round(
                float(np.linalg.norm(diff) / np.linalg.norm(survey)), 4
            ),
        },
    }


def _profile_float64(psf_params, psf_radius):
    """The normalised SDSS profile of ``SDSSPSF.create(psf_params,
    psf_radius)`` as a numpy function of r^2, in float64."""
    s1, s2, sp, beta, b, p0 = (float(p) for p in psf_params)

    def unnormalized(r2):
        return (np.exp(-r2 / (2.0 * s1)) + b * np.exp(-r2 / (2.0 * s2))
                + p0 * (1.0 + r2 / (beta * sp)) ** (-beta / 2.0)) / (
                    1.0 + b + p0)

    side = 32 * int(psf_radius)
    coords = np.arange(side) - side / 2.0 + 0.5
    norm = unnormalized(coords[:, None] ** 2 + coords[None, :] ** 2).sum()
    return lambda r2: unnormalized(r2) / norm


def _star_summary(cfg, data_root, tiles):
    """Part 4: the isolated star. Isolation is checked against the full
    Hubble catalog projected through the frame's WCS (exactly one star in
    the tile, the least neighbour flux in the render reach), since the
    tiles' catalogs miss stars 4-8 px outside a region-boundary tile.
    Returns the star's arrays and its summary."""
    from scipy.optimize import least_squares

    from smcdet_tpu_torch.ingest.sdss import SloanDigitalSkySurvey
    from smcdet_tpu_torch.ingest.wcs import plocs_from_ra_dec
    from smcdet_tpu_torch.utils.units import convert_mag_to_nmgy

    sdss = SloanDigitalSkySurvey(
        fields=[{"run": P.RUN, "camcol": P.CAMCOL, "fields": [P.FIELD]}],
        dir_path=str(data_root / "sdss"),
    )
    sdss.prepare_data(download=False)
    hubble = np.loadtxt(data_root / "m71" / "hubble_ngc6838.zpt",
                        skiprows=3, usecols=(9, 21, 22))
    flux_all = np.asarray(convert_mag_to_nmgy(hubble[:, 0]))
    locs_all = plocs_from_ra_dec(hubble[:, 1], hubble[:, 2],
                                 sdss[0]["wcs"][RBAND])
    R = PSF_RADIUS

    def tile_neighbors(k):
        """The catalog stars that can deposit flux into kept tile k, in
        tile-local coords: (locs, fluxes, inside the tile)."""
        torig = int(tiles["tile_index"][k])
        ty = (torig // P.TW) * P.TILE + P.REGION_Y0
        tx = (torig % P.TW) * P.TILE + P.REGION_X0
        rel = locs_all - [ty, tx]
        near = (
            (rel[:, 0] > -R - 0.6)
            & (rel[:, 0] < P.TILE + R + 0.6)
            & (rel[:, 1] > -R - 0.6)
            & (rel[:, 1] < P.TILE + R + 0.6)
        )
        r_near, f_near = rel[near], flux_all[near]
        inside = (
            (r_near[:, 0] >= 0)
            & (r_near[:, 0] < P.TILE)
            & (r_near[:, 1] >= 0)
            & (r_near[:, 1] < P.TILE)
        )
        return r_near, f_near, inside

    best, best_ratio = None, np.inf
    for k in np.flatnonzero(tiles["true_counts"] == 1):
        r_near, f_near, inside = tile_neighbors(int(k))
        if int(inside.sum()) != 1:
            continue
        tgt = float(f_near[inside][0])
        contam = float(f_near[~inside].sum())
        if tgt > 100 and contam / tgt < best_ratio:
            best, best_ratio = int(k), contam / tgt
    if best is None:
        raise RuntimeError(
            "no isolated star found: no single-count tile has exactly one "
            "in-tile catalog star above 100 nmgy"
        )
    idx = best
    r_near, f_near, inside = tile_neighbors(idx)
    loc = r_near[inside][0]
    flux = float(f_near[inside][0])
    nb_locs, nb_fluxes = r_near[~inside], f_near[~inside]
    tile = tiles["images"][idx].astype(np.float64)
    bg = tiles["background"][idx].astype(np.float64)

    adu = float(cfg.image_model.adu_per_nmgy)
    h_px = np.arange(tile.shape[0])
    w_px = np.arange(tile.shape[1])

    profile = _profile_float64(cfg.image_model.psf_params, R)

    def render_star(ly, lx, f):
        """One patch-truncated star into the tile (ADU), on the host in
        float64: least_squares' finite-difference step (about 1e-8 px) is
        below a float32 r^2's resolution, so at float32 its Jacobian is
        rounding noise and the refit stops wherever the rounding leaves
        it (the JAX script's does)."""
        in_h = np.abs(h_px - np.floor(ly)) <= R
        in_w = np.abs(w_px - np.floor(lx)) <= R
        rr2 = ((h_px + 0.5) - ly)[:, None] ** 2 + ((w_px + 0.5) - lx)[
            None, :
        ] ** 2
        return adu * f * profile(rr2) * (in_h[:, None] & in_w[None, :])

    nb_image = sum(
        (render_star(ly, lx, f) for (ly, lx), f in zip(nb_locs, nb_fluxes)),
        np.zeros_like(tile),
    )

    def noise_sigma(model_img):
        return np.sqrt(
            float(cfg.image_model.noise_additive)
            + float(cfg.image_model.noise_multiplicative)
            * np.maximum(model_img, 1.0)
        )

    recon = render_star(loc[0], loc[1], flux) + nb_image + bg
    resid = tile - recon
    sigma = noise_sigma(recon)

    def refit_resid(theta):
        ly, lx, lf = theta
        model_img = render_star(ly, lx, np.exp(lf)) + nb_image + bg
        return ((tile - model_img) / noise_sigma(model_img)).ravel()

    fit = least_squares(
        refit_resid, x0=[float(loc[0]), float(loc[1]), np.log(flux)],
        method="lm",
    )
    refit_rms = float(np.sqrt(np.mean(fit.fun**2)))
    star = {"tile": tile, "recon": recon, "resid": resid, "sigma": sigma,
            "loc": loc, "idx": idx}
    return star, {
        "tile_index": idx,
        "true_flux_nmgy": round(flux, 3),
        "neighbor_flux_sum_nmgy": round(float(nb_fluxes.sum()), 3),
        "num_neighbors_in_render_reach": int(nb_fluxes.size),
        "peak_adu": round(float(tile.max()), 1),
        "residual_rms_over_noise": round(
            float(np.sqrt(np.mean((resid / sigma) ** 2))), 3),
        "residual_max_abs_over_peak": round(
            float(np.abs(resid).max() / tile.max()), 4
        ),
        "refit_loc_offset_px": [
            round(float(fit.x[0] - loc[0]), 4),
            round(float(fit.x[1] - loc[1]), 4),
        ],
        "refit_flux_rel_change": round(float(np.exp(fit.x[2]) / flux - 1.0),
                                       4),
        "refit_residual_rms_over_noise": round(refit_rms, 3),
    }


def psf_comparison(config="config.yaml", data_root=None, device="cuda"):
    """The run's name, its report ``{"psf", "empirical_star"}`` and its
    figure's arrays for one m71 config."""
    from smcdet_tpu_torch.config import load_config

    cfg = load_config(M71 / config)
    data_dir = Path(cfg.data_path)
    data_root = (M71 / data_dir.parts[0] if data_root is None
                 else Path(data_root))
    psfield = (data_root / "sdss" / str(P.RUN) / str(P.CAMCOL)
               / str(P.FIELD)
               / f"psField-{P.RUN:06d}-{P.CAMCOL}-{P.FIELD:04d}.fits")
    c = (STAMP - 1) / 2
    yy, xx = np.mgrid[:STAMP, :STAMP]
    r2 = ((yy - c) ** 2 + (xx - c) ** 2).astype(np.float32)
    stamps, psf = _psf_summary(cfg, psfield, r2, device)
    with np.load(data_root.joinpath(*data_dir.parts[1:])) as t:
        tiles = {k: t[k] for k in ("tile_index", "true_counts", "images",
                                   "background")}
    star_arrays, star = _star_summary(cfg, data_root, tiles)
    data = dict(stamps, gaussian_fwhm_px=psf["gaussian_fwhm_px"],
                **star_arrays)
    return cfg.name, {"psf": psf, "empirical_star": star}, data


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.psf_comparison",
        description="Gaussian vs survey psField vs fitted PSF vs an "
                    "isolated star.")
    parser.add_argument("--config", default="config.yaml",
                        help="an experiments/m71 config (config_mis.yaml, "
                        "config_vary.yaml for the misspecified fixtures)")
    parser.add_argument("--data-root", default=None)
    parser.add_argument("--output-dir", default="output")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--figure", action="store_true",
                        help="also draw figures/psf_comparison.png (needs "
                             "matplotlib)")
    args = parser.parse_args(argv)
    if args.figure:
        require_matplotlib("--figure")
    name, report, data = psf_comparison(args.config, args.data_root,
                                        args.device)
    out = Path(args.output_dir) / name / "psf_comparison.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    path = save_figure_data(out.parent, "psf_comparison", **data)
    if args.figure:
        for png in draw(path):
            print(f"figure: {png}")
    return report


if __name__ == "__main__":
    main()
