"""M71 data preparation (port of ``experiments/m71/prepare_data.py``):

    python -m smcdet_tpu_torch.data_prep.prepare_data --data-dir D
        --no-download [--device cuda|cpu]

Reads the survey's bytes under ``D`` (``D/sdss``: SDSS run 6895 / camcol 3 /
field 52, photoField, five frames, psField; ``D/m71/hubble_ngc6838.zpt``:
the ACS Globular Cluster Treasury catalog of NGC 6838, or the offline
fixture's stand-ins from ``make_fixture``) and writes what the m71 suites
read:

1. the r-band frame in electrons and its sky, the Hubble catalog cut at
   mag < 24 and projected through the frame's WCS;
2. the 320x160-pixel target region in 8x8 tiles with a checkerboard
   tune/eval split; each tile's truth catalogs (in-tile, the 4-px padded
   window, the radius-8 render reach); the catalog-based saturation mask
   (a star brighter than mag 14) dilated by 7x7 tiles;
3. the truncated-Pareto flux prior and the Poisson count rate (closed
   form, on the tune half), then the PSF, noise and calibration by 200
   L-BFGS steps on ``device`` against an off-target 64x64 patch of the
   image with its known stars (``fitting.fit_image_model``);
4. ``D/m71/tiles.npz``, ``D/m71/params.yaml`` and, where the fixture's
   exact star list ``truth_stars.npz`` exists, ``tiles_exact.npz`` (the
   same tiles with scatter-free truth catalogs).

Nothing is downloaded: without ``--no-download`` every archive product a
download would place must already be there, and a missing one raises
``FileNotFoundError`` naming the file and its URL, as a missing Hubble
catalog does in either mode.
"""

from __future__ import annotations

import argparse
import time
import warnings
from pathlib import Path

import numpy as np
import yaml
from scipy.ndimage import binary_dilation

from smcdet_tpu_torch.fitting import (
    fit_image_model,
    fit_poisson_rate,
    fit_truncated_pareto_flux,
)
from smcdet_tpu_torch.ingest.sdss import SloanDigitalSkySurvey
from smcdet_tpu_torch.ingest.wcs import plocs_from_ra_dec
from smcdet_tpu_torch.utils.units import convert_mag_to_nmgy

__all__ = ["prepare", "tile_truth_catalogs", "fit_patch", "main"]

RUN, CAMCOL, FIELD = 6895, 3, 52
RBAND = 2
# the target region in frame pixel coords: 320x160 with its corner at
# (x=1728, y=900)
REGION_Y0, REGION_X0, REGION_H, REGION_W = 900, 1728, 320, 160
TILE = 8
TH, TW = REGION_H // TILE, REGION_W // TILE
HUBBLE_URL = (
    "https://archive.stsci.edu/pub/hlsp/acsggct/ngc6838/"
    "hlsp_acsggct_hst_acs-wfc_ngc6838_r.rdviq.cal.adj.zpt"
)
SATURATION_ADU = 60000.0
PAD, REACH = 4.0, 9.0  # padded-window / render-reach half-widths (px)
# the Hubble catalog's depth cut, which also sets the flux prior's floor
MAG_UPPER_BOUND = 24.0
# the SDSS saturation limit (mag 14) in nmgy
BRIGHT_FLUX = 10 ** ((22.5 - 14.0) / 2.5)
# the image-model fit: an off-target 64x64 patch above the region, with
# every catalog star up to the PSF radius outside it (their photons spill
# in), 200 L-BFGS steps
FIT_Y0, FIT_X0, FIT_HW, FIT_MARGIN = REGION_Y0 - 96, REGION_X0, 64, 8.0
FIT_STEPS = 200
MAX_PER_TILE, MAX_PADDED, MAX_REACH = 32, 64, 96


def tile_truth_catalogs(cat_locs_all, cat_fluxes_all):
    """Per-tile truth / padded / reach catalogs from a full-frame star list
    (frame pixel coords + nmgy fluxes). Returns ``(catalogs, locs_region,
    fluxes_region)``: the in-region stars in region coordinates."""
    in_region = (
        (cat_locs_all[:, 0] >= REGION_Y0)
        & (cat_locs_all[:, 0] < REGION_Y0 + REGION_H)
        & (cat_locs_all[:, 1] >= REGION_X0)
        & (cat_locs_all[:, 1] < REGION_X0 + REGION_W)
    )
    locs_region = cat_locs_all[in_region] - [REGION_Y0, REGION_X0]
    fluxes_region = cat_fluxes_all[in_region]
    T = TH * TW

    # per-tile truth catalogs (in-tile coords)
    true_counts = np.zeros(T, dtype=np.int64)
    true_locs = np.zeros((T, MAX_PER_TILE, 2))
    true_fluxes = np.zeros((T, MAX_PER_TILE))
    for i, (r, c) in enumerate(zip(locs_region[:, 0], locs_region[:, 1])):
        t = int(r // TILE) * TW + int(c // TILE)
        m = true_counts[t]
        if m < MAX_PER_TILE:
            true_locs[t, m] = (r % TILE, c % TILE)
            true_fluxes[t, m] = fluxes_region[i]
            true_counts[t] += 1

    # padded-window catalogs: every in-region star within the tile's
    # window [-PAD, TILE+PAD)^2, in window-local coords (what the
    # semisynthetic suites render); render-reach catalogs: every star of
    # the whole frame whose radius-8 patch can light the tile (window
    # [-REACH, TILE+REACH)), neighbours outside the region included
    padded_counts = np.zeros(T, dtype=np.int64)
    padded_locs = np.zeros((T, MAX_PADDED, 2))
    padded_fluxes = np.zeros((T, MAX_PADDED))
    locs_frame = cat_locs_all - [REGION_Y0, REGION_X0]
    reach_counts = np.zeros(T, dtype=np.int64)
    reach_locs = np.zeros((T, MAX_REACH, 2))
    reach_fluxes = np.zeros((T, MAX_REACH))
    for t in range(T):
        ty, tx = (t // TW) * TILE, (t % TW) * TILE
        rel = locs_region - [ty, tx]
        in_pad = (
            (rel[:, 0] >= -PAD)
            & (rel[:, 0] < TILE + PAD)
            & (rel[:, 1] >= -PAD)
            & (rel[:, 1] < TILE + PAD)
        )
        sel = np.flatnonzero(in_pad)[:MAX_PADDED]
        padded_counts[t] = sel.size
        padded_locs[t, : sel.size] = rel[sel]
        padded_fluxes[t, : sel.size] = fluxes_region[sel]

        rel_f = locs_frame - [ty, tx]
        in_reach = (
            (rel_f[:, 0] >= -REACH)
            & (rel_f[:, 0] < TILE + REACH)
            & (rel_f[:, 1] >= -REACH)
            & (rel_f[:, 1] < TILE + REACH)
        )
        sel_r = np.flatnonzero(in_reach)
        if sel_r.size > MAX_REACH:
            raise RuntimeError(
                f"tile {t}: {sel_r.size} stars in render reach exceeds the "
                f"{MAX_REACH}-slot reach catalog — raise MAX_REACH"
            )
        reach_counts[t] = sel_r.size
        reach_locs[t, : sel_r.size] = rel_f[sel_r]
        reach_fluxes[t, : sel_r.size] = cat_fluxes_all[sel_r]

    return {
        "true_counts": true_counts,
        "true_locs": true_locs,
        "true_fluxes": true_fluxes,
        "padded_counts": padded_counts,
        "padded_locs": padded_locs,
        "padded_fluxes": padded_fluxes,
        "reach_counts": reach_counts,
        "reach_locs": reach_locs,
        "reach_fluxes": reach_fluxes,
    }, locs_region, fluxes_region


def _tile_index(locs_region):
    return (locs_region[:, 0] // TILE).astype(int) * TW + (
        locs_region[:, 1] // TILE).astype(int)


def fit_patch(image, background, locs_all, fluxes_all):
    """The image-model fit's inputs: the 64x64 patch of ``image`` (ADU),
    its sky map, and the catalog stars up to the PSF radius outside it in
    patch coordinates, as float32 arrays ``(patch, sky, locs, fluxes)``."""
    ys = slice(FIT_Y0, FIT_Y0 + FIT_HW)
    xs = slice(FIT_X0, FIT_X0 + FIT_HW)
    in_patch = (
        (locs_all[:, 0] >= FIT_Y0 - FIT_MARGIN)
        & (locs_all[:, 0] < FIT_Y0 + FIT_HW + FIT_MARGIN)
        & (locs_all[:, 1] >= FIT_X0 - FIT_MARGIN)
        & (locs_all[:, 1] < FIT_X0 + FIT_HW + FIT_MARGIN)
    )
    return (np.asarray(image[ys, xs], dtype=np.float32),
            np.asarray(background[ys, xs], dtype=np.float32),
            np.asarray(locs_all[in_patch] - [FIT_Y0, FIT_X0],
                       dtype=np.float32),
            np.asarray(fluxes_all[in_patch], dtype=np.float32))


def read_survey(data_dir, download=False):
    """The field's survey item (``SloanDigitalSkySurvey``, images loaded)
    and the Hubble catalog cut at ``MAG_UPPER_BOUND``: ``(item,
    locs_all, fluxes_all)``, the catalog's stars in frame pixels (row,
    col) through the r band's WCS and their nmgy fluxes."""
    data_dir = Path(data_dir)
    survey = SloanDigitalSkySurvey(
        fields=[{"run": RUN, "camcol": CAMCOL, "fields": [FIELD]}],
        dir_path=str(data_dir / "sdss"),
        load_image_data=True,
    )
    survey.prepare_data(download=download)
    item = survey[0]

    hubble_path = data_dir / "m71" / "hubble_ngc6838.zpt"
    if not hubble_path.exists():
        raise FileNotFoundError(
            f"{hubble_path} is missing: this program downloads nothing; "
            f"fetch {HUBBLE_URL} and place it there"
        )
    # columns: 9 = V mag (zero-point adjusted), 21/22 = RA/DEC
    hubble = np.loadtxt(hubble_path, skiprows=3, usecols=(9, 21, 22))
    hubble = hubble[hubble[:, 0] < MAG_UPPER_BOUND]
    fluxes_all = np.asarray(convert_mag_to_nmgy(hubble[:, 0]))
    locs_all = plocs_from_ra_dec(hubble[:, 1], hubble[:, 2],
                                 item["wcs"][RBAND])
    return item, locs_all, fluxes_all


def _region(a):
    return a[REGION_Y0: REGION_Y0 + REGION_H,
             REGION_X0: REGION_X0 + REGION_W]


def _tiles(a):
    """The region of a frame-sized array as ``[TH * TW, TILE, TILE]``."""
    return _region(a).reshape(TH, TILE, TW, TILE).transpose(
        0, 2, 1, 3).reshape(-1, TILE, TILE)


def prepare(data_dir, download=False, device="cuda", num_steps=FIT_STEPS):
    """Write ``tiles.npz``, ``params.yaml`` (and ``tiles_exact.npz``)
    under ``data_dir/m71``; returns ``{"params", "fit": FittedImageModel,
    "fit_s", "fit_steps", "kept", "wall_s"}``."""
    start = time.perf_counter()
    m71_dir = Path(data_dir) / "m71"
    m71_dir.mkdir(parents=True, exist_ok=True)
    item, locs_all, fluxes_all = read_survey(data_dir, download)

    # tiles, checkerboard split, saturation mask
    image = item["image"][RBAND]
    background = item["background"][RBAND]
    tiles_flat = _tiles(image)
    tiles_bkg = _tiles(background)
    grid_h, grid_w = np.meshgrid(np.arange(TH), np.arange(TW), indexing="ij")
    checker = ((grid_h + grid_w) % 2 == 0).reshape(-1)
    saturated_px = tiles_flat.max((-2, -1)) > SATURATION_ADU

    cat, locs_region, fluxes_region = tile_truth_catalogs(locs_all,
                                                          fluxes_all)
    # a tile is saturated iff its truth catalog holds a star brighter than
    # mag 14 (a catalog rule, not a pixel rule); dilated by 7x7 tiles, as
    # a bright star's spill reaches far beyond its own tile
    has_bright = np.zeros(TH * TW, dtype=bool)
    has_bright[_tile_index(locs_region)[fluxes_region > BRIGHT_FLUX]] = True
    sat_grid = has_bright.reshape(TH, TW)
    dil = binary_dilation(sat_grid, np.ones((7, 7), dtype=bool))
    keep = ~dil.reshape(-1)
    print(
        f"saturation: {int(sat_grid.sum())} tiles (mag<14), "
        f"{int(saturated_px.sum())} pixel-saturated -> "
        f"{int(dil.sum())} with neighbors; {int(keep.sum())} of "
        f"{TH * TW} kept"
    )
    # the mask only sees in-region stars: an out-of-region giant would
    # light a kept boundary tile's reach catalog unmasked
    kept_reach_max = np.where(keep, cat["reach_fluxes"].max(-1), 0.0).max()
    if kept_reach_max > BRIGHT_FLUX:
        warnings.warn(
            "a kept tile's render-reach catalog holds a "
            f"{kept_reach_max:.0f}-nmgy star (> the mag-14 saturation limit "
            f"{BRIGHT_FLUX:.0f}) — an out-of-region giant the catalog-based "
            "mask cannot see"
        )

    # hyperparameters, fitted on the tune half of the checkerboard only;
    # giants above saturation are masked, not modelled: left out of the
    # flux-prior fit, whose support is pinned at the saturation limit
    tune = keep & checker
    tune_star = tune[_tile_index(locs_region)]
    fit_fluxes = fluxes_region[tune_star & (fluxes_region < BRIGHT_FLUX)]
    alpha, f_lower, f_upper = fit_truncated_pareto_flux(fit_fluxes,
                                                        upper=BRIGHT_FLUX)
    # per-pixel density: in-tile counts over the in-tile area
    counts_rate = fit_poisson_rate(cat["true_counts"][tune], area=TILE**2)

    gain = float(np.mean(item["gain"][RBAND]))
    adu_per_nmgy0 = float(np.mean(item["flux_calibration"][RBAND]))
    psf_params0 = tuple(float(p) for p in item["psf_params"][RBAND])
    patch, patch_bkg, patch_locs, patch_fluxes = fit_patch(
        image, background, locs_all, fluxes_all)
    mark = time.perf_counter()
    fit = fit_image_model(
        patch, patch_locs, patch_fluxes, psf_params_init=psf_params0,
        background_init=patch_bkg, adu_per_nmgy_init=adu_per_nmgy0,
        num_steps=num_steps, device=device,
    )
    fit_s = time.perf_counter() - mark
    print(f"image-model fit on {device}: {num_steps} L-BFGS steps in "
          f"{fit_s:.3f} s, loss {fit.final_loss:.6f}")

    # artifacts
    np.savez_compressed(
        m71_dir / "tiles.npz",
        images=tiles_flat[keep],
        background=tiles_bkg[keep],
        checkerboard=checker[keep],
        **{k: v[keep] for k, v in cat.items()},
        tile_index=np.flatnonzero(keep),
    )
    # the scatter-free truth variant, when the offline fixture ships its
    # exact generating star list: the same images, keep mask and split
    truth_path = m71_dir / "truth_stars.npz"
    if truth_path.exists():
        with np.load(truth_path) as ts:
            exact_locs = np.stack([ts["rows"], ts["cols"]], axis=-1)
            exact, _, _ = tile_truth_catalogs(exact_locs,
                                              np.asarray(ts["fluxes"]))
        np.savez_compressed(
            m71_dir / "tiles_exact.npz",
            images=tiles_flat[keep],
            background=tiles_bkg[keep],
            checkerboard=checker[keep],
            tile_index=np.flatnonzero(keep),
            **{k: v[keep] for k, v in exact.items()},
        )
        print(f"wrote {m71_dir / 'tiles_exact.npz'} (scatter-free truth)")
    params = {
        "flux_alpha": alpha,
        "flux_lower": f_lower,
        "flux_upper": f_upper,
        "counts_rate": counts_rate,
        "pad": PAD,
        "psf_radius": 8,
        "background": float(np.mean(_region(background))),
        "gain": gain,
        "adu_per_nmgy": fit.adu_per_nmgy,
        "psf_params": list(fit.psf_params),
        "noise_additive": fit.noise_additive,
        "noise_multiplicative": fit.noise_multiplicative,
    }
    with open(m71_dir / "params.yaml", "w") as f:
        yaml.safe_dump(params, f, sort_keys=False)
    print("fitted params:", params)
    print(f"wrote {m71_dir / 'tiles.npz'} and {m71_dir / 'params.yaml'}")
    return {"params": params, "fit": fit, "fit_s": fit_s,
            "fit_steps": num_steps, "kept": int(keep.sum()),
            "wall_s": time.perf_counter() - start}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--no-download", action="store_true",
                        help="read the files in place (nothing is ever "
                        "downloaded; without this flag every archive "
                        "product must be there)")
    parser.add_argument("--device", default="cuda",
                        help="where the image-model fit runs")
    args = parser.parse_args(argv)
    return prepare(args.data_dir, download=not args.no_download,
                   device=args.device)


if __name__ == "__main__":
    main()
