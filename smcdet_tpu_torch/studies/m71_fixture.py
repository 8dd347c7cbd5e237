"""What the M71 studies need from the fixture scripts
(``experiments/m71/make_fixture.py`` and ``prepare_data.py``), as the
port's own copy: those scripts import the JAX package's ``ingest``, so the
card cannot import them.

- The generating constants the studies read: the truncated-Pareto flux
  support's top ``FLUX_UPPER``, the render's ``PSF_RADIUS`` and the target
  region's corner ``REGION_Y0`` / ``REGION_X0`` in frame pixels.
- The prepare-data tile grid: ``TILE``-pixel tiles, ``TW`` of them a row of
  the region, so tile ``i`` sits at row ``(i // TW) * TILE`` and column
  ``(i % TW) * TILE`` of the region.
- ``default_truth_stars``: the default fixture's exact star list, which is
  not committed. The no-giants fixture (``data_nogiants``) is drawn from
  the same seed and consumes the same random stream, leaving out only the
  four saturated giants, so the default list is the no-giants one with the
  giants (replayed from the seed) put back after the region's stars, where
  ``make_fixture.py`` concatenates them.
"""

from __future__ import annotations

import numpy as np

from smcdet_tpu_torch.studies import REPO

__all__ = ["FLUX_UPPER", "PSF_RADIUS", "REGION_X0", "REGION_Y0", "TILE",
           "TW", "M71", "default_truth_stars", "tile_origins"]

M71 = REPO / "experiments" / "m71"

# target region (frame pixels) and the generating model
REGION_Y0, REGION_X0, REGION_H, REGION_W = 900, 1728, 320, 160
MU_PER_PX = 0.030
FLUX_ALPHA, FLUX_LOWER, FLUX_UPPER = 0.214, 0.252, 1804.679
PSF_RADIUS = 8
SEED = 6838  # make_fixture.py's default (NGC 6838)
NUM_GIANTS = 4

TILE = 8
TW = REGION_W // TILE  # region tile-grid width


def _truncated_pareto(rng, n):
    """make_fixture.py's inverse-CDF truncated-Pareto draw."""
    u = rng.uniform(size=n)
    la, ua = FLUX_LOWER ** -FLUX_ALPHA, FLUX_UPPER ** -FLUX_ALPHA
    return (la - u * (la - ua)) ** (-1.0 / FLUX_ALPHA)


def _region_and_giants(seed):
    """The region's stars and the giants, drawn from ``seed`` in
    make_fixture.py's order: the region's Poisson count, rows, columns and
    fluxes, then the giants' rows, columns and log-uniform fluxes around
    two cluster centres."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(MU_PER_PX * REGION_H * REGION_W)
    rows = rng.uniform(REGION_Y0, REGION_Y0 + REGION_H, n)
    cols = rng.uniform(REGION_X0, REGION_X0 + REGION_W, n)
    region = (rows, cols, _truncated_pareto(rng, n))
    centers = np.asarray([[REGION_Y0 + 70.0, REGION_X0 + 50.0],
                          [REGION_Y0 + 240.0, REGION_X0 + 105.0]])
    g_rows = np.repeat(centers[:, 0], 2) + rng.uniform(-9, 9, NUM_GIANTS)
    g_cols = np.repeat(centers[:, 1], 2) + rng.uniform(-9, 9, NUM_GIANTS)
    g_flux = np.exp(rng.uniform(np.log(2600.0), np.log(20000.0),
                                NUM_GIANTS))
    return region, (g_rows, g_cols, g_flux)


def default_truth_stars(nogiants_truth=M71 / "data_nogiants" / "m71"
                        / "truth_stars.npz", seed=SEED):
    """The default fixture's exact star list ``{rows, cols, fluxes}``: the
    no-giants fixture's (``nogiants_truth``, same seed), with the giants
    inserted after the region's stars. Raises if the no-giants list does
    not begin with the region's stars as ``seed`` draws them."""
    region, giants = _region_and_giants(seed)
    n = region[0].size
    with np.load(nogiants_truth) as ts:
        stars = [ts["rows"], ts["cols"], ts["fluxes"]]
    for name, got, want in zip(("rows", "cols", "fluxes"), stars, region):
        if not np.array_equal(got[:n], want):
            raise ValueError(f"{nogiants_truth}: its first {n} {name} are "
                             f"not the region's stars of seed {seed}")
    return {name: np.concatenate([s[:n], g, s[n:]])
            for name, s, g in zip(("rows", "cols", "fluxes"), stars, giants)}


def tile_origins(tile_index):
    """Region-pixel ``(row, col)`` of the top-left corner of each tile of
    the prepare-data grid."""
    tile_index = np.asarray(tile_index)
    return (tile_index // TW) * TILE, (tile_index % TW) * TILE

