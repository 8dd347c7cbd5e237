"""What the M71 studies need from the fixture scripts, taken from the
port's own (``smcdet_tpu_torch.data_prep.make_fixture`` and
``prepare_data``), so that the port keeps one copy of them.

- The generating constants the studies read: the truncated-Pareto flux
  support's top ``FLUX_UPPER``, the render's ``PSF_RADIUS`` and the target
  region's corner ``REGION_Y0`` / ``REGION_X0`` in frame pixels.
- The prepare-data tile grid: ``TILE``-pixel tiles, ``TW`` of them a row of
  the region, so tile ``i`` sits at row ``(i // TW) * TILE`` and column
  ``(i % TW) * TILE`` of the region.
- ``default_truth_stars``: the default fixture's exact star list, which is
  not committed: ``make_fixture``'s draw from the seed, checked against
  the committed no-giants fixture's (``data_nogiants``), drawn from the
  same seed and stream but for the four saturated giants.
"""

from __future__ import annotations

import numpy as np

from smcdet_tpu_torch.data_prep.make_fixture import (  # noqa: F401
    FLUX_ALPHA,
    FLUX_LOWER,
    FLUX_UPPER,
    MU_PER_PX,
    NUM_GIANTS,
    PSF_RADIUS,
    REGION_H,
    REGION_W,
    REGION_X0,
    REGION_Y0,
    SEED,
    draw_stars,
)
from smcdet_tpu_torch.data_prep.prepare_data import TILE, TW
from smcdet_tpu_torch.studies import REPO

__all__ = ["FLUX_UPPER", "PSF_RADIUS", "REGION_X0", "REGION_Y0", "TILE",
           "TW", "M71", "default_truth_stars", "tile_origins"]

M71 = REPO / "experiments" / "m71"


def default_truth_stars(nogiants_truth=M71 / "data_nogiants" / "m71"
                        / "truth_stars.npz", seed=SEED):
    """The default fixture's exact star list ``{rows, cols, fluxes}``, as
    ``make_fixture`` draws it from ``seed``. Raises if the committed
    no-giants list (``nogiants_truth``, drawn from the same seed) is not
    that list without the four giants, which follow the region's stars."""
    rows, cols, fluxes, n_region = draw_stars(np.random.default_rng(seed),
                                               no_giants=False)
    stars = {"rows": rows, "cols": cols, "fluxes": fluxes}
    giants = np.arange(n_region - NUM_GIANTS, n_region)
    with np.load(nogiants_truth) as ts:
        for name, v in stars.items():
            if not np.array_equal(ts[name], np.delete(v, giants)):
                raise ValueError(f"{nogiants_truth}: its {name} are not the "
                                 f"region's stars of seed {seed} and the "
                                 "rest of its field")
    return stars


def tile_origins(tile_index):
    """Region-pixel ``(row, col)`` of the top-left corner of each tile of
    the prepare-data grid."""
    tile_index = np.asarray(tile_index)
    return (tile_index // TW) * TILE, (tile_index % TW) * TILE

