"""Catalog data structures (dict-of-array containers; port of
``smcdet_tpu/ingest/catalogs.py``, numpy on the host): RA/DEC -> pixel
conversion, full<->tile conversions, flux filtering, brightest-k per tile,
ploc-box filtering, and union.

Conventions:
- ``plocs`` are (row, col) pixel coordinates with (0, 0) at the image
  corner.
- Padded slots are explicit via ``n_sources``; per-batch slot ``m`` is
  active iff ``m < n_sources``.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np
import torch

from smcdet_tpu_torch.ingest.wcs import plocs_from_ra_dec
from smcdet_tpu_torch.utils.units import convert_nmgy_to_mag

__all__ = ["SourceType", "FullCatalog", "TileCatalog"]


class SourceType(IntEnum):
    STAR = 0
    GALAXY = 1


class _CatalogBase:
    def __init__(self, d: dict):
        self.data = dict(d)

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        self.data[key] = np.asarray(value)

    def __contains__(self, key):
        return key in self.data

    def keys(self):
        return self.data.keys()

    def items(self):
        return self.data.items()


class FullCatalog(_CatalogBase):
    """Whole-image catalog: ``plocs [B, N, 2]``, ``n_sources [B]``, plus
    arbitrary per-source fields ``[B, N, k]``."""

    plocs_from_ra_dec = staticmethod(plocs_from_ra_dec)

    def __init__(self, height: int, width: int, d: dict):
        super().__init__(d)
        self.height = height
        self.width = width
        self.batch_size, self.max_sources = d["plocs"].shape[:2]

    @property
    def is_on_mask(self) -> np.ndarray:
        arange = np.arange(self.max_sources)
        return arange[None, :] < self.data["n_sources"][:, None]

    @property
    def star_bools(self) -> np.ndarray:
        return (
            (self.data["source_type"][..., 0] == SourceType.STAR)
            & self.is_on_mask
        )

    @property
    def galaxy_bools(self) -> np.ndarray:
        return (
            (self.data["source_type"][..., 0] == SourceType.GALAXY)
            & self.is_on_mask
        )

    def on_fluxes(self) -> np.ndarray:
        return self.data["fluxes"] * self.is_on_mask[..., None]

    def on_magnitudes(self, zero_point=1.0) -> np.ndarray:
        f = np.maximum(self.on_fluxes() / zero_point, 1e-30)
        return convert_nmgy_to_mag(torch.from_numpy(f)).numpy()

    def filter_by_ploc_box(self, box_origin, box_len: float) -> "FullCatalog":
        """Keep sources inside the [origin, origin+len)^2 box, shifting
        plocs to the box frame."""
        origin = np.asarray(box_origin, dtype=np.float64)
        plocs = self.data["plocs"]
        inside = np.all(
            (plocs >= origin) & (plocs < origin + box_len), axis=-1
        ) & self.is_on_mask

        out = {}
        n_new = inside.sum(-1)
        m_new = int(n_new.max()) if n_new.size else 0
        B = self.batch_size
        for key, val in self.data.items():
            if key == "n_sources":
                out[key] = n_new
                continue
            new = np.zeros((B, m_new) + val.shape[2:], dtype=val.dtype)
            for b in range(B):
                sel = val[b][inside[b]]
                new[b, : sel.shape[0]] = sel
            out[key] = new
        out["plocs"] = out["plocs"] - origin
        return FullCatalog(int(box_len), int(box_len), out)

    def to_tile_catalog(
        self, tile_slen: int, max_sources_per_tile: int
    ) -> "TileCatalog":
        """Assign each source to its tile (scatter
        formulation). Raises if any tile overflows."""
        B = self.batch_size
        n_th = self.height // tile_slen
        n_tw = self.width // tile_slen
        M = max_sources_per_tile
        plocs = self.data["plocs"]
        on = self.is_on_mask

        out = {
            "locs": np.zeros((B, n_th, n_tw, M, 2)),
            "n_sources": np.zeros((B, n_th, n_tw), dtype=np.int64),
        }
        extra = {
            k: np.zeros((B, n_th, n_tw, M) + v.shape[2:], dtype=v.dtype)
            for k, v in self.data.items()
            if k not in ("plocs", "n_sources")
        }
        for b in range(B):
            for s in range(self.max_sources):
                if not on[b, s]:
                    continue
                r, c = plocs[b, s]
                th = min(int(r // tile_slen), n_th - 1)
                tw = min(int(c // tile_slen), n_tw - 1)
                m = out["n_sources"][b, th, tw]
                if m >= M:
                    raise ValueError(
                        f"tile ({th},{tw}) overflows max_sources_per_tile={M}"
                    )
                out["locs"][b, th, tw, m] = (
                    r - th * tile_slen,
                    c - tw * tile_slen,
                )
                for k in extra:
                    extra[k][b, th, tw, m] = self.data[k][b, s]
                out["n_sources"][b, th, tw] += 1
        out.update(extra)
        return TileCatalog(tile_slen, out)


class TileCatalog(_CatalogBase):
    """Tile-gridded catalog: ``locs [B, Th, Tw, M, 2]`` (tile-local),
    ``n_sources [B, Th, Tw]``."""

    def __init__(self, tile_slen: int, d: dict):
        super().__init__(d)
        self.tile_slen = tile_slen
        (
            self.batch_size,
            self.n_tiles_h,
            self.n_tiles_w,
            self.max_sources,
        ) = d["locs"].shape[:4]

    @property
    def is_on_mask(self) -> np.ndarray:
        arange = np.arange(self.max_sources)
        return arange[None, None, None, :] < self.data["n_sources"][..., None]

    def on_fluxes(self) -> np.ndarray:
        return self.data["fluxes"] * self.is_on_mask[..., None]

    def to_full_catalog(self, height=None, width=None) -> FullCatalog:
        """Flatten tiles back to image coordinates."""
        B = self.batch_size
        height = height or self.n_tiles_h * self.tile_slen
        width = width or self.n_tiles_w * self.tile_slen
        on = self.is_on_mask
        n_total = on.reshape(B, -1).sum(-1)
        m_new = int(n_total.max()) if n_total.size else 0

        tile_origin = np.stack(
            np.meshgrid(
                np.arange(self.n_tiles_h) * self.tile_slen,
                np.arange(self.n_tiles_w) * self.tile_slen,
                indexing="ij",
            ),
            axis=-1,
        )  # [Th, Tw, 2]
        plocs_global = (
            self.data["locs"] + tile_origin[None, :, :, None, :]
        )

        out = {
            "plocs": np.zeros((B, m_new, 2)),
            "n_sources": n_total,
        }
        extra = {
            k: np.zeros((B, m_new) + v.shape[4:], dtype=v.dtype)
            for k, v in self.data.items()
            if k not in ("locs", "n_sources")
        }
        for b in range(B):
            sel = on[b]
            n = int(sel.sum())
            out["plocs"][b, :n] = plocs_global[b][sel]
            for k in extra:
                extra[k][b, :n] = self.data[k][b][sel]
        out.update(extra)
        return FullCatalog(height, width, out)

    def filter_by_flux(self, min_flux=0.0, band=2) -> "TileCatalog":
        """Drop sources below ``min_flux`` in ``band``, compacting slots
        to the front."""
        fluxes = self.data["fluxes"][..., band]
        keep = (fluxes >= min_flux) & self.is_on_mask
        order = np.argsort(~keep, axis=-1, kind="stable")
        d = {"n_sources": keep.sum(-1)}
        for k, v in self.data.items():
            if k == "n_sources":
                continue
            idx = order.reshape(order.shape + (1,) * (v.ndim - 4))
            kept = np.take_along_axis(
                v * keep.reshape(keep.shape + (1,) * (v.ndim - 4)),
                idx,
                axis=3,
            )
            d[k] = kept
        return TileCatalog(self.tile_slen, d)

    def get_brightest_sources_per_tile(
        self, top_k=1, exclude_num=0, band=2
    ) -> "TileCatalog":
        """Keep the top-k brightest per tile after skipping ``exclude_num``
       ."""
        fluxes = np.where(self.is_on_mask, self.data["fluxes"][..., band],
                          -np.inf)
        order = np.argsort(-fluxes, axis=-1, kind="stable")
        sel = order[..., exclude_num : exclude_num + top_k]
        d = {}
        n_on = np.minimum(
            np.maximum(self.data["n_sources"] - exclude_num, 0), top_k
        )
        d["n_sources"] = n_on
        keep_mask = (
            np.arange(top_k)[None, None, None, :] < n_on[..., None]
        )
        for k, v in self.data.items():
            if k == "n_sources":
                continue
            idx = sel.reshape(sel.shape + (1,) * (v.ndim - 4))
            kept = np.take_along_axis(v, idx, axis=3)
            kept = kept * keep_mask.reshape(
                keep_mask.shape + (1,) * (v.ndim - 4)
            )
            d[k] = kept
        return TileCatalog(self.tile_slen, d)

    def union(self, other: "TileCatalog") -> "TileCatalog":
        """Concatenate two tile catalogs slot-wise."""
        assert self.tile_slen == other.tile_slen
        d = {"n_sources": self.data["n_sources"] + other.data["n_sources"]}
        # compact: self's active slots first, then other's
        M1, M2 = self.max_sources, other.max_sources
        on1, on2 = self.is_on_mask, other.is_on_mask
        keep = np.concatenate([on1, on2], axis=-1)
        order = np.argsort(~keep, axis=-1, kind="stable")
        for k in self.data:
            if k == "n_sources":
                continue
            v = np.concatenate([self.data[k], other.data[k]], axis=3)
            idx = order.reshape(order.shape + (1,) * (v.ndim - 4))
            d[k] = np.take_along_axis(
                v * keep.reshape(keep.shape + (1,) * (v.ndim - 4)), idx, axis=3
            )
        return TileCatalog(self.tile_slen, d)
