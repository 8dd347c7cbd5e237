"""SDSS survey ingestion (port of ``smcdet_tpu/ingest/sdss.py``, numpy on
the host over the port's FITS/WCS layer):

- ``SDSSDownloader`` — where each SDSS DR12 product (photoField, photoObj,
  frame, psField, fpM) lives on disk, in the archive's directory layout.
  The port downloads nothing: ``fetch`` returns a product's path when the
  file is in place and raises ``FileNotFoundError`` naming the file and
  its archive URL when it is not.
- ``SloanDigitalSkySurvey`` — per-(run, camcol, field) frame reading:
  calibration vector, nearest-grid-interpolated sky background, gain,
  WCS, and conversion of the calibrated sky-subtracted frame back to
  electron counts.
- ``read_psf_params`` — the 6 PSF parameters per band from psField HDU 6,
  with the sigma fields squared.
- ``PhotoFullCatalog`` — photoObj table -> arrays with the star/galaxy
  masks.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from smcdet_tpu_torch.ingest import fits
from smcdet_tpu_torch.ingest.catalogs import FullCatalog, SourceType
from smcdet_tpu_torch.ingest.survey import Survey
from smcdet_tpu_torch.ingest.wcs import TanWCS

__all__ = [
    "BANDS",
    "SDSSDownloader",
    "SloanDigitalSkySurvey",
    "PhotoFullCatalog",
    "read_psf_params",
    "read_frame",
]

BANDS = ("u", "g", "r", "i", "z")


# The SDSS DR12 file products this pipeline consumes: (archive URL
# template, local path template). The URL/directory layout is an external
# fact of data.sdss.org (DR12 data model); templates take the named fields
# produced by ``_sdss_ids``: run (zero-stripped), run6 (6-digit), camcol,
# field (zero-stripped), field4 (4-digit), band. The archive compresses
# frames (bz2) and masks (gzip); the local files are decompressed.
_SDSS_URLBASE = "https://data.sdss.org/sas/dr12/boss"
_SDSS_PRODUCTS = {
    "photofield": (
        "{base}/photoObj/301/{run}/photoField-{run6}-{camcol}.fits",
        "{run}/{camcol}/photoField-{run6}-{camcol}.fits",
    ),
    "photoobj": (
        "{base}/photoObj/301/{run}/{camcol}/"
        "photoObj-{run6}-{camcol}-{field4}.fits",
        "{run}/{camcol}/{field}/photoObj-{run6}-{camcol}-{field4}.fits",
    ),
    "frame": (
        "{base}/photoObj/frames/301/{run}/{camcol}/"
        "frame-{band}-{run6}-{camcol}-{field4}.fits.bz2",
        "{run}/{camcol}/{field}/frame-{band}-{run6}-{camcol}-{field4}.fits",
    ),
    "psfield": (
        "{base}/photo/redux/301/{run}/objcs/{camcol}/"
        "psField-{run6}-{camcol}-{field4}.fit",
        "{run}/{camcol}/{field}/psField-{run6}-{camcol}-{field4}.fits",
    ),
    "mask": (
        "{base}/photo/redux/301/{run}/objcs/{camcol}/"
        "fpM-{run6}-{band}{camcol}-{field4}.fit.gz",
        "{run}/{camcol}/{field}/fpM-{run6}-{band}{camcol}-{field4}.fits",
    ),
}


def _sdss_ids(run=None, camcol=None, field=None, band=None) -> dict:
    """Template fields for one (run, camcol, field, band) identifier."""
    ids = {"base": _SDSS_URLBASE, "camcol": camcol, "band": band}
    if run is not None:
        ids["run"] = str(run).lstrip("0")
        ids["run6"] = f"{int(ids['run']):06d}"
    if field is not None:
        ids["field"] = str(field).lstrip("0")
        ids["field4"] = f"{int(ids['field']):04d}"
    return ids


class SDSSDownloader:
    """The on-disk layout of the SDSS products in ``_SDSS_PRODUCTS`` for a
    list of (run, camcol, field) identifiers. ``fetch`` and the
    ``download_*`` methods check that each product is in place; they
    never open a connection."""

    def __init__(self, image_ids, download_dir):
        self.image_ids = image_ids
        self.download_dir = download_dir

    def local_path(self, product: str, **ids) -> str:
        _, path_tpl = _SDSS_PRODUCTS[product]
        return f"{self.download_dir}/" + path_tpl.format(**_sdss_ids(**ids))

    def url(self, product: str, **ids) -> str:
        url_tpl, _ = _SDSS_PRODUCTS[product]
        return url_tpl.format(**_sdss_ids(**ids))

    def fetch(self, product: str, **ids) -> str:
        """The local path of one product; raises ``FileNotFoundError``
        naming the file and its archive URL if it is not there."""
        dst = self.local_path(product, **ids)
        if not Path(dst).exists():
            raise FileNotFoundError(
                f"{dst} is missing: this program downloads nothing; fetch "
                f"{self.url(product, **ids)} (decompressed) and place it "
                "there"
            )
        return dst

    # -- convenience views used by SloanDigitalSkySurvey ----------------
    def pf_path(self, run, camcol) -> str:
        return self.local_path("photofield", run=run, camcol=camcol)

    def frame_path(self, run, camcol, field, band) -> str:
        return self.local_path(
            "frame", run=run, camcol=camcol, field=field, band=band
        )

    def psfield_path(self, run, camcol, field) -> str:
        return self.local_path("psfield", run=run, camcol=camcol, field=field)

    def catalog_path(self, run, camcol, field) -> str:
        return self.local_path("photoobj", run=run, camcol=camcol, field=field)

    def download_pfs(self):
        for run, camcol, _ in self.image_ids:
            self.fetch("photofield", run=run, camcol=camcol)

    def download_catalogs(self):
        for run, camcol, field in self.image_ids:
            self.fetch("photoobj", run=run, camcol=camcol, field=field)

    def download_images(self):
        for run, camcol, field in self.image_ids:
            for band in BANDS:
                ids = dict(run=run, camcol=camcol, field=field, band=band)
                self.fetch("mask", **ids)
                self.fetch("frame", **ids)

    def download_psfields(self):
        for run, camcol, field in self.image_ids:
            self.fetch("psfield", run=run, camcol=camcol, field=field)

    def download_all(self):
        self.download_pfs()
        self.download_catalogs()
        self.download_images()
        self.download_psfields()


def read_psf_params(psfield_path, bands) -> np.ndarray:
    """6 PSF params per band from psField HDU 6: (sigma1^2, sigma2^2,
    sigmap^2, beta, b, p0) — the sigma fields are squared on load."""
    hdus = fits.read(psfield_path)
    data = hdus[6].data
    out = np.zeros((len(bands), 6), dtype=np.float32)
    for i, band in enumerate(bands):
        row = {
            k: np.asarray(data[k])[0] for k in (
                "psf_sigma1", "psf_sigma2", "psf_sigmap",
                "psf_beta", "psf_b", "psf_p0",
            )
        }
        out[i] = [
            row["psf_sigma1"][band] ** 2,
            row["psf_sigma2"][band] ** 2,
            row["psf_sigmap"][band] ** 2,
            row["psf_beta"][band],
            row["psf_b"][band],
            row["psf_p0"][band],
        ]
    return out


def _nearest_grid_interpolate(small, yy, xx):
    """Nearest-neighbour lookup of ``small`` at fractional grid coords."""
    iy = np.clip(np.rint(yy).astype(int), 0, small.shape[0] - 1)
    ix = np.clip(np.rint(xx).astype(int), 0, small.shape[1] - 1)
    return small[iy[:, None], ix[None, :]]


def read_frame(frame_path, gain, load_image=True):
    """Read one SDSS frame file.

    Returns dict with ``background`` (electrons), ``gain``,
    ``flux_calibration`` (nelec per nmgy, per column), ``wcs`` and — when
    ``load_image`` — ``image`` in electrons (sky re-added).
    """
    hdus = fits.read(frame_path)
    calibration = np.asarray(hdus[1].data, dtype=np.float64)  # [W] nmgy/count
    nelec_per_nmgy = gain / calibration

    sky = hdus[2].data
    sky_small = np.asarray(sky["ALLSKY"], dtype=np.float64)
    sky_small = sky_small.reshape(sky_small.shape[-2:])
    sky_x = np.asarray(sky["XINTERP"], dtype=np.float64).ravel()
    sky_y = np.asarray(sky["YINTERP"], dtype=np.float64).ravel()
    sky_y = sky_y.clip(0, sky_small.shape[0] - 1)
    sky_x = sky_x.clip(0, sky_small.shape[1] - 1)
    large_sky = _nearest_grid_interpolate(sky_small, sky_y, sky_x)
    large_sky_nelec = large_sky * gain

    d = {
        "background": large_sky_nelec,
        "gain": np.asarray(gain),
        "flux_calibration": nelec_per_nmgy,
        "wcs": TanWCS.from_header(hdus[0].header),
    }
    if load_image:
        pixels_ss_nmgy = np.asarray(hdus[0].data, dtype=np.float64)
        pixels_ss_nelec = pixels_ss_nmgy * nelec_per_nmgy[None, :]
        d["image"] = pixels_ss_nelec + large_sky_nelec
    return d


class SloanDigitalSkySurvey(Survey):
    """Survey over (run, camcol, field) frames.

    ``fields``: list of dicts ``{"run": int, "camcol": int,
    "fields": [int, ...]}``.
    """

    BANDS = BANDS

    def __init__(
        self,
        fields,
        dir_path="data/sdss",
        load_image_data=False,
        background_offset=0.0,
        align_to_band=None,
        crop_to_bands=None,
        crop_to_hw=None,
        psf_config=None,
    ):
        self.sdss_path = Path(dir_path)
        self.sdss_fields = fields
        self.load_image_data = load_image_data
        self.background_offset = background_offset
        self.align_to_band = align_to_band
        self.crop_to_bands = crop_to_bands
        self.crop_to_hw = crop_to_hw
        self.psf_config = psf_config or {"pixel_scale": 0.396, "psf_slen": 25}

        self.rcfgcs = []
        self.items = {}
        self.downloader = SDSSDownloader(
            self.image_ids(), download_dir=str(self.sdss_path)
        )

    def image_ids(self):
        out = []
        for rcf in self.sdss_fields:
            for field in rcf["fields"]:
                out.append((rcf["run"], rcf["camcol"], field))
        return out

    def image_id(self, idx):
        return self.rcfgcs[idx][:3]

    def idx(self, image_id):
        return next(
            i
            for i, (run, camcol, field, _) in enumerate(self.rcfgcs)
            if (run, camcol, field) == tuple(image_id)
        )

    def prepare_data(self, download=True):
        """Resolve per-field gains from photoField. ``download=True`` also
        checks that every product a download would place (masks included)
        is there, and raises ``FileNotFoundError`` naming the first one
        missing; ``download=False`` reads the pre-placed files."""
        if download:
            self.downloader.download_pfs()
        for rcf in self.sdss_fields:
            run, camcol, fields_list = rcf["run"], rcf["camcol"], rcf["fields"]
            pf_path = self.downloader.pf_path(run, camcol)
            if not Path(pf_path).exists():
                raise FileNotFoundError(
                    f"{pf_path} does not exist — place the photoField first"
                )
            table = fits.read(pf_path)[1].data
            fieldnums = np.asarray(table["FIELD"]).ravel()
            fieldgains = np.asarray(table["GAIN"])
            for field in fields_list:
                gain = fieldgains[fieldnums == field][0]
                self.rcfgcs.append((run, camcol, field, gain))
        if download:
            self.downloader.download_images()
            self.downloader.download_psfields()

    def __len__(self):
        return len(self.rcfgcs)

    def __getitem__(self, idx):
        if idx not in self.items:
            self.items[idx] = self.get_from_disk(idx)
        return self.items[idx]

    def get_from_disk(self, idx):
        run, camcol, field, gain = self.rcfgcs[idx]
        psf_params = read_psf_params(
            self.downloader.psfield_path(run, camcol, field),
            range(len(self.BANDS)),
        )
        item = {"field": field, "psf_params": psf_params}
        frames = [
            read_frame(
                self.downloader.frame_path(run, camcol, field, band),
                gain[b],
                load_image=self.load_image_data,
            )
            for b, band in enumerate(self.BANDS)
        ]
        for k in frames[0]:
            vals = [f[k] for f in frames]
            item[k] = (
                np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
            )
        item["background"] = item["background"] + self.background_offset
        return item


class PhotoFullCatalog(FullCatalog):
    """SDSS photoObj catalog as arrays."""

    @classmethod
    def from_file(cls, cat_path, wcs: TanWCS, height, width):
        table = fits.read(cat_path)[1].data
        objc_type = np.asarray(table["objc_type"]).ravel()
        thing_id = np.asarray(table["thing_id"]).ravel()
        ras = np.asarray(table["ra"], dtype=np.float64).ravel()
        decs = np.asarray(table["dec"], dtype=np.float64).ravel()
        galaxy_bools = (objc_type == 3) & (thing_id != -1)
        star_bools = (objc_type == 6) & (thing_id != -1)

        star_fluxes = np.asarray(table["psfflux"]) * star_bools[:, None]
        galaxy_fluxes = np.asarray(table["cmodelflux"]) * galaxy_bools[:, None]
        fluxes = star_fluxes + galaxy_fluxes

        keep = galaxy_bools | star_bools
        galaxy_bools, star_bools = galaxy_bools[keep], star_bools[keep]
        ras, decs, fluxes = ras[keep], decs[keep], fluxes[keep]
        nobj = int(ras.shape[0])

        plocs = cls.plocs_from_ra_dec(ras, decs, wcs)
        source_type = np.where(
            star_bools, SourceType.STAR, SourceType.GALAXY
        )
        d = {
            "plocs": plocs.reshape(1, nobj, 2),
            "n_sources": np.asarray([nobj]),
            "source_type": source_type.reshape(1, nobj, 1),
            "fluxes": fluxes.reshape(1, nobj, len(BANDS)),
            "ra": ras.reshape(1, nobj, 1),
            "dec": decs.reshape(1, nobj, 1),
        }
        return cls(height, width, d)

    def restrict_by_ra_dec(self, ra_lim, dec_lim):
        """Restrict to sources inside RA/DEC limits."""
        ra = self["ra"].reshape(-1)
        dec = self["dec"].reshape(-1)
        keep = (
            (ra > ra_lim[0])
            & (ra < ra_lim[1])
            & (dec >= dec_lim[0])
            & (dec <= dec_lim[1])
        )
        d = {"n_sources": np.asarray([int(keep.sum())])}
        for key, val in self.data.items():
            if key != "n_sources":
                d[key] = val[:, keep]
        plocs = d["plocs"]
        height = int(plocs[0, :, 0].max() - plocs[0, :, 0].min())
        width = int(plocs[0, :, 1].max() - plocs[0, :, 1].min())
        return PhotoFullCatalog(height, width, d)
