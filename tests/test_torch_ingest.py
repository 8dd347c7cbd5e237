"""The port's ingestion layer (``smcdet_tpu_torch/ingest``) against the JAX
package's (``smcdet_tpu/ingest``) on the same inputs, made from numpy
seeds: the cases of ``tests/test_ingest.py`` and
``tests/test_sdss_ingest.py`` as parity cases. FITS bytes equal and each
reader reads the other's files; WCS round trips within 1e-9 px; PSF stamps
within 1e-6 relative; the alignment within 1e-5 of the frame's peak; the
frame reader exactly equal; the prediction iterator within 1e-5 relative;
the catalogs exactly equal."""

import bz2
import gzip
import hashlib

import numpy as np
import pytest
import torch
from test_sdss_ingest import (
    CAMCOL,
    FIELD,
    GAINS,
    RUN,
    WCS_CARDS,
    H,
    W,
    make_survey_dir,
)
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu.ingest import catalogs as jcat
from smcdet_tpu.ingest import fits as jfits
from smcdet_tpu.ingest import psf as jpsf
from smcdet_tpu.ingest import sdss as jsdss
from smcdet_tpu.ingest import survey as jsurvey
from smcdet_tpu.ingest import wcs as jwcs
from smcdet_tpu.ingest.align import align as jax_align
from smcdet_tpu_torch.ingest import catalogs as tcat
from smcdet_tpu_torch.ingest import fits as tfits
from smcdet_tpu_torch.ingest import psf as tpsf
from smcdet_tpu_torch.ingest import sdss as tsdss
from smcdet_tpu_torch.ingest import survey as tsurvey
from smcdet_tpu_torch.ingest import wcs as twcs
from smcdet_tpu_torch.ingest.align import align as torch_align


def _sha(b):
    return hashlib.sha256(b).hexdigest()


def _card(text):
    return text.ljust(80).encode("ascii")


def _pad(b):
    return b + b"\x00" * (-len(b) % 2880)


# ------------------------------------------------------------------ FITS

IMAGES = {
    "float32": (np.random.default_rng(0).normal(size=(7, 11))
                .astype(np.float32), {"MYKEY": 42, "SCALE": 1.5}),
    "int16_3d": (np.arange(24, dtype=np.int16).reshape(2, 3, 4), None),
}


@pytest.mark.parametrize("name", IMAGES)
def test_write_image_same_bytes_and_cross_read(name, tmp_path):
    arr, extras = IMAGES[name]
    jfits.write_image(tmp_path / "j.fits", arr, extras)
    tfits.write_image(tmp_path / "t.fits", arr, extras)
    jb, tb = (tmp_path / "j.fits").read_bytes(), (tmp_path /
                                                   "t.fits").read_bytes()
    assert _sha(jb) == _sha(tb)
    for reader, path in ((tfits, "j.fits"), (jfits, "t.fits")):
        hdu = reader.read(tmp_path / path)[0]
        np.testing.assert_array_equal(hdu.data, arr)
        assert hdu.data.dtype == arr.dtype
        for k, v in (extras or {}).items():
            assert hdu.header[k] == v


def test_bscale_bzero_unsigned_read_equal():
    raw = np.asarray([[0, 1], [-32768, 32767]], dtype=np.int16)
    header = b"".join(_card(c) for c in (
        "SIMPLE  =                    T", "BITPIX  =                   16",
        "NAXIS   =                    2", "NAXIS1  =                    2",
        "NAXIS2  =                    2", "BZERO   =                32768",
        "BSCALE  =                    1", "END"))
    buf = _pad(header) + _pad(raw.astype(">i2").tobytes())
    got, want = tfits.read(buf)[0].data, jfits.read(buf)[0].data
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, [[32768, 32769], [0, 65535]])


@pytest.mark.parametrize("compress", [gzip.compress, bz2.compress],
                         ids=["gzip", "bz2"])
def test_compressed_cross_read(compress, tmp_path):
    arr = np.random.default_rng(3).normal(size=(5, 6)).astype(np.float32)
    jfits.write_image(tmp_path / "j.fits", arr)
    buf = compress((tmp_path / "j.fits").read_bytes())
    np.testing.assert_array_equal(tfits.read(buf)[0].data,
                                  jfits.read(buf)[0].data)


def test_hdus_and_bintable_same_bytes_and_cross_read(tmp_path):
    rng = np.random.default_rng(4)
    cols = {"FIELD": np.asarray([12, 13], dtype=np.int32),
            "GAIN": rng.normal(size=(2, 5)).astype(np.float32),
            "ALLSKY": rng.normal(size=(2, 3, 4)).astype(np.float32),
            "X": rng.normal(size=2)}
    img = rng.normal(size=(4, 3))
    for mod, name in ((jfits, "j.fits"), (tfits, "t.fits")):
        mod.write_hdus(tmp_path / name, [
            mod.image_hdu_bytes(img, {"CRPIX1": 3.5}, primary=True),
            mod.image_hdu_bytes(),
            mod.bintable_hdu_bytes(cols)])
    assert _sha((tmp_path / "j.fits").read_bytes()) == _sha(
        (tmp_path / "t.fits").read_bytes())
    for reader, path in ((tfits, "j.fits"), (jfits, "t.fits")):
        hdus = reader.read(tmp_path / path)
        np.testing.assert_array_equal(hdus[0].data, img)
        assert hdus[0].header["CRPIX1"] == 3.5
        assert hdus[1].data is None
        for k, v in cols.items():
            np.testing.assert_array_equal(hdus[2].data[k], v)
            np.testing.assert_array_equal(hdus[2].data[k.lower()], v)


# ------------------------------------------------------------------- WCS

def _wcs(header=WCS_CARDS):
    return jwcs.TanWCS.from_header(header), twcs.TanWCS.from_header(header)


def test_wcs_reference_pixel_and_swapped_axes():
    swapped = dict(WCS_CARDS, CTYPE1="DEC--TAN", CTYPE2="RA---TAN",
                   CRVAL1=WCS_CARDS["CRVAL2"], CRVAL2=WCS_CARDS["CRVAL1"])
    for header in (WCS_CARDS, swapped):
        j, t = _wcs(header)
        x0, y0 = header["CRPIX1"] - 1, header["CRPIX2"] - 1
        assert t.pix2world(x0, y0) == j.pix2world(x0, y0)
        np.testing.assert_allclose(t.pix2world(x0, y0), (298.0, 18.77),
                                   atol=1e-10)


def test_wcs_numpy_equals_jax_and_tensor_round_trip():
    """The numpy path is the JAX package's arithmetic (bit-equal); the
    tensor path (a pixel grid on a device) round-trips within 1e-9 px and
    agrees with numpy to 1e-9 px."""
    j, t = _wcs()
    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 2048, 100), rng.uniform(0, 1489, 100)
    ra, dec = t.pix2world(x, y)
    jra, jdec = j.pix2world(x, y)
    np.testing.assert_array_equal(ra, jra)
    np.testing.assert_array_equal(dec, jdec)
    for a, b in zip(t.world2pix(ra, dec), j.world2pix(ra, dec)):
        np.testing.assert_array_equal(a, b)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    rat, dect = t.pix2world(xt, yt)
    assert isinstance(rat, torch.Tensor) and rat.dtype == torch.float64
    x2, y2 = t.world2pix(rat, dect)
    np.testing.assert_allclose(x2.numpy(), x, atol=1e-9, rtol=0)
    np.testing.assert_allclose(y2.numpy(), y, atol=1e-9, rtol=0)
    sx, sy = j.world2pix(rat.numpy(), dect.numpy())
    np.testing.assert_allclose(sx, x, atol=1e-9, rtol=0)
    np.testing.assert_allclose(sy, y, atol=1e-9, rtol=0)


def test_wcs_local_linearity_matches_cd():
    _, t = _wcs()
    x0, y0 = WCS_CARDS["CRPIX1"] - 1, WCS_CARDS["CRPIX2"] - 1
    ra0, dec0 = t.pix2world(x0, y0)
    ra1, dec1 = t.pix2world(x0 + 1, y0)
    dra = (ra1 - ra0 + 180) % 360 - 180
    np.testing.assert_allclose(dra * np.cos(np.deg2rad(dec0)), -6.0e-6,
                               rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(dec1 - dec0, 1.09e-4, rtol=1e-3)


def test_plocs_convention_equals_jax():
    j, t = _wcs()
    ra, dec = j.pix2world(np.asarray([10.0, 40.0]), np.asarray([20.0, 30.0]))
    got = twcs.plocs_from_ra_dec(ra, dec, t)
    np.testing.assert_array_equal(got, jwcs.plocs_from_ra_dec(ra, dec, j))
    np.testing.assert_allclose(got[0], [20.5, 10.5], atol=1e-6)


# ------------------------------------------------------------ the survey

@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    """One survey directory (written by the JAX package's writer) read by
    both packages."""
    base = make_survey_dir(tmp_path_factory.mktemp("sdss_parity"))
    fields = [{"run": RUN, "camcol": CAMCOL, "fields": [FIELD]}]
    out = []
    for mod in (jsdss, tsdss):
        s = mod.SloanDigitalSkySurvey(fields, dir_path=str(base),
                                      load_image_data=True)
        s.prepare_data(download=False)
        out.append(s)
    return out


def test_gain_resolution_equal(surveys):
    j, t = surveys
    assert len(t) == len(j) == 1
    np.testing.assert_array_equal(t.rcfgcs[0][3], j.rcfgcs[0][3])
    np.testing.assert_allclose(t.rcfgcs[0][3], GAINS)


def test_read_frame_exactly_equal(surveys):
    j, t = surveys
    a, b = t[0], j[0]
    for k in ("image", "background", "flux_calibration", "gain",
              "psf_params"):
        np.testing.assert_array_equal(a[k], b[k])
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    for wa, wb in zip(a["wcs"], b["wcs"]):
        np.testing.assert_array_equal(wa.cd, wb.cd)
        np.testing.assert_array_equal(wa.crpix, wb.crpix)
    path = t.downloader.frame_path(RUN, CAMCOL, FIELD, "g")
    one = tsdss.read_frame(path, float(GAINS[1]), load_image=False)
    assert "image" not in one
    np.testing.assert_array_equal(
        one["background"], jsdss.read_frame(path, float(GAINS[1]),
                                            load_image=False)["background"])


def test_read_psf_params_equal(surveys):
    _, t = surveys
    path = t.downloader.psfield_path(RUN, CAMCOL, FIELD)
    got = tsdss.read_psf_params(path, [2, 4])
    np.testing.assert_array_equal(got, jsdss.read_psf_params(path, [2, 4]))
    np.testing.assert_allclose(got[0, 0], 1.3**2, rtol=1e-6)


@pytest.mark.parametrize("crop", [None, ([1, 2], (4, 36, 0, 50))],
                         ids=["whole", "cropped"])
def test_predict_iterator_matches_jax(surveys, crop):
    j, t = surveys
    for s in (j, t):
        s.crop_to_bands, s.crop_to_hw = crop or (None, None)
    try:
        got = tsurvey.SurveyPredictIterator(t, device="cpu")[0]
        want = jsurvey.SurveyPredictIterator(j)[0]
    finally:
        for s in (j, t):
            s.crop_to_bands = s.crop_to_hw = None
    assert got["images"].dtype == torch.float32
    assert tuple(got["images"].shape) == want["images"].shape
    np.testing.assert_allclose(got["images"].numpy(), want["images"],
                               rtol=1e-5, atol=1e-5 * np.abs(
                                   want["images"]).max())
    np.testing.assert_array_equal(got["psf_params"], want["psf_params"])


def test_predict_iterator_aligned_matches_jax(surveys):
    j, t = surveys
    for s in (j, t):
        s.align_to_band = 2
    try:
        got = tsurvey.SurveyPredictIterator(t, device="cpu")[0]["images"]
        want = jsurvey.SurveyPredictIterator(j)[0]["images"]
    finally:
        for s in (j, t):
            s.align_to_band = None
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_photo_catalog_equal(surveys):
    _, t = surveys
    path = t.downloader.catalog_path(RUN, CAMCOL, FIELD)
    wcs_j, wcs_t = _wcs()
    got = tsdss.PhotoFullCatalog.from_file(path, wcs_t, H, W)
    want = jsdss.PhotoFullCatalog.from_file(path, wcs_j, H, W)
    assert got.data.keys() == want.data.keys()
    for k in want.data:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["n_sources"][0] == 3
    np.testing.assert_array_equal(got.star_bools, want.star_bools)
    sub = got.restrict_by_ra_dec((-1e9, 1e9), (-90.0, 90.0))
    ref = want.restrict_by_ra_dec((-1e9, 1e9), (-90.0, 90.0))
    assert (sub.height, sub.width) == (ref.height, ref.width)


def test_downloader_layout_equal_and_missing_file_raises(tmp_path):
    ids = [(RUN, CAMCOL, FIELD)]
    j = jsdss.SDSSDownloader(ids, str(tmp_path))
    t = tsdss.SDSSDownloader(ids, str(tmp_path))
    for product, kw in (("photofield", dict(run=RUN, camcol=CAMCOL)),
                        ("photoobj", dict(run=RUN, camcol=CAMCOL,
                                          field=FIELD)),
                        ("frame", dict(run=RUN, camcol=CAMCOL, field=FIELD,
                                       band="r")),
                        ("psfield", dict(run=RUN, camcol=CAMCOL,
                                         field=FIELD)),
                        ("mask", dict(run=RUN, camcol=CAMCOL, field=FIELD,
                                      band="g"))):
        assert t.local_path(product, **kw) == j.local_path(product, **kw)
        assert t.url(product, **kw) == jsdss._SDSS_PRODUCTS[product][
            0].format(**jsdss._sdss_ids(**kw))
        with pytest.raises(FileNotFoundError) as e:
            t.fetch(product, **kw)
        assert t.local_path(product, **kw) in str(e.value)
        assert t.url(product, **kw) in str(e.value)
    path = t.local_path("psfield", run=RUN, camcol=CAMCOL, field=FIELD)
    __import__("pathlib").Path(path).parent.mkdir(parents=True)
    open(path, "wb").close()
    assert t.fetch("psfield", run=RUN, camcol=CAMCOL, field=FIELD) == path


# ----------------------------------------------------------------- align

def _shifted(dx):
    j0, t0 = _wcs()
    j1, t1 = _wcs(dict(WCS_CARDS, CRPIX1=WCS_CARDS["CRPIX1"] + dx))
    return [j0, j1], [t0, t1]


@pytest.mark.parametrize("dx", [0.0, 3.0, 2.37],
                         ids=["identity", "integer", "fractional"])
def test_align_matches_jax(dx):
    rng = np.random.default_rng(2)
    base = rng.normal(size=(32, 40))
    img = np.stack([base, np.roll(base, int(round(dx)), axis=1)])
    jw, tw = _shifted(dx)
    got = torch_align(img, tw, ref_band=0, device="cpu")
    want = jax_align(img, jw, ref_band=0)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(img).max())
    # the zeroed footprint is the same
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    if dx == 0.0:
        np.testing.assert_allclose(got[:, 4:-4, 4:-4].numpy(),
                                   img[:, 4:-4, 4:-4], atol=1e-4)


def test_align_with_depth_matches_jax():
    rng = np.random.default_rng(5)
    img = rng.normal(size=(2, 2, 24, 30))
    jw, tw = _shifted(1.5)
    got = torch_align(img, [tw, tw[::-1]], ref_band=1, ref_depth=1,
                       device="cpu")
    want = jax_align(img, [jw, jw[::-1]], ref_band=1, ref_depth=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(img).max())


# ------------------------------------------------------------------- PSF

PSF_PARAMS = (1.3**2, 2.3**2, 1.9**2, 3.2, 0.08, 0.004)


@pytest.mark.parametrize("slen", [25, 9])
def test_render_psf_image_matches_jax(slen):
    got = tpsf.render_psf_image(PSF_PARAMS, slen, device="cpu")
    want = jpsf.render_psf_image(PSF_PARAMS, slen)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert int(got.argmax()) == (slen // 2) * slen + slen // 2
    with pytest.raises(ValueError, match="odd"):
        tpsf.render_psf_image(PSF_PARAMS, 24, device="cpu")


def test_image_psf_matches_jax():
    params = np.tile(np.asarray(PSF_PARAMS), (5, 1))
    params[:, 3] += np.arange(5) * 0.5
    got = tpsf.ImagePSF(params, psf_slen=25, device="cpu")
    want = jpsf.ImagePSF(params, psf_slen=25)
    assert got.n_bands == want.n_bands == 5
    rng = np.random.default_rng(6)
    dy, dx = rng.uniform(-12, 12, (2, 50))
    for band in (0, 2, 4):
        np.testing.assert_allclose(got.at(band, dy, dx).numpy(),
                                   want.at(band, dy, dx), rtol=1e-6)
        np.testing.assert_allclose(got.image(band).numpy(),
                                   want.image(band), rtol=1e-6)


# -------------------------------------------------------------- catalogs

def _full(mod):
    rng = np.random.default_rng(7)
    n = 12
    plocs = rng.uniform(0, 32, (1, n + 2, 2))
    d = {"plocs": plocs, "n_sources": np.asarray([n]),
         "source_type": rng.integers(0, 2, (1, n + 2, 1)),
         "fluxes": rng.uniform(0, 30, (1, n + 2, 5))}
    return mod.FullCatalog(32, 32, d)


def _same(a, b):
    assert a.data.keys() == b.data.keys()
    for k in b.data:
        np.testing.assert_array_equal(a[k], b[k])


def test_tile_round_trip_equal():
    t, j = _full(tcat).to_tile_catalog(16, 8), _full(jcat).to_tile_catalog(
        16, 8)
    _same(t, j)
    _same(t.to_full_catalog(), j.to_full_catalog())
    np.testing.assert_array_equal(t.is_on_mask, j.is_on_mask)
    np.testing.assert_array_equal(_full(tcat).star_bools,
                                  _full(jcat).star_bools)
    # JAX's magnitudes are float32 (jnp.log10), the port's float64
    np.testing.assert_allclose(_full(tcat).on_magnitudes(),
                               _full(jcat).on_magnitudes(), rtol=1e-6)


def test_flux_filter_and_brightest_per_tile_equal():
    t, j = _full(tcat).to_tile_catalog(16, 8), _full(jcat).to_tile_catalog(
        16, 8)
    _same(t.filter_by_flux(min_flux=9.0), j.filter_by_flux(min_flux=9.0))
    for top_k, exclude in ((1, 0), (2, 1)):
        _same(t.get_brightest_sources_per_tile(top_k, exclude),
              j.get_brightest_sources_per_tile(top_k, exclude))


def test_ploc_box_and_union_equal():
    t, j = _full(tcat), _full(jcat)
    _same(t.filter_by_ploc_box([4.0, 2.0], 16.0),
          j.filter_by_ploc_box([4.0, 2.0], 16.0))
    tt, jt = t.to_tile_catalog(16, 8), j.to_tile_catalog(16, 8)
    _same(tt.union(tt.filter_by_flux(10.0)), jt.union(jt.filter_by_flux(
        10.0)))
    assert tcat.SourceType.GALAXY == jcat.SourceType.GALAXY == 1
