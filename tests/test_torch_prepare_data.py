"""The port's M71 data front on the CPU (``smcdet_tpu_torch/data_prep``):
``make_fixture`` and ``prepare_data`` for the default seed into a temporary
directory reproduce the committed fixture (``experiments/m71/data/m71``,
written by the JAX package's scripts): ``tiles.npz`` array for array,
``hubble_ngc6838.zpt`` byte for byte, the exact star list equal to
``m71_fixture.default_truth_stars``, the closed-form parameters to 1e-9 and
the L-BFGS fit where the likelihood pins it (``data_prep.compare``); the
two studies that read the survey files reproduce their committed JSONs
(psf_comparison for all three of its runs, the isolated star's refit at
the float64 optimum an independent implementation finds).
The card's render path (torch, not numpy) is held to the host's on CPU
tensors."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu_torch.data_prep import compare, make_fixture, prepare_data
from smcdet_tpu_torch.studies import (
    m71_fixture,
    psf_comparison,
    sky_exactness_probe,
)

REPO = Path(__file__).resolve().parents[1]
M71 = REPO / "experiments" / "m71"
COMMITTED = M71 / "data" / "m71"
RESULTS = REPO / "docs" / "results" / "m71"
with np.load(COMMITTED / "tiles.npz") as _t:
    TILE_KEYS = list(_t.files)


def _load_jax_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("m71_fixture")
    make_fixture.make_fixture(data_dir, device="cpu")
    info = prepare_data.prepare(data_dir, download=False, device="cpu")
    return data_dir, info


@pytest.mark.parametrize("key", TILE_KEYS)
def test_tiles_equal_committed(prepared, key):
    data_dir, _ = prepared
    with np.load(data_dir / "m71" / "tiles.npz") as got, \
            np.load(COMMITTED / "tiles.npz") as want:
        assert got.files == want.files
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_scatter_free_tiles_share_the_images(prepared):
    """``tiles_exact.npz``: the same images, mask and split, its truth
    catalogs from the exact star list, which differ from the catalog's by
    its 0.01-px astrometric scatter."""
    data_dir, _ = prepared
    with np.load(data_dir / "m71" / "tiles_exact.npz") as ex, \
            np.load(data_dir / "m71" / "tiles.npz") as t:
        for k in ("images", "background", "checkerboard", "tile_index"):
            np.testing.assert_array_equal(ex[k], t[k])
        same = ex["true_counts"] == t["true_counts"]
        assert same.mean() > 0.9
        d = np.abs(ex["true_locs"][same] - t["true_locs"][same])
        assert 0 < d.max() < 0.1


def test_catalog_and_truth_files_equal_committed(prepared):
    data_dir, _ = prepared
    got = data_dir / "m71"
    assert (got / "hubble_ngc6838.zpt").read_bytes() == (
        COMMITTED / "hubble_ngc6838.zpt").read_bytes()
    assert yaml.safe_load((got / "fixture_truth.yaml").read_text()) == \
        yaml.safe_load((COMMITTED / "fixture_truth.yaml").read_text())
    stars = m71_fixture.default_truth_stars()
    with np.load(got / "truth_stars.npz") as ts:
        for k in ("rows", "cols", "fluxes"):
            np.testing.assert_array_equal(ts[k], stars[k])


@pytest.mark.parametrize("key", compare.CLOSED_FORM)
def test_closed_form_params_equal_committed(prepared, key):
    data_dir, _ = prepared
    got = yaml.safe_load((data_dir / "m71" / "params.yaml").read_text())
    want = yaml.safe_load((COMMITTED / "params.yaml").read_text())
    assert list(got) == list(want)
    np.testing.assert_allclose(got[key], want[key], rtol=1e-9, atol=0)


def test_lbfgs_fit_held_where_the_likelihood_pins_it(prepared):
    """The fit (optax.lbfgs's algorithm, as the JAX script runs it)
    against the committed one: its loss within 1e-3 relative of the loss
    at the committed parameters on the same patch, the in-window
    calibration 1e-3, the multiplicative noise 2e-2, sigma1 0.15."""
    data_dir, info = prepared
    want = yaml.safe_load((COMMITTED / "params.yaml").read_text())
    fit = info["fit"]
    assert np.isfinite(fit.final_loss) and info["fit_steps"] == 200
    assert compare.hold_params(
        info["params"], want, fit.final_loss,
        compare.patch_loss(data_dir, want), "params.yaml") == []


def test_sky_exactness_equals_committed(prepared, tmp_path):
    data_dir, _ = prepared
    out = tmp_path / "sky_exactness.json"
    sky_exactness_probe.main(["--data-dir", str(data_dir), "--out",
                              str(out)])
    assert out.read_text() == (RESULTS / "sky_exactness.json").read_text()


# psf_comparison run -> (config, fixture)
PSF_RUNS = {"m71": ("config.yaml", "data"),
            "m71_mis": ("config_mis.yaml", "data_mis"),
            "m71_vary": ("config_vary.yaml", "data_vary")}


@pytest.fixture(scope="module")
def psf_reports(prepared, tmp_path_factory):
    """psf_comparison (its command, into ``psf_comparison/output``) for each
    run on the regenerated default fixture's survey files (the misspecified
    fixtures share its psField and WCS and differ in pixels only) with the
    run's committed catalog and tiles (which the default fixture's test
    shows the port reproduces)."""
    data_dir, _ = prepared
    out, reports = tmp_path_factory.mktemp("psf_comparison"), {}
    for name, (config, fixture) in PSF_RUNS.items():
        root = data_dir
        if fixture != "data":
            root = out / fixture
            root.mkdir()
            (root / "sdss").symlink_to(data_dir / "sdss")
            (root / "m71").symlink_to(M71 / fixture / "m71")
        reports[name] = psf_comparison.main([
            "--config", config, "--data-root", str(root), "--output-dir",
            str(out / "output"), "--device", "cpu"])
    return data_dir, reports, out / "output"


@pytest.mark.parametrize("name", PSF_RUNS)
def test_psf_comparison_equals_committed(psf_reports, name):
    """Every key equal; the isolated star's refit at the float64 optimum
    (``compare.REFIT_FLOAT64``), its residual no higher than the committed
    one (the JAX script refits through a float32 profile whose rounding
    decides where it stops)."""
    _, reports, _ = psf_reports
    want = json.loads((RESULTS.parent / name / "psf_comparison.json")
                      .read_text())
    assert compare.hold_psf_comparison(reports[name], want, name) == []
    assert reports[name]["psf"] == want["psf"]


def _refit_float64(fixture, data_root, k):
    """``experiments/m71/psf_comparison.py``'s isolated-star refit of kept
    tile ``k`` with the fitted profile in float64: numpy and scipy, the
    catalog projected by the JAX package's survey reader and WCS."""
    from scipy.optimize import least_squares

    from smcdet_tpu.ingest.sdss import SloanDigitalSkySurvey
    from smcdet_tpu.ingest.wcs import plocs_from_ra_dec
    from smcdet_tpu.utils.units import convert_mag_to_nmgy

    script = _load_jax_script(M71 / "prepare_data.py", "jax_prepare_data")
    tile_side, reach = script.TILE, 8
    fx = M71 / fixture / "m71"
    par = yaml.safe_load((fx / "params.yaml").read_text())
    with np.load(fx / "tiles.npz") as t:
        tile = t["images"][k].astype(np.float64)
        bg = t["background"][k].astype(np.float64)
        orig = int(t["tile_index"][k])
    sdss = SloanDigitalSkySurvey(
        fields=[{"run": script.RUN, "camcol": script.CAMCOL,
                 "fields": [script.FIELD]}],
        dir_path=str(data_root / "sdss"), load_image_data=True)
    sdss.prepare_data(download=False)
    hub = np.loadtxt(fx / "hubble_ngc6838.zpt", skiprows=3,
                     usecols=(9, 21, 22))
    flux_all = np.asarray(convert_mag_to_nmgy(hub[:, 0]))
    locs_all = np.asarray(plocs_from_ra_dec(hub[:, 1], hub[:, 2],
                                            sdss[0]["wcs"][script.RBAND]))
    tw = script.REGION_W // tile_side
    rel = locs_all - [(orig // tw) * tile_side + script.REGION_Y0,
                      (orig % tw) * tile_side + script.REGION_X0]
    near = ((rel > -reach - 0.6) & (rel < tile_side + reach + 0.6)).all(1)
    r_near, f_near = rel[near], flux_all[near]
    inside = ((r_near >= 0) & (r_near < tile_side)).all(1)
    loc, flux = r_near[inside][0], float(f_near[inside][0])
    s1, s2, sp, beta, b, p0 = par["psf_params"]

    def unnorm(r2):
        return (np.exp(-r2 / (2 * s1)) + b * np.exp(-r2 / (2 * s2))
                + p0 * (1 + r2 / (beta * sp)) ** (-beta / 2)) / (1 + b + p0)

    c = np.arange(32 * reach) - 16 * reach + 0.5
    norm = unnorm(c[:, None] ** 2 + c[None, :] ** 2).sum()
    px = np.arange(tile_side)

    def render(ly, lx, f):
        mask = (np.abs(px - np.floor(ly)) <= reach)[:, None] & (
            np.abs(px - np.floor(lx)) <= reach)[None, :]
        r2 = ((px + 0.5) - ly)[:, None] ** 2 + ((px + 0.5) - lx)[None, :] ** 2
        return par["adu_per_nmgy"] * f * unnorm(r2) / norm * mask

    nb = sum((render(*xy, f) for xy, f in zip(r_near[~inside],
                                              f_near[~inside])),
             np.zeros_like(tile))

    def resid(th):
        m = render(th[0], th[1], np.exp(th[2])) + nb + bg
        return ((tile - m) / np.sqrt(par["noise_additive"]
                                     + par["noise_multiplicative"]
                                     * np.maximum(m, 1.0))).ravel()

    fit = least_squares(resid, x0=[loc[0], loc[1], np.log(flux)],
                        method="lm")
    return {"refit_loc_offset_px": [fit.x[0] - loc[0], fit.x[1] - loc[1]],
            "refit_flux_rel_change": np.exp(fit.x[2]) / flux - 1.0,
            compare.REFIT_RMS: np.sqrt(np.mean(fit.fun ** 2))}


@pytest.mark.parametrize("name", PSF_RUNS)
def test_refit_is_the_float64_optimum(psf_reports, name):
    """The port's refit and ``compare.REFIT_FLOAT64`` against an
    independent float64 implementation of the JAX script's refit: the
    report equal to it at the report's decimals, the constants to 1e-6."""
    data_dir, reports, _ = psf_reports
    star = reports[name]["empirical_star"]
    want = _refit_float64(PSF_RUNS[name][1], data_dir, star["tile_index"])
    for k, decimals in (("refit_loc_offset_px", 4),
                        ("refit_flux_rel_change", 4),
                        (compare.REFIT_RMS, 3)):
        np.testing.assert_allclose(star[k], want[k],
                                   atol=0.5 * 10.0 ** -decimals + 1e-9)
        np.testing.assert_allclose(compare.REFIT_FLOAT64[name][k], want[k],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", PSF_RUNS)
def test_psf_comparison_figure_data_draw_at_the_committed_size(psf_reports,
                                                               name, capsys):
    """Each run's figure data: the residual over the noise gives the
    report's RMS, the stamps are the report's FWHMs, and ``python -m
    smcdet_tpu_torch.figures`` draws ``figures/psf_comparison.png`` from
    the file alone at the committed PNG's pixel size."""
    from PIL import Image

    from smcdet_tpu_torch import figures

    _, reports, out = psf_reports
    path = figures.figure_data_path(out / name, "psf_comparison")
    star = reports[name]["empirical_star"]
    with np.load(path) as d:
        assert d["tile"].shape == d["resid"].shape == (8, 8)
        assert d["gauss"].shape == d["diff"].shape == (
            psf_comparison.STAMP,) * 2
        assert round(float(np.sqrt(np.mean((d["resid"] / d["sigma"]) ** 2))),
                     3) == star["residual_rms_over_noise"]
        assert int(d["idx"]) == star["tile_index"]
        assert round(psf_comparison.fwhm(d["fitted"]), 3) == reports[name][
            "psf"]["fitted_model_fwhm_px"]
    png = out / name / "figures" / "psf_comparison.png"
    png.unlink(missing_ok=True)
    assert figures.draw(path) == [png]
    assert Image.open(png).size == Image.open(
        RESULTS.parent / name / "psf_comparison.png").size
    capsys.readouterr()


def test_psf_comparison_figure_is_the_jax_scripts(prepared, tmp_path,
                                                  monkeypatch, capsys):
    """``experiments/m71/psf_comparison.py`` run unedited beside a link to
    the regenerated survey files and the committed catalog and tiles; the
    arrays its figure shows, taken at its ``savefig``, written as the
    port's figure data and drawn by ``figures.draw``: the same PNG, pixel
    for pixel."""
    from matplotlib.figure import Figure
    from matplotlib.image import imread

    from smcdet_tpu_torch import figures

    data_dir, _ = prepared
    jdir = tmp_path / "jax"
    (jdir / "data").mkdir(parents=True)
    for name in ("psf_comparison.py", "config.yaml"):
        (jdir / name).write_bytes((M71 / name).read_bytes())
    (jdir / "data" / "sdss").symlink_to(data_dir / "sdss")
    (jdir / "data" / "m71").symlink_to(COMMITTED)
    monkeypatch.syspath_prepend(str(M71))
    monkeypatch.syspath_prepend(str(REPO / "experiments"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    shown = {}
    savefig = Figure.savefig

    def keep(fig, path, *args, **kwargs):
        import sys

        shown.update(sys._getframe(1).f_locals)
        return savefig(fig, path, *args, **kwargs)

    monkeypatch.setattr(Figure, "savefig", keep)
    monkeypatch.setattr("sys.argv", ["psf_comparison.py"])
    _load_jax_script(jdir / "psf_comparison.py", "jax_psf_comparison").main()
    monkeypatch.setattr(Figure, "savefig", savefig)
    data = figures.save_figure_data(
        tmp_path / "port", "psf_comparison",
        gaussian_fwhm_px=shown["psf_summary"]["gaussian_fwhm_px"],
        **{k: shown[k] for k in ("gauss", "survey", "fitted", "diff",
                                 "tile", "recon", "resid", "sigma", "loc",
                                 "idx")})
    [png] = figures.draw(data)
    np.testing.assert_array_equal(imread(png), imread(
        jdir / "output" / "m71" / "figures" / "psf_comparison.png"))
    capsys.readouterr()


def test_prepare_reads_download_mode_files_in_place(prepared, tmp_path):
    """Without ``--no-download`` every product a download would place must
    be there: the fixture has no fpM masks, so the first one is named."""
    data_dir, _ = prepared
    with pytest.raises(FileNotFoundError, match=r"fpM-006895-u3-0052"):
        prepare_data.main(["--data-dir", str(data_dir), "--device", "cpu"])


# ------------------------------------------------- the card's render path

@pytest.mark.parametrize("misspec", ["none", "elliptical", "varying"])
def test_card_psf_path_matches_host(misspec):
    """``psf_eval_factory`` on tensors (the card's path, here on the CPU)
    against numpy (the host's), on stars spread over the region and
    beyond it (the varying PSF clips there)."""
    rng = np.random.default_rng(1)
    n = 70
    rows = rng.uniform(make_fixture.REGION_Y0 - 120,
                       make_fixture.REGION_Y0 + make_fixture.REGION_H + 50,
                       n)
    dy = rng.uniform(-8.5, 8.5, (n, 17, 1))
    dx = rng.uniform(-8.5, 8.5, (n, 1, 17))
    psf = make_fixture.psf_eval_factory(misspec)
    got = psf(torch.from_numpy(dy), torch.from_numpy(dx),
              torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), psf(dy, dx, rows), rtol=1e-12,
                               atol=0)


def test_card_accumulation_adds_in_star_order():
    """The card's rank-by-rank accumulation gives ``np.add.at``'s sums
    bit for bit, on pixels many entries share."""
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 50, 4000)
    vals = rng.lognormal(0.0, 3.0, 4000)
    got = make_fixture._add_in_star_order(torch.from_numpy(idx),
                                          torch.from_numpy(vals), "cpu")
    want = make_fixture._add_in_star_order(idx, vals, "cpu")
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(want) == 50


def test_images_within_ulp_rule():
    bkg = np.full((2, 3), 900.0)
    frame = np.float32([[1.5, -2.25, 100.0], [0.5, 3.0, 7.0]])
    want = frame.astype(np.float64) * compare.NELEC_PER_NMGY + bkg
    up = np.nextafter(frame, np.float32(np.inf)).astype(np.float64)
    one = up * compare.NELEC_PER_NMGY + bkg
    assert compare.images_within_ulp(one, want, bkg)[:2] == (True, 6)
    two = np.nextafter(up.astype(np.float32), np.float32(np.inf)).astype(
        np.float64) * compare.NELEC_PER_NMGY + bkg
    assert not compare.images_within_ulp(two, want, bkg)[0]
