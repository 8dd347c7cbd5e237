"""The port's source-extractor baseline (smcdet_tpu_torch/detect/) against
the JAX package's on the same inputs, on the CPU: the extractor on the
cases of test_detect.py and on m71 fixture tiles (counts exact, locations
and fluxes to float32 rounding), the mesh background, the F1 grid search,
and the whole baseline's ``sep_results.npz``."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu import detect as jdetect
from smcdet_tpu.detect import baseline as jbaseline
from smcdet_tpu.models.imaging import ImageModel
from smcdet_tpu.models.psf import GaussianPSF
from smcdet_tpu_torch import detect as tdetect
from smcdet_tpu_torch.detect import baseline as tbaseline

REPO = Path(__file__).resolve().parents[1]
M71_TILES = REPO / "experiments/m71/data/m71/tiles.npz"

# Float32 sums in another order: the centroids (weighted means of a few
# pixels) agree to a few ulps of the tile size, the fluxes to a few ulps of
# themselves.
LOC_ATOL = 1e-4
FLUX_RTOL = 1e-5


def render(locs, fluxes, H=32, W=32, background=0.0):
    model = ImageModel(height=H, width=W, psf_radius=6, noise="poisson",
                       background=jnp.float32(background),
                       psf=GaussianPSF(stdev=jnp.float32(1.2)))
    return np.asarray(model.render(jnp.asarray(locs), jnp.asarray(fluxes)))


def _assert_same(jax_out, torch_out):
    jc, jl, jf = (np.asarray(a) for a in jax_out)
    tc, tl, tf = (a.numpy() for a in torch_out)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOC_ATOL)
    np.testing.assert_allclose(tf, jf, rtol=FLUX_RTOL, atol=1e-3)


def _single_pixel():
    img = np.zeros((32, 32), np.float32)
    img[5, 5] = 100.0
    return img


# (image, extract keywords): test_detect.py's cases
CASES = {
    "single": (lambda: render([[10.0, 20.0]], [1000.0]),
               dict(thresh=5.0, err=1.0)),
    "two_sorted": (lambda: render([[8.0, 8.0], [24.0, 24.0]],
                                  [500.0, 900.0]), dict(thresh=5.0, err=1.0)),
    "empty": (lambda: np.zeros((32, 32), np.float32),
              dict(thresh=3.0, err=1.0)),
    "minarea3": (_single_pixel, dict(thresh=3.0, err=1.0, minarea=3)),
    "minarea1": (_single_pixel, dict(thresh=3.0, err=1.0, minarea=1)),
    "deblend": (lambda: render([[16.0, 13.0], [16.0, 18.0]], [800.0, 700.0]),
                dict(thresh=2.0, err=1.0, deblend_cont=0.005)),
    "no_deblend": (lambda: render([[16.0, 13.0], [16.0, 18.0]],
                                  [800.0, 700.0]),
                   dict(thresh=2.0, err=1.0, deblend_cont=1.0)),
    "clean": (lambda: render([[8.0, 8.0], [24.0, 24.0]], [60.0, 900.0]),
              dict(thresh=1.0, err=1.0, clean_param=3.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_extract_matches_jax(case):
    make, kw = CASES[case]
    img = make()
    _assert_same(jdetect.extract(img, **kw),
                 tdetect.extract(torch.tensor(img), **kw))


def test_extract_batch_matches_jax():
    imgs = np.stack([render([[10.0, 10.0]], [1000.0]),
                     render([[20.0, 22.0]], [1500.0]),
                     render([[16.0, 13.0], [16.0, 18.0]], [800.0, 700.0])])
    kw = dict(thresh=2.0, err=1.0, max_detections=8)
    got = tdetect.extract_batch(torch.from_numpy(imgs), **kw)
    _assert_same(jdetect.extract_batch(imgs, **kw), got)
    assert got[0].tolist() == [1, 1, 2]


@pytest.fixture(scope="module")
def m71():
    d = np.load(M71_TILES)
    return {k: d[k] for k in d.files}


@pytest.mark.parametrize("thresh,minarea,deblend,clean", [
    (2.5, 1, 1e-6, 0.0), (4.0, 3, 1e-3, 1.0), (7.0, 5, 1e-6, 1.0)])
def test_extract_matches_jax_on_m71_fixture_tiles(m71, thresh, minarea,
                                                  deblend, clean):
    idx = np.arange(0, 688, 11)  # 63 tiles across the frame
    sub = (m71["images"][idx].astype(np.float32)
           - m71["background"][idx].astype(np.float32))
    err = float(np.sqrt(m71["background"][idx].mean()))
    kw = dict(thresh=thresh, err=err, minarea=minarea, deblend_cont=deblend,
              clean_param=clean)
    want = jdetect.extract_batch(sub, **kw)
    _assert_same(want, tdetect.extract_batch(torch.from_numpy(sub), **kw))
    assert int(np.asarray(want[0]).sum()) > 0


def test_label_components_reaches_the_fixed_point_past_a_check():
    # a one-pixel-wide serpentine: its label travels ~H*W/2 pixels, many
    # times LABEL_CHECK_EVERY sweeps
    from smcdet_tpu.detect.extractor import _label_components as jlabel
    from smcdet_tpu_torch.detect.extractor import (
        LABEL_CHECK_EVERY,
        _label_components,
    )

    mask = np.zeros((16, 16), bool)
    mask[::2] = True
    mask[1::4, -1] = True
    mask[3::4, 0] = True
    got = _label_components(torch.from_numpy(mask)[None])[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jlabel(mask)))
    assert np.unique(got[mask]).tolist() == [0]
    assert mask.sum() > 10 * LABEL_CHECK_EVERY


@pytest.mark.parametrize("case", ["flat_with_star", "gradient"])
def test_estimate_background_matches_jax(case):
    if case == "gradient":
        img = np.asarray(100.0 + np.arange(64)[:, None] * 0.5
                         * np.ones((1, 64)), np.float32)
    else:
        noise = np.asarray(jax.random.normal(jax.random.key(0), (64, 64)))
        img = (150.0 + 3.0 * noise
               + render([[30.0, 30.0]], [5000.0], H=64, W=64)).astype(
            np.float32)
    jb, jr = jdetect.estimate_background(img, box_size=16)
    tb, tr = tdetect.estimate_background(torch.from_numpy(img), box_size=16)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4,
                               atol=1e-5)


def test_tune_extractor_matches_jax(m71):
    cb = m71["checkerboard"]
    idx = np.flatnonzero(cb)[:40]
    images = m71["images"][idx]
    bkg = m71["background"][idx]
    err = float(np.sqrt(bkg.mean()))
    kw = dict(err=err, adu_per_nmgy=856.0, mag_bins=[22.9],
              thresh_grid=[1.0, 2.5, 4.0], minarea_grid=[1, 3],
              deblend_cont_grid=[1e-6, 1e-3], clean_param_grid=[0.0, 1.0])
    want = jdetect.tune_extractor(
        jax.random.key(0), images, m71["true_counts"][idx],
        m71["true_locs"][idx], m71["true_fluxes"][idx],
        background=jnp.asarray(bkg, jnp.float32), **kw)
    got = tdetect.tune_extractor(
        torch.as_tensor(images, dtype=torch.float32),
        torch.from_numpy(m71["true_counts"][idx]),
        torch.from_numpy(m71["true_locs"][idx]),
        torch.from_numpy(m71["true_fluxes"][idx]),
        background=torch.as_tensor(bkg, dtype=torch.float32), **kw)
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], abs=1e-6)
    assert got[0] > 0


def _basic_config(tmp_path):
    from smcdet_tpu.config import load_config as jload
    from smcdet_tpu_torch.config import load_config as tload

    path = REPO / "experiments/basic/config.yaml"
    jcfg, tcfg = jload(path), tload(path)
    for cfg in (jcfg, tcfg):
        cfg.num_images = 8
        cfg.output_dir = str(tmp_path)
    return jcfg, tcfg


# a cut of the default grid (each point matches every tuning tile's 32
# detection slots, seconds on the CPU)
GRID = dict(thresh_grid=[2.5, 5.5], minarea_grid=(1, 3),
            deblend_cont_grid=(1e-6, 1e-3), clean_param_grid=(0.0, 1.0))


def test_run_sep_baseline_matches_jax_on_basic(tmp_path):
    from smcdet_tpu.runner import simulate_tiles

    jcfg, tcfg = _basic_config(tmp_path)
    tiles = simulate_tiles(jcfg)
    jscore, jbest, want = jbaseline.run_sep_baseline(jcfg, tiles, **GRID)
    tscore, tbest, got = tbaseline.run_sep_baseline(tcfg, tiles,
                                                    device="cpu", **GRID)
    assert tbest == jbest
    assert tscore == pytest.approx(jscore, abs=1e-6)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got["counts"], want["counts"])
    np.testing.assert_allclose(got["locs"], want["locs"], rtol=0,
                               atol=LOC_ATOL)
    np.testing.assert_allclose(got["fluxes"], want["fluxes"],
                               rtol=FLUX_RTOL, atol=1e-6)
    for k in ("eval_true_counts", "eval_true_locs", "eval_true_fluxes",
              "eval_indices"):
        np.testing.assert_array_equal(got[k], want[k])


def test_sep_cli_writes_the_jax_scripts_keys(tmp_path, monkeypatch):
    import functools

    import yaml

    monkeypatch.setattr(tbaseline, "run_sep_baseline", functools.partial(
        tbaseline.run_sep_baseline, **GRID))
    with open(REPO / "experiments/basic/config.yaml") as f:
        raw = yaml.safe_load(f)
    raw["output_dir"] = str(tmp_path / "out")
    cfg_path = tmp_path / "basic.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    path = tbaseline.run_sep_cli([str(cfg_path), "--num-images", "8",
                                  "--num-tune", "4", "--device", "cpu"])
    out = np.load(path)
    assert sorted(out.files) == sorted(
        ["counts", "locs", "fluxes", "eval_true_counts", "eval_true_locs",
         "eval_true_fluxes", "eval_indices", "tuned_f1"])
    assert out["counts"].shape == (4,) and out["locs"].shape == (4, 32, 2)
    assert out["eval_indices"].tolist() == [1, 3, 5, 7]
