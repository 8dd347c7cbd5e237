"""How a fixture regenerated by ``make_fixture`` + ``prepare_data`` is held
to a committed one (``experiments/m71/data*/m71``), and the two JSON
studies to their committed reports.

- ``tiles*.npz``: every array the committed file holds; integer, boolean,
  catalog and background arrays exactly equal. ``images`` exactly equal,
  or, where the star render ran on the card (whose float64 ``exp`` may
  round a pixel differently from numpy's), within one float32 ulp of the
  frame pixel it came from. Arrays only the regenerated file holds are
  allowed (the committed ``data_mis`` predates the ``reach_*`` catalogs).
- ``hubble_ngc6838.zpt``: byte-equal. ``fixture_truth.yaml``: every
  committed key equal (the older files lack ``no_giants``).
- ``params.yaml``: the closed-form entries within 1e-9 relative; the
  L-BFGS entries where the likelihood pins them — the fit's loss within
  1e-3 relative of the loss at the committed parameters on the same
  patch, the calibration as it reaches the pixels
  (``fitting.in_window_calibration``) 1e-3, ``noise_multiplicative``
  2e-2, sigma1 0.15 — and the rest reported, not held: the wing (sigma2,
  sigmap, beta, b, p0), which barely moves the likelihood,
  ``noise_additive``, and ``adu_per_nmgy``, which trades with the wing's
  mass outside the render window (on ``data_vary`` the JAX script's own
  fit moves it 0.15% under a reordering of the patch's stars, and the
  float64 optimum lies 0.9% below the committed value, at the same
  in-window calibration to 1e-6).
- ``psf_comparison.json``: every key equal but the isolated star's refit.
  The JAX script refits through a float32 profile, whose rounding is
  coarser than least_squares' finite-difference step, so its refit stops
  where its exp's float32 rounding leaves it; the port refits through a
  float64 profile on the host and reaches the least-squares optimum. The
  refit's keys are held to that optimum (``REFIT_FLOAT64``, from an
  independent numpy implementation of the JAX script's formulas that
  ``tests/test_torch_prepare_data.py`` recomputes) to one unit of the
  report's last decimal, its residual RMS also no higher than the
  committed one; the committed values are printed beside them.
  ``sky_exactness.json``: the same text.

Each ``hold_*`` returns a list of failures (empty when held) and prints
what it compared.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import yaml

from smcdet_tpu_torch.data_prep import make_fixture as mf

__all__ = ["CLOSED_FORM", "LBFGS_HELD", "WING", "REFIT_FLOAT64",
           "images_within_ulp", "hold_npz", "hold_params", "hold_fixture",
           "hold_psf_comparison", "patch_loss"]

CLOSED_FORM = ("flux_alpha", "flux_lower", "flux_upper", "counts_rate",
               "pad", "psf_radius", "background", "gain")
CLOSED_FORM_RTOL = 1e-9
LOSS_RTOL = 1e-3
# relative tolerances of the L-BFGS entries the likelihood pins
LBFGS_HELD = {"in_window_calibration": 1e-3, "noise_multiplicative": 2e-2,
              "sigma1": 0.15}
# the L-BFGS entries it barely constrains, reported
WING = ("adu_per_nmgy", "sigma2", "sigmap", "beta", "b", "p0",
        "noise_additive")
PSF_NAMES = ("sigma1", "sigma2", "sigmap", "beta", "b", "p0")
# the isolated star's refit at the float64 least-squares optimum, per
# psf_comparison run; held to one unit of the report's last decimal
REFIT_RMS = "refit_residual_rms_over_noise"
REFIT_FLOAT64 = {
    "m71": {"refit_loc_offset_px": [0.00969946, 0.00585181],
            "refit_flux_rel_change": -0.00251042, REFIT_RMS: 0.951551},
    "m71_mis": {"refit_loc_offset_px": [0.0227030, -0.0931824],
                "refit_flux_rel_change": -0.0215040, REFIT_RMS: 1.13780},
    "m71_vary": {"refit_loc_offset_px": [0.167975, -0.195094],
                 "refit_flux_rel_change": -0.172709, REFIT_RMS: 6.38198},
}
REFIT_TOL = {"refit_loc_offset_px": 1e-4, "refit_flux_rel_change": 1e-4,
             REFIT_RMS: 1e-3}
# the fixture's electrons per nmgy, which scales a frame pixel's ulp
NELEC_PER_NMGY = float(mf.GAINS[mf.RBAND] / mf.CALIB_NMGY_PER_COUNT)


def images_within_ulp(got, want, background):
    """``(held, n_differing, max_ulps)``: tile images (electrons) against
    the committed ones, each pixel within one float32 ulp of the frame
    pixel (nmgy) it was read from."""
    got, want = np.asarray(got), np.asarray(want)
    frame = np.abs((want - np.asarray(background)) / NELEC_PER_NMGY)
    ulp = np.spacing(frame.astype(np.float32)).astype(np.float64) \
        * NELEC_PER_NMGY
    err = np.abs(got - want)
    ulps = float((err / ulp).max()) if err.size else 0.0
    return bool((err <= ulp * (1 + 1e-6)).all()), int((got != want).sum()), \
        ulps


def hold_npz(got_path, want_path, label, exact_images=True):
    """A regenerated ``.npz`` against the committed one (module rule)."""
    fails = []
    with np.load(got_path) as g, np.load(want_path) as w:
        missing = sorted(set(w.files) - set(g.files))
        if missing:
            fails.append(f"{label}: arrays missing {missing}")
        for k in sorted(set(w.files) & set(g.files)):
            a, b = g[k], w[k]
            if a.shape != b.shape or a.dtype != b.dtype:
                fails.append(f"{label}: {k} {a.dtype}{a.shape} against "
                             f"{b.dtype}{b.shape}")
            elif k == "images" and not exact_images:
                ok, n, ulps = images_within_ulp(a, b, w["background"])
                print(f"[compare] {label}: images differ in {n} of "
                      f"{b.size} pixels, at most {ulps:.3g} float32 ulp "
                      "of the frame pixel")
                if not ok:
                    fails.append(f"{label}: images beyond 1 ulp ({ulps})")
            elif not np.array_equal(a, b):
                fails.append(f"{label}: {k} differs in "
                             f"{int((a != b).sum())} entries")
        extra = sorted(set(g.files) - set(w.files))
    print(f"[compare] {label}: {len(w.files) - len(missing)} committed "
          f"arrays compared, extra {extra}: "
          f"{'held' if not fails else 'MISSED'}")
    return fails


def _entries(params):
    """A params.yaml dict with its PSF entries by name and its in-window
    calibration."""
    from smcdet_tpu_torch.fitting import in_window_calibration

    return {**params, **dict(zip(PSF_NAMES, params["psf_params"])),
            "in_window_calibration": in_window_calibration(
                params["adu_per_nmgy"], params["psf_params"],
                params["psf_radius"])}


def patch_loss(data_dir, params, device="cpu"):
    """The per-pixel negative log-likelihood of the fit's patch in
    ``data_dir`` under ``params`` (a params.yaml dict), the loss the
    image-model fit minimises."""
    import torch

    from smcdet_tpu_torch import convert, fitting
    from smcdet_tpu_torch.data_prep import prepare_data as P

    item, locs_all, fluxes_all = P.read_survey(data_dir)
    patch, sky, locs, fluxes = P.fit_patch(
        item["image"][P.RBAND], item["background"][P.RBAND], locs_all,
        fluxes_all)
    model = convert.m71_model_from_fit(
        fitting.FittedImageModel(tuple(params["psf_params"]), 0.0,
                                 params["adu_per_nmgy"],
                                 params["noise_additive"],
                                 params["noise_multiplicative"], 0.0),
        P.FIT_HW, P.FIT_HW, params["psf_radius"],
        background=torch.as_tensor(sky, device=device), device=device)

    def t(a):
        return torch.as_tensor(a, device=device)

    return -float(model.loglikelihood(t(patch), t(locs), t(fluxes))) / (
        P.FIT_HW * P.FIT_HW)


def hold_params(got, want, loss, want_loss, label):
    """The regenerated params.yaml dict against the committed one;
    ``loss`` is the fit's, ``want_loss`` the loss at the committed
    parameters on the same patch."""
    fails = []
    for k in CLOSED_FORM:
        if not np.isclose(got[k], want[k], rtol=CLOSED_FORM_RTOL, atol=0):
            fails.append(f"{label}: {k} {got[k]!r} against {want[k]!r}")
    if not abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss):
        fails.append(f"{label}: loss {loss} against {want_loss}")
    g, w = _entries(got), _entries(want)
    for k, rtol in LBFGS_HELD.items():
        if not abs(g[k] - w[k]) <= rtol * abs(w[k]):
            fails.append(f"{label}: {k} {g[k]} against {w[k]} (rtol {rtol})")
    print(f"[compare] {label}: closed form {len(CLOSED_FORM)} entries; "
          f"loss {loss:.6f} (committed parameters' {want_loss:.6f}); "
          + ", ".join(f"{k} {g[k]:.6g} ({w[k]:.6g})" for k in LBFGS_HELD)
          + "; not held: "
          + ", ".join(f"{k} {g[k]:.4g} ({w[k]:.4g})" for k in WING)
          + f": {'held' if not fails else 'MISSED'}")
    return fails


def hold_fixture(got_dir, want_dir, label, loss, exact_images=True,
                 device="cpu"):
    """Every committed file of one fixture (``want_dir``, e.g.
    ``experiments/m71/data/m71``) against the regenerated one
    (``got_dir``); ``loss`` is the regenerated fit's. The crowded probe's
    ``tiles_crowded*.npz`` are not the fixture scripts' and are skipped."""
    got_dir, want_dir = Path(got_dir), Path(want_dir)
    fails = []
    for f in sorted(want_dir.iterdir()):
        name = f"{label} {f.name}"
        if f.name.startswith("tiles_crowded"):
            continue
        if f.suffix == ".npz":
            fails += hold_npz(got_dir / f.name, f, name, exact_images)
        elif f.suffix == ".zpt":
            same = (got_dir / f.name).read_bytes() == f.read_bytes()
            print(f"[compare] {name}: {'byte-equal' if same else 'DIFFERS'}")
            fails += [] if same else [f"{name} differs"]
        elif f.name == "fixture_truth.yaml":
            g = yaml.safe_load((got_dir / f.name).read_text())
            w = yaml.safe_load(f.read_text())
            bad = [k for k in w if g.get(k) != w[k]]
            print(f"[compare] {name}: {len(w)} committed keys, extra "
                  f"{sorted(set(g) - set(w))}, differing {bad}")
            fails += [f"{name}: {k}" for k in bad]
        elif f.name == "params.yaml":
            g = yaml.safe_load((got_dir / f.name).read_text())
            w = yaml.safe_load(f.read_text())
            fails += hold_params(g, w, loss,
                                 patch_loss(got_dir.parent, w, device), name)
        else:
            fails.append(f"{name}: no rule for this file")
    return fails


def hold_psf_comparison(got, want, name):
    """A psf_comparison report of the run ``name`` (``m71``, ``m71_mis``,
    ``m71_vary``) against the committed one (module rule)."""
    star, ref = dict(got["empirical_star"]), dict(want["empirical_star"])
    fails = []
    for k, tol in REFIT_TOL.items():
        a, committed = np.atleast_1d(star.pop(k)), ref.pop(k)
        b = np.atleast_1d(REFIT_FLOAT64[name][k])
        if not np.all(np.abs(a - b) <= tol + 1e-12):
            fails.append(f"{name}: {k} {a.tolist()} against the float64 "
                         f"optimum {b.tolist()}")
        print(f"[compare] {name} {k}: {a.tolist()} (float64 optimum "
              f"{b.tolist()}, held to {tol:g}; committed float32 refit "
              f"{committed})")
        if k == REFIT_RMS and not a[0] <= committed + 5e-4:
            fails.append(f"{name}: {k} {a[0]} above the committed "
                         f"{committed}")
    for part, a, b in (("psf", got["psf"], want["psf"]),
                       ("empirical_star", star, ref)):
        bad = [k for k in set(a) | set(b) if a.get(k) != b.get(k)]
        fails += [f"{name}: {part}.{k} {a.get(k)} against {b.get(k)}"
                  for k in sorted(bad)]
    print(f"[compare] {name}: {'held' if not fails else 'MISSED'}"
          + "".join(f"\n  {f}" for f in fails))
    return fails
