"""Where the image-model fit ends: on each M71 fixture's 64x64 patch and on
``chip_smoke.py`` ``[fit]``'s synthetic patch, the JAX package's fit
(``optax.lbfgs``) and the port's (``fitting.fit_image_model``), each on the
patch as it is and with its stars in ``--orders`` random orders (the same
problem under another float32 rounding), beside the float64 optimum
(scipy's L-BFGS-B on a float64 transcription of the loss, from the fit's
start). Each line gives the loss, ``adu_per_nmgy`` and the in-window
calibration (``fitting.in_window_calibration``), the last two relative to
the committed ``params.yaml`` (to the truth for ``fit``). CPU only: it
imports JAX.

    JAX_PLATFORMS=cpu python tests/torch_fit_valley.py \\
        [--fixtures data data_mis data_vary data_nogiants data_seed2 fit] \\
        [--orders 8] [--out output/fit_valley]

The fixtures are regenerated under ``--out`` by the port's
``make_fixture`` (bit for bit the committed ones on the CPU); the summary
goes to ``--out/summary.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import yaml

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from smcdet_tpu_torch import fitting  # noqa: E402
from smcdet_tpu_torch.data_prep import make_fixture as mf  # noqa: E402
from smcdet_tpu_torch.data_prep import prepare_data as P  # noqa: E402

FIXTURES = {
    "data": [],
    "data_mis": ["--psf-misspec", "elliptical"],
    "data_vary": ["--psf-misspec", "varying"],
    "data_nogiants": ["--no-giants"],
    "data_seed2": ["--seed", "6839"],
}


def fixture_patch(name, out):
    """``(patch, sky, locs, fluxes, psf0, adu0, reference)``: the fit's
    inputs and start as ``prepare_data`` gives them, and the committed
    parameters (for ``fit``, ``chip_smoke.py``'s patch and its truth)."""
    if name == "fit":
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", REPO / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        image, locs, fluxes, sky, p = smoke.fit_problem("cpu")
        return (image.numpy(), sky, locs, fluxes,
                [1.1 * v for v in p["psf_params"]],
                0.95 * p["adu_per_nmgy"], p)
    data_dir = out / name
    mf.main(["--data-dir", str(data_dir), "--device", "cpu",
             *FIXTURES[name]])
    item, locs_all, fluxes_all = P.read_survey(data_dir)
    patch, sky, locs, fluxes = P.fit_patch(
        item["image"][P.RBAND], item["background"][P.RBAND], locs_all,
        fluxes_all)
    ref = yaml.safe_load((REPO / "experiments" / "m71" / name / "m71"
                          / "params.yaml").read_text())
    return (patch, sky, locs, fluxes,
            [float(v) for v in item["psf_params"][P.RBAND]],
            float(np.mean(item["flux_calibration"][P.RBAND])), ref)


def loss64(theta, patch, sky, locs, fluxes, radius=8):
    """The fit's loss in float64 at the log-parameters ``theta`` (the six
    PSF entries, the calibration, the additive and multiplicative noise):
    each star rendered into its ``(2r+1)^2`` window, the profile normalised
    over the ``32r x 32r`` grid, the per-pixel Gaussian negative
    log-likelihood."""
    s1, s2, sp, beta, b, p0, adu, add, mult = torch.exp(theta)

    def unnormalized(r2):
        return (torch.exp(-r2 / (2 * s1)) + b * torch.exp(-r2 / (2 * s2))
                + p0 * (1 + r2 / (beta * sp)) ** (-beta / 2)) / (1 + b + p0)

    grid = torch.arange(32 * radius, dtype=torch.float64) - 16 * radius + 0.5
    norm = unnormalized(grid[:, None] ** 2 + grid[None, :] ** 2).sum()
    h = torch.arange(patch.shape[0], dtype=torch.float64)[:, None]
    w = torch.arange(patch.shape[1], dtype=torch.float64)[None, :]
    ly, lx = locs[:, 0, None, None], locs[:, 1, None, None]
    window = ((h - torch.floor(ly)).abs() <= radius) & (
        (w - torch.floor(lx)).abs() <= radius)
    r2 = ((h + 0.5) - ly) ** 2 + ((w + 0.5) - lx) ** 2
    rate = (adu * fluxes[:, None, None] * unnormalized(r2) / norm
            * window).sum(0) + sky
    var = add + mult * rate
    nll = 0.5 * (patch - rate) ** 2 / var + 0.5 * torch.log(var) + 0.5 * (
        np.log(2 * np.pi))
    return nll.mean()


def optimum64(patch, sky, locs, fluxes, psf0, adu0):
    from scipy.optimize import minimize

    args = [torch.as_tensor(np.asarray(a, dtype=np.float64))
            for a in (patch, sky, locs, fluxes)]

    def value_and_grad(theta):
        theta = torch.as_tensor(theta).requires_grad_(True)
        loss = loss64(theta, *args)
        return float(loss.detach()), torch.autograd.grad(
            loss, theta)[0].numpy()

    start = np.log(np.array([*psf0, adu0, 1.0, 1.0], dtype=np.float64))
    res = minimize(value_and_grad, start, jac=True, method="L-BFGS-B",
                   options=dict(maxiter=20000, ftol=1e-16, gtol=1e-12,
                                maxcor=30))
    x = np.exp(res.x)
    return {"loss": float(res.fun), "psf_params": x[:6].tolist(),
            "adu_per_nmgy": float(x[6]), "noise_additive": float(x[7]),
            "noise_multiplicative": float(x[8]), "iterations": int(res.nit)}


def jax_fit(patch, sky, locs, fluxes, psf0, adu0):
    import jax.numpy as jnp

    from smcdet_tpu.fitting import fit_image_model

    fit = fit_image_model(jnp.asarray(patch), jnp.asarray(locs),
                          jnp.asarray(fluxes), psf_params_init=tuple(psf0),
                          background_init=jnp.asarray(sky),
                          adu_per_nmgy_init=adu0, num_steps=200)
    return fit._asdict()


def port_fit(patch, sky, locs, fluxes, psf0, adu0):
    fit = fitting.fit_image_model(patch, locs, fluxes, tuple(psf0), sky,
                                  adu0, num_steps=200, device="cpu")
    return fit._asdict()


def describe(label, fit, ref, radius):
    cal = fitting.in_window_calibration(fit["adu_per_nmgy"],
                                        fit["psf_params"], radius)
    ref_cal = fitting.in_window_calibration(ref["adu_per_nmgy"],
                                            ref["psf_params"], radius)
    loss = fit.get("final_loss", fit.get("loss"))
    print(f"{label}: loss {loss:.7f}, adu_per_nmgy {fit['adu_per_nmgy']:.3f} "
          f"({fit['adu_per_nmgy'] / ref['adu_per_nmgy'] - 1:+.4%}), "
          f"in-window calibration {cal:.4f} ({cal / ref_cal - 1:+.2e}); "
          f"sigmap {fit['psf_params'][2]:.4g}, beta "
          f"{fit['psf_params'][3]:.4g}", flush=True)
    return {**fit, "in_window_calibration": cal,
            "adu_rel": fit["adu_per_nmgy"] / ref["adu_per_nmgy"] - 1,
            "in_window_rel": cal / ref_cal - 1}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--fixtures", nargs="+",
                        default=[*FIXTURES, "fit"])
    parser.add_argument("--orders", type=int, default=8)
    parser.add_argument("--out", default="output/fit_valley")
    args = parser.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    summary = {}
    for name in args.fixtures:
        start = time.perf_counter()
        patch, sky, locs, fluxes, psf0, adu0, ref = fixture_patch(name, out)
        radius = int(ref["psf_radius"])
        rows = {"optimum64": describe(
            f"{name} float64 optimum", optimum64(patch, sky, locs, fluxes,
                                                 psf0, adu0), ref, radius)}
        for order in range(-1, args.orders):
            perm = (np.arange(len(fluxes)) if order < 0 else
                    np.random.default_rng(order).permutation(len(fluxes)))
            inputs = (patch, sky, locs[perm].copy(), fluxes[perm].copy(),
                      psf0, adu0)
            tag = "as is" if order < 0 else f"order {order}"
            for who, fit in (("jax", jax_fit), ("port", port_fit)):
                rows[f"{who} {tag}"] = describe(f"{name} {who} {tag}",
                                                fit(*inputs), ref, radius)
        for who in ("jax", "port"):
            adu = [r["adu_rel"] for k, r in rows.items()
                   if k.startswith(who)]
            cal = [r["in_window_rel"] for k, r in rows.items()
                   if k.startswith(who)]
            print(f"{name} {who}: adu_per_nmgy {min(adu):+.4%} to "
                  f"{max(adu):+.4%}, in-window calibration {min(cal):+.2e} "
                  f"to {max(cal):+.2e} over {len(adu)} runs", flush=True)
        summary[name] = {"rows": rows,
                         "wall_s": time.perf_counter() - start}
    (out / "summary.json").write_text(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
