"""The port's hyperparameter fitting (smcdet_tpu_torch/fitting.py) against
the JAX package's (smcdet_tpu/fitting.py): the scipy fits equal, the
port's L-BFGS taking optax.lbfgs's steps, and the image-model MLE reaching
the same optimum on one synthetic patch."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu import fitting as jfit
from smcdet_tpu.models.imaging import M71ImageModel as JaxM71
from smcdet_tpu_torch import convert, fitting as tfit

TRUE_PSF = (1.51, 4.85, 1.32, 3.0, 0.09, 0.002)


def _pareto_sample(n, alpha, lower, upper, seed):
    """Inverse-CDF draws of the truncated Pareto (numpy)."""
    u = np.random.default_rng(seed).uniform(size=n)
    a = 1.0 - (lower / upper) ** alpha
    return lower * (1.0 - u * a) ** (-1.0 / alpha)


@pytest.mark.parametrize("upper", [None, 1800.0])
def test_truncated_pareto_fit_equals_jax(upper):
    x = _pareto_sample(5000, 0.25, 0.3, 1800.0, 0)
    if upper is not None:
        x = np.concatenate([x, [2500.0]])  # outside: dropped, with a warning
    with pytest.warns(UserWarning) if upper else _nothing():
        got = tfit.fit_truncated_pareto_flux(x, upper=upper)
    with pytest.warns(UserWarning) if upper else _nothing():
        want = jfit.fit_truncated_pareto_flux(x, upper=upper)
    assert got == want
    assert abs(got[0] - 0.25) < 0.05


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_fixed_support_without_samples_raises():
    with pytest.raises(ValueError, match="no samples"):
        tfit.fit_truncated_pareto_flux([5000.0], lower=1.0, upper=10.0)


def test_poisson_rate_equals_jax():
    counts = np.random.default_rng(0).poisson(4.32, size=5000)
    assert (tfit.fit_poisson_rate(counts, area=144.0)
            == jfit.fit_poisson_rate(counts, area=144.0))


def _optax_steps(f, x0, steps):
    """``steps`` iterations of ``optax.lbfgs()`` from ``x0`` (float32)."""
    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(f)
    x = jnp.asarray(x0)
    state = opt.init(x)
    for _ in range(steps):
        value, grad = value_and_grad(x, state=state)
        updates, state = opt.update(grad, state, x, value=value, grad=grad,
                                    value_fn=f)
        x = optax.apply_updates(x, updates)
    return np.asarray(x)


def _port_steps(f, x0, steps):
    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        loss = f(x)
        return loss.detach(), torch.autograd.grad(loss, x)[0]

    return tfit._lbfgs(value_and_grad, torch.tensor(x0), steps)[0].numpy()


def _rosenbrock(x):
    return (100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()


@pytest.mark.parametrize("steps", [1, 3, 10])
def test_lbfgs_takes_optax_steps(steps):
    """The port's L-BFGS (optax.lbfgs's memory and scaling, its zoom line
    search) against optax's from the same start on a float32 Rosenbrock
    valley, where every step's line search brackets, zooms and takes the
    curvature condition: the iterates agree to float32 rounding (the two
    drift apart by it only over tens of steps)."""
    x0 = np.array([-1.2, 1.0, -0.5, 0.8], np.float32)
    np.testing.assert_allclose(_port_steps(_rosenbrock, x0, steps),
                               _optax_steps(_rosenbrock, x0, steps),
                               atol=1e-5)


def test_line_search_moves_where_float32_cannot_resolve_the_decrease():
    """On 1000 + 1e-4 |x - 3|^2 from 2.9 every float32 loss on the way to
    the minimum rounds to 1000, so Armijo's decrease never holds; the zoom
    line search accepts on the slope (the approximate decrease) as
    optax's does and reaches the minimum, where ``torch.optim.LBFGS``'s
    strong-Wolfe search does not move."""
    x0 = np.full(4, 2.9, np.float32)
    got = _port_steps(lambda x: 1000.0 + 1e-4 * ((x - 3.0) ** 2).sum(), x0,
                      5)
    want = _optax_steps(lambda x: 1000.0 + 1e-4 * jnp.sum((x - 3.0) ** 2),
                        x0, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, 3.0, atol=1e-4)
    x = torch.tensor(x0, requires_grad=True)
    stalled = torch.optim.LBFGS([x], max_iter=1,
                                line_search_fn="strong_wolfe")

    def closure():
        stalled.zero_grad()
        loss = 1000.0 + 1e-4 * ((x - 3.0) ** 2).sum()
        loss.backward()
        return loss

    for _ in range(5):
        stalled.step(closure)
    np.testing.assert_array_equal(x.detach().numpy(), x0)


def _patch(size=32, stars=12, seed=0):
    """A synthetic patch from the M71 model with known stars over a sky
    that varies across the patch, as prepare_data.py fits against."""
    rng = np.random.default_rng(seed)
    locs = rng.uniform(3, size - 3, (stars, 2)).astype(np.float32)
    fluxes = rng.uniform(40, 400, stars).astype(np.float32)
    yy, xx = np.mgrid[:size, :size]
    bkg = (860.0 + 0.8 * yy - 0.5 * xx).astype(np.float32)
    model = JaxM71(image_height=size, image_width=size,
                   background=jnp.asarray(bkg), adu_per_nmgy=850.0,
                   psf_params=TRUE_PSF, psf_radius=8, noise_additive=1e-3,
                   noise_multiplicative=1.9)
    image = np.array(model.sample(jax.random.key(1), jnp.asarray(locs),
                                    jnp.asarray(fluxes)))
    return image, locs, fluxes, bkg


@pytest.fixture(scope="module")
def fits():
    image, locs, fluxes, bkg = _patch()
    kw = dict(psf_params_init=tuple(1.1 * p for p in TRUE_PSF),
              background_init=bkg, adu_per_nmgy_init=800.0,
              noise_additive_init=1.0, num_steps=200)
    want = jfit.fit_image_model(jnp.asarray(image), jnp.asarray(locs),
                                jnp.asarray(fluxes), **kw)
    got = tfit.fit_image_model(image, locs, fluxes, device="cpu", **kw)
    return got, want, (image, locs, fluxes, bkg)


def test_image_model_fit_reaches_the_jax_optimum(fits):
    """200 L-BFGS steps from the same start (PSF 10% off, calibration 6%
    off, noise 1.0 / 1.0) on a 32x32 patch with 12 stars over a sloped sky
    map. The wing's parameters are barely constrained by 12 stars and
    wander between optimisers (and between JAX runs), so the fits are held
    where the likelihood pins them: the per-pixel loss to 1e-3 relative,
    the calibration to 0.5%, the multiplicative noise to 2%, the core
    width sigma1 to 15%; the truth lies within 1% and 3% of the two."""
    got, want, _ = fits
    assert np.isfinite(got.final_loss)
    np.testing.assert_allclose(got.final_loss, want.final_loss, rtol=1e-3)
    np.testing.assert_allclose(got.adu_per_nmgy, want.adu_per_nmgy,
                               rtol=5e-3)
    np.testing.assert_allclose(got.noise_multiplicative,
                               want.noise_multiplicative, rtol=2e-2)
    np.testing.assert_allclose(got.psf_params[0], want.psf_params[0],
                               rtol=0.15)
    assert abs(got.adu_per_nmgy / 850.0 - 1.0) < 0.01
    assert abs(got.noise_multiplicative / 1.9 - 1.0) < 0.03
    # a background map is held fixed and summarised by its mean
    assert got.background == pytest.approx(want.background, rel=1e-6)


def test_fitted_model_beats_the_start(fits):
    """The fitted model (``convert.m71_model_from_fit`` over the patch's
    sky map) explains the patch better than the starting one."""
    got, _, (image, locs, fluxes, bkg) = fits
    fitted = convert.m71_model_from_fit(got, 32, 32, background=bkg,
                                        device="cpu")
    start = convert.m71_model_from_fit(
        tfit.FittedImageModel(tuple(1.1 * p for p in TRUE_PSF), 0.0, 800.0,
                              1.0, 1.0, 0.0), 32, 32, background=bkg,
        device="cpu")
    ll = [float(m.loglikelihood(torch.from_numpy(image),
                                torch.from_numpy(locs),
                                torch.from_numpy(fluxes)))
          for m in (fitted, start)]
    assert ll[0] > ll[1]
    np.testing.assert_allclose(-ll[0] / 1024, got.final_loss, rtol=1e-3)


@pytest.mark.parametrize("psf", [TRUE_PSF, (1.29, 4.14, 3.93, 1.54, 0.089,
                                         2.7e-4)])
def test_in_window_calibration_is_the_rendered_flux(psf):
    """One nmgy at a pixel corner, rendered by the port's M71 model: its
    pixels sum to ``in_window_calibration`` (a narrow and a heavy wing)."""
    model = convert.m71_model_from_fit(
        tfit.FittedImageModel(psf, 0.0, 850.0, 0.0, 1.0, 0.0), 40, 40,
        background=0.0, device="cpu")
    image = model.render(torch.tensor([[20.0, 20.0]]), torch.tensor([1.0]))
    assert float(image.sum()) == pytest.approx(
        tfit.in_window_calibration(850.0, psf, 8), rel=1e-5)


def test_divergence_raises():
    image, locs, fluxes, bkg = _patch(size=16, stars=3)
    image[0, 0] = np.nan
    with pytest.raises(FloatingPointError):
        tfit.fit_image_model(image, locs, fluxes, TRUE_PSF, bkg, 850.0,
                             num_steps=3, device="cpu")


def test_fit_background_fits_a_scalar():
    image, locs, fluxes, bkg = _patch(size=16, stars=3, seed=2)
    fit = tfit.fit_image_model(image, locs, fluxes, TRUE_PSF, 700.0, 850.0,
                               noise_multiplicative_init=1.9, num_steps=30,
                               fit_background=True, device="cpu")
    assert abs(fit.background - float(bkg.mean())) < 20.0
