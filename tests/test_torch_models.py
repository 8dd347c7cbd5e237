"""smcdet_tpu_torch/models against smcdet_tpu/models on the same inputs
(f32, rtol = atol = 1e-5 unless stated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    m71_problem,
    one_torch_thread,
    port_model,
    port_prior,
    t,
)

from smcdet_tpu.models import imaging as jim
from smcdet_tpu.models import priors as jpr
from smcdet_tpu.models import psf as jpsf
from smcdet_tpu.models.simulate import generate_images as jax_generate
from smcdet_tpu.ops.catalogs import compact_catalog as jax_compact
from smcdet_tpu_torch.models import psf as tpsf
from smcdet_tpu_torch.models.simulate import generate_images

RTOL = ATOL = 1e-5
PSF_PARAMS = (1.33, 4.82, 3.15, 3.0, 0.06, 0.002)


@pytest.mark.parametrize("beta,radius", [(3.0, 8), (3.0, 4), (2.5, 8)])
def test_sdss_psf_normalizing_constant_and_profile(beta, radius):
    params = PSF_PARAMS[:3] + (beta,) + PSF_PARAMS[4:]
    jp = jpsf.SDSSPSF.create(params, radius)
    tp = tpsf.SDSSPSF.create(params, radius, device="cpu")
    assert tp.wing_beta3 == jp.wing_beta3 == (beta == 3.0)
    np.testing.assert_allclose(float(tp.normalizing_constant),
                               float(jp.normalizing_constant), rtol=RTOL)
    r2 = np.linspace(0.0, 200.0, 1001, dtype=np.float32)
    np.testing.assert_allclose(tp.normalized(t(r2)).numpy(),
                               np.asarray(jp.normalized(r2)), rtol=RTOL,
                               atol=ATOL)


def test_sdss_psf_wing_flag_guard():
    with pytest.raises(ValueError, match="wing_beta3"):
        tpsf.SDSSPSF(*PSF_PARAMS[:3], 2.5, *PSF_PARAMS[4:], wing_beta3=True,
                     device="cpu")


def test_gaussian_psf():
    r2 = np.linspace(0.0, 30.0, 301, dtype=np.float32)
    np.testing.assert_allclose(
        tpsf.GaussianPSF(1.3, device="cpu").normalized(t(r2)).numpy(),
        np.asarray(jpsf.GaussianPSF(stdev=jnp.float32(1.3)).normalized(r2)),
        rtol=RTOL, atol=ATOL,
    )


def _models():
    _, m71, _ = m71_problem()
    poisson = jim.ImageModel(height=8, width=8, psf_radius=4,
                             noise="poisson", background=jnp.float32(100.0),
                             psf=jpsf.GaussianPSF(stdev=jnp.float32(1.0)),
                             normal_tail_threshold=500.0)
    return {"m71": m71, "poisson": poisson}


def _catalog(seed, shape=(3, 5), M=4):
    rng = np.random.default_rng(seed)
    locs = rng.uniform(-1.0, 9.0, shape + (M, 2)).astype(np.float32)
    fluxes = rng.uniform(0.3, 60.0, shape + (M,)).astype(np.float32)
    return locs, fluxes


@pytest.mark.parametrize("name", ["m71", "poisson"])
def test_star_image_and_render(name):
    jm = _models()[name]
    tm = port_model(jm)
    locs, fluxes = _catalog(0)
    np.testing.assert_allclose(tm.star_image_flat(t(locs)).numpy(),
                               np.asarray(jm.star_image_flat(locs)),
                               rtol=RTOL, atol=ATOL)
    # the rate is ~1e2..1e4 ADU: rtol carries the comparison
    np.testing.assert_allclose(tm.render(t(locs), t(fluxes)).numpy(),
                               np.asarray(jm.render(locs, fluxes)),
                               rtol=RTOL, atol=1e-3)


@pytest.mark.parametrize("name", ["m71", "poisson"])
def test_likelihood_laws(name):
    jm = _models()[name]
    tm = port_model(jm)
    locs, fluxes = _catalog(1)
    rate = np.asarray(jm.render(locs, fluxes)).reshape(3, 5, 64)
    rng = np.random.default_rng(2)
    # Poisson rates straddle the 500-count Normal-tail switch
    image = np.round(rate * rng.uniform(0.8, 1.2, rate.shape)).astype(
        np.float32)
    np.testing.assert_allclose(
        tm.loglikelihood_from_rate_flat(t(image), t(rate)).numpy(),
        np.asarray(jm.loglikelihood_from_rate_flat(image, rate)),
        rtol=RTOL, atol=1e-3,  # sums of 64 terms of up to ~1e3 nats
    )
    img = image.reshape(3, 5, 8, 8)
    np.testing.assert_allclose(
        tm.loglikelihood(t(img), t(locs), t(fluxes)).numpy(),
        np.asarray(jm.loglikelihood(img, locs, fluxes)),
        rtol=RTOL, atol=1e-3,
    )


def test_sample_shapes_and_noise_level():
    tm = port_model(_models()["m71"])
    locs, fluxes = _catalog(3, shape=(400,))
    img = tm.sample(torch.Generator().manual_seed(0), t(locs), t(fluxes))
    rate = tm.render(t(locs), t(fluxes))
    z = (img - rate) / torch.sqrt(1.94 * rate)
    assert img.shape == (400, 8, 8)
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1) < 0.05


def _priors():
    m71, _, _ = m71_problem()
    star = jpr.StarPrior(0, 3, 8, 8, flux_mean=2000.0, flux_stdev=300.0,
                         pad=1.0)
    pareto = jpr.ParetoStarPrior(1, 4, 8, 8, flux_scale=1.5, flux_alpha=0.7,
                                 pad=0.5)
    poisson = jpr.PoissonProcessPrior(0, 5, counts_rate=0.05,
                                      image_height=8, image_width=8, pad=1.0)
    geometric = jpr.GeometricProcessPrior(0, 4, 8, 8, pad=1.0)
    return {"m71": m71, "star": star, "pareto": pareto, "poisson": poisson,
            "geometric": geometric}


@pytest.mark.parametrize("name", ["m71", "star", "pareto", "poisson",
                                  "geometric"])
def test_prior_log_prob_and_count_log_prob(name):
    jp = _priors()[name]
    tp = port_prior(jp)
    rng = np.random.default_rng(4)
    M = jp.max_objects
    counts = rng.integers(jp.min_objects, M + 1, (50,)).astype(np.int32)
    locs = rng.uniform(-0.5, 8.5, (50, M, 2)).astype(np.float32)
    lo = 0.3 if name == "m71" else 1.6
    fluxes = rng.uniform(lo, 900.0, (50, M)).astype(np.float32)
    np.testing.assert_allclose(
        tp.log_prob(torch.from_numpy(counts), t(locs), t(fluxes)).numpy(),
        np.asarray(jp.log_prob(counts, locs, fluxes)), rtol=RTOL, atol=1e-4,
    )
    support = np.arange(jp.min_objects, M + 1, dtype=np.int32)
    np.testing.assert_allclose(
        tp.count_log_prob_truncated(torch.from_numpy(support)).numpy(),
        np.asarray(jp.count_log_prob_truncated(support)), rtol=RTOL,
        atol=ATOL,
    )


# the port's factories against the JAX ones, built from the same arguments
_FACTORIES = {
    "PoissonProcessPrior": dict(min_objects=0, max_objects=5,
                                counts_rate=0.05, image_height=8,
                                image_width=8, pad=1.0),
    "GeometricProcessPrior": dict(min_objects=0, max_objects=4,
                                  image_height=16, image_width=16, pad=2.0),
    "StarPrior": dict(min_objects=0, max_objects=3, image_height=8,
                      image_width=8, flux_mean=2000.0, flux_stdev=300.0,
                      pad=1.0),
    "ParetoStarPrior": dict(min_objects=0, max_objects=8, image_height=8,
                            image_width=8, flux_scale=345.84, flux_alpha=2.0,
                            pad=2.0),
    "M71Prior": dict(min_objects=0, max_objects=12, counts_rate=0.02,
                     image_height=16, image_width=16, flux_alpha=0.5,
                     flux_lower=100.0, flux_upper=100000.0, pad=1.0),
}


@pytest.mark.parametrize("name", list(_FACTORIES))
def test_prior_factories_match_jax(name):
    from smcdet_tpu_torch.models import priors as tpr

    kw = _FACTORIES[name]
    jp = getattr(jpr, name)(**kw)
    tp = getattr(tpr, name)(**kw, device="cpu")
    M = jp.max_objects
    assert (tp.min_objects, tp.max_objects, tp.num_counts) == (
        jp.min_objects, M, jp.num_counts)
    np.testing.assert_array_equal(tp.loc_low.numpy(), np.asarray(jp.loc_low))
    np.testing.assert_array_equal(tp.loc_high.numpy(),
                                  np.asarray(jp.loc_high))
    rng = np.random.default_rng(5)
    counts = rng.integers(0, M + 1, (40,)).astype(np.int32)
    locs = rng.uniform(-1.0, 17.0, (40, M, 2)).astype(np.float32)
    fluxes = rng.uniform(400.0, 5000.0, (40, M)).astype(np.float32)
    np.testing.assert_allclose(
        tp.log_prob(torch.from_numpy(counts), t(locs), t(fluxes)).numpy(),
        np.asarray(jp.log_prob(counts, locs, fluxes)), rtol=RTOL, atol=1e-4)
    support = np.arange(0, M + 1, dtype=np.int32)
    np.testing.assert_allclose(
        tp.count_log_prob_truncated(torch.from_numpy(support)).numpy(),
        np.asarray(jp.count_log_prob_truncated(support)), rtol=RTOL,
        atol=ATOL)


def test_geometric_counts_sample_matches_pmf():
    from smcdet_tpu_torch.models.priors import GeometricCounts

    gc = GeometricCounts(device="cpu")
    draws = gc.sample((200_000,), torch.Generator().manual_seed(0))
    assert draws.dtype == torch.int32 and int(draws.min()) == 0
    ks = torch.arange(5)
    freq = torch.stack([(draws == k).float().mean() for k in ks])
    # Monte Carlo error of a frequency near 0.78 at n = 2e5 is ~1e-3
    np.testing.assert_allclose(freq.numpy(), gc.log_prob(ks).exp().numpy(),
                               atol=5e-3)


def test_prior_sample_stratified_layout():
    tp = port_prior(_priors()["m71"])
    strata, locs, fluxes = tp.sample_stratified(
        torch.Generator().manual_seed(0), 64, batch_shape=(3,))
    C, M = tp.num_counts, tp.max_objects
    assert strata.tolist() == list(range(C))
    assert locs.shape == (3, C, 64, M, 2) and fluxes.shape == (3, C, 64, M)
    active = (torch.arange(M) < strata[:, None, None]).expand(3, C, 64, M)
    assert torch.all(fluxes[~active] == 0)
    assert torch.all(locs[~active] == 0)
    f_on = fluxes[active]
    assert float(f_on.min()) >= 0.252 and float(f_on.max()) <= 1804.68
    assert float(locs.min()) >= -1.0 and float(locs.max()) <= 9.0


def test_generate_images_prunes_like_jax():
    jprior, jmodel, _ = m71_problem()
    tp, tm = port_prior(jprior), port_model(jmodel)
    sim = generate_images(torch.Generator().manual_seed(7), tp, tm, 0.7, 0.0,
                          8.0, num_images=64)
    assert sim.images.shape == (64, 8, 8)
    # the JAX prune rule applied to the port's catalogs
    locs = sim.unpruned_locs.numpy()
    fluxes = sim.unpruned_fluxes.numpy()
    keep = (
        np.all((locs > 0.0) & (locs < 8.0), axis=-1) & (fluxes > 0.7)
        & (np.arange(6) < sim.unpruned_counts.numpy()[:, None])
    )
    jc, jl, jf = jax_compact(locs, fluxes, keep)
    np.testing.assert_array_equal(sim.pruned_counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(sim.pruned_locs.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(sim.pruned_fluxes.numpy(), np.asarray(jf))
    # the JAX simulator draws the same kind of tiles (its own stream)
    jsim = jax.jit(lambda k: jax_generate(k, jprior, jmodel, 0.7, 0.0, 8.0,
                                          num_images=64))(jax.random.key(7))
    for a, b in ((sim.images, jsim.images),
                 (sim.unpruned_counts, jsim.unpruned_counts)):
        assert abs(float(a.float().mean()) - float(np.mean(b))) < 0.2 * (
            float(np.mean(b)) + 1.0)


def test_public_constructors_default_to_the_card():
    """Every public constructor and build function of the port defaults to
    ``device="cuda"``: nothing falls back to the CPU unless asked."""
    import inspect

    from smcdet_tpu_torch import config, convert, distributions
    from smcdet_tpu_torch.inference import kernels
    from smcdet_tpu_torch.models import imaging, priors, psf

    factories = [
        distributions.TruncatedPareto, priors.PoissonCounts,
        priors.GeometricCounts, priors.NormalFlux, priors.ParetoFlux,
        priors.PointProcessPrior, priors.PoissonProcessPrior,
        priors.GeometricProcessPrior, priors.StarPrior,
        priors.ParetoStarPrior, priors.M71Prior, imaging.ImageModel,
        imaging.M71ImageModel, psf.GaussianPSF, psf.SDSSPSF,
        psf.SDSSPSF.create, kernels.SingleComponentMH, config.build_prior,
        config.build_image_model, config.build_kernel,
        convert.prior_from_params, convert.image_model_from_params,
        convert.mh_kernel_from_params,
    ]
    for b in factories:
        default = inspect.signature(b).parameters["device"].default
        assert default == "cuda", (b, default)
    if not torch.cuda.is_available():
        # without a card, building on the default device raises
        with pytest.raises((AssertionError, RuntimeError)):
            psf.GaussianPSF(1.0)
