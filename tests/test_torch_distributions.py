"""smcdet_tpu_torch/distributions.py against smcdet_tpu/distributions.py on
the same inputs (f32, rtol = atol = 1e-5 unless stated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread, t  # noqa: F401

from smcdet_tpu import distributions as jd
from smcdet_tpu_torch import distributions as td

RTOL = ATOL = 1e-5


def _case(seed, n=4096):
    """Means inside the box, as in every MH proposal (the walk starts from
    the current state). MALA's drifted means also lie far outside it: see
    test_truncated_normal_far_outside_the_box_matches_jax."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-1.0, 9.0, n).astype(np.float32)
    sigma = rng.uniform(0.1, 5.0, n).astype(np.float32)
    lb = np.float32(-1.0)
    ub = np.float32(9.0)
    return mu, sigma, lb, ub


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_truncated_normal_sample_given_uniforms(seed):
    mu, sigma, lb, ub = _case(seed)
    key = jax.random.key(seed)
    want = jd.truncated_normal_sample(key, mu, sigma, lb, ub)
    # the uniforms the JAX sampler draws (distributions.py:62-64)
    u = jax.random.uniform(key, mu.shape, minval=1e-6, maxval=1 - 1e-6)
    got = td.truncated_normal_sample(t(mu), t(sigma), float(lb), float(ub),
                                     u=t(u))
    # rtol 1e-4: near p = 1e-6 the inverse CDF's slope amplifies a 1-ulp
    # difference of Phi ~20-fold
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=ATOL)
    assert float(got.min()) >= lb and float(got.max()) <= ub


def test_truncated_normal_sample_from_generator_stays_in_box():
    mu, sigma, lb, ub = _case(3)
    g = torch.Generator().manual_seed(0)
    x = td.truncated_normal_sample(t(mu), t(sigma), float(lb), float(ub),
                                   generator=g)
    assert x.shape == mu.shape
    assert float(x.min()) >= lb and float(x.max()) <= ub


@pytest.mark.parametrize("seed", [0, 1])
def test_truncated_normal_log_mass_and_log_prob(seed):
    mu, sigma, lb, ub = _case(seed)
    value = np.clip(mu + sigma * 0.3, lb, ub).astype(np.float32)
    np.testing.assert_allclose(
        td.truncated_normal_log_mass(t(mu), t(sigma), float(lb),
                                     float(ub)).numpy(),
        np.asarray(jd.truncated_normal_log_mass(mu, sigma, lb, ub)),
        rtol=RTOL, atol=ATOL,
    )
    np.testing.assert_allclose(
        td.truncated_normal_log_prob(t(value), t(mu), t(sigma), float(lb),
                                     float(ub)).numpy(),
        np.asarray(jd.truncated_normal_log_prob(value, mu, sigma, lb, ub)),
        rtol=RTOL, atol=ATOL,
    )


def test_ndtr_matches_jax():
    """Phi by JAX's formula: within the f32 rounding of erf / erfc (a few
    ulps) of JAX's values from -15 to 15, 0 where JAX's f32 result is
    subnormal."""
    x = np.concatenate([np.linspace(-15.0, 15.0, 30001),
                        np.random.default_rng(0).normal(0.0, 4.0, 4096)])
    x = x.astype(np.float32)
    want = np.asarray(jax.scipy.special.ndtr(jnp.asarray(x)))
    got = td.ndtr(t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)
    assert (got[want == 0.0] == 0.0).all()
    assert float(td.ndtr(torch.tensor(-10.0))) > 0.0  # torch's ndtr: 0


@pytest.mark.parametrize("sigma,lb,ub", [(0.25, -1.0, 17.0),
                                         (5.0, 7.0, 1804.679)])
def test_truncated_normal_far_outside_the_box_matches_jax(sigma, lb, ub):
    """Means a MALA drift carries above the box, up to 15 sigma (the
    location and the flux box of divideandconquer at its steps): the box
    mass is a difference of two values of Phi in the lower tail, and its
    log, the proposal's log-density and the sample are JAX's, with the
    log mass between 0 and -88 where torch's f32 ndtr gave 0 beyond 5.4
    sigma. Means below the box, up to 5 sigma, where the mass is still
    above 1e-7."""
    rng = np.random.default_rng(1)
    above = ub + sigma * rng.uniform(0.0, 15.0, 2048)
    below = lb - sigma * rng.uniform(0.0, 5.0, 2048)
    mu = np.concatenate([above, below]).astype(np.float32)
    key = jax.random.key(3)
    u = jax.random.uniform(key, mu.shape, minval=1e-6, maxval=1 - 1e-6)
    value = np.clip(mu - sigma * rng.uniform(0.0, 3.0, mu.shape), lb, ub)
    value = value.astype(np.float32)
    args = (np.float32(sigma), np.float32(lb), np.float32(ub))
    want_mass = np.asarray(jd.truncated_normal_log_mass(mu, *args))
    got_mass = td.truncated_normal_log_mass(t(mu), *map(float, args))
    np.testing.assert_allclose(got_mass.numpy(), want_mass, rtol=1e-5,
                               atol=1e-4)
    assert want_mass[:2048].min() < -80.0  # the tail is exercised
    np.testing.assert_allclose(
        td.truncated_normal_log_prob(t(value), t(mu),
                                     *map(float, args)).numpy(),
        np.asarray(jd.truncated_normal_log_prob(value, mu, *args)),
        rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        td.truncated_normal_sample(t(mu), *map(float, args), u=t(u)).numpy(),
        np.asarray(jd.truncated_normal_sample(key, mu, *args)), rtol=1e-5,
        atol=1e-5)


def test_truncated_normal_log_mass_guards_empty_box():
    # mass underflows to 0 far outside the box: log -> 0, as nan_to_num
    mu = np.asarray([1e4, -1e4], np.float32)
    got = td.truncated_normal_log_mass(t(mu), 1.0, 0.0, 1.0)
    want = jd.truncated_normal_log_mass(mu, 1.0, 0.0, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("alpha,lower,upper",
                         [(0.214, 0.252, 1804.679), (1.5, 1.0, 50.0)])
def test_truncated_pareto(alpha, lower, upper):
    jp = jd.TruncatedPareto(alpha=jnp.float32(alpha),
                            lower=jnp.float32(lower),
                            upper=jnp.float32(upper))
    tp = td.TruncatedPareto(alpha, lower, upper, device="cpu")
    np.testing.assert_allclose(float(tp.logpdf_norm_const),
                               float(jp.logpdf_norm_const), rtol=RTOL)
    key = jax.random.key(4)
    want = jp.sample(key, (2048,))
    u = jax.random.uniform(key, (2048,))
    got = tp.sample((2048,), u=t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=ATOL)  # pow(., -1/alpha) amplifies ulps
    x = np.asarray(want)
    np.testing.assert_allclose(tp.log_prob(t(x)).numpy(),
                               np.asarray(jp.log_prob(x)), rtol=RTOL,
                               atol=ATOL)
    assert float(tp.support_lower) == np.float32(lower)
    assert float(tp.support_upper) == np.float32(upper)


def test_discrete_uniform():
    jdu = jd.DiscreteUniform(low=1, high=4)
    tdu = td.DiscreteUniform(1, 4)
    v = np.arange(-1, 7)
    np.testing.assert_allclose(tdu.log_prob(torch.tensor(v)).numpy(),
                               np.asarray(jdu.log_prob(v)), rtol=RTOL)
    s = tdu.sample((1000,), torch.Generator().manual_seed(0))
    assert int(s.min()) >= 1 and int(s.max()) <= 4
