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
    the current state). Far outside it the box mass falls below ~1e-6,
    where torch's f32 ``ndtr`` flushes to 0 about z < -9 and JAX's does
    not; neither value enters a sweep."""
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
