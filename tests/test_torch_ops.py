"""smcdet_tpu_torch/ops (catalogs, tempering, resampling) against
smcdet_tpu/ops on the same inputs (f32, rtol = atol = 1e-5 unless
stated)."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread, t  # noqa: F401

from smcdet_tpu.ops import catalogs as jcat
from smcdet_tpu.ops import resampling as jres
from smcdet_tpu.ops import tempering as jtemp
from smcdet_tpu_torch.ops import catalogs as tcat
from smcdet_tpu_torch.ops import resampling as tres
from smcdet_tpu_torch.ops import tempering as ttemp

RTOL = ATOL = 1e-5


def _loglik(seed, shape=(3, 4, 512), scale=50.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale - 300.0).astype(np.float32)


@pytest.mark.parametrize("scale", [0.1, 5.0, 200.0])
def test_solve_tempering_step(scale):
    ll = _loglik(0, scale=scale)
    temp = np.asarray([0.0, 0.3, 0.97], np.float32)[:, None]
    want = jtemp.solve_tempering_step(ll, temp, 0.5 * 512)
    got = ttemp.solve_tempering_step(t(ll), t(temp), 0.5 * 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_solve_tempering_step_empty_stratum_takes_full_step():
    ll = np.full((2, 64), -np.inf, np.float32)
    got = ttemp.solve_tempering_step(t(ll), torch.zeros(2), 32.0)
    assert torch.equal(got, torch.ones(2))


def test_ess_at_delta():
    ll = _loglik(1, scale=3.0)
    delta = np.asarray(np.random.default_rng(2).uniform(0, 1, (3, 4)),
                       np.float32)
    np.testing.assert_allclose(
        ttemp.ess_at_delta(t(ll), t(delta)).numpy(),
        np.asarray(jtemp.ess_at_delta(ll, delta)), rtol=1e-4,  # exp of a
        atol=ATOL,  # logsumexp difference of ~1e3-nat terms
    )


def _weights(seed, shape=(3, 5, 256)):
    rng = np.random.default_rng(seed)
    w = rng.gamma(0.3, size=shape).astype(np.float32)
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


def _assert_indices_match(got, want, w, u):
    """Identical except where ``u`` lies within 1e-6 of a CDF knot (the two
    frameworks' f32 cumsums may round a knot to either side of it)."""
    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    if diff.any():
        cdf = np.cumsum(w.astype(np.float64), -1)
        near = np.abs(cdf[..., None, :] - np.asarray(u)[..., :, None]) < 1e-6
        assert near.any(-1)[diff].all()
    assert diff.mean() < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_systematic_indices_given_jax_uniforms(seed):
    w = _weights(seed)
    key = jax.random.key(seed)
    want = jres.systematic_indices(key, w, 256)
    offset = jax.random.uniform(key, w.shape[:-1] + (1,))  # resampling.py:83
    got = tres.systematic_indices(t(w), 256, offset=t(offset))
    u = (np.arange(256, dtype=np.float32) + np.asarray(offset)) / 256
    _assert_indices_match(got, want, w, u)


@pytest.mark.parametrize("seed", [0, 1])
def test_multinomial_indices_given_jax_uniforms(seed):
    w = _weights(seed + 10)
    key = jax.random.key(seed)
    want = jres.multinomial_indices(key, w, 300)
    u = jax.random.uniform(key, w.shape[:-1] + (300,))  # resampling.py:72
    got = tres.multinomial_indices(t(w), 300, u=t(u))
    _assert_indices_match(got, want, w, u)


def test_resample_from_generator_respects_weights():
    w = torch.zeros(2, 100)
    w[0, 7] = 1.0
    w[1, 50:] = 1.0 / 50
    g = torch.Generator().manual_seed(0)
    for method in ("systematic", "multinomial"):
        idx = tres.resample_indices(w, 100, method, generator=g)
        assert torch.all(idx[0] == 7)
        assert int(idx[1].min()) >= 50
    with pytest.raises(ValueError):
        tres.resample_indices(w, 100, "stratified", generator=g)


def test_gather_particles():
    rng = np.random.default_rng(3)
    locs = rng.normal(size=(2, 3, 64, 4, 2)).astype(np.float32)
    fluxes = rng.normal(size=(2, 3, 64, 4)).astype(np.float32)
    idx = rng.integers(0, 64, (2, 3, 64)).astype(np.int32)
    jl, jf = jres.gather_particles(idx, locs, fluxes, particle_axis=2)
    tl, tf = tres.gather_particles(torch.from_numpy(idx).long(), t(locs),
                                   t(fluxes), particle_axis=2)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_slot_mask():
    counts = np.asarray([[0, 3], [6, 1]], np.int32)
    np.testing.assert_array_equal(
        tcat.slot_mask(torch.from_numpy(counts), 6).numpy(),
        np.asarray(jcat.slot_mask(counts, 6)),
    )


@pytest.mark.parametrize("with_mask", [False, True])
def test_prune_catalog(with_mask):
    rng = np.random.default_rng(4)
    locs = rng.uniform(-1.0, 9.0, (50, 6, 2)).astype(np.float32)
    fluxes = rng.uniform(0.0, 3.0, (50, 6)).astype(np.float32)
    counts = rng.integers(0, 7, 50).astype(np.int32)
    mask = np.arange(6) < counts[:, None] if with_mask else None
    want = jcat.prune_catalog(locs, fluxes, height=8, width=8,
                              flux_threshold=0.7, mask=mask)
    got = tcat.prune_catalog(
        t(locs), t(fluxes), height=8, width=8, flux_threshold=0.7,
        mask=None if mask is None else torch.from_numpy(mask),
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
