"""``SMCConfig.record_history`` and ``SMCConfig.fixed_schedule`` of the
port's CS-SMC loop (smcdet_tpu_torch/inference/smc.py) against the JAX
package's (smcdet_tpu/inference/smc.py): the ladder's temperatures exactly,
the tempering step on a ladder given the same log-likelihoods to f32
tolerance, and the history's shapes and its tile order through chunking
and sorting (the JAX package's tests/test_smc.py cases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    m71_problem,
    one_torch_thread,
    port_kernel,
    port_model,
    port_prior,
    t,
)

from smcdet_tpu.inference import smc as jsmc
from smcdet_tpu_torch import convert
from smcdet_tpu_torch.inference import smc as tsmc

LADDER = (0.1, 0.3, 0.6, 1.0)
_LOCS = [[[1.8, 2.0], [6.2, 2.5], [4.0, 6.3]],
         [[2.3, 5.6], [5.9, 2.4], [0.0, 0.0]],
         [[4.1, 4.0], [0.0, 0.0], [0.0, 0.0]]]
_FLUXES = [[80.0, 120.0, 100.0], [90.0, 150.0, 0.0], [60.0, 0.0, 0.0]]


@pytest.fixture(scope="module")
def problem():
    prior, model, kernel = m71_problem(max_objects=3)
    images = jax.jit(model.sample)(jax.random.key(3),
                                   jnp.asarray(_LOCS, jnp.float32),
                                   jnp.asarray(_FLUXES, jnp.float32))
    return prior, model, kernel.replace(num_iters=5), images


def _port(problem):
    prior, model, kernel, images = problem
    return t(images), port_prior(prior), port_model(model), port_kernel(
        kernel)


def test_fixed_ladder_gives_the_jax_trajectory(problem):
    """The ladder of tests/test_smc.py:243-250 (0.1, 0.3, 0.6, 1.0): three
    iterations after the initial temper, the recorded temperatures equal to
    JAX's bit for bit, zeros past the end, history shapes equal."""
    prior, model, kernel, images = problem
    jcfg = jsmc.SMCConfig(num_catalogs=32, max_smc_iters=6,
                          record_history=True, fixed_schedule=LADDER)
    jr = jax.jit(jsmc.run_csmc, static_argnums=5)(
        jax.random.key(0), images, prior, model, kernel, jcfg)
    tcfg = tsmc.SMCConfig(num_catalogs=32, max_smc_iters=6,
                          record_history=True, fixed_schedule=LADDER)
    tr = tsmc.run_csmc(torch.Generator().manual_seed(0), *_port(problem),
                       tcfg)
    assert tr.num_iters == int(jr.num_iters) == 3
    want = convert.history_from_arrays(jr.history, "cpu")
    for name in ("temperature", "ess", "acc_rate"):
        assert tr.history[name].shape == want[name].shape, name
    assert tr.history["temperature"].shape == (6, 3)
    assert tr.history["ess"].shape == (6, 3, prior.num_counts)
    assert torch.equal(tr.history["temperature"], want["temperature"])
    np.testing.assert_allclose(tr.history["temperature"][:3, 0].numpy(),
                               LADDER[1:], atol=1e-6)
    assert torch.all(tr.temperature == 1.0)
    # the rows past the last iteration stay zero, as JAX's
    for name in ("ess", "acc_rate"):
        assert torch.all(tr.history[name][3:] == 0.0), name
        assert torch.all(tr.history[name][:3] > 0.0), name


def _states(T, C, N, iteration, temp, seed=0):
    rng = np.random.default_rng(seed)
    loglik = (rng.normal(size=(T, C, N)) * 20 - 500).astype(np.float32)
    log_z = rng.normal(size=(T, C)).astype(np.float32)
    weights = rng.dirichlet(np.ones(N), (T, C)).astype(np.float32)
    ess = np.full((T, C), 50.0, np.float32)
    prev = rng.normal(size=(T, C, N)).astype(np.float32)
    jstate = jsmc.SMCState(
        key=jax.random.key(0), locs=None, fluxes=None,
        temperature=jnp.asarray(temp), temperature_prev=jnp.asarray(temp),
        loglik=jnp.asarray(prev), weights=jnp.asarray(weights),
        log_z=jnp.asarray(log_z), ess=jnp.asarray(ess),
        acc_rate=jnp.zeros(T), iteration=jnp.int32(iteration),
    )
    tstate = tsmc.SMCState(
        generator=None, locs=None, fluxes=None, temperature=t(temp),
        temperature_prev=t(temp), loglik=t(prev), weights=t(weights),
        log_z=t(log_z), ess=t(ess), acc_rate=torch.zeros(T),
        iteration=iteration,
    )
    return loglik, jstate, tstate


@pytest.mark.parametrize("iteration", [0, 1, 2, 3, 7])
def test_ladder_step_matches_jax(iteration):
    """One tempering step on the ladder given the same log-likelihoods, at
    every rung and past the ladder's end (the last rung again): the new
    temperature equal to JAX's bit for bit, the log Z increment, weights
    and ESS to f32 tolerance (rtol 1e-5); a finished tile and one already
    past its rung stay put."""
    T, C, N = 4, 3, 96
    temp = np.asarray([0.0, 0.2, 1.0, 0.95], np.float32)
    loglik, jstate, tstate = _states(T, C, N, iteration, temp, iteration)
    want = jsmc._temper_and_reweight(
        None, None, None, jsmc.SMCConfig(num_catalogs=N,
                                         fixed_schedule=LADDER),
        jstate, loglik=jnp.asarray(loglik))
    got = tsmc._temper_and_reweight(
        tsmc.SMCConfig(num_catalogs=N, fixed_schedule=LADDER), tstate,
        t(loglik))
    np.testing.assert_array_equal(got.temperature.numpy(),
                                  np.asarray(want.temperature))
    for name in ("loglik", "weights", "log_z", "ess"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    rung = LADDER[min(iteration, len(LADDER) - 1)]
    assert float(got.temperature[2]) == 1.0
    assert float(got.temperature[0]) == pytest.approx(rung)
    if rung <= 0.2:
        assert float(got.temperature[1]) == np.float32(0.2)


def test_history_follows_the_tiles_through_sorting_and_chunking(problem):
    """tests/test_smc.py:477-499 and :543-567: one tile a chunk, tiles
    sorted by flux; the history of tile ``order[j]`` is that of tile ``j``
    of a run on the pre-sorted tiles, and its shapes equal JAX's chunked
    run's."""
    prior, model, kernel, images = problem
    timages, tp, tm, tk = _port(problem)
    cfg = tsmc.SMCConfig(num_catalogs=32, resample_method="systematic",
                         max_smc_iters=8, flux_detection_threshold=0.7,
                         record_history=True)
    res = tsmc.run_csmc_chunked(torch.Generator().manual_seed(11), timages,
                                tp, tm, tk, cfg, budget_bytes=1,
                                sort_tiles=True)
    order = np.argsort(timages.sum((1, 2)).numpy())
    manual = tsmc.run_csmc_chunked(torch.Generator().manual_seed(11),
                                   timages[order], tp, tm, tk, cfg,
                                   budget_bytes=1)
    for j in range(3):
        for name in ("temperature", "ess", "acc_rate"):
            assert torch.equal(res.history[name][:, order[j]],
                               manual.history[name][:, j]), name
        assert torch.equal(res.pruned_counts[order[j]],
                           manual.pruned_counts[j])
    jcfg = jsmc.SMCConfig(num_catalogs=32, resample_method="systematic",
                          max_smc_iters=8, flux_detection_threshold=0.7,
                          record_history=True)
    jr = jsmc.run_csmc_chunked(jax.random.key(11), images, prior, model,
                               kernel, jcfg, budget_bytes=1,
                               sort_tiles=True)
    for name in ("temperature", "ess", "acc_rate"):
        assert tuple(res.history[name].shape) == jr.history[name].shape
    # every tile's recorded trajectory rises to its final temperature
    n = res.num_iters
    for i in range(3):
        temps = res.history["temperature"][:, i]
        last = int((temps > 0).nonzero().max())
        assert last < n
        assert float(temps[last]) == float(res.temperature[i])
        assert torch.all(temps[:last].diff() >= 0)


def test_no_history_unless_asked(problem):
    timages, tp, tm, tk = _port(problem)
    cfg = tsmc.SMCConfig(num_catalogs=16, max_smc_iters=4)
    res = tsmc.run_csmc_chunked(torch.Generator().manual_seed(1), timages,
                                tp, tm, tk, cfg, budget_bytes=1)
    assert res.history is None
