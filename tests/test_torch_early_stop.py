"""The ``sqjumpdist_tol`` early stop of the port's MH and MALA mutations
(``smcdet_tpu_torch/inference/kernels.py:early_stop_sweeps``) against the
JAX package's ``_run_sweeps_early_stop``, on the plain path (CPU).

The JAX package's own cases (tests/test_kernels.py): a tolerance of 0
runs every sweep, a huge one stops after the first, a near-zero MALA step
stops at sweep 1; and the JAX loop and the port's, fed the same uniforms
every sweep, stop at the same sweep with the same state. The CUDA route
(one kernel launch a sweep, never the plain version) is tested on the card
in tests/test_torch_gpu.py.
"""

import copy

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

from smcdet_tpu.inference import kernels as jkernels
from smcdet_tpu_torch.inference import kernels as tkernels
from smcdet_tpu_torch.inference.kernels import (
    KernelState,
    SingleComponentMALA,
    TargetContext,
    init_kernel_state,
)

T, N, M = 2, 128, 4


def _jax_problem():
    prior, model, kernel = m71_problem(max_objects=M)
    C = prior.num_counts

    @jax.jit
    def draw(k_prior, k_image):
        strata, locs, fluxes = prior.sample_stratified(k_prior, N, (T,))
        images = jnp.abs(model.sample(k_image, locs[:, -1, 0],
                                      fluxes[:, -1, 0]))
        return strata, locs, fluxes, images

    strata, locs, fluxes, images = draw(jax.random.key(0),
                                        jax.random.key(1))
    counts = jnp.broadcast_to(strata[None, :, None], (T, C, N))
    ctx = jkernels.TargetContext(prior=prior, model=model,
                                 image=images[:, None, None],
                                 temperature=jnp.full((T, 1, 1), 0.8))
    return prior, model, kernel, ctx, counts, locs, fluxes


@pytest.fixture(scope="module")
def problem():
    prior, model, kernel, ctx, counts, locs, fluxes = _jax_problem()
    p_ctx = TargetContext(port_prior(prior), port_model(model),
                          t(ctx.image), t(ctx.temperature))
    pcounts = t(counts, torch.int32)
    state = init_kernel_state(p_ctx, pcounts, t(locs), t(fluxes))
    return {"jax": (prior, model, kernel, ctx, counts, locs, fluxes),
            "kernel": port_kernel(kernel), "ctx": p_ctx, "counts": pcounts,
            "state": state}


def _with(kernel, **fields):
    out = copy.copy(kernel)
    for k, v in fields.items():
        setattr(out, k, v)
    return out


def _assert_states_equal(a: KernelState, b: KernelState):
    for name in ("locs", "fluxes", "rate", "parent_ll", "logprior"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _hand_rolled(kernel, gen, ctx, counts, state, sweeps):
    """``sweeps`` one-sweep mutations in a row, each on its own key: what
    the early stop runs when it never stops."""
    one = _with(kernel, num_iters=1, sqjumpdist_tol=None)
    accs = []
    for _ in range(sweeps):
        state, acc = one.run_from_state(gen, ctx, counts, state)
        accs.append(acc)
    return state, torch.stack(accs).mean(0)


def test_zero_tolerance_runs_every_sweep(problem):
    """tol = 0: exactly ``num_iters`` sweeps, bit for bit the hand-rolled
    loop of one-sweep runs on the same generator (acceptance to 1e-6: the
    two average sweeps and particles in another order)."""
    kernel = _with(problem["kernel"], num_iters=6, sqjumpdist_tol=0.0)
    args = (problem["ctx"], problem["counts"], problem["state"])
    got, acc = kernel.run_from_state(torch.Generator().manual_seed(3), *args)
    want, acc_want = _hand_rolled(kernel, torch.Generator().manual_seed(3),
                                  *args, 6)
    _assert_states_equal(got, want)
    np.testing.assert_allclose(acc.numpy(), acc_want.numpy(), atol=1e-6)


def test_huge_tolerance_runs_one_sweep(problem):
    kernel = _with(problem["kernel"], num_iters=6, sqjumpdist_tol=1e9)
    args = (problem["ctx"], problem["counts"], problem["state"])
    got, acc = kernel.run_from_state(torch.Generator().manual_seed(4), *args)
    want, acc_want = _hand_rolled(kernel, torch.Generator().manual_seed(4),
                                  *args, 1)
    _assert_states_equal(got, want)
    assert torch.equal(acc, acc_want)


def test_near_zero_mala_step_stops_at_sweep_one(problem, monkeypatch):
    """A MALA step of 1e-6 px barely moves a star, so the squared jump of
    the first sweep is far below 1e-2 and the mutation stops there."""
    runs = []
    early_stop = tkernels.early_stop_sweeps

    def recorded(*a, **kw):
        out = early_stop(*a, **kw)
        runs.append(out[2])
        return out

    monkeypatch.setattr(tkernels, "early_stop_sweeps", recorded)
    kernel = SingleComponentMALA(num_iters=10, locs_step=1e-6,
                                 fluxes_step=1e-6, fluxes_min=0.252,
                                 fluxes_max=1804.679, sqjumpdist_tol=1e-2,
                                 device="cpu")
    args = (problem["ctx"], problem["counts"], problem["state"])
    got, _ = kernel.run_from_state(torch.Generator().manual_seed(5), *args)
    assert runs == [1]
    want, _ = _hand_rolled(kernel, torch.Generator().manual_seed(5), *args,
                           1)
    _assert_states_equal(got, want)


def _jax_uniforms(key, shape):
    """The uniforms JAX's sweep draws from ``key`` (kernels.py:309-334 and
    distributions.py:62-64), as in tests/test_torch_mh_sweep.py."""
    k_j, k_loc, k_flux, k_acc = jax.random.split(key, 4)
    eps = 1e-6
    return (
        jax.random.uniform(k_j, shape),
        jax.random.uniform(k_loc, shape + (2,), minval=eps, maxval=1 - eps),
        jax.random.uniform(k_flux, shape, minval=eps, maxval=1 - eps),
        jax.random.uniform(k_acc, shape),
    )


def test_stops_where_jax_stops_given_the_same_uniforms(problem):
    """The JAX loop (``_run_sweeps_early_stop``, sweep ``i`` on
    ``fold_in(key, i)``) and the port's, whose sweep ``i`` takes the
    uniforms JAX's draws from that key, stop at the same sweep: the first
    whose batch-mean squared jump falls below a tolerance set between the
    statistic's values along the run. Particles agree with JAX's to 1e-4
    (rtol) but for accept flips on the boundary, at most 2% after the
    sweeps run (one sweep flips under 1%, tests/test_torch_mh_sweep.py);
    one sweep fewer or more leaves far fewer in agreement."""
    prior, model, kernel, ctx, counts, locs, fluxes = problem["jax"]
    key = jax.random.key(21)
    uniforms = jax.jit(_jax_uniforms, static_argnums=1)
    pk, pctx, pcounts = problem["kernel"], problem["ctx"], problem["counts"]

    def port_sweep(i, st):
        u = [t(x) for x in uniforms(jax.random.fold_in(key, i),
                                    counts.shape)]
        return pk.sweep(None, pctx, pcounts, st, uniforms=u)

    # the statistic along a run that never stops
    stats, states = [], [problem["state"]]

    def tracked(i, st):
        new, applied = port_sweep(i, st)
        stats.append(float(((new.locs - st.locs) ** 2).sum((-1, -2)).mean()))
        states.append(new)
        return new, applied

    tkernels.early_stop_sweeps(tracked, problem["state"], 12, 0.0)
    # stop at the first sweep (past the first two) whose statistic lies 10%
    # below every earlier one's, the tolerance halfway between
    stop = next(i for i in range(2, 12) if stats[i] < 0.9 * min(stats[:i]))
    tol = 0.5 * (stats[stop] + min(stats[:stop]))

    got, acc, n = tkernels.early_stop_sweeps(port_sweep, problem["state"],
                                             12, tol)
    assert n == stop + 1
    jstate = jax.jit(jkernels.init_kernel_state)(ctx, counts, locs, fluxes)
    jk = kernel.replace(num_iters=12, sqjumpdist_tol=tol, backend="xla")
    jst, jacc = jax.jit(lambda k, st: jkernels._run_sweeps_early_stop(
        jk, k, ctx, counts, st))(key, jstate)

    def agree(st):
        ok = torch.ones(pcounts.shape, dtype=torch.bool)
        for name in ("locs", "fluxes", "parent_ll", "logprior"):
            a, b = getattr(st, name), t(getattr(jst, name))
            close = torch.isclose(a, b, rtol=1e-4, atol=1e-4)
            ok &= close.reshape(pcounts.shape + (-1,)).all(-1)
        return float(ok.float().mean())

    assert agree(got) >= 0.98, agree(got)
    assert max(agree(states[n - 1]), agree(states[n + 1])) < 0.95
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), atol=0.02)
