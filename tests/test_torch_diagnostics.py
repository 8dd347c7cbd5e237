"""The port's observability and checkpointing
(smcdet_tpu_torch/utils/diagnostics.py, utils/checkpoint.py), mirroring the
JAX package's tests/test_diagnostics.py: the phase timer, the summary of a
recorded history (the same text as the JAX package's on the same result),
the profiler hook, and a round trip of an ``SMCResult`` through ``.npz``."""

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
from smcdet_tpu.utils import diagnostics as jdiag
from smcdet_tpu_torch.inference import smc as tsmc
from smcdet_tpu_torch.utils import diagnostics as tdiag
from smcdet_tpu_torch.utils.checkpoint import load_pytree, save_pytree

_LOCS = [[[2.0, 2.5], [5.5, 5.0]]]
_FLUXES = [[6.0, 9.0]]


@pytest.fixture(scope="module")
def problem():
    prior, model, kernel = m71_problem(max_objects=3)
    images = jax.jit(model.sample)(jax.random.key(42),
                                   jnp.asarray(_LOCS, jnp.float32),
                                   jnp.asarray(_FLUXES, jnp.float32))
    return prior, model, kernel.replace(num_iters=5), images


@pytest.fixture(scope="module")
def result(problem):
    prior, model, kernel, images = problem
    cfg = tsmc.SMCConfig(num_catalogs=64, resample_method="systematic",
                         max_smc_iters=60, record_history=True)
    return tsmc.run_csmc(torch.Generator().manual_seed(0), t(images),
                         port_prior(prior), port_model(model),
                         port_kernel(kernel), cfg)


def test_phase_timer_accumulates_and_reports():
    timer = tdiag.PhaseTimer()
    with timer("a"):
        sum(range(1000))
    with timer("a", sync=torch.zeros(3)):  # a CPU tensor: nothing to wait
        sum(range(1000))
    with timer("b", sync="cpu"):
        pass
    assert timer.counts["a"] == 2 and timer.counts["b"] == 1
    rep = timer.report()
    assert "a" in rep and "b" in rep and "share" in rep
    assert set(timer.as_dict()) == {"a", "b"}


def test_history_recorded(result):
    n = result.num_iters
    temp = result.history["temperature"][:n, 0].numpy()
    # temperatures are non-decreasing and end at 1
    assert (np.diff(temp) >= -1e-6).all()
    np.testing.assert_allclose(temp[-1], 1.0)
    assert tuple(result.history["ess"].shape[1:]) == (1, 4)


def test_summary_renders(result):
    text = tdiag.summarize_diagnostics(result)
    assert "iterations" in text and "temperature" in text
    assert f"iter {result.num_iters:3d}" in text


def test_summary_is_the_jax_summary(problem):
    """On the JAX package's recorded result, the port's summary prints the
    text the JAX package's prints."""
    prior, model, kernel, images = problem
    cfg = jsmc.SMCConfig(num_catalogs=32, max_smc_iters=12,
                         record_history=True)
    jr = jax.jit(jsmc.run_csmc, static_argnums=5)(
        jax.random.key(0), images, prior, model, kernel, cfg)
    assert (tdiag.summarize_diagnostics(jr)
            == jdiag.summarize_diagnostics(jr))


def test_trace_profile_writes_a_trace(tmp_path):
    with tdiag.trace_profile(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert prof.key_averages()


def test_roundtrip_smc_result(result, tmp_path):
    path = save_pytree(tmp_path / "state", result)
    assert path.suffix == ".npz"
    back = load_pytree(path, result, device="cpu")
    assert type(back) is type(result)
    assert back.num_iters == result.num_iters
    for name in result._fields:
        a, b = getattr(result, name), getattr(back, name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
    for k, v in result.history.items():
        assert torch.equal(back.history[k], v), k


def test_roundtrip_keeps_missing_fields_none(tmp_path):
    state = tsmc.SMCResult(*([torch.arange(3.0)] * 11), num_iters=4,
                           acc_rate=torch.ones(2))
    assert state.history is None
    back = load_pytree(save_pytree(tmp_path / "s", state), state, "cpu")
    assert back.history is None and back.num_iters == 4
    nested = {"a": torch.ones(2, 3), "b": {"c": torch.zeros(4), "d": 2.5}}
    got = load_pytree(save_pytree(tmp_path / "d", nested), nested, "cpu")
    assert torch.equal(got["a"], nested["a"])
    assert torch.equal(got["b"]["c"], nested["b"]["c"])
    assert got["b"]["d"] == 2.5
