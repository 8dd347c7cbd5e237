"""Kernel K5's plain version (smcdet_tpu_torch/roofline.py): the dependent
FP32 / special-function chains of experiments/roofline.py:_chain_bench.

The JAX ``_chain_bench`` returns only a time and an operation count, no
values, so the chains' values are held against a numpy f32 chain of the same
steps; against the JAX version the tests hold what it does return, the
counted operations, and the constants the two share. The CUDA kernel runs
only on the card: see tests/test_torch_gpu.py.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu_torch import roofline


def _jax_roofline():
    path = Path(__file__).resolve().parents[1] / "experiments" / "roofline.py"
    spec = importlib.util.spec_from_file_location("jax_roofline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _numpy_step(kind, x):
    f32 = np.float32
    if kind == "fma":  # one rounding per step, as a fused multiply-add
        return (x.astype(np.float64) * np.float64(f32(1.0000001))
                + np.float64(f32(1e-9))).astype(f32)
    if kind == "exp":
        return np.exp(-x)
    if kind == "rsqrt":
        return f32(1.0) / np.sqrt(x + f32(1.5))
    return np.log(x + f32(2.0))


@pytest.mark.parametrize("kind", roofline.KINDS)
def test_plain_chain_matches_numpy(kind):
    """200 x 8 steps of the 4 chains per element against numpy in f32: the
    fma chain's step rounds once in both (rtol 1e-7, the four-term sum's
    order); exp, sqrt and log may differ by an ulp per step, which the
    contracting chains keep near their fixed points (rtol 1e-6)."""
    x0 = np.linspace(0.1, 1.0, 257, dtype=np.float32)
    n_chain = 200
    x = x0[None, :] + np.float32(0.001) * np.arange(
        roofline.STREAMS, dtype=np.float32)[:, None]
    for _ in range(n_chain * roofline.UNROLL):
        x = _numpy_step(kind, x).astype(np.float32)
    want = x.sum(0, dtype=np.float32)
    got = roofline.chain(kind, torch.from_numpy(x0), n_chain)
    assert got.dtype == torch.float32 and got.shape == (257,)
    if kind == "fma":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)
        assert float(got.max()) > float(x0.max() * roofline.STREAMS)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("kind,fixed_point", [("exp", 0.5671433),
                                              ("rsqrt", 0.6776507),
                                              ("log", 1.1461932)])
def test_contracting_chains_reach_their_fixed_points(kind, fixed_point):
    """The reference's comments name the fixed points (exp ~0.567, rsqrt
    ~0.68, log ~1.14); the plain chains converge to them from anywhere in
    (0.1, 1)."""
    x0 = torch.linspace(0.1, 1.0, 10)
    got = roofline.chain(kind, x0, 50) / roofline.STREAMS
    np.testing.assert_allclose(got.numpy(), fixed_point, rtol=1e-5)


def test_counted_operations_match_the_jax_microbenchmark():
    """``experiments/roofline.py:_chain_bench`` (Pallas, interpret mode on
    the CPU) counts ``streams x 8 x 128 x n_chain x UNROLL`` steps, two
    flops each for fma and one operation each for the others: the port's
    STEP_OPS count the same per step (flops for fma, SFU operations for
    the others), and the two share UNROLL and the four kinds."""
    jr = _jax_roofline()
    assert roofline.UNROLL == jr.UNROLL
    for kind in roofline.KINDS:
        _, ops = jr._chain_bench(kind, streams=2, n_chain=3, interpret=True,
                                 reps=1)
        flops, sfu = roofline.STEP_OPS[kind]
        per_step = flops if kind == "fma" else sfu
        assert ops == 8 * 128 * 2 * 3 * roofline.UNROLL * per_step, kind


@pytest.mark.parametrize("kind", roofline.KINDS)
def test_check_lengths_resolve_one_step(kind):
    """At ``CHECK_N_CHAIN`` chain iterations from x0 in [0, 10] (what
    chip_smoke.py and the card's tests hold K5 to), the plain chain one step
    shorter and one step longer each differ from it by more than
    ``CHECK_RTOL``: a kernel that runs another number of steps than it
    counts fails the check."""
    x0 = torch.linspace(0.0, 10.0, 4096)
    n_chain, rtol = roofline.CHECK_N_CHAIN[kind], roofline.CHECK_RTOL[kind]
    want = roofline.chain_reference(kind, x0, n_chain)
    for d in (-1, 1):
        off = roofline.chain_reference(kind, x0, 0,
                                       n_chain * roofline.UNROLL + d)
        assert float(((off - want).abs() / want.abs()).max()) > rtol, d


def test_fma_step_rounds_once():
    """The plain fma step is the f32 rounding of the exact ``x c + b``
    (``c``, ``b`` the f32 constants of the kernel's ``fma.rn.f32``), not
    the product rounded and then the sum."""
    x = torch.linspace(0.1, 1.0, 100001)
    exact = x.double() * (1.0 + 2.0**-23) + float(np.float32(1e-9))
    assert torch.equal(roofline.chain_step("fma", x), exact.float())
    twice = x * np.float32(1.0000001) + np.float32(1e-9)
    assert not torch.equal(roofline.chain_step("fma", x), twice)


def test_chain_on_cpu_counts_no_launch_and_checks_its_kind():
    before = roofline.chain.launches
    out = roofline.chain("log", torch.full((8,), 0.5), 2)
    assert roofline.chain.launches == before
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="kind"):
        roofline.chain("sin", torch.full((8,), 0.5), 2)


def test_step_ops_name_what_each_step_issues():
    """Per step: fma one FFMA (2 flops, no SFU); every other kind one SFU
    operation plus its glue (exp: the multiply by -log2 e; rsqrt: the add;
    log: the add and the multiply by ln 2)."""
    assert roofline.STEP_OPS == {"fma": (2, 0), "exp": (1, 1),
                                 "rsqrt": (1, 1), "log": (2, 1)}
    assert set(roofline.STEP_OPS) == set(roofline.KINDS)
