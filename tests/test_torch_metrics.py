"""The port's scoring (smcdet_tpu_torch/ops/assignment.py, metrics.py,
validation.py, analyze.py) against the JAX package's and
experiments/analyze.py on the same inputs, on the CPU."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu import metrics as jmetrics
from smcdet_tpu import validation as jval
from smcdet_tpu.ops import assignment as jassign
from smcdet_tpu.ops.resampling import multinomial_indices as jax_multinomial
from smcdet_tpu_torch import analyze as tanalyze
from smcdet_tpu_torch import metrics as tmetrics
from smcdet_tpu_torch import validation as tval
from smcdet_tpu_torch.ops import assignment as tassign

REPO = Path(__file__).resolve().parents[1]


def _cost_matrices(n, B=64, seed=0):
    """Random costs, and the same with whole padded blocks: rows or columns
    of BIG, and the (pad, pad) corner at 0, as ``pad_cost_matrix`` makes
    them."""
    rng = np.random.default_rng(seed + n)
    cost = rng.random((B, n, n)).astype(np.float32)
    rv = np.arange(n) < rng.integers(0, n + 1, (B, 1))
    cv = np.arange(n) < rng.integers(0, n + 1, (B, 1))
    padded = np.asarray(jassign.pad_cost_matrix(cost, rv, cv))
    np.testing.assert_array_equal(
        tassign.pad_cost_matrix(torch.from_numpy(cost), torch.from_numpy(rv),
                                torch.from_numpy(cv)).numpy(), padded)
    return np.concatenate([cost, padded])


@pytest.mark.parametrize("n", [1, 3, 8, 13])
def test_linear_sum_assignment_matches_jax_and_is_optimal(n):
    cost = _cost_matrices(n)
    got = tassign.linear_sum_assignment(torch.from_numpy(cost)).numpy()
    want = np.asarray(jax.jit(jassign.linear_sum_assignment)(cost))
    np.testing.assert_array_equal(got, want)
    rows = np.arange(n)
    for c, col in zip(cost.astype(np.float64), got):
        assert sorted(col) == list(rows)  # a permutation
        r, s = scipy_lsa(c)
        np.testing.assert_allclose(c[rows, col].sum(), c[r, s].sum(),
                                   rtol=1e-9)


def _catalogs(rng, T, M, N=None, truth=None):
    """Catalogs on an 8x8 tile: fluxes log-uniform over the default
    magnitude bins; with ``truth``, N posterior catalogs per tile scattered
    around it (counts off by one now and then)."""
    if truth is None:
        counts = rng.integers(0, M + 1, T)
        locs = rng.uniform(0.0, 8.0, (T, M, 2))
        fluxes = np.exp(rng.uniform(np.log(0.5), np.log(3000.0), (T, M)))
    else:
        tc, tl, tf = truth
        counts = np.clip(tc[:, None] + rng.integers(-1, 2, (T, N)), 0, M)
        locs = tl[:, None] + rng.normal(0.0, 0.3, (T, N, M, 2))
        fluxes = tf[:, None] * np.exp(rng.normal(0.0, 0.3, (T, N, M)))
    occ = np.arange(M) < counts[..., None]
    return (counts.astype(np.int32),
            np.where(occ[..., None], locs, 0.0).astype(np.float32),
            np.where(occ, fluxes, 0.0).astype(np.float32))


def test_match_catalogs_given_jax_indices_matches_jax():
    rng = np.random.default_rng(1)
    T, N, S = 16, 32, 20
    truth = _catalogs(rng, T, 6)
    est = _catalogs(rng, T, 5, N, (truth[0].clip(0, 5), truth[1][:, :5],
                                   truth[2][:, :5]))
    weights = rng.dirichlet(np.ones(N), T).astype(np.float32)
    bins = [15.0, 18.0, 21.0, 24.0]
    kw = dict(num_est_catalogs_to_match=S, locs_tol=0.5, mags_tol=0.5)
    want = jmetrics.match_catalogs(
        jax.random.key(3), *map(jnp.asarray, truth), *map(jnp.asarray, est),
        mag_bins=jnp.asarray(bins), est_weights=jnp.asarray(weights), **kw)
    idx = jax_multinomial(jax.random.key(3), jnp.asarray(weights), S)
    got = tmetrics.match_catalogs(
        *map(torch.from_numpy, truth), *map(torch.from_numpy, est),
        mag_bins=bins, indices=torch.from_numpy(np.asarray(idx)), **kw)
    for name, a, b in zip(tmetrics.MatchCounts._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert 0 < float(got.num_true_matches.sum()) < float(
        got.num_true_total.sum())
    for a, b in zip(tmetrics.compute_precision_recall_f1(got),
                    jmetrics.compute_precision_recall_f1(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    # drawn from a generator with the weights: catalogs of the posterior
    drawn = tmetrics.match_catalogs(
        *map(torch.from_numpy, truth), *map(torch.from_numpy, est),
        mag_bins=bins, est_weights=torch.from_numpy(weights),
        generator=torch.Generator().manual_seed(0), **kw)
    assert drawn.num_est_total.shape == (T, S, len(bins))


def test_validation_matches_jax_package():
    rng = np.random.default_rng(2)
    I, S = 40, 64
    truth = rng.normal(10.0, 2.0, I)
    samples = rng.normal(10.0, 2.0, (I, S))
    samples[:, :8] = np.round(samples[:, :8])  # some ties
    w = rng.dirichlet(np.ones(S), I)
    for weights in (None, w):
        np.testing.assert_array_equal(
            tval.sbc_ranks(truth, samples, weights),
            jval.sbc_ranks(truth, samples, weights))
        np.testing.assert_array_equal(
            tval.credible_interval_coverage(truth, samples, [0.5, 0.95],
                                            weights),
            jval.credible_interval_coverage(truth, samples, [0.5, 0.95],
                                            weights))
    ranks = jval.sbc_ranks(truth, samples)
    assert tval.sbc_uniformity_pvalue(ranks) == jval.sbc_uniformity_pvalue(
        ranks)
    tc = rng.integers(0, 5, I)
    ec = rng.integers(0, 6, (I, S))
    M = tval.count_confusion_matrix(tc, ec, weights=w)
    np.testing.assert_array_equal(M, jval.count_confusion_matrix(tc, ec, w))
    assert tval.confusion_asymmetry(M) == jval.confusion_asymmetry(M)


def _results_dir(path, T=24, N=64, M=5, ns=12):
    """A finished experiment written by hand: two batch files of the
    runner's keys, the truth ``tiles.npz`` and an extractor baseline
    ``sep_results.npz`` over every other image."""
    rng = np.random.default_rng(4)
    truth = _catalogs(rng, T, M)
    est = _catalogs(rng, T, M, N, truth)
    weights = rng.dirichlet(np.ones(N), T).astype(np.float32)
    path.mkdir(parents=True)
    np.savez(path / "tiles.npz", images=np.zeros((T, 8, 8), np.float32),
             true_counts=truth[0], true_locs=truth[1], true_fluxes=truth[2])
    for b, (lo, hi) in enumerate(((0, T // 2), (T // 2, T))):
        np.savez(path / f"smc_batch{b:04d}.npz", counts=est[0][lo:hi],
                 pruned_counts=est[0][lo:hi], pruned_locs=est[1][lo:hi],
                 pruned_fluxes=est[2][lo:hi], weights=weights[lo:hi],
                 runtime=np.asarray(1.5 + b),
                 runtime_per_image=rng.uniform(0.1, 0.2, hi - lo),
                 image_index=np.arange(lo, hi))
    idx = np.arange(1, T, 2)[:ns]
    sep = _catalogs(rng, ns, M, 1, tuple(a[idx] for a in truth))
    np.savez(path / "sep_results.npz", counts=sep[0][:, 0],
             locs=sep[1][:, 0], fluxes=sep[2][:, 0],
             eval_true_counts=truth[0][idx], eval_true_locs=truth[1][idx],
             eval_true_fluxes=truth[2][idx], eval_indices=idx)


def _jax_draw(seed, weights, num):
    """The catalogs ``experiments/analyze.py`` draws with
    ``jax.random.key(seed)``."""
    return torch.from_numpy(np.asarray(jax_multinomial(
        jax.random.key(seed), jnp.asarray(weights), num)))


def test_analyze_json_matches_experiments_analyze(tmp_path, capsys):
    """The port's analyzer and ``experiments/analyze.py --no-figures`` on
    the same directory, the port's catalog draw pinned to the JAX script's:
    the same JSON keys and values. Every value is computed from the same
    MatchCounts and numpy statistics, rounded to 4 or 5 decimals; allowed
    difference 1e-4, one unit of the rounding."""
    _results_dir(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    args = ["--bootstrap", "200", "--num-match", "30"]
    spec = importlib.util.spec_from_file_location(
        "experiments_analyze", REPO / "experiments" / "analyze.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    argv = sys.argv
    sys.argv = ["analyze.py", str(tmp_path / "jax"), "--no-figures", *args]
    try:
        script.main()
    finally:
        sys.argv = argv
    want = json.loads((tmp_path / "jax" / "smc_analysis.json").read_text())
    got = tanalyze.main([str(tmp_path / "port"), "--device", "cpu",
                         "--no-figures", *args], draw=_jax_draw)
    assert json.loads((tmp_path / "port" / "smc_analysis.json").read_text()
                      ) == got
    assert "figures" not in got and "figures" not in want
    assert sorted(got) == sorted(want)
    assert {"sep_baseline", "detection_eval_subset"} <= set(got)

    def compare(a, b, key):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), key
            for k in b:
                compare(a[k], b[k], f"{key}.{k}")
        elif isinstance(b, list):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=0, atol=1e-4, err_msg=key)
        else:
            assert a == pytest.approx(b, abs=1e-4), key

    compare(got, want, "report")
    f1 = np.asarray(got["detection"]["f1_by_bin"]["point"])
    assert (f1 > 0).sum() >= 2  # the matching does match
    capsys.readouterr()


def test_analyze_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _results_dir(tmp_path / "r")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tanalyze.main([str(tmp_path / "r")])
