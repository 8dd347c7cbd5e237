"""Posterior-correctness statistics (a copy of ``smcdet_tpu/validation.py``,
numpy and scipy only, so that the port scores results without the JAX
package).

The reference validates its samplers with statistical checks in results
notebooks rather than unit tests: count confusion matrices whose expected
symmetry under exact posterior sampling is a correctness check,
credible-interval coverage curves, and simulation-based-calibration rank
histograms (``experiments/analyze.py`` and ``smcdet_tpu_torch/analyze.py``
report them).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "sbc_ranks",
    "sbc_uniformity_pvalue",
    "credible_interval_contains",
    "credible_interval_coverage",
    "count_confusion_matrix",
    "confusion_asymmetry",
]


def sbc_ranks(true_values, posterior_samples, weights=None):
    """Simulation-based-calibration ranks: P_posterior(sample <= truth).

    ``true_values``: ``[I]``; ``posterior_samples``: ``[I, S]``;
    ``weights``: optional ``[I, S]`` posterior weights. Under a correct
    sampler the ranks are U(0,1) (results.ipynb cell 40 computes
    ``(true <= samples).mean(-1)``, i.e. 1 - rank; either is uniform).
    """
    true_values = np.asarray(true_values, dtype=np.float64)
    samples = np.asarray(posterior_samples, dtype=np.float64)
    less = samples < true_values[:, None]
    ties = samples == true_values[:, None]
    if weights is None:
        weights = np.full(samples.shape, 1.0 / samples.shape[-1])
    else:
        weights = np.asarray(weights, dtype=np.float64)
        weights = weights / weights.sum(-1, keepdims=True)
    # randomised tie-breaking keeps discrete statistics (counts) uniform
    rng = np.random.default_rng(0)
    u = rng.uniform(size=true_values.shape)
    return (weights * less).sum(-1) + u * (weights * ties).sum(-1)


def sbc_uniformity_pvalue(ranks):
    """Kolmogorov-Smirnov p-value of the ranks against U(0,1)."""
    from scipy.stats import kstest

    return float(kstest(np.asarray(ranks), "uniform").pvalue)


def credible_interval_contains(true_values, posterior_samples, level,
                               weights=None):
    """Per-image membership of the central ``level`` credible interval.

    Returns a boolean ``[I]`` array: truth inside the interval. The
    single source of the interval-endpoint convention — coverage curves
    and any stratified coverage (e.g. by region row) must agree.
    """
    true_values = np.asarray(true_values, dtype=np.float64)
    samples = np.asarray(posterior_samples, dtype=np.float64)
    alpha = (1.0 - float(level)) / 2.0
    if weights is None:
        lo = np.quantile(samples, alpha, axis=-1)
        hi = np.quantile(samples, 1.0 - alpha, axis=-1)
    else:
        w = np.asarray(weights, dtype=np.float64)
        lo = np.empty(samples.shape[0])
        hi = np.empty(samples.shape[0])
        for j in range(samples.shape[0]):
            order = np.argsort(samples[j])
            cdf = np.cumsum(w[j][order])
            cdf /= cdf[-1]
            lo[j] = samples[j][order][np.searchsorted(cdf, alpha)]
            hi[j] = samples[j][order][
                min(np.searchsorted(cdf, 1 - alpha), len(cdf) - 1)
            ]
    return (true_values >= lo) & (true_values <= hi)


def credible_interval_coverage(true_values, posterior_samples, levels,
                               weights=None):
    """Empirical coverage of central credible intervals.

    Returns ``coverage [len(levels)]``: the fraction of images whose true
    value falls inside the central ``level`` interval of its posterior
    samples (results.ipynb cells 35-36).
    """
    levels = np.asarray(levels, dtype=np.float64)
    out = np.zeros(levels.shape)
    for i, level in enumerate(levels):
        out[i] = credible_interval_contains(
            true_values, posterior_samples, level, weights=weights
        ).mean()
    return out


def count_confusion_matrix(true_counts, est_count_samples, weights=None,
                           max_count=None):
    """Posterior-averaged count confusion matrix ``[K+1, K+1]``.

    Entry (i, j) is the average posterior probability of count j among
    images with true count i (results.ipynb cells 29-34). Under exact
    posterior sampling with images drawn from the prior predictive the
    matrix is symmetric in expectation (manuscript.tex:608-611).
    """
    true_counts = np.asarray(true_counts, dtype=int)
    samples = np.asarray(est_count_samples, dtype=int)
    if max_count is None:
        max_count = max(int(true_counts.max()), int(samples.max()))
    K = max_count + 1
    if weights is None:
        weights = np.full(samples.shape, 1.0 / samples.shape[-1])
    else:
        weights = np.asarray(weights, dtype=np.float64)
        weights = weights / weights.sum(-1, keepdims=True)
    M = np.zeros((K, K))
    counts_per_row = np.zeros(K)
    for i in range(true_counts.shape[0]):
        t = min(true_counts[i], max_count)
        pmf = np.bincount(
            np.clip(samples[i], 0, max_count), weights=weights[i], minlength=K
        )
        M[t] += pmf
        counts_per_row[t] += 1
    # joint pmf over (true, estimated): weight rows by their frequency
    M /= max(true_counts.shape[0], 1)
    return M


def confusion_asymmetry(M):
    """Normalised asymmetry ``|M - M^T|_1 / |M|_1`` (0 for exact posterior
    sampling in expectation)."""
    M = np.asarray(M)
    denom = np.abs(M).sum()
    return float(np.abs(M - M.T).sum() / denom) if denom else 0.0
