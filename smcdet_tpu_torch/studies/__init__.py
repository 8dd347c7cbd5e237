"""The repository's studies on the port, without JAX, and the count-pmf
helpers they share: the comparison studies of
``experiments/basic/compare_kernels.py`` and
``experiments/divideandconquer/compare_{singletile,pooled}.py``, and the M71
studies of ``experiments/m71/{crowded_budget_probe,run_smc_oracle,
compare_nogiants,misspec_study,simulator_checks}.py`` and
``experiments/m71synthetic/{repeated_runs,split_mode_study}.py``
(``m71_fixture`` holds what they need of the fixture scripts).

Each study reads its suite's config from the checkout this package sits in
(``REPO / experiments/<suite>``) and its tiles and results under the
config's ``output_dir``, relative to the working directory, as the JAX
scripts do.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["REPO", "weighted_pmf", "tvd_stats"]

REPO = Path(__file__).resolve().parents[2]


def weighted_pmf(counts, weights, K):
    """Per image, the posterior pmf of the pruned count over 0..K-1 from
    flat particles ``counts`` / ``weights [I, P]`` (numpy, float64),
    renormalised over that support."""
    counts, weights = np.asarray(counts), np.asarray(weights)
    pmf = np.zeros((counts.shape[0], K))
    for k in range(K):
        pmf[:, k] = ((counts == k) * weights).sum(-1)
    return pmf / np.maximum(pmf.sum(-1, keepdims=True), 1e-12)


def tvd_stats(tvd):
    """Mean, median and p90 of per-image TVDs, rounded as the JAX scripts
    round them."""
    return {
        "mean": round(float(tvd.mean()), 4),
        "median": round(float(np.median(tvd)), 4),
        "p90": round(float(np.quantile(tvd, 0.9)), 4),
    }
