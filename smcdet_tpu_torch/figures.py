"""Matplotlib figures for experiment reports (a copy of
``experiments/figures.py``, the port's own, without JAX): per-magnitude-bin
precision / recall / F1 with bootstrap bands beside the extractor's, the
count confusion heatmap, the credible-interval coverage, the SBC rank
histogram, the runtime against the true count and the detected stars by
magnitude, written by ``save_all`` under the JAX script's file names; and
``compare_mcmc``'s three-panel figure (``plot_mcmc_comparison``, the
figure of ``experiments/m71synthetic/compare_mcmc.py``).

Every function takes numpy arrays and imports matplotlib inside itself, so
the module imports where matplotlib does not (the H100 machine has none):
draw the figures on a CPU machine from a card run's result files.
``require_matplotlib`` raises where matplotlib is missing.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["require_matplotlib", "plot_detection", "plot_confusion",
           "plot_coverage", "plot_sbc", "plot_runtime",
           "plot_classified_counts", "save_all", "plot_mcmc_comparison"]

SMC_COLOR = "#2a78d6"
SEP_COLOR = "#eb6834"
NEUTRAL = "#6b6b66"
SEQ_RAMP = ["#f4f9ff", "#cde2fb", "#9ec5f4", "#5598e7", "#256abf", "#0d366b"]


def _style(ax):
    ax.spines[["top", "right"]].set_visible(False)
    ax.grid(True, axis="y", alpha=0.25, linewidth=0.6)
    ax.set_axisbelow(True)


def _bin_labels(mag_bins):
    edges = [f"{b:g}" for b in mag_bins]
    labels = [f"<{edges[0]}"]
    labels += [f"{edges[i]}-{edges[i + 1]}" for i in range(len(edges) - 1)]
    return labels


def plot_detection(out_path, mag_bins, smc_ci, sep_ci=None):
    """P/R/F1 per magnitude bin. ``smc_ci``/``sep_ci`` map each metric name
    to ``[3, n_bins]`` (lo, mid, hi) bootstrap summaries."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics = ["precision", "recall", "f1"]
    labels = _bin_labels(mag_bins)
    x = np.arange(len(labels))
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.6), sharey=True)
    for ax, m in zip(axes, metrics):
        lo, mid, hi = np.asarray(smc_ci[m])
        ax.fill_between(x, lo, hi, color=SMC_COLOR, alpha=0.18, linewidth=0)
        ax.plot(x, mid, color=SMC_COLOR, linewidth=2, marker="o",
                markersize=5, label="CS-SMC")
        if sep_ci is not None:
            slo, smid, shi = np.asarray(sep_ci[m])
            ax.fill_between(x, slo, shi, color=SEP_COLOR, alpha=0.18,
                            linewidth=0)
            ax.plot(x, smid, color=SEP_COLOR, linewidth=2, marker="s",
                    markersize=5, label="extractor (tuned)")
        ax.set_title(m, fontsize=11)
        ax.set_xticks(x, labels, rotation=30, fontsize=8)
        ax.set_ylim(0, 1.02)
        ax.set_xlabel("magnitude bin")
        _style(ax)
    axes[0].set_ylabel("value")
    axes[0].legend(frameon=False, fontsize=9, loc="lower left")
    fig.suptitle("Detection metrics by magnitude (95% bootstrap CI)",
                 fontsize=12)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_confusion(out_path, M):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap

    M = np.asarray(M)
    cmap = LinearSegmentedColormap.from_list("seqblue", SEQ_RAMP)
    fig, ax = plt.subplots(figsize=(4.8, 4.2))
    im = ax.imshow(M, cmap=cmap, vmin=0, origin="lower")
    K = M.shape[0]
    thresh = M.max() * 0.55 if M.max() else 1.0
    for i in range(K):
        for j in range(K):
            if M[i, j] >= 0.0005:
                ax.text(j, i, f"{M[i, j]:.3f}", ha="center", va="center",
                        fontsize=7,
                        color="white" if M[i, j] > thresh else "#1a1a19")
    ax.set_xlabel("posterior count")
    ax.set_ylabel("true count")
    ax.set_xticks(range(K))
    ax.set_yticks(range(K))
    ax.set_title("Joint pmf of (true, posterior) counts", fontsize=11)
    fig.colorbar(im, ax=ax, shrink=0.85)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_coverage(out_path, levels, coverage, n_images):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    levels = np.asarray(levels, dtype=float)
    coverage = np.asarray(coverage, dtype=float)
    se = np.sqrt(np.clip(coverage * (1 - coverage), 1e-12, None) / n_images)
    fig, ax = plt.subplots(figsize=(4.6, 4.2))
    ax.plot([0, 1], [0, 1], color=NEUTRAL, linewidth=1, linestyle="--",
            label="nominal")
    ax.errorbar(levels, coverage, yerr=1.96 * se, color=SMC_COLOR,
                linewidth=2, marker="o", markersize=5, capsize=3,
                label="empirical")
    ax.set_xlabel("nominal credible level")
    ax.set_ylabel("empirical coverage")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.05)
    ax.set_title("Total-flux credible-interval coverage", fontsize=11)
    ax.legend(frameon=False, fontsize=9, loc="upper left")
    _style(ax)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_sbc(out_path, ranks, n_bins=20):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ranks = np.asarray(ranks)
    n = ranks.shape[0]
    expected = n / n_bins
    # 99% envelope for a uniform histogram bin count
    from scipy.stats import binom

    lo = binom.ppf(0.005, n, 1 / n_bins)
    hi = binom.ppf(0.995, n, 1 / n_bins)
    fig, ax = plt.subplots(figsize=(4.6, 3.6))
    ax.axhspan(lo, hi, color=NEUTRAL, alpha=0.15, linewidth=0)
    ax.axhline(expected, color=NEUTRAL, linewidth=1, linestyle="--")
    ax.hist(ranks, bins=np.linspace(0, 1, n_bins + 1), color=SMC_COLOR,
            edgecolor="white", linewidth=1)
    ax.set_xlabel("SBC rank of true total flux")
    ax.set_ylabel("images")
    ax.set_title("Simulation-based calibration (99% band)", fontsize=11)
    _style(ax)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_runtime(out_path, true_counts, runtimes):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    true_counts = np.asarray(true_counts)
    runtimes = np.asarray(runtimes)
    rng = np.random.default_rng(0)
    jitter = rng.uniform(-0.18, 0.18, size=true_counts.shape)
    fig, ax = plt.subplots(figsize=(5.2, 3.8))
    ax.scatter(true_counts + jitter, runtimes, s=12, alpha=0.35,
               color=SMC_COLOR, linewidths=0)
    uniq = np.unique(true_counts)
    med = [np.median(runtimes[true_counts == u]) for u in uniq]
    ax.plot(uniq, med, color="#104281", linewidth=2, marker="o",
            markersize=5, label="median")
    ax.set_xlabel("true source count")
    ax.set_ylabel("runtime per image (s)")
    ax.set_title("CS-SMC + aggregation runtime", fontsize=11)
    ax.legend(frameon=False, fontsize=9)
    _style(ax)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_classified_counts(out_path, mag_bins, true_total, est_by_catalog,
                           sep_total=None):
    """Number of detected stars per magnitude bin: truth vs the posterior
    spread vs the extractor point estimate (results.ipynb cell 57).
    ``est_by_catalog``: ``[S, n_bins]`` totals per sampled catalog."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = _bin_labels(mag_bins)
    x = np.arange(len(labels))
    est = np.asarray(est_by_catalog)
    fig, ax = plt.subplots(figsize=(6.0, 4.2))
    ax.plot(x, np.asarray(true_total), color="#1a1a19", linewidth=2,
            marker="v", markersize=6, label="true catalog")
    ax.vlines(x, np.quantile(est, 0.05, 0), np.quantile(est, 0.95, 0),
              color=SMC_COLOR, linewidth=2)
    ax.plot(x, np.median(est, 0), color=SMC_COLOR, linewidth=2, marker="o",
            markersize=5, label="CS-SMC (median, 90% band)")
    if sep_total is not None:
        ax.plot(x, np.asarray(sep_total), color=SEP_COLOR, linewidth=2,
                marker="s", markersize=5, label="extractor (tuned)")
    ax.set_xticks(x, labels, rotation=30, fontsize=8)
    ax.set_xlabel("magnitude bin (fainter →)")
    ax.set_ylabel("number of stars")
    ax.set_title("Detected stars by magnitude", fontsize=11)
    ax.legend(frameon=False, fontsize=9)
    _style(ax)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def save_all(fig_dir, *, mag_bins, smc_ci, sep_ci, confusion, levels,
             coverage, n_images, ranks, true_counts, runtimes,
             classified=None):
    fig_dir = Path(fig_dir)
    fig_dir.mkdir(parents=True, exist_ok=True)
    plot_detection(fig_dir / "detection.png", mag_bins, smc_ci, sep_ci)
    plot_confusion(fig_dir / "count_confusion.png", confusion)
    plot_coverage(fig_dir / "coverage.png", levels, coverage, n_images)
    plot_sbc(fig_dir / "sbc.png", ranks)
    if runtimes is not None:
        plot_runtime(fig_dir / "runtime.png", true_counts, runtimes)
    if classified is not None:
        plot_classified_counts(fig_dir / "classified_counts.png", mag_bins,
                               *classified)
    return sorted(p.name for p in fig_dir.glob("*.png"))


def require_matplotlib(flag: str = "--no-figures"):
    """Raise ``RuntimeError`` naming ``flag`` when matplotlib does not
    import (figures are never skipped silently)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            f"figures need matplotlib, which does not import here ({e}); "
            f"pass {flag}, or draw the figures on a machine with matplotlib "
            "from this run's result files") from e


def plot_mcmc_comparison(out_path, s, num_samples):
    """``compare_mcmc``'s figure from its per-image arrays ``s``
    (``studies.compare_mcmc.stats``): the plain MH and the RJ mean counts
    against CS-SMC's, and the TVD histograms."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mean_mc, mean_smc, mean_rj = s["mean_mc"], s["mean_smc"], s["mean_rj"]
    mixed, tvd, rj_tvd = s["mixed"], s["tvd"], s["rj_tvd"]
    n = tvd.shape[0]
    fig, axes = plt.subplots(1, 3, figsize=(13.2, 4.0))
    ax = axes[0]
    lim = max(mean_mc.max(), mean_smc.max()) * 1.05 + 0.1
    ax.plot([0, lim], [0, lim], color=NEUTRAL, linewidth=1, linestyle="--")
    ax.scatter(mean_smc[mixed], mean_mc[mixed], s=14, alpha=0.5,
               color=SMC_COLOR, linewidths=0,
               label=f"well-mixed chain (n={int(mixed.sum())})")
    ax.scatter(mean_smc[~mixed], mean_mc[~mixed], s=14, alpha=0.5,
               color=SEP_COLOR, linewidths=0,
               label=f"stuck chain, acc<0.15 (n={int((~mixed).sum())})")
    ax.legend(frameon=False, fontsize=8, loc="upper left")
    ax.set_xlabel("CS-SMC posterior mean count")
    ax.set_ylabel("plain MH posterior mean count")
    ax.set_title("Plain saturated MH (reference baseline)", fontsize=11)
    ax.spines[["top", "right"]].set_visible(False)

    ax = axes[1]
    lim = max(mean_rj.max(), mean_smc.max()) * 1.05 + 0.1
    ax.plot([0, lim], [0, lim], color=NEUTRAL, linewidth=1, linestyle="--")
    ax.scatter(mean_smc, mean_rj, s=14, alpha=0.5, color=SMC_COLOR,
               linewidths=0)
    ax.set_xlabel("CS-SMC posterior mean count")
    ax.set_ylabel("RJ-MH posterior mean count")
    ax.set_title("Reversible-jump MH (birth/death)", fontsize=11)
    ax.spines[["top", "right"]].set_visible(False)

    ax = axes[2]
    bins = np.linspace(0, max(0.3, tvd.max(), rj_tvd.max()), 25)
    ax.hist(tvd, bins=bins, color=SEP_COLOR, edgecolor="white",
            linewidth=0.8, alpha=0.7, label="plain MH")
    ax.hist(rj_tvd, bins=bins, color=SMC_COLOR, edgecolor="white",
            linewidth=0.8, alpha=0.7, label="RJ-MH")
    ax.legend(frameon=False, fontsize=8)
    ax.set_xlabel("TV distance to CS-SMC count pmf")
    ax.set_ylabel("images")
    ax.set_title("Count-pmf agreement", fontsize=11)
    ax.spines[["top", "right"]].set_visible(False)
    fig.suptitle(f"CS-SMC vs {num_samples // 1000}k-sample MCMC anchors on "
                 f"{n} images", fontsize=12)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
