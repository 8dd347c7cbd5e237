"""Matplotlib figures for experiment reports (a copy of
``experiments/figures.py``, the port's own, without JAX): per-magnitude-bin
precision / recall / F1 with bootstrap bands beside the extractor's, the
count confusion heatmap, the credible-interval coverage, the SBC rank
histogram, the runtime against the true count and the detected stars by
magnitude, written by ``save_all`` under the JAX script's file names; and
the studies' figures, each a copy of its JAX script's plot block:
``plot_misspec_study`` (``experiments/m71/misspec_study.py``),
``plot_simulator_checks`` (``experiments/m71/simulator_checks.py``),
``plot_repeated_runs_grid`` (``experiments/m71synthetic/repeated_runs.py``),
``plot_split_mode`` (``experiments/m71synthetic/split_mode_study.py``),
``plot_psf_comparison`` (``experiments/m71/psf_comparison.py``),
``plot_singletile_comparison``
(``experiments/divideandconquer/compare_singletile.py``) and
``plot_mcmc_comparison`` (``experiments/m71synthetic/compare_mcmc.py``).

Every function takes numpy arrays and imports matplotlib inside itself, so
the module imports where matplotlib does not (the H100 machine has none).
``require_matplotlib`` raises where matplotlib is missing.

The studies write their figures' arrays, unrounded, beside their JSON on
the machine that runs them, and the figures are drawn from those files on
any machine with matplotlib:

    python -m smcdet_tpu_torch.figures <output-dir>

draws every figure whose data it finds under ``<output-dir>`` into the JAX
scripts' file names, printing each file it writes. The data files (``dir``
is the directory that holds the study's JSON, the figure goes to
``dir/figures/<name>.png``):

- ``dir/figure_data/<name>.npz`` (``save_figure_data``), ``<name>`` one of
  ``simulator_checks``, ``split_mode_study``, ``psf_comparison``,
  ``singletile_comparison`` and ``mcmc_comparison``;
- ``dir/misspec_study.json``, the study's report (the JAX figure reads
  only that; no figure below two finished variants, as the JAX script);
- ``dir/repeatedruns_s<count>.npz``, the repeated-runs grid, which gives
  ``repeatedruns_logpx_s<count>.png`` and
  ``repeatedruns_countprob_s<count>.png``.

A file that fails to draw, or a ``figure_data`` file of no known figure,
makes the command exit non-zero.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np

__all__ = ["require_matplotlib", "plot_detection", "plot_confusion",
           "plot_coverage", "plot_sbc", "plot_runtime",
           "plot_classified_counts", "save_all", "plot_mcmc_comparison",
           "plot_misspec_study", "plot_simulator_checks",
           "plot_repeated_runs_grid", "plot_split_mode",
           "plot_psf_comparison", "plot_singletile_comparison",
           "FIGURE_DATA", "figure_data_path", "save_figure_data",
           "data_files", "draw", "main"]

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
    import (figures are never skipped silently): ``flag`` is the option
    that leaves the figures out (``--no-...``), or the option or command
    that asked for them."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        fix = (f"pass {flag}" if flag.startswith("--no-")
               else f"{flag} needs it")
        raise RuntimeError(
            f"figures need matplotlib, which does not import here ({e}); "
            f"{fix}: draw the figures on a machine with matplotlib from "
            "this run's result files (python -m smcdet_tpu_torch.figures "
            "<output-dir>)") from e


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


# ---------------------------------------------------------------- studies

MISSPEC_VARIANTS = ("control", "elliptical", "varying")
MISSPEC_COLORS = {"control": "#2a78d6", "elliptical": "#b58a2a",
                  "varying": "#eb6834"}
MISSPEC_LEVELS = (0.5, 0.8, 0.95)


def plot_misspec_study(out_path, report, level=0.95):
    """``misspec_study``'s figure from its report (``misspec_study.json``):
    the total-flux coverage per finished variant at each nominal level,
    and the coverage at ``level`` by band of region rows. Draws nothing
    and returns False below two finished variants, as the JAX script."""
    done = [k for k in MISSPEC_VARIANTS
            if isinstance(report["variants"].get(k), dict)]
    if len(done) < 2:
        return False
    row_cov = {k: report["variants"][k][f"coverage_{level}_by_region_row"]
               for k in done}
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    LEVELS = MISSPEC_LEVELS
    fig, axes = plt.subplots(1, 2, figsize=(11.2, 4.2))
    ax = axes[0]
    width = 0.8 / len(done)
    for i, name in enumerate(done):
        cov = report["variants"][name]["total_flux_coverage"]
        xs = np.arange(len(LEVELS)) + (i - (len(done) - 1) / 2) * width
        ax.bar(xs, [cov[str(lv)] for lv in LEVELS], width,
               color=MISSPEC_COLORS[name], label=name,
               edgecolor="white", linewidth=0.5)
    ax.plot(np.arange(len(LEVELS)), LEVELS, marker="_", markersize=26,
            linestyle="none", color="black", label="nominal")
    ax.set_xticks(np.arange(len(LEVELS)), [str(lv) for lv in LEVELS])
    ax.set_xlabel("nominal level")
    ax.set_ylabel("empirical total-flux coverage")
    ax.legend(frameon=False, fontsize=9)
    ax.spines[["top", "right"]].set_visible(False)

    ax = axes[1]
    for name, by_row in row_cov.items():
        xs = [0.5 * (b["rows"][0] + b["rows"][1]) for b in by_row]
        ys = [b["coverage"] for b in by_row]
        ax.plot(xs, ys, marker="o", color=MISSPEC_COLORS[name], label=name)
    ax.axhline(level, color="black", linestyle="dotted", linewidth=1)
    ax.set_xlabel("region tile row (fit patch at row < 0)")
    ax.set_ylabel(f"coverage at nominal {level}")
    ax.legend(frameon=False, fontsize=9)
    ax.spines[["top", "right"]].set_visible(False)
    fig.suptitle(
        "PSF-misspecification study (manuscript.tex:686-688 mechanism, "
        "offline)",
        fontsize=12,
    )
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return True


SYN_COLOR = "#2a78d6"
REAL_COLOR = "#eb6834"


def plot_simulator_checks(out_path, sq, rq, ks, ppflux, true_observed,
                          img_idx, T):
    """``simulator_checks``' figure: per quantile name (q10, median, q90,
    in that order) the histograms of the synthetic (``sq[name]``) and real
    (``rq[name]``) tiles' log-intensity quantile with its KS statistic
    ``ks[name]`` in the title, and the posterior-predictive total observed
    flux ``ppflux`` of image ``img_idx`` against ``true_observed``; ``T``
    tiles."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(sq)
    pp_quantile = float((ppflux < true_observed).mean())
    fig, axes = plt.subplots(1, 4, figsize=(16.4, 4.0))
    for ax, name in zip(axes[:3], names):
        s, r = sq[name], rq[name]
        lo = min(s.min(), r.min())
        hi = max(s.max(), r.max())
        bins = np.linspace(lo, hi, 31)
        ax.hist(s, bins=bins, density=True, alpha=0.55, color=SYN_COLOR,
                label="synthetic", edgecolor="white", linewidth=0.6)
        ax.hist(r, bins=bins, density=True, alpha=0.55, color=REAL_COLOR,
                label="M71", edgecolor="white", linewidth=0.6)
        ax.set_title(f"{name} (KS = {ks[name]:.3f})", fontsize=11)
        ax.set_xlabel("log pixel intensity (ADU)")
        ax.spines[["top", "right"]].set_visible(False)
    axes[0].set_ylabel("density")
    axes[0].legend(frameon=False, fontsize=9)

    ax = axes[3]
    ax.hist(ppflux, bins=40, density=True, color="#b58a2a", alpha=0.8,
            edgecolor="white", linewidth=0.6)
    ax.axvline(true_observed, color="black", linestyle="dotted",
               label="true observed flux")
    ax.set_title(
        f"posterior predictive, image {img_idx} "
        f"(truth at q = {pp_quantile:.2f})",
        fontsize=11,
    )
    ax.set_xlabel("total observed flux (ADU)")
    ax.legend(frameon=False, fontsize=9)
    ax.spines[["top", "right"]].set_visible(False)
    fig.suptitle(
        f"Prior-predictive simulator checks on {T} tiles "
        "(simulator_checks.ipynb cells 1-8, 10-22)",
        fontsize=12,
    )
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


REPEATED_COLORS = ["#2a78d6", "#eb6834", "#1baf7a"]


def plot_repeated_runs_grid(out_path, values, Ns, steps_list, strata, ylabel,
                            title):
    """``repeated_runs``' figure (the JAX script's ``plot_grid``): one
    panel per N, the median and middle 90% over the runs of ``values
    [n_N, n_steps, reps, C]`` at each of ``strata``, one colour per
    number of MH steps."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_cols = len(Ns)
    fig, axes = plt.subplots(
        1, n_cols, figsize=(3.9 * n_cols, 3.6), sharey=True
    )
    axes = np.atleast_1d(axes)
    offsets = np.linspace(-0.22, 0.22, len(steps_list))
    for a, (ax, N) in enumerate(zip(axes, Ns)):
        for b, steps in enumerate(steps_list):
            v = values[a, b][:, strata]  # [reps, len(strata)]
            med = np.median(v, axis=0)
            lo = np.quantile(v, 0.05, axis=0)
            hi = np.quantile(v, 0.95, axis=0)
            x = np.asarray(strata, dtype=float) + offsets[b]
            ax.errorbar(
                x, med, yerr=np.stack([med - lo, hi - med]),
                fmt="o", markersize=4.5, capsize=3, linewidth=1.6,
                color=REPEATED_COLORS[b % len(REPEATED_COLORS)],
                label=f"{steps} MH steps",
            )
        ax.set_title(f"N = {N}", fontsize=11)
        ax.set_xlabel("source count s")
        ax.set_xticks(list(strata))
        ax.spines[["top", "right"]].set_visible(False)
        ax.grid(True, axis="y", alpha=0.25, linewidth=0.6)
        ax.set_axisbelow(True)
    axes[0].set_ylabel(ylabel)
    axes[0].legend(frameon=False, fontsize=8, loc="best")
    fig.suptitle(title, fontsize=12)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def draw_repeated_runs(fig_dir, logpx, pmf, Ns, steps_list, s):
    """The two figures the JAX script draws for true count ``s`` from its
    grid (``logpx`` and ``pmf [n_N, n_steps, reps, C]``): returns their
    paths."""
    fig_dir = Path(fig_dir)
    fig_dir.mkdir(parents=True, exist_ok=True)
    reps, C = logpx.shape[-2:]
    strata = range(max(0, s - 1), min(C - 1, s + 3) + 1)
    paths = [fig_dir / f"repeatedruns_logpx_s{s}.png",
             fig_dir / f"repeatedruns_countprob_s{s}.png"]
    plot_repeated_runs_grid(
        paths[0], logpx, Ns, steps_list, strata,
        ylabel=r"$\log \hat p(x\,|\,s)$",
        title=f"Marginal-likelihood variability over {reps} runs "
              f"(true count {s}; bars: middle 90%)",
    )
    plot_repeated_runs_grid(
        paths[1], pmf, Ns, steps_list, strata,
        ylabel=r"$\hat p(s\,|\,x)$",
        title=f"Posterior count-probability variability over {reps} "
              f"runs (true count {s}; bars: middle 90%)",
    )
    return paths


SPLIT_COLORS = {"mh": "#6b6b66", "rj": "#2a78d6", "rj_splitmerge": "#eb6834"}
SPLIT_LABELS = {
    "mh": "saturated single-site MH",
    "rj": "RJ birth/death",
    "rj_splitmerge": "RJ birth/death + split/merge",
}


def plot_split_mode(out_path, pmfs, idx, true_flux, chains):
    """``split_mode_study``'s figure: each anchor's pooled pruned-count pmf
    (``pmfs``: anchor name to ``[K]``, in the study's order) on image
    ``idx`` with its one star of ``true_flux`` nmgy, ``chains`` chains
    each."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    K = len(next(iter(pmfs.values())))
    fig, ax = plt.subplots(figsize=(7.2, 4.2))
    width = 0.27
    ks = np.arange(K)
    for i, (name, pmf) in enumerate(pmfs.items()):
        ax.bar(ks + (i - 1) * width, pmf, width, color=SPLIT_COLORS[name],
               label=SPLIT_LABELS[name], edgecolor="white", linewidth=0.5)
    ax.axvline(1.0, color="black", linestyle="dotted", linewidth=1,
               label="true count")
    ax.set_xlabel("pruned star count")
    ax.set_ylabel("pooled posterior probability")
    ax.set_title(
        f"split-mode study: image {idx} ({true_flux:.0f} nmgy single star), "
        f"{chains} chains each",
        fontsize=11,
    )
    ax.legend(frameon=False, fontsize=9)
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_psf_comparison(out_path, gauss, survey, fitted, diff, gauss_fwhm,
                        tile, recon, resid, sigma, loc, idx):
    """``psf_comparison``'s figure: the four PSF stamps (the Gaussian of
    FWHM ``gauss_fwhm`` px, the survey's, the fitted model's, survey -
    fitted) and the isolated star's tile ``idx``, its noiseless
    reconstruction, the residual and the residual over the noise
    ``sigma``, the star marked at ``loc - 0.5``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 4, figsize=(15.2, 7.6))
    panels = [
        (gauss, f"Gaussian (FWHM {gauss_fwhm:.2f} px)"),
        (survey, "survey psField profile"),
        (fitted, "fitted model PSF"),
        (diff, "survey − fitted"),
    ]
    for ax, (img, title) in zip(axes[0], panels):
        im = ax.imshow(np.asarray(img, dtype=np.float64), cmap="gray")
        fig.colorbar(im, ax=ax, fraction=0.045)
        ax.set_title(title, fontsize=10)
        ax.set_xticks([])
        ax.set_yticks([])

    star_panels = [
        (tile, f"M71 tile {idx} (isolated star)"),
        (recon, "noiseless reconstruction"),
        (resid, "residual (ADU)"),
        (resid / sigma, "residual / noise σ"),
    ]
    for ax, (img, title) in zip(axes[1], star_panels):
        im = ax.imshow(np.asarray(img, dtype=np.float64), cmap="gray")
        fig.colorbar(im, ax=ax, fraction=0.045)
        ax.scatter([loc[1] - 0.5], [loc[0] - 0.5], marker="*", s=160,
                   c="#eb6834", edgecolors="black")
        ax.set_title(title, fontsize=10)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.suptitle(
        "PSF comparison (psf_comparison.ipynb cells 5-26): model vs survey "
        "vs empirical star",
        fontsize=12,
    )
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_singletile_comparison(out_path, mean_dc, mean_st, tvd):
    """``compare_singletile``'s figure: per image, the posterior mean count
    of the tree (``mean_dc``) against the single tile's (``mean_st``),
    and the histogram of the count-pmf TVDs ``tvd``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = tvd.shape[0]
    fig, axes = plt.subplots(1, 2, figsize=(9.2, 4.0))
    ax = axes[0]
    lim = max(mean_dc.max(), mean_st.max()) * 1.05 + 0.1
    ax.plot([0, lim], [0, lim], color=NEUTRAL, linewidth=1, linestyle="--")
    ax.scatter(mean_st, mean_dc, s=16, alpha=0.6, color=SMC_COLOR,
               linewidths=0)
    ax.set_xlabel("single-tile posterior mean count")
    ax.set_ylabel("divide-and-conquer posterior mean count")
    ax.set_title("Posterior mean detectable count", fontsize=11)
    ax.spines[["top", "right"]].set_visible(False)

    ax = axes[1]
    ax.hist(tvd, bins=np.linspace(0, max(0.3, tvd.max()), 25),
            color=SMC_COLOR, edgecolor="white", linewidth=0.8)
    ax.set_xlabel("TV distance between count pmfs")
    ax.set_ylabel("images")
    ax.set_title("D&C vs single-tile count pmf", fontsize=11)
    ax.spines[["top", "right"]].set_visible(False)
    fig.suptitle(
        f"Divide-and-conquer aggregation vs whole-image CS-SMC "
        f"({n} images)",
        fontsize=12,
    )
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


# ------------------------------------------------- figure data and drawing

FIGURE_DATA = "figure_data"
SIMULATOR_QUANTILES = ("q10", "median", "q90")
SPLIT_ANCHORS = ("mh", "rj", "rj_splitmerge")
MCMC_STATS = ("mean_mc", "mean_smc", "mean_rj", "mixed", "tvd", "rj_tvd")
REPEATED_RE = re.compile(r"repeatedruns_s(\d+)\.npz")


def figure_data_path(out_dir, name):
    """Where a study writing into ``out_dir`` keeps figure ``name``'s
    arrays."""
    return Path(out_dir) / FIGURE_DATA / f"{name}.npz"


def save_figure_data(out_dir, name, **arrays):
    """Write figure ``name``'s arrays (``np.savez``); returns the path."""
    path = figure_data_path(out_dir, name)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    return path


def _draw_simulator_checks(d, out):
    from smcdet_tpu_torch.studies.simulator_checks import ks_statistic

    sq = {q: d[f"sq_{q}"] for q in SIMULATOR_QUANTILES}
    rq = {q: d[f"rq_{q}"] for q in SIMULATOR_QUANTILES}
    ks = {q: round(ks_statistic(sq[q], rq[q]), 4) for q in sq}
    plot_simulator_checks(out, sq, rq, ks, d["ppflux"],
                          float(d["true_observed"]), int(d["img_idx"]),
                          int(d["T"]))


def _draw_split_mode(d, out):
    plot_split_mode(out, {a: d[f"pmf_{a}"] for a in SPLIT_ANCHORS},
                    int(d["image_index"]), float(d["true_flux"]),
                    int(d["chains"]))


def _draw_psf_comparison(d, out):
    plot_psf_comparison(out, d["gauss"], d["survey"], d["fitted"], d["diff"],
                        float(d["gaussian_fwhm_px"]), d["tile"], d["recon"],
                        d["resid"], d["sigma"], d["loc"], int(d["idx"]))


def _draw_singletile(d, out):
    plot_singletile_comparison(out, d["mean_dc"], d["mean_st"], d["tvd"])


def _draw_mcmc(d, out):
    plot_mcmc_comparison(out, {k: d[k] for k in MCMC_STATS},
                         int(d["num_samples"]))


_DRAWERS = {
    "simulator_checks": _draw_simulator_checks,
    "split_mode_study": _draw_split_mode,
    "psf_comparison": _draw_psf_comparison,
    "singletile_comparison": _draw_singletile,
    "mcmc_comparison": _draw_mcmc,
}


def data_files(root):
    """Every figure-data file under ``root`` (see the module's
    docstring), sorted."""
    root = Path(root)
    found = set(root.rglob(f"{FIGURE_DATA}/*.npz"))
    found |= set(root.rglob("misspec_study.json"))
    found |= {p for p in root.rglob("repeatedruns_s*.npz")
              if REPEATED_RE.fullmatch(p.name)}
    return sorted(found)


def draw(path):
    """Draw the figure(s) of one data file into ``figures/`` beside the
    study's JSON; returns the PNGs written (none for a misspec report
    with fewer than two finished variants). Raises ``ValueError`` for a
    file of no known figure."""
    path = Path(path)
    if path.name == "misspec_study.json":
        from smcdet_tpu_torch.studies.misspec_study import LEVEL

        out = path.parent / "figures" / "misspec_study.png"
        out.parent.mkdir(parents=True, exist_ok=True)
        report = json.loads(path.read_text())
        return [out] if plot_misspec_study(out, report, LEVEL) else []
    m = REPEATED_RE.fullmatch(path.name)
    if m:
        with np.load(path) as d:
            return draw_repeated_runs(
                path.parent / "figures", d["logpx"], d["count_pmf"],
                d["num_catalogs"], d["mh_steps"], int(m.group(1)))
    if path.parent.name != FIGURE_DATA or path.stem not in _DRAWERS:
        raise ValueError(f"{path}: no figure of that name (known: "
                         f"{sorted(_DRAWERS)}, misspec_study.json, "
                         "repeatedruns_s<count>.npz)")
    out = path.parent.parent / "figures" / f"{path.stem}.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    with np.load(path) as d:
        _DRAWERS[path.stem](d, out)
    return [out]


def main(argv=None):
    """Draw every figure whose data lies under the output directory,
    printing each PNG written; exit non-zero if a file fails to draw or
    none is found. Returns the PNGs."""
    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.figures",
        description="Draw the studies' figures from the data files their "
                    "runs wrote under an output directory.")
    parser.add_argument("output_dir")
    args = parser.parse_args(argv)
    require_matplotlib("python -m smcdet_tpu_torch.figures")
    if not Path(args.output_dir).is_dir():
        raise SystemExit(f"{args.output_dir}: no such directory")
    files = data_files(args.output_dir)
    if not files:
        raise SystemExit(f"no figure data under {args.output_dir}")
    written, failed = [], {}
    for path in files:
        try:
            pngs = draw(path)
        except Exception as e:  # noqa: BLE001  (reported, exit non-zero)
            failed[str(path)] = f"{type(e).__name__}: {e}"
            print(f"FAILED {path}: {failed[str(path)]}", file=sys.stderr)
            continue
        if not pngs:
            print(f"{path}: fewer than two finished variants, no figure "
                  "(as the JAX script)")
        for png in pngs:
            print(png)
        written += pngs
    if failed:
        raise SystemExit(f"{len(failed)} figure-data file(s) failed to "
                         f"draw: {sorted(failed)}")
    return written


if __name__ == "__main__":
    main()
