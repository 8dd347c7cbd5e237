"""The port's studies (``smcdet_tpu_torch/studies``) and the synthetic suites'
runner (``tests/torch_synthetic_suites.py``) against the JAX scripts on the
CPU: compare_kernels' report against ``experiments/basic/compare_kernels.py``'s
formulas, compare_singletile against the JAX script run on the same
results directories, compare_pooled's report and dump (read by the numpy
scripts ``attribute_pooled.py`` and ``truth_score_pooled.py``), and the
runner's bands and intervals on the committed analyses and perturbed
copies of them."""

import copy
import hashlib
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_synthetic_suites as suites
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu_torch.studies import (
    compare_kernels,
    compare_pooled,
    compare_singletile,
)

REPO = Path(__file__).resolve().parents[1]
DNC = REPO / "experiments" / "divideandconquer"
RESULTS = REPO / "docs" / "results"
# the keys of compare_pooled.py's report with two reps or more
# (experiments/divideandconquer/compare_pooled.py:192-216)
POOLED_KEYS = ["images", "reps", "tvd_single_run", "tvd_pooled",
               "mean_count_abs_diff_pooled", "bridge_effort",
               "tvd_singletile_self_halves", "tvd_dc_self_halves",
               "tvd_cross_floor_quadrature"]
STATS_KEYS = ["mean", "median", "p90"]
# the committed analyses the runner holds, with their suite's tiles
ANALYSES = [("basic", "smc"), ("divideandconquer", "smc"),
            ("m71synthetic", "smc"), ("m71synthetic", "mcmc")]


def _load_jax_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _particles(seed, images=7, particles=40, K=8):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 1, size=(images, particles))
    weights = rng.random((images, particles))
    weights /= weights.sum(-1, keepdims=True)
    return counts, weights


def _jax_kernel_entry(res, wall, K):
    """``experiments/basic/compare_kernels.py:98-118``, on numpy results."""
    n = res["pruned_counts"].shape[0]
    pc = np.asarray(res["pruned_counts"])
    w = np.asarray(res["weights"])
    pmf = np.zeros((n, K))
    for c in range(K):
        pmf[:, c] = ((pc == c) * w).sum(-1)
    pmf = pmf / np.maximum(pmf.sum(-1, keepdims=True), 1e-12)
    return {
        "wall_s": round(wall, 2),
        "smc_iterations": int(res["num_iters"]),
        "acceptance_rate_mean": round(
            float(np.asarray(res["acc_rate"]).mean()), 4),
        "mean_total_flux": round(
            float((np.asarray(res["pruned_fluxes"]).sum(-1) * w).sum(-1)
                  .mean()), 2),
    }, pmf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_report_matches_the_jax_formulas(seed):
    """compare_kernels' per-kernel entries, pmfs (exact to 1e-12) and TVD
    summary equal the JAX script's on the same pruned counts and weights."""
    K = 10  # basic: max_objects + 2
    results, pmfs, ref_results, ref_pmfs = {}, {}, {}, {}
    rng = np.random.default_rng(100 + seed)
    for i, name in enumerate(("mh", "mala")):
        counts, weights = _particles(seed * 2 + i, K=K - 1)
        res = {"pruned_counts": counts, "weights": weights,
               "pruned_fluxes": rng.random(counts.shape + (8,)) * 500,
               "acc_rate": rng.random(counts.shape[0]),
               "num_iters": 30 + i}
        results[name], pmfs[name] = compare_kernels.kernel_summary(
            res, 1.234 + i, K)
        ref_results[name], ref_pmfs[name] = _jax_kernel_entry(
            res, 1.234 + i, K)
        np.testing.assert_allclose(pmfs[name], ref_pmfs[name], rtol=0,
                                   atol=1e-12)
    report = compare_kernels.kernel_report(7, 512, results, pmfs)
    tvd = 0.5 * np.abs(ref_pmfs["mh"] - ref_pmfs["mala"]).sum(-1)
    assert report == {
        "images": 7, "num_catalogs": 512, "kernels": ref_results,
        "count_pmf_tvd": {
            "mean": round(float(tvd.mean()), 4),
            "median": round(float(np.median(tvd)), 4),
            "p90": round(float(np.quantile(tvd, 0.9)), 4)}}
    assert list(report) == list(json.loads(
        (RESULTS / "basic" / "kernel_comparison.json").read_text()))


def test_compare_kernels_cli_runs_both_kernels(tmp_path, monkeypatch):
    """``python -m smcdet_tpu_torch.studies.compare_kernels --device cpu``
    on 4 basic tiles (N = 16, 3 sweeps, ``--seed 3``): both kernels bring
    every tile to the end, the report has the committed report's keys and
    lands in ``output/basic/kernel_comparison.json``, and ``--dump`` keeps
    the count pmfs the TVD was taken from."""
    staged = tmp_path / "output" / "basic" / "tiles.npz"
    staged.parent.mkdir(parents=True)
    shutil.copy(REPO / "tests" / "data" / "basic_tiles.npz", staged)
    monkeypatch.chdir(tmp_path)
    report = compare_kernels.main(["--num-images", "4", "--num-catalogs",
                                   "16", "--sweeps", "3", "--seed", "3",
                                   "--dump", "pmfs.npz", "--device",
                                   "cpu"])
    committed = json.loads(
        (RESULTS / "basic" / "kernel_comparison.json").read_text())
    assert list(report) == list(committed)
    assert list(report["kernels"]) == ["mh", "mala"]
    for entry in report["kernels"].values():
        assert list(entry) == list(committed["kernels"]["mh"])
        assert 0 < entry["acceptance_rate_mean"] < 1
        assert entry["smc_iterations"] > 0
    assert 0 <= report["count_pmf_tvd"]["mean"] <= 1
    assert json.loads((staged.parent / "kernel_comparison.json")
                      .read_text()) == report
    with np.load(tmp_path / "pmfs.npz") as d:
        assert d["seeds"].tolist() == [3]
        for name in ("mh", "mala"):
            assert d[name].shape == (1, 4, 10)
            np.testing.assert_allclose(d[name].sum(-1), 1.0, atol=1e-9)
        tvd = 0.5 * np.abs(d["mh"][0] - d["mala"][0]).sum(-1)
    assert report["count_pmf_tvd"]["mean"] == round(float(tvd.mean()), 4)


def _write_batches(out_dir, seed, sizes, K):
    out_dir.mkdir(parents=True)
    lo = 0
    for b, n in enumerate(sizes):
        counts, weights = _particles(seed + b, images=n, K=K)
        np.savez_compressed(out_dir / f"smc_batch{b:04d}.npz",
                            pruned_counts=counts.astype(np.int32),
                            weights=weights.astype(np.float32),
                            image_index=np.arange(lo, lo + n),
                            runtime=np.asarray(1.5))
        lo += n


@pytest.mark.parametrize("seed", [0, 1])
def test_compare_singletile_matches_the_jax_script(tmp_path, monkeypatch,
                                                   seed):
    """On two results directories of batch files (the single-tile run one
    image longer), the port's report equals the one
    ``experiments/divideandconquer/compare_singletile.py`` writes."""
    _write_batches(tmp_path / "output" / "divideandconquer", 10 * seed,
                   (4, 3), 9)
    _write_batches(tmp_path / "output" / "divideandconquer_singletile",
                   10 * seed + 5, (5, 3), 11)
    monkeypatch.chdir(tmp_path)
    # experiments/common.py skips its compilation cache when this is empty
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    jax_script = _load_jax_script(DNC / "compare_singletile.py",
                                  "jax_compare_singletile")
    jax_script.main()
    out = tmp_path / "output" / "divideandconquer" / (
        "singletile_comparison.json")
    expected = json.loads(out.read_text())
    out.unlink()
    report = compare_singletile.main([])
    assert report == expected
    assert json.loads(out.read_text()) == expected
    assert report["images"] == 7
    # the port's pmf helper is the JAX script's
    counts, weights = _particles(seed, K=9)
    np.testing.assert_array_equal(
        compare_singletile.weighted_pmf(counts, weights, 11),
        jax_script.weighted_pmf(counts, weights, 11))


def _independent_pooled(st, dc):
    """compare_pooled.py's statistics written out once more, per image."""
    R = st.shape[0]
    st_pool, dc_pool = st.mean(0), dc.mean(0)
    ks = np.arange(st.shape[-1])
    out = {
        "tvd_single_run": 0.5 * np.abs(dc[0] - st[0]).sum(-1),
        "tvd_pooled": 0.5 * np.abs(dc_pool - st_pool).sum(-1),
        "mean_diff": np.abs((dc_pool * ks).sum(-1)
                            - (st_pool * ks).sum(-1)).mean(),
    }
    if R >= 2:
        halves = [0.5 * np.abs(p[: R // 2].mean(0) - p[R // 2:].mean(0))
                  .sum(-1) for p in (st, dc)]
        out.update(tvd_singletile_self_halves=halves[0],
                   tvd_dc_self_halves=halves[1],
                   tvd_cross_floor_quadrature=0.5 * np.sqrt(
                       halves[0] ** 2 + halves[1] ** 2))
    return out


@pytest.mark.parametrize("reps", [1, 2, 3, 8])
def test_pooled_report_statistics(reps):
    """``pooled_report`` on random pmfs: the JAX script's keys (the floors
    only from two reps on), each statistic the formula's."""
    rng = np.random.default_rng(reps)
    st, dc = (rng.dirichlet(np.ones(33), size=(reps, 6)) for _ in range(2))
    effort = {"max_smc_iters": 150, "relocate_sweeps": 8, "pair_sweeps": 0}
    report = compare_pooled.pooled_report(st, dc, effort)
    keys = POOLED_KEYS if reps >= 2 else POOLED_KEYS[:6]
    assert list(report) == keys
    assert report["bridge_effort"] == effort
    ref = _independent_pooled(st, dc)
    assert report["mean_count_abs_diff_pooled"] == round(
        float(ref.pop("mean_diff")), 4)
    assert sorted(ref) == sorted(k for k in report if k.startswith("tvd"))
    for key, tvd in ref.items():
        assert report[key] == {
                "mean": round(float(tvd.mean()), 4),
                "median": round(float(np.median(tvd)), 4),
                "p90": round(float(np.quantile(tvd, 0.9)), 4)}, key


@pytest.fixture(scope="module")
def pooled_run(tmp_path_factory, one_torch_thread):  # noqa: F811
    """compare_pooled on the plain path: 2 divideandconquer images x 2
    reps, the tile stage at N = 16 (the single-tile run at 64), 2 sweeps,
    with the dump, in a directory of its own."""
    root = tmp_path_factory.mktemp("pooled")
    staged = root / "output" / "divideandconquer" / "tiles.npz"
    staged.parent.mkdir(parents=True)
    shutil.copy(REPO / "tests" / "data" / "divideandconquer_tiles.npz",
                staged)
    report = compare_pooled.main([
        "--num-images", "2", "--reps", "2", "--num-catalogs", "16",
        "--sweeps", "2", "--dump", "--suffix", "_dump", "--output-dir",
        str(root / "output"), "--device", "cpu"])
    return root, report


def test_compare_pooled_report(pooled_run):
    """The report has the JAX script's keys, its bridge effort is the
    config's, and every TVD lies in [0, 1]."""
    root, report = pooled_run
    assert list(report) == POOLED_KEYS
    assert report["images"] == 2 and report["reps"] == 2
    assert report["bridge_effort"] == {"max_smc_iters": 150,
                                       "relocate_sweeps": 8,
                                       "pair_sweeps": 0}
    for key in POOLED_KEYS[2:]:
        if key.startswith("tvd"):
            assert list(report[key]) == STATS_KEYS
            assert all(0.0 <= v <= 1.0 for v in report[key].values()), key
    assert json.loads((root / "output" / "divideandconquer" /
                       "pooled_comparison_dump.json").read_text()) == report


def test_compare_pooled_dump(pooled_run):
    """The dump holds the arrays the numpy scripts read: ``st_pmfs`` and
    ``dc_pmfs [R, I, K]`` (K = 4 max_objects + 1 = 33, every pmf summing
    to 1) and ``true_counts [I]`` (the tiles')."""
    root, _ = pooled_run
    out = root / "output" / "divideandconquer"
    with np.load(out / "pooled_pmfs_dump.npz") as d:
        assert sorted(d.files) == ["dc_pmfs", "st_pmfs", "true_counts"]
        for key in ("st_pmfs", "dc_pmfs"):
            assert d[key].shape == (2, 2, 33)
            np.testing.assert_allclose(d[key].sum(-1), 1.0, atol=1e-9)
        np.testing.assert_array_equal(
            d["true_counts"], np.load(out / "tiles.npz")["true_counts"][:2])


@pytest.mark.parametrize("script,output", [
    ("attribute_pooled.py", "pooled_attribution_dump.json"),
    ("truth_score_pooled.py", "truth_score_dump.json")])
def test_numpy_scripts_read_the_dump(pooled_run, script, output):
    """The JAX repository's numpy-only scripts run on the port's dump from
    the directory that holds ``output/divideandconquer`` and exit 0."""
    root, _ = pooled_run
    proc = subprocess.run([sys.executable, str(DNC / script)], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads((root / "output" / "divideandconquer" / output)
                        .read_text())
    assert report["images"] == 2 and report["reps"] == 2


@pytest.mark.parametrize("name", list(suites.SUITES))
def test_committed_tiles_are_the_committed_draw(name):
    """Each committed tiles file's true-count histogram equals its
    committed analysis's confusion-matrix row sums (the analyses scored
    these tiles), at the suite's image count."""
    ref = json.loads((RESULTS / name / "smc_analysis.json").read_text())
    path = REPO / "tests" / "data" / f"{name}_tiles.npz"
    record = suites.tiles_record(path, ref)
    assert record["images"] == suites.SUITES[name][0] == ref["images"]
    assert record["committed_truth_histogram_matches"]
    assert record["sha256"] == hashlib.sha256(path.read_bytes()).hexdigest()


def _analysis(name, method):
    return json.loads((RESULTS / name / f"{method}_analysis.json")
                      .read_text())


@pytest.mark.parametrize("name,method", ANALYSES)
def test_scoring_holds_the_committed_analysis(name, method):
    row, ok = suites.score_analysis(_analysis(name, method),
                                    _analysis(name, method),
                                    hold_f1=method == "smc")
    assert ok and row["ok"]
    assert row["count_accuracy"]["verdict"] == "held"
    assert row["coverage95"]["verdict"] == "held"
    if "sep_baseline" in row:
        assert all(row["sep_baseline"]["f1_inside_committed_ci"])


@pytest.mark.parametrize("name,method", ANALYSES)
@pytest.mark.parametrize("key,shift,held", [
    ("count_accuracy", 0.049, True), ("count_accuracy", 0.051, False),
    ("count_accuracy", -0.06, False), ("coverage95", -0.049, True),
    ("coverage95", 0.051, False)])
def test_scoring_bands(name, method, key, shift, held):
    ref = _analysis(name, method)
    got = copy.deepcopy(ref)
    if key == "coverage95":
        got["total_flux_coverage"]["0.95"] += shift
    else:
        got[key] += shift
    row, ok = suites.score_analysis(got, ref, hold_f1=method == "smc")
    assert ok is held
    assert row[key]["verdict"] == ("held" if held else "missed")


@pytest.mark.parametrize("name,method,block", [
    (name, method, block) for name, method in ANALYSES
    for block in ("detection", "sep_baseline")
    if block in _analysis(name, method)])
def test_scoring_f1_intervals(name, method, block):
    """A bin's F1 just above the committed interval fails the SMC
    detection and the extractor, not the MCMC chain's detection (printed,
    not held)."""
    ref = _analysis(name, method)
    got = copy.deepcopy(ref)
    got[block]["f1_by_bin"]["point"][-1] = (
        ref[block]["f1_by_bin"]["ci95_hi"][-1] + 1e-4)
    row, ok = suites.score_analysis(got, ref, hold_f1=method == "smc")
    held = block == "detection" and method == "mcmc"
    assert ok is held
    if not held:
        assert row[block]["f1_inside_committed_ci"][-1] is False


@pytest.mark.parametrize("name,method", [
    a for a in ANALYSES if "sep_baseline" in _analysis(*a)])
def test_scoring_needs_the_extractor(name, method):
    """A held suite whose committed analysis scores the extractor fails
    when the port's analysis has no ``sep_baseline`` (no extractor ran)."""
    ref = _analysis(name, method)
    got = copy.deepcopy(ref)
    del got["sep_baseline"]
    row, ok = suites.score_analysis(got, ref, hold_f1=method == "smc")
    assert not ok and row["sep_baseline"] == "not in the port's analysis"


@pytest.mark.parametrize("port,verdict", [
    (0.70, "held"), (0.7499, "held"), (0.6501, "held"), (0.76, "missed"),
    (0.78, "missed"), (0.62, "missed"), (0.64, "missed")])
def test_hold_verdicts(port, verdict):
    """A figure of the committed 0.70 is held within the band of 0.05 and
    missed outside it; the row carries nothing else."""
    row = suites.hold(port, 0.70, 0.05)
    assert row == {"port": port, "committed": 0.70, "band": 0.05,
                   "verdict": verdict}


def test_a_missed_band_fails_the_suite():
    """A count accuracy 0.08 above the committed one fails the suite, and
    the coverage beside it is still held."""
    ref = _analysis("basic", "smc")
    got = copy.deepcopy(ref)
    got["count_accuracy"] += 0.08
    row, ok = suites.score_analysis(got, ref)
    assert not ok and not row["ok"]
    assert row["count_accuracy"]["verdict"] == "missed"
    assert row["coverage95"]["verdict"] == "held"


@pytest.mark.parametrize("study,path,key,shift,held", [
    ("singletile", "divideandconquer/singletile_comparison.json",
     ("count_pmf_tvd", "mean"), 0.099, True),
    ("singletile", "divideandconquer/singletile_comparison.json",
     ("count_pmf_tvd", "mean"), -0.101, False),
    ("singletile", "divideandconquer/singletile_comparison.json",
     ("mean_count", "mean_abs_diff"), 0.151, False),
    ("pooled", "divideandconquer/pooled_comparison.json",
     ("tvd_pooled", "mean"), 0.099, True),
    ("pooled", "divideandconquer/pooled_comparison.json",
     ("tvd_pooled", "mean"), 0.101, False),
    ("kernels", "basic/kernel_comparison.json",
     ("kernels", "mh", "acceptance_rate_mean"), 0.031, False),
    ("kernels", "basic/kernel_comparison.json",
     ("kernels", "mala", "acceptance_rate_mean"), -0.029, True),
    ("kernels", "basic/kernel_comparison.json",
     ("count_pmf_tvd", "mean"), 0.051, False),
    ("kernels", "basic/kernel_comparison.json",
     ("kernels", "mh", "smc_iterations"), 40, True),
])
def test_study_bands(study, path, key, shift, held):
    """Each study's held figures on its committed JSON and a perturbed
    copy (the iterations and walls are printed, not held)."""
    score = getattr(suites, f"score_{study}")
    ref = json.loads((RESULTS / path).read_text())
    assert score(ref)[1]
    got = copy.deepcopy(ref)
    node = got
    for k in key[:-1]:
        node = node[k]
    node[key[-1]] += shift
    assert score(got)[1] is held


@pytest.mark.parametrize("key,value", [
    ("kernels_mh_acceptance", 0.40), ("kernels_mala_acceptance", 0.81),
    ("kernels_tvd_mean", 0.0393), ("kernels_tvd_mean", 0.1441)])
def test_study_miss_fails(key, value):
    """A compare_kernels figure outside its band is missed and fails the
    study, whatever the other figures read."""
    got = json.loads((RESULTS / "basic" / "kernel_comparison.json")
                     .read_text())
    k = got["kernels"]
    node, leaf = {"kernels_mh_acceptance": (k["mh"], "acceptance_rate_mean"),
                  "kernels_mala_acceptance": (k["mala"],
                                              "acceptance_rate_mean"),
                  "kernels_tvd_mean": (got["count_pmf_tvd"], "mean")}[key]
    node[leaf] = value
    row, ok = suites.score_kernels(got)
    assert not ok and not row["ok"]
    assert row[key]["verdict"] == "missed"
    assert [row[other]["verdict"] for other in row
            if other.startswith("kernels_") and other != key] == [
        "held", "held"]


def test_compare_kernels_makes_both_kernels_from_the_config():
    """compare_kernels' two kernels: MH at the suite's proposal scales,
    MALA at the given steps, both with the suite's flux box and sweeps."""
    from smcdet_tpu_torch.config import load_config

    k = load_config(REPO / "experiments" / "basic" / "config.yaml").kernel
    kernels = compare_kernels.build_kernels(k, 0.05, 20.0, "cpu")
    mh, mala = kernels["mh"], kernels["mala"]
    assert mh.num_iters == mala.num_iters == k.num_iters
    assert float(mh.locs_stdev) == pytest.approx(k.locs_stdev)
    assert float(mh.fluxes_stdev) == pytest.approx(k.fluxes_stdev)
    assert float(mala.locs_step) == pytest.approx(0.05)
    assert float(mala.fluxes_step) == pytest.approx(20.0)
    for kernel in (mh, mala):
        assert float(kernel.fluxes_min) == pytest.approx(k.fluxes_min)
        assert float(kernel.fluxes_max) == pytest.approx(k.fluxes_max)
        assert kernel.fluxes_min.device == torch.device("cpu")
    assert compare_kernels.build_kernels(k, 0.05, 20.0, "cpu",
                                         sweeps=3)["mala"].num_iters == 3
