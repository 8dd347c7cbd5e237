"""The port's M71 studies (``smcdet_tpu_torch/studies``) against the JAX
scripts on the CPU, on the same numpy arrays (made from a seed or taken
from the committed fixtures), and the card runner's bands
(``tests/torch_m71_studies.py``) on the committed analyses.

Tolerances: integer and geometry results exactly; float figures to 1e-6
(the JSON figures are rounded to 4 decimals by both sides); the
repeated-runs grid, a stochastic run, as stated at its test."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_m71_studies as runner
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu_torch.studies import (
    compare_nogiants,
    crowded_budget_probe,
    m71_fixture,
    misspec_study,
    repeated_runs,
    run_smc_oracle,
    simulator_checks,
    split_mode_study,
)

REPO = Path(__file__).resolve().parents[1]
M71 = REPO / "experiments" / "m71"
M71SYN = REPO / "experiments" / "m71synthetic"
RESULTS = REPO / "docs" / "results"
FLOAT_TOL = 1e-6


def _load_jax_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def make_fixture():
    sys.path.insert(0, str(M71))
    try:
        yield _load_jax_script(M71 / "make_fixture.py", "make_fixture")
    finally:
        sys.path.remove(str(M71))


def _assert_same(got, want, path="report"):
    """Nested JSON-like values equal: numbers to ``FLOAT_TOL``, the rest
    exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert got is not None and abs(got - want) <= FLOAT_TOL, (
            path, got, want)
    else:
        assert got == want, (path, got, want)


def _fake_run(out_dir, n, seed, M=10, P=64):
    """A results directory of ``n`` tiles: weighted posterior particles of
    pruned counts and fluxes (either package's batch-file keys)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, size=(n, P)).astype(np.int32)
    fluxes = rng.gamma(1.0, 300.0, size=(n, P, M)) * (
        np.arange(M) < counts[..., None])
    weights = rng.random((n, P))
    weights /= weights.sum(-1, keepdims=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "smc_batch0000.npz", counts=counts,
             pruned_counts=counts, pruned_fluxes=fluxes.astype(np.float32),
             weights=weights.astype(np.float32), runtime=np.asarray(1.0),
             image_index=np.arange(n))
    return out_dir


# --------------------------------------------------------------- fixture


def test_fixture_constants_equal_make_fixtures(make_fixture):
    for name in ("FLUX_UPPER", "PSF_RADIUS", "REGION_X0", "REGION_Y0",
                 "REGION_H", "REGION_W", "MU_PER_PX", "FLUX_ALPHA",
                 "FLUX_LOWER"):
        assert getattr(m71_fixture, name) == getattr(make_fixture, name), (
            name)
    jax_nogiants = _load_jax_script(M71 / "compare_nogiants.py",
                                    "jax_compare_nogiants_constants")
    assert (m71_fixture.TILE, m71_fixture.TW) == (jax_nogiants.TILE,
                                                  jax_nogiants.TW)


def test_default_truth_stars_put_the_giants_back():
    """The rebuilt star list: the no-giants fixture's stars and the four
    giants above the Pareto support, which reproduce the committed
    geometry exactly."""
    with np.load(M71 / "data_nogiants" / "m71" / "truth_stars.npz") as ts:
        n_nogiants = ts["rows"].size
    stars = m71_fixture.default_truth_stars()
    assert stars["rows"].size == n_nogiants + m71_fixture.NUM_GIANTS
    giants = stars["fluxes"] > m71_fixture.FLUX_UPPER
    assert int(giants.sum()) == m71_fixture.NUM_GIANTS
    # the giants sit right after the region's stars, as make_fixture.py
    # concatenates them (log-uniform on [2600, 20000] nmgy)
    first = int(np.flatnonzero(giants)[0])
    assert np.flatnonzero(giants).tolist() == list(range(first, first + 4))
    assert ((stars["fluxes"][giants] >= 2600)
            & (stars["fluxes"][giants] <= 20000)).all()
    with np.load(M71 / "data" / "m71" / "tiles.npz") as t:
        geo = compare_nogiants.geometry(stars, t["tile_index"])
    committed = json.loads((RESULTS / "m71" / "nogiants_comparison.json")
                           .read_text())
    assert geo == committed["geometry"]


def test_default_truth_stars_refuse_another_seed():
    with pytest.raises(ValueError, match="region's stars"):
        m71_fixture.default_truth_stars(seed=6839)


# --------------------------------------------------------------- crowded


def test_crowded_selection_equals_the_committed_subsets():
    assert crowded_budget_probe.subsets_match() == {
        "tiles_crowded.npz": True, "tiles_crowded_exact.npz": True}
    with np.load(crowded_budget_probe.DATA / "tiles_crowded.npz") as t:
        assert t["images"].shape[0] == 156


@pytest.fixture(scope="module")
def jax_crowded():
    return _load_jax_script(M71 / "crowded_budget_probe.py",
                            "jax_crowded_budget_probe")


@pytest.mark.parametrize("weighted", [True, False])
def test_crowded_score_matches_jax(jax_crowded, weighted):
    rng = np.random.default_rng(3)
    est = rng.gamma(2.0, 100.0, size=(40, 50))
    w = rng.random((40, 50)) if weighted else None
    truth = rng.gamma(2.0, 100.0, size=40)
    _assert_same(crowded_budget_probe.score(est, w, truth),
                 jax_crowded._score(est, w, truth))


def test_crowded_compare_matches_jax_load_and_score(jax_crowded, tmp_path):
    """A whole-fixture base run is restricted to the crowded tiles, a
    subset arm taken as it is; each arm scored as the JAX script scores
    it; an arm without batches is "not run"."""
    with np.load(crowded_budget_probe.DATA / "tiles_exact.npz") as exact:
        keep = crowded_budget_probe.crowded_mask(exact["true_counts"])
        truth = exact["true_fluxes"][keep].sum(-1)
    _fake_run(tmp_path / "m71_seed2", keep.size, 0)
    _fake_run(tmp_path / "m71_seed2_crowded_hiN", int(keep.sum()), 1)
    report = crowded_budget_probe.compare(tmp_path)
    assert report["tiles"] == 156
    assert report["arms"]["hiS_n2048_s200"] == "not run"
    for arm, name, restrict in (("base_n2048_s100", "m71_seed2", True),
                                ("hiN_n8192_s100", "m71_seed2_crowded_hiN",
                                 False)):
        f, _, w = jax_crowded._load_run(tmp_path / name)
        if restrict:
            f, w = f[keep], w[keep]
        _assert_same(report["arms"][arm],
                     jax_crowded._score(f.sum(-1), w, truth))
    cut = crowded_budget_probe.compare(tmp_path, num_tiles=10)
    assert cut["tiles"] == 10 and cut["arms"]["base_n2048_s100"] == (
        "not run")  # the cut reads the crowded-subset base run


# ---------------------------------------------------------------- oracle


def test_oracle_config_is_the_jax_scripts():
    from smcdet_tpu.config import load_config

    from smcdet_tpu_torch.config import _to_dict, build_image_model, \
        build_prior
    from smcdet_tpu_torch.ops import mh_sweep

    want = load_config(M71 / "config.yaml", apply_params=False)
    want.name = "m71oracle"
    got = run_smc_oracle.oracle_config()
    for part in ("prior", "image_model", "kernel", "sampler"):
        g, w = _to_dict(getattr(got, part)), vars(getattr(want, part))
        for k, v in g.items():
            if k in w:
                _assert_same(list(v) if isinstance(v, tuple) else v,
                             list(w[k]) if isinstance(w[k], tuple) else w[k],
                             f"{part}.{k}")
    assert got.name == want.name and Path(got.data_path) == M71 / (
        want.data_path)
    # the literal beta = 3 wing: K1 on the card, not K2's general wing
    prior = build_prior(got.prior, "cpu")
    model = build_image_model(got.image_model, "cpu")
    assert mh_sweep.sweep_kernel(prior, model, prior.max_objects) == "K1"


# -------------------------------------------------------------- nogiants


def test_nogiants_report_matches_the_jax_script(tmp_path, monkeypatch):
    """``compare_nogiants.py`` and the port on the same two runs (the first
    40 m71 and 50 no-giants fixture tiles, seeded particles), the giants
    from the rebuilt star list."""
    base, ablat = tmp_path / "base", tmp_path / "ablat"
    tiles = {}
    for d, src, n, seed in ((base, "data", 40, 0),
                            (ablat, "data_nogiants", 50, 1)):
        _fake_run(d, n, seed)
        with np.load(M71 / src / "m71" / "tiles.npz") as t:
            tiles[d] = {k: t[k][:n] for k in t.files}
        np.savez(d / "tiles.npz", **tiles[d])
    stars = m71_fixture.default_truth_stars()
    np.savez(tmp_path / "truth_stars.npz", **stars)
    out = tmp_path / "jax.json"
    monkeypatch.syspath_prepend(str(M71))
    monkeypatch.setattr(sys, "argv", [
        "compare_nogiants.py", "--base", str(base), "--ablat", str(ablat),
        "--truth-stars", str(tmp_path / "truth_stars.npz"), "--out",
        str(out)])
    _load_jax_script(M71 / "compare_nogiants.py",
                     "jax_compare_nogiants").main()
    want = json.loads(out.read_text())
    assert want["shared_tiles"] > 0
    got = compare_nogiants.main([
        "--base", str(base), "--ablat", str(ablat), "--base-tiles",
        str(base / "tiles.npz"), "--ablat-tiles", str(ablat / "tiles.npz"),
        "--out", str(tmp_path / "port.json")])
    _assert_same(got, want)


def test_nogiants_coverage_on_matches_jax():
    jax_nogiants = _load_jax_script(M71 / "compare_nogiants.py",
                                    "jax_compare_nogiants_cov")
    rng = np.random.default_rng(5)
    truth, est = rng.gamma(2, 50, 30), rng.gamma(2, 50, (30, 40))
    w = rng.random((30, 40))
    idx = np.flatnonzero(rng.random(30) < 0.6)
    for weights in (w, None):
        assert compare_nogiants.coverage_on(idx, truth, est, weights) == (
            jax_nogiants.coverage_on(idx, truth, est, weights))


# --------------------------------------------------------------- misspec


def test_misspec_report_matches_the_jax_script(tmp_path, monkeypatch):
    """``misspec_study.py`` (a copy in a scratch directory, where it looks
    for ``data*/m71/tiles.npz`` and ``output/m71*``) and the port's
    ``variant_report`` on the same runs: the first 120 tiles of each
    fixture, seeded particles; the elliptical run missing."""
    script = tmp_path / "misspec_study.py"
    shutil.copy(M71 / "misspec_study.py", script)
    runs = {}
    for i, (name, (data, run)) in enumerate(
            misspec_study.VARIANTS.items()):
        with np.load(M71 / data / "m71" / "tiles.npz") as t:
            tiles = {k: t[k][:120] for k in t.files}
        (tmp_path / data / "m71").mkdir(parents=True)
        np.savez(tmp_path / data / "m71" / "tiles.npz", **tiles)
        if name != "elliptical":
            _fake_run(tmp_path / "output" / run, 120, 10 + i)
            runs[name] = tiles
    monkeypatch.setattr(sys, "argv", ["misspec_study.py"])
    _load_jax_script(script, "jax_misspec_study").main()
    want = json.loads((tmp_path / "output" / "m71" / "misspec_study.json")
                      .read_text())
    assert want["variants"]["elliptical"] == misspec_study.MISSING
    from smcdet_tpu_torch.runner import load_results

    for name, tiles in runs.items():
        res = load_results(tmp_path / "output" / misspec_study.VARIANTS[
            name][1])
        _assert_same(misspec_study.variant_report(res, tiles),
                     want["variants"][name])
    # the port's main on the same tree, the fixtures its own
    report = misspec_study.main(["--output-dir", str(tmp_path / "output")])
    assert report["variants"]["elliptical"] == misspec_study.MISSING
    assert report["variants"]["control"]["images"] == 120


# ------------------------------------------------------------- simulator


@pytest.fixture(scope="module")
def jax_simulator():
    return _load_jax_script(M71 / "simulator_checks.py",
                            "jax_simulator_checks")


@pytest.mark.parametrize("sizes", [(50, 50), (37, 81), (200, 7)])
def test_ks_statistic_matches_jax(jax_simulator, sizes):
    rng = np.random.default_rng(sum(sizes))
    a = rng.normal(size=sizes[0])
    b = np.round(rng.normal(0.3, 1.2, size=sizes[1]), 1)  # with ties
    assert simulator_checks.ks_statistic(a, b) == jax_simulator.ks_statistic(
        a, b)


def test_quantile_checks_match_the_jax_formula(jax_simulator):
    """``simulator_checks.py:127-141`` restated on seeded tiles (it is
    inline in the script's main), with its own ``ks_statistic``."""
    rng = np.random.default_rng(11)
    real = rng.gamma(30.0, 30.0, size=(64, 8, 8))
    syn = rng.gamma(28.0, 33.0, size=(64, 8, 8))
    syn[0, 0, 0] = 0.0  # the 1e-3 floor
    syn_flat = np.log(np.maximum(syn.reshape(64, -1), 1e-3))
    real_flat = np.log(np.maximum(real.reshape(64, -1), 1e-3))
    want = {}
    for name, q in {"q10": 0.1, "median": 0.5, "q90": 0.9}.items():
        sq = np.quantile(syn_flat, q, axis=-1)
        rq = np.quantile(real_flat, q, axis=-1)
        want[name] = {
            "ks_statistic": round(jax_simulator.ks_statistic(sq, rq), 4),
            "synthetic_mean": round(float(sq.mean()), 4),
            "real_mean": round(float(rq.mean()), 4),
            "synthetic_std": round(float(sq.std()), 4),
            "real_std": round(float(rq.std()), 4),
        }
    _assert_same(simulator_checks.quantile_checks(syn, real), want)


def test_simulated_tiles_lie_in_the_jax_ks_range():
    """The port's prior-predictive draw (CPU, seed 0) over the fixture's
    688 backgrounds: each KS statistic inside the card runner's band, the
    current JAX script's range over seeds 0-3 widened by 0.03."""
    from smcdet_tpu_torch.run_experiment import load_suite_config

    cfg = load_suite_config(str(M71))
    with np.load(cfg.data_path) as t:
        real = np.asarray(t["images"], np.float64)
        backgrounds = np.asarray(t["background"], np.float32)
    sim = simulator_checks.simulate(cfg, backgrounds, 0, 64, "cpu")
    assert sim.images.shape == real.shape
    checks = simulator_checks.quantile_checks(
        sim.images.numpy().astype(np.float64), real)
    pad = runner.BANDS["simulator_ks"]
    for name, (lo, hi) in runner.SIMULATOR_KS_JAX.items():
        assert lo - pad <= checks[name]["ks_statistic"] <= hi + pad, (
            name, checks[name])


# -------------------------------------------------------------- repeated


@pytest.fixture(scope="module")
def jax_repeated():
    return _load_jax_script(M71SYN / "repeated_runs.py", "jax_repeated_runs")


def test_interval_width_matches_jax(jax_repeated):
    x = np.random.default_rng(2).normal(size=(2, 3, 17, 7))
    for axis in (-2, 2):
        np.testing.assert_array_equal(
            repeated_runs.interval_width(x, axis=axis),
            jax_repeated.interval_width(x, axis=axis))


def test_entropy_pick_and_summary_match_the_jax_formulas():
    """``repeated_runs.py:163-183`` (the pick) and ``:200-225`` (the
    summary) restated, on seeded particles over the committed m71synthetic
    tiles."""
    with np.load(REPO / "tests" / "data" / "m71synthetic_tiles.npz") as t:
        true_counts = t["true_counts"]
    rng = np.random.default_rng(4)
    n = 300  # a run over the first 300 tiles: later candidates score 0
    smc = {"pruned_counts": rng.integers(0, 7, size=(n, 32)),
           "weights": rng.random((n, 32))}
    cand = np.flatnonzero(true_counts == 3)
    ent = np.zeros(len(cand))
    for j, i in enumerate(cand):
        if i >= n:
            continue
        pmf = np.bincount(smc["pruned_counts"][i], weights=smc["weights"][i],
                          minlength=10)
        pmf = pmf / pmf.sum()
        ent[j] = -(pmf[pmf > 0] * np.log(pmf[pmf > 0])).sum()
    assert repeated_runs.entropy_pick(true_counts, 3, smc) == (
        int(cand[np.argmax(ent)]), float(ent.max()))
    assert repeated_runs.entropy_pick(true_counts, 3) == (int(cand[0]), None)

    logpx = rng.normal(size=(3, 3, 20, 7)) * np.arange(1, 4)[::-1, None,
                                                             None, None]
    pmf = np.exp(logpx) / np.exp(logpx).sum(-1, keepdims=True)
    w_logpx = (np.quantile(logpx, 0.95, axis=-2)
               - np.quantile(logpx, 0.05, axis=-2))[..., 3]
    w_pmf = (np.quantile(pmf, 0.95, axis=-2)
             - np.quantile(pmf, 0.05, axis=-2))[..., 3]
    got = repeated_runs.summarize(logpx, pmf, 190, 3, [1, 2, 3], [4, 5, 6])
    assert got["logpx_mid90_width_at_true_count"] == np.round(
        w_logpx, 4).tolist()
    assert got["count_prob_mid90_width_at_true_count"] == np.round(
        w_pmf, 4).tolist()
    assert got["shrinks_with_N_and_steps"] == bool(
        (w_logpx[-1, -1] < w_logpx[0, 0] or w_logpx[0, 0] <= 1e-4)
        and (w_pmf[-1, -1] < w_pmf[0, 0] or w_pmf[0, 0] <= 1e-4))


def test_reps_per_call_follows_the_chunk_estimate():
    from smcdet_tpu_torch.config import build_prior, load_config
    from smcdet_tpu_torch.inference.smc import chunk_bytes_per_tile

    prior = build_prior(load_config(M71SYN / "config.yaml").prior, "cpu")
    per = chunk_bytes_per_tile(prior, 8192, 64)
    assert repeated_runs.reps_per_call(prior, 8192, 100, 64, 99 * per) == 50
    assert repeated_runs.reps_per_call(prior, 8192, 100, 64, 100 * per) == (
        100)
    assert repeated_runs.reps_per_call(prior, 8192, 100, 64, 3 * per) == 2


def test_run_grid_matches_jax_on_the_s3_image(jax_repeated):
    """``run_grid`` at 8 reps, N = 64, 5 sweeps on the committed s = 3
    image (190 of the m71synthetic tiles), the JAX script's against the
    port's on the CPU. The JAX side runs 16 reps in two calls of 8 (two
    keys); the port's mean of log p(x|s) at s = 3 over its 8 runs lies
    within 4 standard errors of the JAX mean, the standard error taken from
    the JAX runs' own spread (sd sqrt(1/8 + 1/16)); the two JAX calls'
    means lie within the same bound of each other, and every run's pmf sums
    to 1."""
    import jax.numpy as jnp
    from smcdet_tpu.config import (
        build_image_model as jax_model,
        build_kernel as jax_kernel,
        build_prior as jax_prior,
        load_config as jax_load,
    )
    from smcdet_tpu.inference.smc import SMCConfig as JaxSMCConfig

    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
        load_config,
    )
    from smcdet_tpu_torch.inference.smc import SMCConfig

    with np.load(REPO / "tests" / "data" / "m71synthetic_tiles.npz") as t:
        img = t["images"][190]
        assert int(t["true_counts"][190]) == 3
    jcfg = jax_load(M71SYN / "config.yaml")
    s = jcfg.sampler
    jax_logpx, jax_pmf, _ = jax_repeated.run_grid(
        jnp.asarray(img, jnp.float32), jax_prior(jcfg.prior),
        jax_model(jcfg.image_model), jax_kernel(jcfg.kernel),
        JaxSMCConfig(num_catalogs=64, ess_threshold_prop=s.ess_threshold_prop,
                     resample_method=s.resample_method,
                     max_smc_iters=s.max_smc_iters,
                     flux_detection_threshold=s.flux_detection_threshold),
        [64], [5], 16, reps_per_call=8, verbose=False)
    cfg = load_config(M71SYN / "config.yaml")
    s = cfg.sampler
    logpx, pmf, iters = repeated_runs.run_grid(
        img, build_prior(cfg.prior, "cpu"),
        build_image_model(cfg.image_model, "cpu"),
        build_kernel(cfg.kernel, "cpu"),
        SMCConfig(num_catalogs=64, ess_threshold_prop=s.ess_threshold_prop,
                  resample_method=s.resample_method,
                  max_smc_iters=s.max_smc_iters,
                  flux_detection_threshold=s.flux_detection_threshold),
        [64], [5], 8, seed=0, verbose=False)
    assert logpx.shape == pmf.shape == (1, 1, 8, 7)
    assert iters.shape == (1, 1, 8) and (iters > 0).all()
    np.testing.assert_allclose(pmf.sum(-1), 1.0, atol=1e-9)
    assert np.isfinite(logpx).all()
    jax_runs = jax_logpx[0, 0, :, 3]
    bound = 4 * jax_runs.std(ddof=1) * np.sqrt(1 / 8 + 1 / 16)
    assert abs(jax_runs[:8].mean() - jax_runs[8:].mean()) <= bound
    assert abs(logpx[0, 0, :, 3].mean() - jax_runs.mean()) <= bound, (
        logpx[0, 0, :, 3], jax_runs)


# ----------------------------------------------------------------- split


def test_brightest_single_is_the_committed_image():
    with np.load(REPO / "tests" / "data" / "m71synthetic_tiles.npz") as t:
        idx, flux = split_mode_study.brightest_single(t["true_counts"],
                                                      t["true_fluxes"])
    committed = json.loads((RESULTS / "m71synthetic"
                            / "split_mode_study.json").read_text())
    assert idx == committed["image_index"] == 985
    # 1607.456 here against the committed 1607.45: the committed study's
    # tiles held this star's flux within 0.01
    assert abs(flux - committed["true_flux_nmgy"]) <= 0.01


def test_anchor_summary_matches_the_jax_formula():
    """``split_mode_study.py:136-149`` restated on fixed chain arrays."""
    rng = np.random.default_rng(8)
    K = 8
    counts = np.concatenate([rng.integers(0, 3, size=(5, 40)),
                             rng.integers(3, 6, size=(6, 40))])
    acc = rng.random(11)
    pooled = np.bincount(counts.ravel(), minlength=K)[:K]
    pooled = pooled / pooled.sum()
    modal = np.array([np.bincount(c, minlength=K).argmax() for c in counts])
    want = {
        "pooled_count_pmf": [round(float(p), 4) for p in pooled],
        "pooled_mean_count": round(float((pooled * np.arange(K)).sum()), 3),
        "chains_modal_at_true": int((modal == 1).sum()),
        "chains_stuck_above": int((modal > 1).sum()),
        "acc_rate_mean": round(float(acc.mean()), 3),
    }
    _assert_same(split_mode_study.anchor_summary(counts, acc, K), want)


def test_split_anchors_run_on_the_cpu():
    """Each anchor on 3 chains of the image, a short chain: counts within
    0..M, acceptance in [0, 1]."""
    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
        load_config,
    )
    from smcdet_tpu_torch.inference.mcmc import MCMCConfig
    from smcdet_tpu_torch.runner import mcmc_chain

    cfg = load_config(M71SYN / "config.yaml")
    with np.load(REPO / "tests" / "data" / "m71synthetic_tiles.npz") as t:
        image = torch.as_tensor(t["images"][985], dtype=torch.float32)
    images = image.expand((3,) + image.shape).contiguous()
    prior = build_prior(cfg.prior, "cpu")
    model = build_image_model(cfg.image_model, "cpu")
    chain, _ = mcmc_chain(cfg, build_kernel(cfg.kernel, "cpu"), "cpu")
    mc = MCMCConfig(num_samples_total=40, num_samples_burnin=20,
                    keep_every_k=2, flux_detection_threshold=0.7)
    for i, name in enumerate(split_mode_study.ANCHORS):
        res = split_mode_study.run_anchor(name, images, prior, model, chain,
                                          mc, 1000 + i)
        entry = split_mode_study.anchor_summary(
            res.pruned_counts.numpy(), res.acc_rate.numpy(),
            prior.max_objects + 2)
        assert res.pruned_counts.shape == (3, 10)
        assert abs(sum(entry["pooled_count_pmf"]) - 1) < 1e-3
        assert 0.0 <= entry["acc_rate_mean"] <= 1.0
        assert entry["chains_modal_at_true"] + entry[
            "chains_stuck_above"] <= 3


# ---------------------------------------------------------------- runner


COMMITTED_ROWS = [
    ("crowded", "m71/crowded_budget_probe.json", runner.score_crowded),
    ("oracle", "m71/oracle_smc_analysis.json", runner.score_oracle),
    ("nogiants", "m71/nogiants_comparison.json", runner.score_nogiants),
    ("misspec", "m71/misspec_study.json", runner.score_misspec),
    ("simulator", "m71/simulator_checks.json", runner.score_simulator),
    ("repeated s1", "m71synthetic/repeatedruns_s1_summary.json",
     runner.score_repeated),
    ("repeated s3", "m71synthetic/repeatedruns_s3_summary.json",
     runner.score_repeated),
    ("split", "m71synthetic/split_mode_study.json", runner.score_split),
]


@pytest.mark.parametrize("name,path,score", COMMITTED_ROWS,
                         ids=[r[0] for r in COMMITTED_ROWS])
def test_runner_holds_the_committed_analysis_against_itself(name, path,
                                                            score):
    ref = json.loads((RESULTS / path).read_text())
    assert runner._ok(score(ref, ref))


def _perturb(name, got):
    """A copy of the committed figure moved just outside its band."""
    if name == "crowded":
        a = got["arms"]["hiN_n8192_s100"]
        a["mean_sbc_rank"] -= 0.07  # the band: 1.96 sqrt(2) 0.0231 = 0.064
    elif name == "oracle":
        got["count_accuracy"] += 0.051
    elif name == "nogiants":
        got["geometry"]["kept_tiles_within_render_reach"] = 1
    elif name == "misspec":
        got["variants"]["varying"]["posterior_count_excess_on_truth0"] += 0.16
    elif name == "simulator":
        got["pixel_log_intensity_quantiles"]["q90"]["ks_statistic"] = 0.16
    elif name.startswith("repeated"):
        got["logpx_mid90_width_at_true_count"][2][2] *= 1.31
    elif name == "split":
        got["anchors"]["rj_splitmerge"]["chains_modal_at_true"] -= 11
    return got


@pytest.mark.parametrize("name,path,score", COMMITTED_ROWS,
                         ids=[r[0] for r in COMMITTED_ROWS])
def test_runner_misses_a_figure_outside_its_band(name, path, score):
    ref = json.loads((RESULTS / path).read_text())
    got = _perturb(name, json.loads((RESULTS / path).read_text()))
    assert not runner._ok(score(got, ref))


def test_runner_misses_an_arm_not_run():
    ref = json.loads((RESULTS / "m71" / "crowded_budget_probe.json")
                     .read_text())
    got = json.loads(json.dumps(ref))
    got["arms"]["hiS_n2048_s200"] = "not run"
    assert not runner._ok(runner.score_crowded(got, ref))
