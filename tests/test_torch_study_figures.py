"""The studies' figures (``smcdet_tpu_torch/figures.py``) against the JAX
scripts' own PNGs on the CPU.

Each JAX script's ``main`` runs unedited in a scratch directory, its
minutes-long samplers replaced by canned numpy results (``generate_images``
and ``SMCSampler`` for simulator_checks, the grid for repeated_runs,
``run_mh`` / ``run_rjmh`` for split_mode_study); the port's study runs on
the same inputs with the same results (``--device cpu``), writes its
figure data and draws from that file (``--figure``). The two PNGs are
equal pixel for pixel (both drawn with this machine's matplotlib), and
the reports equal. Then the port's output directory alone goes through
``python -m smcdet_tpu_torch.figures``: every PNG under the JAX scripts'
names at the committed PNGs' pixel sizes. Without matplotlib the command
and every study's ``--figure`` raise, naming the flag; a bad data file
makes the command exit non-zero. (psf_comparison's figure, which needs the
regenerated survey files, is held in ``tests/test_torch_prepare_data.py``;
compare_mcmc's against its script in ``tests/test_torch_compare_mcmc.py``.)
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from matplotlib.image import imread
from PIL import Image
from test_torch_m71_studies import _fake_run
from test_torch_studies import _write_batches
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu.inference import mcmc as jmcmc
from smcdet_tpu.inference import smc as jsmc
from smcdet_tpu.models import simulate as jsimulate
from smcdet_tpu_torch import figures
from smcdet_tpu_torch.studies import (
    compare_mcmc,
    compare_singletile,
    misspec_study,
    psf_comparison,
    repeated_runs,
    simulator_checks,
    split_mode_study,
)

REPO = Path(__file__).resolve().parents[1]
EXPERIMENTS = REPO / "experiments"
M71 = EXPERIMENTS / "m71"
M71SYN = EXPERIMENTS / "m71synthetic"
RESULTS = REPO / "docs" / "results"
SYN_TILES = REPO / "tests" / "data" / "m71synthetic_tiles.npz"
NS, STEPS, REPS = [512, 2048, 8192], [10, 50, 100], 20

# the scratch directory each JAX script writes its outputs under
JAX_ROOTS = {"misspec_study": "jax_misspec",
             "simulator_checks": "jax_simulator",
             "repeatedruns": "jax_repeated", "split_mode_study": "jax_split",
             "singletile_comparison": "jax_singletile"}
# the port's PNG (under the output directory) -> the committed PNG
COMMITTED = {
    "m71/figures/misspec_study.png": "m71/misspec_study.png",
    "m71/figures/simulator_checks.png": "m71/simulator_checks.png",
    **{f"m71synthetic/figures/repeatedruns_{kind}_s{s}.png":
       f"m71synthetic/repeatedruns_{kind}_s{s}.png"
       for kind in ("logpx", "countprob") for s in (1, 3)},
    "m71synthetic/figures/split_mode_study.png":
        "m71synthetic/split_mode_study.png",
    "m71synthetic/figures/mcmc_comparison.png":
        "m71synthetic/mcmc_comparison.png",
    "divideandconquer/figures/singletile_comparison.png":
        "divideandconquer/singletile_comparison.png",
}


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _script_copy(mp, root, src, name):
    """``src`` copied into ``root`` beside its suite's config and a link to
    the suite's committed data, so that the script reads the fixture and
    writes its outputs under ``root``; loaded as a module."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(src, root / src.name)
    shutil.copy(src.parent / "config.yaml", root / "config.yaml")
    if (src.parent / "data").exists():
        (root / "data").symlink_to(src.parent / "data")
    mp.syspath_prepend(str(EXPERIMENTS))
    return _load(root / src.name, name)


def _run_jax(mp, main, argv):
    mp.setattr(sys, "argv", argv)
    main()


# ----------------------------------------------------- canned results


def _simulator_fakes(rng):
    """The prior-predictive draw and the posterior run simulator_checks
    gets on both sides: the fixture's tiles scaled by a seeded factor,
    seeded pruned counts and a float32 posterior predictive."""
    with np.load(M71 / "data" / "m71" / "tiles.npz") as t:
        real = t["images"].astype(np.float32)
    syn = real * rng.uniform(0.8, 1.25, size=(real.shape[0], 1, 1)).astype(
        np.float32)
    syn[3, 0, 0] = 0.0  # the 1e-3 floor
    pruned = rng.integers(0, 4, size=real.shape[0])
    # the tile both scripts pick: the first draw of default_rng(seed 0)
    pick = int(np.random.default_rng(0).integers(0, real.shape[0]))
    ppflux = rng.normal(float(syn[pick].sum()), 900.0,
                        size=(11, 48)).astype(np.float32)
    return syn, pruned, ppflux, 1.4375


def _grid(rng, s):
    """repeated_runs' grid at ``NS`` x ``STEPS`` x ``REPS`` runs, 7 strata:
    log p(x|s) spreading less with N and steps, its softmax, iterations."""
    scale = np.linspace(30.0, 2.0, 9).reshape(3, 3, 1, 1)
    logpx = -1000.0 + 40.0 * (np.arange(7) == s) + scale * rng.normal(
        size=(3, 3, REPS, 7))
    pmf = np.exp(logpx - logpx.max(-1, keepdims=True))
    pmf /= pmf.sum(-1, keepdims=True)
    return logpx, pmf, np.full((3, 3, REPS), 40.0)


def _chains(rng, chains, kept, K):
    """split_mode_study's three anchors: pruned counts and acceptance."""
    out = {}
    for i, name in enumerate(split_mode_study.ANCHORS):
        hi = 2 + i
        out[name] = (rng.integers(0, hi + 1, size=(chains, kept)).clip(
            0, K - 1).astype(np.int32), rng.uniform(0.1, 0.6, size=chains)
            .astype(np.float32))
    return out


# ---------------------------------------------------------------- runs


def _misspec(mp, tmp):
    """The scored runs (the control and varying fixtures' first 120 tiles,
    the elliptical one missing) under both sides' output directories."""
    jdir = tmp / "jax_misspec"
    script = _script_copy(mp, jdir, M71 / "misspec_study.py",
                          "jax_misspec_study_figure")
    for i, (name, (data, run)) in enumerate(misspec_study.VARIANTS.items()):
        if name == "elliptical":
            continue
        for root in (jdir / "output", tmp / "port" / "output"):
            _fake_run(root / run, 120, 20 + i)
    # the script reads data*/m71/tiles.npz beside itself
    (jdir / "data").unlink()
    for data, _ in misspec_study.VARIANTS.values():
        with np.load(M71 / data / "m71" / "tiles.npz") as t:
            tiles = {k: t[k][:120] for k in t.files}
        (jdir / data / "m71").mkdir(parents=True)
        np.savez(jdir / data / "m71" / "tiles.npz", **tiles)
    _run_jax(mp, script.main, ["misspec_study.py"])
    want = json.loads((jdir / "output" / "m71" / "misspec_study.json")
                      .read_text())
    got = misspec_study.main(["--output-dir", str(tmp / "port" / "output"),
                              "--figure"])
    return got, want


def _simulator(mp, tmp, rng):
    syn, pruned, ppflux, mean_count = _simulator_fakes(rng)

    class Sampler:
        def __init__(self, **kwargs):
            pass

        def run(self, key):
            pass

        def posterior_predictive_total_observed_flux(self, key):
            return jax.numpy.asarray(ppflux)

        def posterior_mean_count(self):
            return np.asarray([mean_count])

    mp.setattr(jsimulate, "generate_images", lambda *a, **k: SimpleNamespace(
        images=jax.numpy.asarray(syn), pruned_counts=pruned))
    mp.setattr(jsmc, "SMCSampler", Sampler)
    jdir = tmp / "jax_simulator"
    script = _script_copy(mp, jdir, M71 / "simulator_checks.py",
                          "jax_simulator_checks_figure")
    _run_jax(mp, script.main, ["simulator_checks.py"])
    want = json.loads((jdir / "output" / "m71" / "simulator_checks.json")
                      .read_text())

    mp.setattr(simulator_checks, "simulate",
               lambda *a, **k: SimpleNamespace(
                   images=torch.as_tensor(syn),
                   pruned_counts=torch.as_tensor(pruned)))
    mp.setattr(simulator_checks, "posterior_predictive",
               lambda *a, **k: (SimpleNamespace(
                   posterior_mean_count=lambda: torch.tensor([mean_count])),
                   ppflux.reshape(-1)))
    got = simulator_checks.main(["--output-dir", str(tmp / "port" / "output"),
                                 "--device", "cpu", "--figure"])
    return got, want


def _repeated(mp, tmp, rng):
    jdir = tmp / "jax_repeated"
    (jdir / "output" / "m71synthetic").mkdir(parents=True)
    shutil.copy(SYN_TILES, jdir / "output" / "m71synthetic" / "tiles.npz")
    shutil.copy(SYN_TILES, tmp / "port" / "output" / "m71synthetic"
                / "tiles.npz")
    script = _load(M71SYN / "repeated_runs.py", "jax_repeated_runs_figure")
    mp.chdir(jdir)
    out = {}
    for s in (1, 3):
        grid = _grid(rng, s)
        fake = lambda *a, grid=grid, **k: grid  # noqa: E731
        mp.setattr(script, "run_grid", fake)
        mp.setattr(repeated_runs, "run_grid", fake)
        argv = ["--true-count", str(s), "--reps", str(REPS),
                "--num-catalogs", *map(str, NS), "--mh-steps",
                *map(str, STEPS)]
        _run_jax(mp, script.main, ["repeated_runs.py", *argv])
        want = json.loads((jdir / "output" / "m71synthetic"
                           / f"repeatedruns_s{s}_summary.json").read_text())
        got = repeated_runs.main([*argv, "--output-dir",
                                  str(tmp / "port" / "output"), "--device",
                                  "cpu", "--figure"])
        out[s] = (got, want)
    return out


def _split(mp, tmp, rng):
    chains, samples, burnin = 6, 40, 20
    runs = _chains(rng, chains, (samples - burnin) // 2, 8)
    jdir = tmp / "jax_split"
    (jdir / "output" / "m71synthetic").mkdir(parents=True)
    shutil.copy(SYN_TILES, jdir / "output" / "m71synthetic" / "tiles.npz")

    def fake(base):
        def run(key, images, *rest):
            r = int(jax.random.key_data(key)[-1]) - 1000
            assert images.shape[0] == chains
            name = split_mode_study.ANCHORS[r]
            assert (name == "mh") == (base == "mh")
            return SimpleNamespace(pruned_counts=runs[name][0],
                                   acc_rate=runs[name][1])
        return run

    mp.setattr(jmcmc, "run_mh", fake("mh"))
    mp.setattr(jmcmc, "run_rjmh", fake("rj"))
    mp.setattr(jax, "jit", lambda f: f)
    script = _load(M71SYN / "split_mode_study.py", "jax_split_mode_figure")
    mp.chdir(jdir)
    argv = ["--chains", str(chains), "--num-samples", str(samples),
            "--burnin", str(burnin)]
    _run_jax(mp, script.main, ["split_mode_study.py", *argv, "--cpu"])
    want = json.loads((jdir / "output" / "m71synthetic"
                       / "split_mode_study.json").read_text())

    def port_anchor(name, images, *args):
        counts, acc = runs[name]
        return SimpleNamespace(pruned_counts=torch.as_tensor(counts),
                               acc_rate=torch.as_tensor(acc))

    mp.setattr(split_mode_study, "run_anchor", port_anchor)
    got = split_mode_study.main([*argv, "--output-dir",
                                 str(tmp / "port" / "output"), "--device",
                                 "cpu", "--figure"])
    for entry in got["anchors"].values():
        del entry["wall_s"]
    return got, want


def _singletile(mp, tmp):
    roots = (tmp / "jax_singletile", tmp / "port")
    for root in roots:
        _write_batches(root / "output" / "divideandconquer", 3, (5, 4), 9)
        _write_batches(root / "output" / "divideandconquer_singletile", 8,
                       (6, 4), 11)
    mp.syspath_prepend(str(EXPERIMENTS))
    script = _load(EXPERIMENTS / "divideandconquer" / "compare_singletile.py",
                   "jax_compare_singletile_figure")
    mp.chdir(roots[0])
    _run_jax(mp, script.main, ["compare_singletile.py"])
    want = json.loads((roots[0] / "output" / "divideandconquer"
                       / "singletile_comparison.json").read_text())
    mp.chdir(roots[1])
    got = compare_singletile.main(["--figure"])
    return got, want


def _mcmc(mp, tmp, rng):
    """compare_mcmc's port run on staged SMC results, its chains canned
    (its figure against the script's: ``tests/test_torch_compare_mcmc.py``)."""
    out = tmp / "port" / "output" / "m71synthetic"
    n, reps, kept, M, P = 5, 2, 30, 6, 40
    counts = rng.integers(0, M + 1, size=(n, P)).astype(np.int32)
    np.savez(out / "smc_batch0000.npz", pruned_counts=counts,
             weights=rng.dirichlet(np.ones(P), size=n).astype(np.float32),
             pruned_fluxes=(rng.gamma(1.5, 20.0, size=(n, P, M)) * (
                 np.arange(M) < counts[..., None])).astype(np.float32),
             runtime=np.asarray(1.0))
    chains = {}
    for name in ("mh", "rj"):
        c = rng.integers(0, M + 1, size=(n, reps * kept)).astype(np.int32)
        chains[name] = (c, (rng.gamma(1.5, 20.0, size=c.shape + (M,)) * (
            np.arange(M) < c[..., None])).astype(np.float32),
            rng.uniform(0.05, 0.5, size=n))
    mp.setattr(compare_mcmc, "run_anchors",
               lambda *a, **k: (chains, {"mh": 1.0, "rj": 2.0}))
    return compare_mcmc.main(["--num-images", str(n), "--reps", str(reps),
                              "--output-dir", str(tmp / "port" / "output"),
                              "--device", "cpu"])


@pytest.fixture(scope="module")
def drawn(tmp_path_factory):
    """Every study on both sides; returns the scratch directory (the JAX
    scripts' directories ``JAX_ROOTS``), the port's output directory and
    the reports (port, JAX)."""
    tmp = tmp_path_factory.mktemp("study_figures")
    (tmp / "port" / "output" / "m71synthetic").mkdir(parents=True)
    rng = np.random.default_rng(19)
    reports = {}
    with pytest.MonkeyPatch.context() as mp:
        # experiments/common.py skips its compilation cache when this is
        # empty
        mp.setenv("JAX_COMPILATION_CACHE_DIR", "")
        reports["misspec"] = _misspec(mp, tmp)
        reports["simulator"] = _simulator(mp, tmp, rng)
        for s, pair in _repeated(mp, tmp, rng).items():
            reports[f"repeated s{s}"] = pair
        reports["split"] = _split(mp, tmp, rng)
        reports["singletile"] = _singletile(mp, tmp)
        _mcmc(mp, tmp, rng)
    return tmp, tmp / "port" / "output", reports


@pytest.mark.parametrize("png", [p for p in COMMITTED
                                 if "mcmc" not in p])
def test_the_port_draws_the_jax_scripts_figure(drawn, png):
    tmp, port, _ = drawn
    root = next(r for stem, r in JAX_ROOTS.items()
                if Path(png).stem.startswith(stem))
    want = tmp / root / "output" / png
    np.testing.assert_array_equal(imread(port / png), imread(want),
                                  err_msg=png)


@pytest.mark.parametrize("name", ["misspec", "simulator", "repeated s1",
                                  "repeated s3", "split", "singletile"])
def test_the_reports_are_the_jax_scripts(drawn, name):
    got, want = drawn[2][name]
    assert {k: v for k, v in got.items() if k != "entropy_pick"} == want


def test_the_figure_data_hold_the_unrounded_arrays(drawn):
    _, port, reports = drawn
    with np.load(port / "m71" / "figure_data" / "simulator_checks.npz") as d:
        assert d["ppflux"].dtype == np.float32
        report = reports["simulator"][0]
        for q in figures.SIMULATOR_QUANTILES:
            assert d[f"sq_{q}"].shape == (int(d["T"]),)
            assert round(simulator_checks.ks_statistic(
                d[f"sq_{q}"], d[f"rq_{q}"]), 4) == report[
                    "pixel_log_intensity_quantiles"][q]["ks_statistic"]
        # a Python float, as the study compares: in float32
        truth = float(d["true_observed"])
        assert round(float((d["ppflux"] < truth).mean()), 4) == report[
            "posterior_predictive_image"]["pp_flux_quantile_of_truth"]
    with np.load(port / "m71synthetic" / "figure_data"
                 / "split_mode_study.npz") as d:
        report = reports["split"][0]
        for name in split_mode_study.ANCHORS:
            pmf = d[f"pmf_{name}"]
            assert pmf.dtype == np.float64
            assert [round(float(p), 4) for p in pmf] == report["anchors"][
                name]["pooled_count_pmf"]
        assert int(d["image_index"]) == report["image_index"]
        assert round(float(d["true_flux"]), 2) == report["true_flux_nmgy"]


def test_the_draw_command_draws_every_figure_from_the_files(drawn, tmp_path,
                                                             capsys):
    """The port's output directory copied without its PNGs: the command
    finds every data file and writes every figure under the JAX scripts'
    names, each at the committed PNG's pixel size, printing each path."""
    _, port, _ = drawn
    root = tmp_path / "output"
    shutil.copytree(port, root, ignore=shutil.ignore_patterns("*.png"))
    assert not list(root.rglob("*.png"))
    written = figures.main([str(root)])
    assert sorted(str(p.relative_to(root)) for p in written) == sorted(
        COMMITTED)
    printed = capsys.readouterr().out.split()
    for png, committed in COMMITTED.items():
        assert str(root / png) in printed
        assert Image.open(root / png).size == Image.open(
            RESULTS / committed).size, png


@pytest.mark.parametrize("bad", ["unknown_name", "corrupt"])
def test_the_draw_command_exits_non_zero_on_a_bad_file(drawn, tmp_path, bad,
                                                      capsys):
    _, port, _ = drawn
    root = tmp_path / "output"
    shutil.copytree(port / "divideandconquer", root / "divideandconquer",
                    ignore=shutil.ignore_patterns("*.png"))
    data = root / "divideandconquer" / "figure_data"
    if bad == "unknown_name":
        np.savez(data / "unknown.npz", x=np.zeros(3))
    else:
        (data / "singletile_comparison.npz").write_bytes(b"not a npz")
    with pytest.raises(SystemExit) as e:
        figures.main([str(root)])
    assert e.value.code not in (0, None)
    assert "failed to draw" in str(e.value.code)
    assert bad != "corrupt" or not (root / "divideandconquer" / "figures"
                                    / "singletile_comparison.png").exists()
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no figure data"):
        figures.main([str(tmp_path / "empty")])
    capsys.readouterr()


def test_misspec_draws_nothing_below_two_variants(tmp_path, capsys):
    report = {"variants": {"control": misspec_study.MISSING,
                           "elliptical": misspec_study.MISSING,
                           "varying": {}}}
    path = tmp_path / "m71" / "misspec_study.json"
    path.parent.mkdir()
    path.write_text(json.dumps(report))
    assert figures.draw(path) == []
    assert not (tmp_path / "m71" / "figures" / "misspec_study.png").exists()
    capsys.readouterr()


FIGURE_FLAGS = [
    (misspec_study.main, ["--output-dir", "out"]),
    (simulator_checks.main, ["--output-dir", "out", "--device", "cpu"]),
    (repeated_runs.main, ["--output-dir", "out", "--device", "cpu"]),
    (split_mode_study.main, ["--output-dir", "out", "--device", "cpu"]),
    (psf_comparison.main, ["--output-dir", "out", "--device", "cpu"]),
    (compare_singletile.main, ["--config", "absent.yaml"]),
    (compare_mcmc.main, ["--output-dir", "out", "--device", "cpu"]),
]


@pytest.fixture
def no_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


@pytest.mark.parametrize("main,argv", FIGURE_FLAGS,
                         ids=[m.__module__.split(".")[-1]
                              for m, _ in FIGURE_FLAGS])
def test_figure_without_matplotlib_raises_before_running(
        no_matplotlib, monkeypatch, tmp_path, main, argv):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="--figure needs it"):
        main([*argv, "--figure"])
    assert not any(tmp_path.iterdir())


def test_the_draw_command_without_matplotlib_raises(no_matplotlib,
                                                    tmp_path):
    with pytest.raises(RuntimeError,
                       match="python -m smcdet_tpu_torch.figures needs it"):
        figures.main([str(tmp_path)])
