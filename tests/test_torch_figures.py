"""The port's figures (``smcdet_tpu_torch/figures.py``) and the analyzer's
``figures`` key against ``experiments/figures.py`` and
``experiments/analyze.py`` on the CPU: the same file names from the same
inputs, each image equal pixel for pixel (both draw with this machine's
matplotlib); and without matplotlib the analyzer raises, naming
``--no-figures``, where figures are asked for."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from matplotlib.image import imread
from test_torch_metrics import _jax_draw, _results_dir
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

from smcdet_tpu_torch import analyze as tanalyze
from smcdet_tpu_torch import figures

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--bootstrap", "50", "--num-match", "10"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_figures():
    sys.path.insert(0, str(REPO / "experiments"))
    try:
        yield _load(REPO / "experiments" / "figures.py", "jax_figures")
    finally:
        sys.path.remove(str(REPO / "experiments"))


def _same_images(a_dir, b_dir, names):
    for name in names:
        np.testing.assert_array_equal(imread(a_dir / name),
                                      imread(b_dir / name), err_msg=name)


def _inputs(rng, runtimes=True, classified=True, sep=True):
    bins = [15.0, 18.0, 21.0, 24.0]
    nb = len(bins)

    def ci():
        mid = rng.uniform(0.2, 0.9, (1, nb))
        return {m: np.concatenate([mid - 0.1, mid, mid + 0.05])
                for m in ("precision", "recall", "f1")}

    n = 40
    conf = rng.dirichlet(np.ones(25)).reshape(5, 5)
    return dict(
        mag_bins=bins, smc_ci=ci(), sep_ci=ci() if sep else None,
        confusion=conf, levels=[0.1, 0.5, 0.9, 0.95],
        coverage=[0.12, 0.48, 0.85, 0.93], n_images=n,
        ranks=rng.uniform(size=n), true_counts=rng.integers(0, 5, n),
        runtimes=rng.uniform(0.1, 0.3, n) if runtimes else None,
        classified=(rng.integers(1, 20, nb), rng.integers(0, 20, (50, nb)))
        if classified else None)


@pytest.mark.parametrize("variant", [
    {}, {"runtimes": False}, {"classified": False}, {"sep": False}],
    ids=["all", "no_runtimes", "no_classified", "no_extractor"])
def test_save_all_writes_the_jax_files(jax_figures, tmp_path, variant):
    want = jax_figures.save_all(tmp_path / "jax", **_inputs(
        np.random.default_rng(1), **variant))
    got = figures.save_all(tmp_path / "port", **_inputs(
        np.random.default_rng(1), **variant))
    assert got == want
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == want
    _same_images(tmp_path / "jax", tmp_path / "port", want)


def _jax_analyze(path, extra=()):
    script = _load(REPO / "experiments" / "analyze.py", "jax_analyze")
    argv = sys.argv
    sys.argv = ["analyze.py", str(path), *ARGS, *extra]
    sys.path.insert(0, str(REPO / "experiments"))
    try:
        script.main()
    finally:
        sys.argv = argv
        sys.path.remove(str(REPO / "experiments"))


@pytest.mark.parametrize("suffix", ["", "_variant"], ids=["main", "suffix"])
def test_analyze_draws_the_jax_figures(tmp_path, capsys, suffix):
    _results_dir(tmp_path / "jax")
    _results_dir(tmp_path / "port")
    extra = ["--out-suffix", suffix] if suffix else []
    _jax_analyze(tmp_path / "jax", extra)
    want = json.loads((tmp_path / "jax" / f"smc_analysis{suffix}.json")
                      .read_text())
    got = tanalyze.main([str(tmp_path / "port"), "--device", "cpu", *ARGS,
                         *extra], draw=_jax_draw)
    assert got["figures"] == want["figures"]
    assert "classified_counts.png" in got["figures"]
    assert sorted(got) == sorted(want)
    fig_dir = f"figures{suffix}"
    assert sorted(p.name for p in (tmp_path / "port" / fig_dir).iterdir()
                  ) == got["figures"]
    _same_images(tmp_path / "jax" / fig_dir, tmp_path / "port" / fig_dir,
                 ["count_confusion.png", "coverage.png"])
    capsys.readouterr()


def test_analyze_without_matplotlib_raises(tmp_path, monkeypatch, capsys):
    _results_dir(tmp_path / "r")
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="--no-figures"):
        tanalyze.main([str(tmp_path / "r"), "--device", "cpu", *ARGS])
    assert not (tmp_path / "r" / "figures").exists()
    assert not (tmp_path / "r" / "smc_analysis.json").exists()
    got = tanalyze.main([str(tmp_path / "r"), "--device", "cpu", *ARGS,
                         "--no-figures"])
    assert "figures" not in got
    with pytest.raises(RuntimeError, match="--figure"):
        figures.require_matplotlib("--figure")
    capsys.readouterr()
