"""The port's SMC-versus-MCMC anchor (``smcdet_tpu_torch/studies/
compare_mcmc.py``) against ``experiments/m71synthetic/compare_mcmc.py`` on
the CPU, and the card runner's bands (``tests/torch_mcmc_anchor.py``).

- The report: the JAX script's ``main`` run on chains given as numpy
  arrays (its ``run_mh`` / ``run_rjmh`` replaced by the arrays, rep by rep
  on its own keys) and the port's ``fold_reps`` + ``report`` on the same
  arrays stacked rep-major: the same JSON, exactly, and the same figure
  pixel for pixel.
- The reps on the tile axis against JAX's ``pooled`` in law: 4 two-star
  tiles (``tests/test_smc.py``) x 3 reps, 600 sweeps (300 burn-in, thin 2).
  JAX's own spread over the pooled runs of keys 11, 21, 31 and 41 (CPU):
  the pooled count pmf's widest range over a count 0.25 (the share at two
  stars 0.167-0.417), the mean acceptance 0.2122-0.2300. The port's pooled
  pmf lies within ``PMF_TOL`` of the mean of JAX's four, per count, and
  its mean acceptance within ``ACC_TOL``.
- The CLI end to end at 4 images x 2 reps x 200 sweeps on staged SMC
  results.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mcmc_anchor as runner
from matplotlib.image import imread
from tests.test_smc import two_star_image
from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread,
    port_kernel,
    port_model,
    port_prior,
)

from smcdet_tpu.inference import mcmc as jmcmc
from smcdet_tpu_torch.figures import plot_mcmc_comparison
from smcdet_tpu_torch.inference import mcmc as tmcmc
from smcdet_tpu_torch.studies import compare_mcmc

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "experiments" / "m71synthetic" / "compare_mcmc.py"
COMMITTED = REPO / "docs" / "results" / "m71synthetic" / "mcmc_comparison.json"
TILES = REPO / "tests" / "data" / "m71synthetic_tiles.npz"
PMF_TOL = 0.25
ACC_TOL = 0.02
M, KEPT, P = 6, 30, 40  # slots, kept samples a rep, SMC particles
K = M + 2


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("jax_compare_mcmc", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _chains(rng, n, reps, stuck=False):
    """Per rep, fake chain results ``(pruned_counts [n, KEPT],
    pruned_fluxes [n, KEPT, M], acc_rate [n])``; ``stuck``: every
    acceptance below the well-mixed threshold."""
    out = []
    for _ in range(reps):
        counts = rng.integers(0, M + 1, size=(n, KEPT))
        fluxes = rng.gamma(1.5, 20.0, size=(n, KEPT, M)) * (
            np.arange(M) < counts[..., None])
        hi = 0.14 if stuck else 0.5
        acc = rng.uniform(0.02, hi, size=n)
        out.append((counts.astype(np.int32), fluxes.astype(np.float32),
                    acc.astype(np.float32)))
    return out


def _smc(rng, n):
    counts = rng.integers(0, M + 1, size=(n, P)).astype(np.int32)
    w = rng.dirichlet(np.ones(P), size=n).astype(np.float32)
    fluxes = (rng.gamma(1.5, 20.0, size=(n, P, M))
              * (np.arange(M) < counts[..., None])).astype(np.float32)
    return counts, w, fluxes


def _stage(root, n, smc):
    out = root / "output" / "m71synthetic"
    out.mkdir(parents=True)
    with np.load(TILES) as t:
        np.savez(out / "tiles.npz", **{k: t[k][:n] for k in t.files})
    counts, w, fluxes = smc
    np.savez(out / "smc_batch0000.npz", pruned_counts=counts, weights=w,
             pruned_fluxes=fluxes, runtime=np.asarray(1.0))
    return out


class _Res:
    def __init__(self, counts, fluxes, acc):
        self.pruned_counts, self.pruned_fluxes, self.acc_rate = (
            counts, fluxes, acc)


def _run_script(script, monkeypatch, root, n, reps, mh, rj):
    """The JAX script's ``main`` in ``root`` with its chains replaced by
    ``mh`` / ``rj`` (per rep, picked by the key: MH keys 11 + r, RJ 1011 +
    r); returns its JSON."""
    def fake(base, runs):
        def run(key, images, *rest):
            r = int(jax.random.key_data(key)[-1]) - base
            assert images.shape[0] == n and 0 <= r < reps
            return _Res(*runs[r])
        return run

    monkeypatch.chdir(root)
    monkeypatch.setattr(jmcmc, "run_mh", fake(11, mh))
    monkeypatch.setattr(jmcmc, "run_rjmh", fake(1011, rj))
    monkeypatch.setattr(jax, "jit", lambda f: f)
    monkeypatch.setattr(sys, "argv", [
        "compare_mcmc.py", "--num-images", str(n), "--reps", str(reps)])
    script.main()
    return json.loads((root / "output" / "m71synthetic"
                       / "mcmc_comparison.json").read_text())


def _folded(mh, rj, reps):
    """The reps' chains stacked rep-major, as the port runs them, and
    folded back (``fold_reps``)."""
    stacked = [np.concatenate([r[i] for r in runs]) for runs in (mh, rj)
               for i in range(3)]
    return (compare_mcmc.fold_reps(*stacked[:3], reps),
            compare_mcmc.fold_reps(*stacked[3:], reps))


def _port(n, reps, mh, rj, smc, num_samples=50_000):
    mc, rjf = _folded(mh, rj, reps)
    return compare_mcmc.report(*mc, rjf[0], *smc, K, num_samples, reps)


@pytest.mark.parametrize("stuck", [False, True], ids=["mixed", "all_stuck"])
def test_report_equals_the_script(script, monkeypatch, tmp_path, capsys,
                                  stuck):
    rng = np.random.default_rng(3 + stuck)
    n, reps = 12, 3
    mh, rj = _chains(rng, n, reps, stuck), _chains(rng, n, reps)
    smc = _smc(rng, n)
    _stage(tmp_path, n, smc)
    want = _run_script(script, monkeypatch, tmp_path, n, reps, mh, rj)
    got = _port(n, reps, mh, rj, smc)
    assert got == want
    # the figure: the script's, pixel for pixel
    mc, rjf = _folded(mh, rj, reps)
    path = tmp_path / "port.png"
    plot_mcmc_comparison(path, compare_mcmc.stats(*mc, rjf[0], *smc, K),
                         50_000)
    np.testing.assert_array_equal(imread(path), imread(
        tmp_path / "output" / "m71synthetic" / "figures"
        / "mcmc_comparison.png"))
    if stuck:
        assert got["well_mixed_chains"]["n"] == 0
        assert got["well_mixed_chains"]["count_pmf_tvd_mean"] is None
        assert got["well_mixed_chains"]["count_pmf_tvd_p90"] is None
    capsys.readouterr()


def test_figure_from_its_data_file_equals_the_script(script, monkeypatch,
                                                     tmp_path, capsys):
    """The port's command on the same chains (``run_anchors`` given the
    reps folded) writes ``figure_data/mcmc_comparison.npz``; the figure
    ``--figure`` draws from that file is the script's, pixel for pixel."""
    rng = np.random.default_rng(11)
    n, reps = 10, 2
    mh, rj = _chains(rng, n, reps), _chains(rng, n, reps)
    smc = _smc(rng, n)
    _stage(tmp_path / "jax", n, smc)
    _run_script(script, monkeypatch, tmp_path / "jax", n, reps, mh, rj)
    out = _stage(tmp_path / "port", n, smc)
    mc, rjf = _folded(mh, rj, reps)
    monkeypatch.setattr(compare_mcmc, "run_anchors", lambda *a, **k: (
        {"mh": mc, "rj": rjf}, {"mh": 1.0, "rj": 1.0}))
    compare_mcmc.main(["--num-images", str(n), "--reps", str(reps),
                       "--output-dir", str(tmp_path / "port" / "output"),
                       "--device", "cpu", "--figure"])
    with np.load(out / "figure_data" / "mcmc_comparison.npz") as d:
        assert int(d["num_samples"]) == 50_000 and d["mixed"].dtype == bool
    np.testing.assert_array_equal(
        imread(out / "figures" / "mcmc_comparison.png"),
        imread(tmp_path / "jax" / "output" / "m71synthetic" / "figures"
               / "mcmc_comparison.png"))
    capsys.readouterr()


def test_count_pmf_and_weighted_median_are_the_script(script):
    rng = np.random.default_rng(7)
    counts, w, fluxes = _smc(rng, 9)
    np.testing.assert_array_equal(compare_mcmc.count_pmf(counts, w, K),
                                  script.count_pmf(counts, w, K))
    s = compare_mcmc.stats(counts, fluxes, np.full(9, 0.3), counts, counts,
                           w, fluxes, K)
    flux = fluxes.sum(-1)
    for i in range(9):
        order = np.argsort(flux[i])
        cdf = np.cumsum(w[i][order])
        assert s["med_smc"][i] == flux[i][order][
            np.searchsorted(cdf / cdf[-1], 0.5)]
    uniform = script.count_pmf(counts, np.full(counts.shape,
                                               1.0 / counts.shape[1]), K)
    tvd = 0.5 * np.abs(uniform - script.count_pmf(counts, w, K)).sum(-1)
    np.testing.assert_array_equal(s["tvd"], tvd)
    np.testing.assert_array_equal(s["rj_tvd"], tvd)


def test_stack_and_fold_reps_round_trip():
    images = torch.arange(3 * 2 * 2, dtype=torch.float32).reshape(3, 2, 2)
    stacked = compare_mcmc.stack_reps(images, 4)
    assert stacked.shape == (12, 2, 2)
    assert torch.equal(stacked[7], images[1])  # rep 2, image 1
    counts = np.arange(12 * 5).reshape(12, 5)
    fluxes = np.arange(12 * 5 * 2).reshape(12, 5, 2)
    acc = np.arange(12, dtype=float)
    c, f, a = compare_mcmc.fold_reps(counts, fluxes, acc, 4)
    assert c.shape == (3, 20) and f.shape == (3, 20, 2)
    np.testing.assert_array_equal(c[1, 5:10], counts[4])  # rep 1, image 1
    np.testing.assert_array_equal(f[2, 15:], fluxes[11])
    np.testing.assert_array_equal(a, acc.reshape(4, 3).mean(0))


@pytest.fixture(scope="module")
def pooled_two_star():
    image, prior, model, kernel = two_star_image()
    kernel = kernel.replace(num_iters=1, locs_stdev=jnp.float32(0.25),
                            fluxes_stdev=jnp.float32(50.0))
    T, reps = 4, 3
    images = jnp.broadcast_to(image, (T,) + image.shape)
    cfg = dict(num_samples_total=600, num_samples_burnin=300,
               keep_every_k=2, flux_detection_threshold=500.0)
    run = jax.jit(lambda k: jmcmc.run_mh(k, images, prior, model, kernel,
                                         jmcmc.MCMCConfig(**cfg)))
    Kp = prior.max_objects + 2
    jax_pmf, jax_acc = [], []
    for key0 in (11, 21, 31, 41):  # the script's pooled, four keys
        res = [run(jax.random.key(key0 + r)) for r in range(reps)]
        c = np.concatenate([np.asarray(x.pruned_counts) for x in res], 1)
        jax_pmf.append(np.bincount(c.ravel(), minlength=Kp)[:Kp] / c.size)
        jax_acc.append(np.stack([np.asarray(x.acc_rate)
                                 for x in res]).mean(0).mean())
    chain = port_kernel(kernel)
    timg = torch.as_tensor(np.array(images))
    out, walls = compare_mcmc.run_anchors(
        timg, port_prior(prior), port_model(model), chain,
        tmcmc.MCMCConfig(**cfg), reps)
    return np.asarray(jax_pmf), np.asarray(jax_acc), out, walls, Kp, T, reps


def test_reps_on_the_tile_axis_agree_in_law_with_pooled(pooled_two_star):
    jax_pmf, jax_acc, out, walls, Kp, T, reps = pooled_two_star
    counts, fluxes, acc = out["mh"]
    assert counts.shape == (T, reps * 150) and acc.shape == (T,)
    assert fluxes.shape == (T, reps * 150, Kp - 2)
    pmf = np.bincount(counts.ravel(), minlength=Kp)[:Kp] / counts.size
    assert np.abs(pmf - jax_pmf.mean(0)).max() <= PMF_TOL, (pmf, jax_pmf)
    assert abs(acc.mean() - jax_acc.mean()) <= ACC_TOL, (acc, jax_acc)
    rj_counts, _, rj_acc = out["rj"]
    assert rj_counts.shape == (T, reps * 150)
    assert ((rj_acc > 0) & (rj_acc < 1)).all()
    assert set(walls) == {"mh", "rj"}


def test_rj_sweep_ms_runs_on_the_cpu():
    image, prior, model, kernel = two_star_image()
    images = torch.as_tensor(np.asarray(image))[None]
    ms = compare_mcmc.rj_sweep_ms(images, port_prior(prior),
                                  port_model(model),
                                  port_kernel(kernel.replace(num_iters=1)),
                                  chains=6, sweeps=3, warm=2)
    assert 0 < ms < 60_000


def test_cli_end_to_end(tmp_path, capsys):
    rng = np.random.default_rng(5)
    n = 4
    out = _stage(tmp_path, n, _smc(rng, n))
    got = compare_mcmc.main([
        "--num-images", str(n), "--reps", "2", "--num-samples", "200",
        "--burnin", "100", "--thin", "2", "--device", "cpu",
        "--output-dir", str(tmp_path / "output"), "--figure"])
    want = json.loads(COMMITTED.read_text())
    assert sorted(got) == sorted([*want, "wall_s"])
    assert got["images"] == n and got["mcmc_chains_per_image"] == 2
    assert json.loads((out / "mcmc_comparison.json").read_text()) == got
    lo, hi = got["mcmc_acc_rate_range"]
    assert 0 <= lo <= hi <= 1
    for key in ("mean", "median", "p90"):
        assert 0 <= got["count_pmf_tvd"][key] <= 1
    assert (out / "figures" / "mcmc_comparison.png").stat().st_size > 0
    capsys.readouterr()


def test_cli_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="no CUDA card"):
        compare_mcmc.main(["--output-dir", str(tmp_path)])


def test_committed_report_holds_its_own_bands():
    ref = json.loads(COMMITTED.read_text())
    rows, ok = runner.hold_report(ref, ref)
    assert ok and all(r["verdict"] == "held" for r in rows.values()
                      if "verdict" in r)
    assert len([r for r in rows.values() if "verdict" in r]) == len(
        runner.BANDS)


@pytest.mark.parametrize("path,band", runner.BANDS,
                         ids=[".".join(map(str, p)) for p, _ in runner.BANDS])
def test_a_figure_outside_its_band_is_a_miss(path, band):
    ref = json.loads(COMMITTED.read_text())
    got = json.loads(COMMITTED.read_text())
    node = got
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = node[path[-1]] + 1.5 * band
    rows, ok = runner.hold_report(got, ref)
    assert not ok
    assert rows[".".join(map(str, path))]["verdict"] == "missed"
    node[path[-1]] = node[path[-1]] - 0.6 * band
    rows, ok = runner.hold_report(got, ref)
    assert ok
