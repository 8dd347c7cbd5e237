"""The port's MCMC baseline (smcdet_tpu_torch/inference/mcmc.py and the
runner's ``method="mcmc"``) against the JAX package's, on the CPU.

The chains draw from other random streams than JAX's, so ``run_mh`` is held
to JAX's in law: 16 chains each on the unambiguous two-star tile of
test_smc.py, where a saturated chain settles in the true two-star mode or
in a "split" mode of three detectable stars (test_mcmc.py). The tolerances
are the spread of JAX's own runs over four keys at this size: the share of
kept samples at three stars 0.50-0.88, the pooled mean total flux
4000-4109, the acceptance 0.083-0.097."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.test_smc import two_star_image
from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread,
    port_kernel,
    port_model,
    port_prior,
)

from smcdet_tpu.inference import mcmc as jmcmc
from smcdet_tpu_torch.inference import mcmc as tmcmc

REPO = Path(__file__).resolve().parents[1]
SPLIT_SHARE_TOL = 0.4
FLUX_RTOL = 0.04
ACC_TOL = 0.02


def _two_star(T=16):
    image, prior, model, kernel = two_star_image()
    kernel = kernel.replace(num_iters=1, locs_stdev=jnp.float32(0.25),
                            fluxes_stdev=jnp.float32(50.0))
    return np.broadcast_to(np.asarray(image), (T,) + image.shape), prior, \
        model, kernel


@pytest.fixture(scope="module")
def chains():
    images, prior, model, kernel = _two_star()
    cfg = dict(num_samples_total=2000, num_samples_burnin=1000,
               keep_every_k=2, flux_detection_threshold=500.0)
    want = jax.jit(lambda k: jmcmc.run_mh(
        k, jnp.asarray(images), prior, model, kernel,
        jmcmc.MCMCConfig(**cfg)))(jax.random.key(0))
    got = tmcmc.run_mh(torch.Generator().manual_seed(0),
                       torch.tensor(images), port_prior(prior),
                       port_model(model), port_kernel(kernel),
                       tmcmc.MCMCConfig(**cfg))
    return ({f: np.asarray(getattr(want, f)) for f in want._fields},
            {f: getattr(got, f).numpy() for f in got._fields})


def test_run_mh_matches_jax_in_law(chains):
    want, got = chains
    for r in (want, got):
        assert set(np.unique(r["pruned_counts"])) <= {1, 2, 3}
    share = [np.mean(r["pruned_counts"] == 3) for r in (want, got)]
    assert abs(share[0] - share[1]) <= SPLIT_SHARE_TOL, share
    flux = [r["pruned_fluxes"].sum(-1).mean() for r in (want, got)]
    assert abs(flux[1] - flux[0]) <= FLUX_RTOL * flux[0], flux
    assert abs(flux[1] - 4100.0) <= 0.1 * 4100.0, flux
    acc = [r["acc_rate"].mean() for r in (want, got)]
    assert abs(acc[0] - acc[1]) <= ACC_TOL, acc


def test_run_mh_shapes_and_dtypes_match_jax(chains):
    want, got = chains
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    K = (2000 - 1000) // 2
    assert got["locs"].shape == (16, K, 3, 2)
    assert (got["counts"] == 3).all()
    assert np.isfinite(got["fluxes"]).all()


def test_acc_rate_weights_burn_in_and_blocks_by_sweeps(monkeypatch):
    images, prior, model, kernel = _two_star(T=2)
    k = port_kernel(kernel)

    def fake(self, generator, ctx, counts, state):
        rate = 0.5 if self.num_iters == 7 else 0.25
        return state, torch.full(counts.shape[:-1], rate)

    monkeypatch.setattr(type(k), "run_from_state", fake)
    for total, burnin, every in ((20, 7, 3), (8, 0, 3), (7, 7, 1)):
        cfg = tmcmc.MCMCConfig(total, burnin, every, 500.0)
        res = tmcmc.run_mh(torch.Generator().manual_seed(0),
                           torch.tensor(images), port_prior(prior),
                           port_model(model), k, cfg)
        K = -(-(total - burnin) // every)
        assert res.locs.shape[1] == K == tmcmc.num_kept(cfg)
        want = (0.5 * burnin + 0.25 * K * every) / (burnin + K * every)
        np.testing.assert_allclose(res.acc_rate.numpy(), [want, want],
                                   rtol=1e-6)


def test_empty_start_sits_at_the_flux_floor():
    images, prior, model, kernel = _two_star(T=2)
    pk = port_kernel(kernel)
    _, counts, state = tmcmc.init_chain(
        torch.Generator().manual_seed(0), torch.tensor(images),
        port_prior(prior), port_model(model), pk)
    assert counts.tolist() == [[3], [3]]
    assert (state.fluxes == 100.0).all()  # fluxes_min, inside the support
    cfg = tmcmc.MCMCConfig(1, 0, 1, 500.0)
    res = tmcmc.run_mh(torch.Generator().manual_seed(0),
                       torch.tensor(images), port_prior(prior),
                       port_model(model), pk, cfg)
    # after one sweep at most one slot per chain has left the floor
    assert ((res.fluxes[:, 0] != 100.0).sum(-1) <= 1).all()
    assert (res.pruned_counts <= 1).all()


def test_pareto_prior_with_zero_fluxes_min_not_frozen():
    # JAX test_mcmc.py's regression: a floor below the Pareto support made
    # every acceptance ratio NaN; the floor clamps into the support
    from smcdet_tpu.inference.kernels import SingleComponentMH
    from smcdet_tpu.models.imaging import M71ImageModel
    from smcdet_tpu.models.priors import M71Prior

    prior = M71Prior(min_objects=0, max_objects=3, image_height=8,
                     image_width=8, pad=1.0, counts_rate=0.03,
                     flux_alpha=0.214, flux_lower=0.252, flux_upper=1804.0)
    model = M71ImageModel(
        image_height=8, image_width=8, background=865.0, adu_per_nmgy=856.0,
        psf_params=(1.51, 4.85, 1.32, 3.0, 0.09, 0.002), psf_radius=8,
        noise_additive=0.001, noise_multiplicative=1.94)
    image = model.sample(jax.random.key(0),
                         jnp.asarray([[4.0, 4.0], [0.0, 0.0], [0.0, 0.0]]),
                         jnp.asarray([300.0, 0.0, 0.0]))
    kernel = SingleComponentMH(
        num_iters=1, locs_stdev=jnp.float32(0.1),
        fluxes_stdev=jnp.float32(2.5), fluxes_min=jnp.float32(0.0),
        fluxes_max=jnp.float32(1804.0))
    pprior = port_prior(prior)
    _, _, state = tmcmc.init_chain(torch.Generator().manual_seed(1),
                                   torch.tensor(np.asarray(image))[None],
                                   pprior, port_model(model),
                                   port_kernel(kernel))
    assert torch.equal(state.fluxes,
                       torch.full_like(state.fluxes, 0.252))
    assert torch.isfinite(state.logprior).all()
    res = tmcmc.run_mh(torch.Generator().manual_seed(1),
                       torch.tensor(np.asarray(image))[None], pprior,
                       port_model(model), port_kernel(kernel),
                       tmcmc.MCMCConfig(1000, 500, 2, 0.7))
    assert float(res.acc_rate[0]) > 0.01, float(res.acc_rate[0])
    assert torch.isfinite(res.fluxes).all()
    vals, cnts = torch.unique(res.pruned_counts[0], return_counts=True)
    assert int(vals[cnts.argmax()]) >= 1


def test_mh_sampler_finds_the_two_stars():
    image, prior, model, _ = two_star_image()
    s = tmcmc.MHSampler(
        image=torch.tensor(np.asarray(image)), tile_dim=8,
        Prior=port_prior(prior), ImageModel=port_model(model),
        locs_stdev=0.25, fluxes_stdev=50.0, flux_detection_threshold=500.0,
        num_samples_total=1500, num_samples_burnin=500, keep_every_k=2,
        fluxes_min=100.0, fluxes_max=5000.0)
    assert not s.has_run
    r = s.run()
    assert r.locs.shape == (1, 500, 3, 2)
    assert 0.02 < float(r.acc_rate[0]) < 0.95
    pc = r.pruned_counts[0].numpy()
    vals, cnts = np.unique(pc, return_counts=True)
    assert vals[cnts.argmax()] in (2, 3)
    assert abs(float(r.pruned_fluxes.sum(-1).mean()) - 4100.0) < 410.0
    # every detectable sampled star sits near a true star
    locs = r.pruned_locs[0].numpy()
    active = np.arange(3)[None, :] < pc[:, None]
    truth = np.asarray([[2.0, 2.5], [5.5, 5.0]])
    d = np.linalg.norm(locs[active][:, None] - truth[None], axis=-1).min(-1)
    assert (d < 1.0).mean() > 0.9
    assert s.posterior_mean_count().shape == (1,)
    s.summarize()


def _tiny_mcmc_yaml(src, tmp_path, **overrides):
    """A copy of a suite config under ``tmp_path`` with a short chain."""
    import yaml

    with open(REPO / src) as f:
        raw = yaml.safe_load(f)
    raw["mcmc"] = {"num_samples_total": 24, "num_samples_burnin": 10,
                   "keep_every_k": 3, "locs_stdev": 0.1,
                   "fluxes_stdev": 2.5}
    raw["output_dir"] = str(tmp_path / "out")
    for k, v in overrides.items():
        raw[k] = v
    path = tmp_path / Path(src).name
    path.write_text(yaml.safe_dump(raw))
    return path


def test_runner_mcmc_artifacts_match_the_jax_runner(tmp_path):
    from smcdet_tpu.config import load_config as jload
    from smcdet_tpu.runner import run_experiment as jrun
    from smcdet_tpu_torch.config import load_config as tload
    from smcdet_tpu_torch.runner import load_results
    from smcdet_tpu_torch.runner import run_experiment as trun

    path = _tiny_mcmc_yaml("experiments/basic/config.yaml", tmp_path,
                           num_images=3, batch_size=2)
    jcfg, tcfg = jload(path), tload(path)
    jcfg.output_dir = str(tmp_path / "jax")
    jout = jrun(jcfg, method="mcmc", verbose=False)
    tout = trun(tcfg, method="mcmc", verbose=False, device="cpu")
    for b in range(2):
        want = np.load(Path(jout) / f"mcmc_batch{b:04d}.npz")
        got = np.load(Path(tout) / f"mcmc_batch{b:04d}.npz")
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].shape == want[k].shape, (b, k)
            assert got[k].dtype == want[k].dtype, (b, k)
    res = load_results(tout, "mcmc")
    assert res["image_index"].tolist() == [0, 1, 2]
    assert res["locs"].shape == (3, 5, 8, 2)
    manifest = json.loads(
        (Path(tout) / "mcmc_manifest_job0.json").read_text())
    assert manifest["method"] == "mcmc"
    assert [b["images"] for b in manifest["batches"]] == [[0, 2], [2, 3]]


def test_mcmc_cli_on_the_m71_fixture_with_tile_backgrounds(tmp_path):
    from smcdet_tpu_torch.run_experiment import main
    from smcdet_tpu_torch.runner import load_results

    suite = REPO / "experiments/m71"
    path = _tiny_mcmc_yaml(
        "experiments/m71/config.yaml", tmp_path, num_images=3, batch_size=3,
        data_path=str(suite / "data/m71/tiles.npz"),
        params_path=str(suite / "data/m71/params.yaml"))
    main([str(path), "--method", "mcmc", "--device", "cpu"])
    res = load_results(tmp_path / "out" / "m71", "mcmc")
    assert res["locs"].shape == (3, 5, 10, 2)
    assert np.isfinite(res["fluxes"]).all()
    assert (res["acc_rate"] > 0).all()
