"""Batch experiment runner with resume (port of ``smcdet_tpu/runner.py``).

Simulate or load tiles, run inference per batch on ``device`` and write one
``{output_dir}/{name}/smc_batch{b:04d}.npz`` per batch, with the keys,
shapes and dtypes of the JAX runner's, so either package's
``load_results`` (and ``experiments/analyze.py``) reads either's output. A
job skips batches whose file exists (resume) and takes every
``num_jobs``-th batch from ``job_index`` (sharding; in a process group,
by default the process's rank in the group, ``parallel/distributed.py``).

Two pipelines for ``method="smc"``: chunked CS-SMC over the batch's
tiles, or, with ``aggregation.enabled``, the per-image pipeline (tile the
image, CS-SMC on its tiles, divide-and-conquer aggregation), which also
takes per-tile background maps (``use_tile_backgrounds``); with
``sampler.streaming`` a batch's tiles run through the swap-on-converge tile
pool (``inference/streaming.py``) instead. ``method="mcmc"`` runs the
saturated MH chain baseline (``inference/mcmc.py:run_mh``, one chain per
tile, per-tile backgrounds whatever ``aggregation`` says) and writes
``mcmc_batch{b:04d}.npz``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from smcdet_tpu_torch.config import (
    ExperimentConfig,
    build_image_model,
    build_kernel,
    build_prior,
)
from smcdet_tpu_torch.inference.smc import SMCConfig, run_csmc_chunked
from smcdet_tpu_torch.inference.streaming import run_csmc_streaming
from smcdet_tpu_torch.models.simulate import generate_images

__all__ = ["batch_generator", "simulate_tiles", "mcmc_chain",
           "run_experiment", "load_results"]


def batch_generator(seed: int, batch: int, device, *more) -> torch.Generator:
    """The generator of batch ``batch`` (and of its image and replicate
    ``*more`` in the per-image pipeline): seeded from these integers alone,
    so a resumed or sharded job reproduces the batch."""
    words = np.random.SeedSequence([seed, batch, *more]).generate_state(
        2, dtype=np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(words[0]) << 31) | (int(words[1]) >> 1))
    return g


def simulate_tiles(cfg: ExperimentConfig):
    """Simulate the experiment's tiles from its own generative model, on a
    CPU generator seeded with ``cfg.seed``, so they are the same on every
    machine. They differ from the JAX package's simulation of the same
    config, whose random stream is JAX's. Returns a dict of numpy arrays
    (the keys of the JAX runner's ``tiles.npz``)."""
    prior = build_prior(cfg.prior, "cpu")
    model = build_image_model(cfg.image_model, "cpu")
    sim = generate_images(
        torch.Generator().manual_seed(cfg.seed),
        prior,
        model,
        flux_threshold=cfg.sampler.flux_detection_threshold,
        loc_threshold_lower=0.0,
        loc_threshold_upper=float(cfg.image_model.image_height),
        num_images=cfg.num_images,
    )
    return {
        "images": sim.images.numpy(),
        "true_counts": sim.pruned_counts.numpy(),
        "true_locs": sim.pruned_locs.numpy(),
        "true_fluxes": sim.pruned_fluxes.numpy(),
        "unpruned_counts": sim.unpruned_counts.numpy(),
        "unpruned_locs": sim.unpruned_locs.numpy(),
        "unpruned_fluxes": sim.unpruned_fluxes.numpy(),
    }


def _load_tiles(cfg: ExperimentConfig):
    """Tiles come from (in order): an explicit ``data_path``, a staged
    ``tiles.npz`` under the output directory, or a fresh simulation."""
    path = (
        Path(cfg.data_path)
        if cfg.data_path is not None
        else Path(cfg.output_dir) / cfg.name / "tiles.npz"
    )
    if path.exists():
        data = np.load(path)
        return {k: data[k] for k in data.files}
    if cfg.data_path is not None:
        raise FileNotFoundError(
            f"{path} not found: run the experiment's data-prep step first"
        )
    if cfg.use_tile_backgrounds:
        # a simulation has no background maps: the suite renders the m71
        # fixture's catalogs (smcdet_tpu_torch/semisynthetic.py)
        raise FileNotFoundError(
            f"{path} not found: write it with python -m "
            "smcdet_tpu_torch.run_experiment <suite> --generate")
    return simulate_tiles(cfg)


def _check_supported(cfg: ExperimentConfig, method: str):
    if method not in ("smc", "mcmc"):
        raise ValueError(f"unknown method {method!r}")
    if method == "mcmc" or cfg.aggregation.enabled:
        return
    if cfg.use_tile_backgrounds:
        raise ValueError(
            "per-tile backgrounds require the per-image pipeline "
            "(aggregation.enabled: true)")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _aggregate_runner(cfg: ExperimentConfig, prior, model, kernel,
                      smc_cfg: SMCConfig, device):
    """The per-image pipeline: tile each image, run CS-SMC on its tiles,
    then aggregate them (the JAX runner's ``_make_smc_aggregate_runner``).
    Images run one at a time; ``sampler.replicates`` independent runs of an
    image pool into one particle set, their log Z by log-mean-exp. Returns
    ``run(batch, imgs, bkgs)`` giving the JAX ``AggregatedResult`` fields
    as numpy arrays stacked over the images."""
    from smcdet_tpu_torch.inference.aggregate import Aggregate, expand_prior
    from smcdet_tpu_torch.inference.smc import SMCSampler, tile_image

    # the config describes the whole image; the tile sampler needs
    # tile-level objects (the count rate rescaled to the padded tile area)
    td = cfg.sampler.tile_dim
    tile_prior = expand_prior(prior, td, td, prior.max_objects)
    tile_model = model.with_shape(td, td)
    replicates = cfg.sampler.replicates
    agg_cfg = cfg.aggregation

    def process_once(batch, i, r, img, bkg):
        gen = batch_generator(cfg.seed, batch, device, i, r)
        model_i = tile_model
        if bkg is not None:
            # the image's background map tiled like the image: a bare
            # [h, w] map for a single tile, else [T, 1, 1, h, w]
            bmap = tile_image(bkg, img.shape[0] // td, img.shape[1] // td,
                              td)
            model_i = tile_model.with_background(
                bmap[0] if bmap.shape[0] == 1 else bmap[:, None, None])
        sampler = SMCSampler(
            image=img, tile_dim=td, Prior=tile_prior, ImageModel=model_i,
            MutationKernel=kernel, num_catalogs=smc_cfg.num_catalogs,
            ess_threshold_prop=smc_cfg.ess_threshold_prop,
            resample_method=smc_cfg.resample_method,
            flux_detection_threshold=smc_cfg.flux_detection_threshold,
            max_smc_iters=smc_cfg.max_smc_iters,
            relocate_sweeps=smc_cfg.relocate_sweeps,
            pair_sweeps=smc_cfg.pair_sweeps,
        )
        sampler.run(gen)
        agg = Aggregate.from_smc(
            sampler, resample_method=agg_cfg.resample_method,
            ess_threshold_prop=agg_cfg.ess_threshold_prop,
            max_smc_iters=agg_cfg.max_smc_iters,
            max_objects_cap=agg_cfg.max_objects_cap,
            relocate_sweeps=agg_cfg.relocate_sweeps,
            pair_sweeps=agg_cfg.pair_sweeps,
        )
        agg.run(gen)
        return {
            "counts": agg.state.counts[0, 0],
            "locs": agg.state.locs[0, 0],
            "fluxes": agg.state.fluxes[0, 0],
            "pruned_counts": agg.pruned_counts[0, 0],
            "pruned_locs": agg.pruned_locs[0, 0],
            "pruned_fluxes": agg.pruned_fluxes[0, 0],
            "weights": agg.state.weights[0, 0],
            "log_normalizing_constant": agg.state.log_z[0, 0],
        }

    def process(batch, i, img, bkg):
        runs = [process_once(batch, i, r, img, bkg)
                for r in range(replicates)]
        if replicates == 1:
            return runs[0]
        out = {k: torch.cat([o[k] for o in runs])
               for k in runs[0] if k != "log_normalizing_constant"}
        out["weights"] = out["weights"] / float(replicates)
        out["log_normalizing_constant"] = torch.logsumexp(
            torch.stack([o["log_normalizing_constant"] for o in runs]),
            dim=0) - np.log(float(replicates))
        return out

    def run(batch, imgs, bkgs=None):
        outs, per_image_s = [], []
        for i in range(imgs.shape[0]):
            _sync(device)
            start = time.perf_counter()
            out = process(batch, i, imgs[i],
                          None if bkgs is None else bkgs[i])
            _sync(device)
            per_image_s.append(time.perf_counter() - start)
            outs.append(out)
        stacked = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
                   for k in outs[0]}
        stacked["runtime_per_image"] = np.asarray(per_image_s,
                                                  dtype=np.float32)
        return {k: stacked[k] for k in sorted(stacked)}

    return run


def mcmc_chain(cfg: ExperimentConfig, kernel, device):
    """The MH chain baseline's kernel and settings (the JAX runner's
    ``method="mcmc"`` branch): a copy of the config's mutation kernel at
    one sweep a step with the ``mcmc`` proposal scales (MALA's step sizes
    under ``kind: mala``), and the ``MCMCConfig``."""
    from smcdet_tpu_torch.inference.mcmc import MCMCConfig, with_iters

    mc = cfg.mcmc
    chain = with_iters(kernel, 1)
    scales = (("locs_step", "fluxes_step") if cfg.kernel.kind == "mala"
              else ("locs_stdev", "fluxes_stdev"))
    for name, v in zip(scales, (mc.locs_stdev, mc.fluxes_stdev)):
        setattr(chain, name, torch.tensor(v, dtype=torch.float32,
                                          device=device))
    return chain, MCMCConfig(
        num_samples_total=mc.num_samples_total,
        num_samples_burnin=mc.num_samples_burnin,
        keep_every_k=mc.keep_every_k,
        flux_detection_threshold=cfg.sampler.flux_detection_threshold,
    )


def _mcmc_runner(cfg: ExperimentConfig, prior, model, kernel, device):
    """One chain per tile (``run_mh``); per-tile backgrounds ride as ``[T,
    1, h, w]``. Returns ``run(batch, imgs, bkgs)`` giving ``MCMCResult``'s
    fields as numpy arrays."""
    from smcdet_tpu_torch.inference.mcmc import run_mh

    chain, mc_cfg = mcmc_chain(cfg, kernel, device)

    def run(batch, imgs, bkgs=None):
        m = model if bkgs is None else model.with_background(bkgs[:, None])
        res = run_mh(batch_generator(cfg.seed, batch, device), imgs, prior,
                     m, chain, mc_cfg)
        return {f: _to_numpy(getattr(res, f)) for f in res._fields}

    return run


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v, dtype=np.int32)  # num_iters, as the JAX runner


def run_experiment(cfg: ExperimentConfig, method: str = "smc",
                   job_index: int = 0, num_jobs: int = 1,
                   verbose: bool = True, device="cuda"):
    """Run the experiment over its images in batches of ``cfg.batch_size``
    on ``device``, writing ``{output_dir}/{name}/{method}_batch{b:04d}.npz``
    and ``{method}_manifest_job{job_index}.json``; returns the output
    directory.

    A ragged last batch is padded with copies of its last image and the
    results sliced back. Existing batch files are skipped (resume). On the
    card the kernel library is built and loaded before the first batch's
    clock starts. In a process group of more than one process
    (``parallel/distributed.py``) with no explicit ``num_jobs``, each
    process takes the shard of its rank (``host_shard``).
    """
    from smcdet_tpu_torch.parallel.distributed import host_shard

    _check_supported(cfg, method)
    job_index, num_jobs = host_shard(job_index, num_jobs)
    if not 0 <= job_index < num_jobs:
        raise ValueError(f"job_index {job_index} not in [0, {num_jobs})")
    device = torch.device(device)
    out_dir = Path(cfg.output_dir) / cfg.name
    out_dir.mkdir(parents=True, exist_ok=True)

    tiles = _load_tiles(cfg)
    # cfg.num_images caps file-loaded tile sets too
    images = torch.as_tensor(tiles["images"][: cfg.num_images],
                             dtype=torch.float32)
    num_images = images.shape[0]
    num_batches = -(-num_images // cfg.batch_size)
    backgrounds = None
    if cfg.use_tile_backgrounds:
        if "background" not in tiles:
            raise ValueError(
                "use_tile_backgrounds=True but the tiles artifact has no "
                "'background' maps: run the experiment's prepare step")
        backgrounds = torch.as_tensor(
            tiles["background"][: cfg.num_images], dtype=torch.float32)

    prior = build_prior(cfg.prior, device)
    model = build_image_model(cfg.image_model, device)
    kernel = build_kernel(cfg.kernel, device)
    s = cfg.sampler
    smc_cfg = SMCConfig(
        num_catalogs=s.num_catalogs,
        ess_threshold_prop=s.ess_threshold_prop,
        resample_method=s.resample_method,
        max_smc_iters=s.max_smc_iters,
        flux_detection_threshold=s.flux_detection_threshold,
        relocate_sweeps=s.relocate_sweeps,
        pair_sweeps=s.pair_sweeps,
    )
    if method == "mcmc":
        run = _mcmc_runner(cfg, prior, model, kernel, device)
    elif cfg.aggregation.enabled:
        run = _aggregate_runner(cfg, prior, model, kernel, smc_cfg, device)
    else:
        def run(batch, imgs, bkgs=None):
            gen = batch_generator(cfg.seed, batch, device)
            if s.streaming:
                res = run_csmc_streaming(gen, imgs, prior, model, kernel,
                                         smc_cfg,
                                         pool=s.streaming_pool or None)
            else:
                res = run_csmc_chunked(gen, imgs, prior, model, kernel,
                                       smc_cfg, sort_tiles=s.sort_tiles)
            return {f: _to_numpy(getattr(res, f)) for f in res._fields
                    if getattr(res, f) is not None}
    if device.type == "cuda":
        from smcdet_tpu_torch import _build

        _build.load_library()  # the nvcc build is set-up, not batch time

    manifest = {"config": cfg.name, "method": method, "batches": []}
    for b in range(num_batches):
        if b % num_jobs != job_index:
            continue
        path = out_dir / f"{method}_batch{b:04d}.npz"
        if path.exists():
            if verbose:
                print(f"batch {b}: exists, skipping (resume)")
            continue
        lo, hi = b * cfg.batch_size, min((b + 1) * cfg.batch_size,
                                         num_images)
        n_real = hi - lo
        imgs = _pad_batch(images[lo:hi], cfg.batch_size).to(device)
        bkgs = None if backgrounds is None else _pad_batch(
            backgrounds[lo:hi], cfg.batch_size).to(device)

        _sync(device)
        start = time.perf_counter()
        result = run(b, imgs, bkgs)
        _sync(device)
        runtime = time.perf_counter() - start

        arrays = {f: (v[:n_real] if v.ndim >= 1
                      and v.shape[0] == cfg.batch_size else v)
                  for f, v in result.items()}
        arrays["runtime"] = np.asarray(runtime)
        arrays["image_index"] = np.arange(lo, hi)
        np.savez_compressed(path, **arrays)
        manifest["batches"].append(
            {"batch": b, "images": [lo, hi], "runtime_s": runtime}
        )
        if verbose:
            print(f"batch {b}: images [{lo}, {hi}) in {runtime:.2f}s")

    with open(out_dir / f"{method}_manifest_job{job_index}.json", "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


def _pad_batch(x, size: int):
    """Pad a ragged batch to ``size`` with copies of its last entry."""
    if x.shape[0] < size:
        x = torch.cat([x, x[-1:].expand((size - x.shape[0],)
                                         + x.shape[1:])])
    return x


def load_results(out_dir, method: str = "smc"):
    """Concatenate all batch artifacts of ``method`` under ``out_dir``."""
    paths = sorted(Path(out_dir).glob(f"{method}_batch*.npz"))
    if not paths:
        raise FileNotFoundError(f"no {method} batches under {out_dir}")
    batches = [np.load(p) for p in paths]
    keys = [k for k in batches[0].files if k != "runtime"]
    out = {}
    for k in keys:
        vals = [b[k] for b in batches]
        # per-batch scalars (num_iters) stack; per-image arrays concatenate
        out[k] = (np.stack(vals) if vals[0].ndim == 0
                  else np.concatenate(vals, axis=0))
    out["runtime"] = np.asarray([float(b["runtime"]) for b in batches])
    return out
