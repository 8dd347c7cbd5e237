"""Batch experiment runner with resume (port of ``smcdet_tpu/runner.py``,
chunked CS-SMC path).

Simulate or load tiles, run CS-SMC per batch on ``device`` and write one
``{output_dir}/{name}/smc_batch{b:04d}.npz`` per batch, with the keys,
shapes and dtypes of the JAX runner's, so either package's
``load_results`` (and ``experiments/analyze.py``) reads either's output. A
job skips batches whose file exists (resume) and takes every
``num_jobs``-th batch from ``job_index`` (sharding). Aggregation, the
streaming pool and the MCMC baseline are not ported yet and raise.
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
from smcdet_tpu_torch.models.simulate import generate_images

__all__ = ["batch_generator", "simulate_tiles", "run_experiment",
           "load_results"]


def batch_generator(seed: int, batch: int, device) -> torch.Generator:
    """The generator of batch ``batch``: seeded from ``(seed, batch)``
    alone, so a resumed or sharded job reproduces the batch."""
    words = np.random.SeedSequence([seed, batch]).generate_state(
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
    prior = build_prior(cfg.prior)
    model = build_image_model(cfg.image_model)
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
    return simulate_tiles(cfg)


def _check_supported(cfg: ExperimentConfig, method: str):
    if method == "mcmc":
        raise NotImplementedError(
            "method 'mcmc' is not ported yet (ROADMAP item 10: baselines)")
    if method != "smc":
        raise ValueError(f"unknown method {method!r}")
    if cfg.aggregation.enabled:
        raise NotImplementedError(
            "aggregation is not ported yet (ROADMAP item 9; it needs "
            "kernel K3, the bridge-target sweep)")
    if cfg.sampler.streaming:
        raise NotImplementedError(
            "the streaming tile pool is not ported yet (ROADMAP item 11)")
    if cfg.use_tile_backgrounds:
        raise ValueError(
            "per-tile backgrounds require the per-image pipeline "
            "(aggregation.enabled: true)")


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v, dtype=np.int32)  # num_iters, as the JAX runner


def run_experiment(cfg: ExperimentConfig, method: str = "smc",
                   job_index: int = 0, num_jobs: int = 1,
                   verbose: bool = True, device="cuda"):
    """Run CS-SMC over the experiment's images in batches of
    ``cfg.batch_size`` on ``device``, writing
    ``{output_dir}/{name}/smc_batch{b:04d}.npz`` and
    ``smc_manifest_job{job_index}.json``; returns the output directory.

    A ragged last batch is padded with copies of its last image and the
    results sliced back. Existing batch files are skipped (resume).
    """
    _check_supported(cfg, method)
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
        imgs = images[lo:hi]
        if n_real < cfg.batch_size:
            pad = imgs[-1:].expand((cfg.batch_size - n_real,)
                                   + imgs.shape[1:])
            imgs = torch.cat([imgs, pad])
        imgs = imgs.to(device)

        if device.type == "cuda":
            torch.cuda.synchronize(device)
        start = time.perf_counter()
        result = run_csmc_chunked(batch_generator(cfg.seed, b, device), imgs,
                                  prior, model, kernel, smc_cfg,
                                  sort_tiles=s.sort_tiles)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        runtime = time.perf_counter() - start

        arrays = {}
        for f in result._fields:
            v = getattr(result, f)
            if v is None:
                continue
            v = _to_numpy(v)
            arrays[f] = (v[:n_real] if v.ndim >= 1
                         and v.shape[0] == cfg.batch_size else v)
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
