"""Headline benchmark of the port: single-component particle updates per
second on the M71 tile workload (port of ``bench.py``).

    python -m smcdet_tpu_torch.bench [--quick] [--streaming [--pool=P]]
                                     [--device cuda|cpu]

The workload is ``bench.py``'s (the reference's M71 configuration): 8x8
tiles, the SDSS PSF with beta = 3 and patch radius 8, truncated-Pareto
fluxes, count strata 0..6, 100 MH sweeps per SMC iteration, adaptive
tempering to an ESS of half of N, systematic resampling. One update is one
single-component MH proposal for one catalog: tiles x strata x catalogs per
stratum x sweeps x SMC iterations / wall seconds. On a CUDA card every
mutation is a launch of kernel K1 (``ops/mh_sweep.py``).

- The full frame (default): 332 tiles, N = 4096, in chunks of 14 tiles
  sorted by summed pixel value, the last chunk padded with the last tile
  (only real tiles are billed). ``--quick``: 16 tiles, N = 2048, one chunk.
  A warm-up run on the first chunk builds the kernels first.
- ``--streaming``: the swap-on-converge tile pool
  (``inference/streaming.py``) at ``--pool`` slots (28; at most 16 with
  ``--quick``), warmed up on ``pool + 2`` tiles so that a swap happens,
  billed by executed slot-steps: steps x pool x strata x N x sweeps.

The tiles are ``bench.py``'s own draw (``generate_images`` with JAX key 7),
which only JAX can make: ``tests/torch_bench_tiles.py`` writes them into
``bench_tiles.npz`` beside this module. Prints one JSON line with the keys
of ``bench.py``'s (and ``--streaming`` adds ``mean_tile_iters`` and
``slot_steps``). The default device is ``cuda``; without a card the module
raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

REFERENCE_UPDATES_PER_SEC = 6.0e6  # BASELINE.md derived estimate (RTX 2080 Ti)
REFERENCE_TILES_PER_SEC = 1.0 / 40.0  # the reference's 20-60 s a tile
TILE = 8
TILES_PATH = Path(__file__).with_name("bench_tiles.npz")
COMMITTED_SIZES = (16, 332)

__all__ = ["BenchTiles", "build_problem", "load_tiles", "sorted_chunks",
           "streaming", "main"]


class BenchTiles(NamedTuple):
    images: torch.Tensor  # [T, 8, 8] on the CPU
    pruned_counts: torch.Tensor  # [T] detectable in-tile stars


def load_tiles(num_tiles: int) -> BenchTiles:
    """The first ``num_tiles`` tiles of ``bench.py``'s draw: the committed
    draw of the smallest committed size that holds them (the 16-tile draw
    is the 332-tile draw's first 16 tiles). A missing file raises."""
    if not TILES_PATH.exists():
        raise FileNotFoundError(
            f"{TILES_PATH} not found: write it with JAX_PLATFORMS=cpu python "
            "tests/torch_bench_tiles.py")
    size = next((n for n in COMMITTED_SIZES if n >= num_tiles), None)
    if size is None:
        raise ValueError(f"{num_tiles} tiles: the committed draws hold "
                         f"{max(COMMITTED_SIZES)}")
    with np.load(TILES_PATH) as data:
        images = data[f"images_{size}"][:num_tiles]
        counts = data[f"pruned_counts_{size}"][:num_tiles]
    return BenchTiles(torch.from_numpy(images), torch.from_numpy(counts))


def build_problem(device, num_tiles=16, num_catalogs=2048, mh_steps=100,
                  max_smc_iters=100, tiles="bench"):
    """``bench.py``'s problem on ``device``: ``(tiles, prior, model, kernel,
    cfg)``, the tiles on the CPU. ``tiles="bench"`` loads ``bench.py``'s
    draw (``load_tiles``); ``tiles="simulate"`` simulates them with the
    port's ``generate_images`` on a CPU generator seeded 7 (the same on
    every machine, another draw than the JAX package's)."""
    from smcdet_tpu_torch.inference.kernels import SingleComponentMH
    from smcdet_tpu_torch.inference.smc import SMCConfig
    from smcdet_tpu_torch.models.imaging import M71ImageModel
    from smcdet_tpu_torch.models.priors import M71Prior
    from smcdet_tpu_torch.models.simulate import generate_images

    # the fitted M71 hyperparameters (BASELINE.md)
    def prior_on(dev):
        return M71Prior(min_objects=0, max_objects=6, counts_rate=0.03,
                        image_height=TILE, image_width=TILE,
                        flux_alpha=0.214, flux_lower=0.252,
                        flux_upper=1804.679, pad=1.0, device=dev)

    def model_on(dev):
        return M71ImageModel(
            image_height=TILE, image_width=TILE, background=179.0,
            adu_per_nmgy=155.0,
            psf_params=(1.33, 4.82, 3.15, 3.0, 0.06, 0.002), psf_radius=8,
            noise_additive=0.0, noise_multiplicative=1.94, device=dev,
        )

    if tiles == "bench":
        sim = load_tiles(num_tiles)
    elif tiles == "simulate":
        sim = generate_images(torch.Generator().manual_seed(7),
                              prior_on("cpu"), model_on("cpu"),
                              flux_threshold=0.7, loc_threshold_lower=0.0,
                              loc_threshold_upper=float(TILE),
                              num_images=num_tiles)
    else:
        raise ValueError(f"tiles={tiles!r}: 'bench' or 'simulate'")
    kernel = SingleComponentMH(num_iters=mh_steps, locs_stdev=0.25,
                               fluxes_stdev=5.0, fluxes_min=0.252,
                               fluxes_max=1804.679, device=device)
    cfg = SMCConfig(num_catalogs=num_catalogs, ess_threshold_prop=0.5,
                    resample_method="systematic",
                    max_smc_iters=max_smc_iters,
                    flux_detection_threshold=0.7)
    return sim, prior_on(device), model_on(device), kernel, cfg


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is "
                           "False); pass --device cpu for the plain version")
    return device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _summary(res):
    """What the bench keeps of a result: small per-tile tensors (the big
    catalog buffers are freed when the result goes)."""
    return {"temperature": res.temperature, "ess": res.ess,
            "log_z": res.log_normalizing_constant,
            "weight_sum": res.weights.sum(-1),
            "mean_count": (res.weights * res.pruned_counts).sum(-1)}


def _check(out, num_catalogs):
    """Every tile at temperature 1 (as ``bench.py`` asserts), finite log Z,
    weights summing to 1; returns the least final ESS over N."""
    t = out["temperature"]
    if float((t - 1.0).abs().max()) >= 1e-6:
        raise AssertionError(f"a tile ended below temperature 1: {t}")
    if not bool(torch.isfinite(out["log_z"]).all()):
        raise AssertionError("a tile's log Z is not finite")
    err = float((out["weight_sum"] - 1.0).abs().max())
    if err > 1e-5:
        raise AssertionError(f"weights sum to 1 within {err}")
    return float(out["ess"].min()) / num_catalogs


def _record(label, num_tiles, num_catalogs, C, mh_steps, elapsed, updates,
            min_ess, device):
    return {
        "metric": "single-component particle updates/sec/card "
                  f"({label}: {num_tiles} tiles, N={num_catalogs}/stratum, "
                  f"C={C}, {mh_steps} MH sweeps/iter, {elapsed:.2f}s wall, "
                  f"{_device_name(device)})",
        "value": updates / elapsed,
        "unit": "updates/sec",
        "vs_baseline": updates / elapsed / REFERENCE_UPDATES_PER_SEC,
        "tiles_per_sec_to_target_ess": num_tiles / elapsed,
        "min_final_ess_prop": min_ess,
        "reference_tiles_per_sec": REFERENCE_TILES_PER_SEC,
    }


def sorted_chunks(device="cuda", num_tiles=332, num_catalogs=4096,
                  mh_steps=100, chunk=14, label=None):
    """``bench.py``'s main: ``run_csmc`` over chunks of ``chunk`` tiles
    sorted by summed pixel value, one generator seeded ``1 + c`` per chunk,
    a synchronise after each, after a warm-up run on the first chunk.
    Returns ``(record, info)``: the JSON record, and the run's chunks,
    SMC iterations per chunk, wall seconds and per-tile posterior-mean
    pruned count and truth in the caller's order."""
    from smcdet_tpu_torch.inference.smc import run_csmc

    device = _device(device)
    tiles, prior, model, kernel, cfg = build_problem(
        device, num_tiles, num_catalogs, mh_steps)
    C = prior.num_counts
    images = tiles.images.to(device)
    order = torch.argsort(images.sum((1, 2)), stable=True)
    images = images[order]
    n_chunks = -(-num_tiles // chunk)
    pad = n_chunks * chunk - num_tiles
    if pad:
        images = torch.cat([images, images[-1:].expand(
            (pad,) + images.shape[1:])])

    warm = run_csmc(_generator(device, 0), images[:chunk], prior, model,
                    kernel, cfg)
    _sync(device)
    del warm
    parts = []
    start = time.perf_counter()
    for c in range(n_chunks):
        res = run_csmc(_generator(device, 1 + c),
                       images[c * chunk:(c + 1) * chunk], prior, model,
                       kernel, cfg)
        _sync(device)
        parts.append((res.num_iters, _summary(res)))
        del res  # the catalogs go before the next chunk
    elapsed = time.perf_counter() - start

    updates = 0
    for c, (num_iters, _) in enumerate(parts):
        real = chunk if c < n_chunks - 1 else chunk - pad
        updates += real * C * num_catalogs * mh_steps * num_iters
    out = {k: torch.cat([p[k] for _, p in parts])[:num_tiles][
        torch.argsort(order)] for k in parts[0][1]}
    min_ess = _check(out, num_catalogs)
    quick = num_tiles <= 16
    record = _record(label or ("M71 quick config" if quick
                               else "M71 full-frame north star"),
                     num_tiles, num_catalogs, C, mh_steps, elapsed, updates,
                     min_ess, device)
    return record, {"chunks": n_chunks, "chunk": chunk,
                    "num_iters": [n for n, _ in parts], "elapsed": elapsed,
                    "updates": updates,
                    "mean_count": out["mean_count"].cpu(),
                    "truth": tiles.pruned_counts}


def streaming(device="cuda", num_tiles=332, num_catalogs=4096, mh_steps=100,
              pool=28):
    """``bench.py``'s ``main_streaming``: the tile pool at ``pool`` slots,
    warmed up on ``pool + 2`` tiles, then timed on all tiles in the caller's
    order. Returns ``(record, info)`` as ``sorted_chunks``, ``info`` with
    the pool's ``steps``, ``pool`` and ``per_tile_iters``."""
    from smcdet_tpu_torch.inference.streaming import run_csmc_streaming

    device = _device(device)
    tiles, prior, model, kernel, cfg = build_problem(
        device, num_tiles, num_catalogs, mh_steps)
    C = prior.num_counts
    images = tiles.images.to(device)

    warm = run_csmc_streaming(_generator(device, 0), images[:pool + 2],
                              prior, model, kernel, cfg, pool=pool)
    _sync(device)
    del warm
    start = time.perf_counter()
    res, info = run_csmc_streaming(_generator(device, 1), images, prior,
                                   model, kernel, cfg, pool=pool,
                                   return_info=True)
    _sync(device)
    elapsed = time.perf_counter() - start
    out = _summary(res)
    del res
    min_ess = _check(out, num_catalogs)
    updates = info["steps"] * info["pool"] * C * num_catalogs * mh_steps
    record = _record(f"M71 full-frame streaming pool={pool}", num_tiles,
                     num_catalogs, C, mh_steps, elapsed, updates, min_ess,
                     device)
    record["mean_tile_iters"] = float(info["per_tile_iters"].mean())
    record["slot_steps"] = int(info["steps"] * info["pool"])
    return record, {**info, "elapsed": elapsed, "updates": updates,
                    "mean_count": out["mean_count"].cpu(),
                    "truth": tiles.pruned_counts}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.bench",
        description="single-component updates/s of CS-SMC on the M71 tiles")
    parser.add_argument("--quick", action="store_true",
                        help="16 tiles at N = 2048 (default: 332 at 4096)")
    parser.add_argument("--streaming", action="store_true",
                        help="the swap-on-converge tile pool")
    parser.add_argument("--pool", type=int, default=28,
                        help="pool slots with --streaming (at most 16 with "
                             "--quick)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    num_tiles = 16 if args.quick else 332
    num_catalogs = 2048 if args.quick else 4096
    if args.streaming:
        record, _ = streaming(args.device, num_tiles, num_catalogs, 100,
                              min(args.pool, 16) if args.quick else args.pool)
    else:
        record, _ = sorted_chunks(args.device, num_tiles, num_catalogs, 100,
                                  16 if args.quick else 14)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
