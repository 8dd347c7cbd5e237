"""Streaming CS-SMC over a persistent tile pool (port of
``smcdet_tpu/inference/streaming.py``).

``run_csmc_chunked`` runs a chunk of tiles until every one of them is at
temperature 1, so each tile of a chunk is billed the chunk's longest
tempering schedule. Here a fixed pool of ``P`` tile slots steps together
through ``csmc_step``, and the host finalizes a tile as soon as it sees the
tile done, then initializes the next tile into the freed slot.

- **The pipeline.** The host dispatches step k+1 before it reads state k's
  temperatures. On the card the read is a copy into a pinned host buffer,
  issued with ``non_blocking=True`` before step k+1 and waited on through a
  ``torch.cuda.Event`` after it, so a plain ``.cpu()`` does not wait for
  step k+1 on the shared stream. Step k+1 builds new tensors and writes
  none of state k's, so state k stays readable while k+1 runs. Each K1/K2
  launch reads its parameters back to the host (``ops/mh_sweep.py``), so
  the dispatch of step k+1 itself returns only after its resample and
  re-render have run on the card.
- **Exactness.** ``csmc_step`` freezes tiles at temperature 1, and each
  tile is finalized from the first state in which it was seen done, so the
  speculative step in flight never reaches a result. A tile at
  ``max_smc_iters`` with temperature below 1 is finalized from the state at
  exactly the cap, as ``run_csmc``'s loop bound.
- **Random draws.** The pool's steps draw from the caller's stateful
  ``torch.Generator``. A finalize and an insert draw from a generator of
  their own, seeded from the caller's seed and the tile's index
  (``_fork``), so they never shift the pool's stream: with ``pool >= T``
  the steps are ``run_csmc``'s, draw for draw. The JAX package forks keys
  the same way but by slot for a finalize (``fold_in(key, 10_000 +
  slot)``, on the pool's current key) and by tile for an insert
  (``fold_in(key, 1_000_000 + tile)``), so the two packages' draws differ
  (they would in any case). The result depends only on the inputs, the
  generator's seed and the pool size.
- **Slots.** A slot's sub-state is the ``[s:s+1]`` view of each leaf of the
  port's ``SMCState``; an insert joins a fresh ``[1, ...]`` state into new
  tensors on the tile axis (``_put``), so no earlier state is written.

The JAX package's ``_measured_pool_check`` (an AOT compile probe of XLA's
allocation) has no counterpart: the pool is sized by the memory model
``max_tiles_per_chunk``. The pool state carries no rate cache, so holding
state k and state k+1 at once adds only their catalogs.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from smcdet_tpu_torch.inference.smc import (
    SMCConfig,
    SMCResult,
    SMCState,
    _per_tile_background,
    csmc_finalize,
    csmc_init,
    csmc_step,
    default_budget_bytes,
    join_results,
    max_tiles_per_chunk,
)
from smcdet_tpu_torch.parallel.sharding import shard_runs

__all__ = ["run_csmc_streaming"]

# the salts of a tile's finalize and insert generators (``_fork``)
_FINALIZE_SALT = 10_000_000
_INSERT_SALT = 1_000_000

# the fields of SMCState indexed by tile
_TILE_FIELDS = ("locs", "fluxes", "temperature", "temperature_prev", "loglik",
                "weights", "log_z", "ess", "acc_rate")


def _pad_tiles(x, n: int):
    """Axis 0 padded to ``n`` with copies of the last tile (or cut to
    ``n``)."""
    if n <= x.shape[0]:
        return x[:n]
    return torch.cat([x, x[-1:].expand((n - x.shape[0],) + x.shape[1:])])


def _slot_substate(state: SMCState, slot: int) -> SMCState:
    """Slot ``slot``'s ``[1, ...]`` sub-state: views of the pool's
    leaves."""
    return state._replace(**{f: getattr(state, f)[slot:slot + 1]
                             for f in _TILE_FIELDS})


def _put(x, slot: int, new):
    """``x`` with row ``slot`` replaced by the one-row ``new``: a new
    tensor, ``x`` is not written. Built by slicing, so no index tensor is
    copied to the card (that copy would wait for the step in flight)."""
    return torch.cat([x[:slot], new, x[slot + 1:]])


def _insert_substate(state: SMCState, sub: SMCState, slot: int) -> SMCState:
    """``state`` with pool slot ``slot`` replaced by the ``[1, ...]``
    sub-state ``sub`` (new tensors; ``state``'s are not written)."""
    return state._replace(**{f: _put(getattr(state, f), slot, getattr(sub, f))
                             for f in _TILE_FIELDS})


def _fork(generator, salt: int) -> torch.Generator:
    """A generator on ``generator``'s device seeded from its seed and
    ``salt`` alone (the JAX package's ``fold_in``), whatever it has drawn
    so far."""
    words = np.random.SeedSequence(
        [generator.initial_seed(), salt]).generate_state(2, dtype=np.uint32)
    fork = torch.Generator(device=generator.device)
    fork.manual_seed((int(words[0]) << 31) | (int(words[1]) >> 1))
    return fork


def _model_for(model, bg):
    return model if bg is None else model.with_background(bg)


class _FlagReader:
    """State k's temperatures on the host, read while the card runs step
    k+1: ``start`` issues the copy before the dispatch, ``read`` waits for
    the copy alone after it. On the CPU the read is a plain copy."""

    def __init__(self, pool: int, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.host = torch.empty(pool, pin_memory=True)
            self.event = torch.cuda.Event()
        self.temperature = None

    def start(self, temperature):
        if self.cuda:
            self.host.copy_(temperature, non_blocking=True)
            self.event.record()
        else:
            self.temperature = temperature

    def read(self) -> np.ndarray:
        if self.cuda:
            self.event.synchronize()
            return self.host.numpy().copy()
        return self.temperature.numpy().copy()


def run_csmc_streaming(generator, images, prior, model, kernel,
                       cfg: SMCConfig, pool: int | None = None,
                       budget_bytes: int | None = None,
                       return_info: bool = False, devices=None):
    """CS-SMC over ``images [T, h, w]`` with a streaming pool of tile slots.

    ``pool``: the number of resident slots (default: ``max_tiles_per_chunk``
    within ``budget_bytes``, by default ``default_budget_bytes`` of the
    images' device), capped at T. The model's background may be a per-tile
    map ``[T, ..., h, w]``; it follows its tile through the swaps. Returns an
    ``SMCResult`` stacked in the caller's tile order, with ``num_iters`` the
    largest per-tile count; with ``return_info=True`` also
    ``{"per_tile_iters", "steps", "pool"}``: the executed slot-steps are
    ``steps * pool``.

    ``fixed_schedule`` and ``record_history`` raise ``ValueError`` (both
    index a global iteration number that swapped-in tiles do not share).
    ``devices``: a list of devices over which the tiles are split
    (``parallel/sharding.py``; default: the images' device alone); each
    range runs a pool of its own (``pool`` divided among them, or each
    sized by its device's budget) and the results are joined in tile order
    on the images' device; with several devices the info's ``steps`` is
    the longest shard's, ``pool`` the slots in all, and ``shards`` each
    shard's info.
    """
    if cfg.fixed_schedule is not None or cfg.record_history:
        raise ValueError(
            "run_csmc_streaming requires adaptive tempering and "
            "record_history=False (both index a global iteration number "
            "that swapped-in tiles don't share)")
    if devices is None:
        devices = [images.device]
    shard_pool = None if pool is None else max(1, pool // len(devices))
    runs = shard_runs(
        lambda gen, imgs, pr, mdl, ker, tiles: _run_pool(
            gen, imgs, pr, mdl, ker, cfg, shard_pool, budget_bytes,
            tiles.start),
        devices, generator, images, prior, model, kernel)
    result = join_results([r for r, _ in runs], device=images.device)
    if len(runs) == 1:
        info = runs[0][1]
    else:
        infos = [i for _, i in runs]
        info = {"per_tile_iters": np.concatenate([i["per_tile_iters"]
                                                  for i in infos]),
                "steps": max(i["steps"] for i in infos),
                "pool": sum(i["pool"] for i in infos), "shards": infos}
    return (result, info) if return_info else result


def _run_pool(generator, images, prior, model, kernel, cfg: SMCConfig,
              pool, budget_bytes, tile_offset: int):
    """``run_csmc_streaming``'s pool on one device: ``(result, info)``.
    ``tile_offset`` is the index of the first tile in the caller's whole
    batch: the finalize and insert generators are forked by that index."""
    T, H, W = images.shape
    if pool is None:
        if budget_bytes is None:
            budget_bytes = default_budget_bytes(images.device)
        pool = max_tiles_per_chunk(prior, cfg.num_catalogs, H * W,
                                   budget_bytes)
    P = min(pool, max(T, 1))

    bg = _per_tile_background(model.background, T)
    pool_images = _pad_tiles(images, P)
    pool_bg = None if bg is None else _pad_tiles(bg, P)
    state = csmc_init(generator, pool_images, prior,
                      _model_for(model, pool_bg), cfg)

    # the tile in each slot (-1: a pad slot or a spent one, outside all
    # accounting; pad slots repeat the last tile)
    slot_tile = [t if t < T else -1 for t in range(P)]
    insert_step = np.zeros(T, dtype=np.int64)  # dispatch index at insertion
    iters = np.zeros(T, dtype=np.int64)
    results: dict[int, SMCResult] = {}
    next_tile = min(P, T)
    flags = _FlagReader(P, images.device)
    in_flight, d_inflight = state, 0  # state 0: init's iteration-0 temper

    while len(results) < T:
        state, d = in_flight, d_inflight
        flags.start(state.temperature)
        # the speculative step first, so the flag copy overlaps it (the
        # profiler ranges name the scheduler's stages: PERF.md, layers)
        with record_function("stream.step"):
            in_flight = csmc_step(pool_images, prior,
                                  _model_for(model, pool_bg), kernel, cfg,
                                  state)
        d_inflight = d + 1
        with record_function("stream.flags"):
            temps = flags.read()

        for s in range(P):
            t = slot_tile[s]
            if t < 0:
                continue
            if temps[s] < 1.0 and d - insert_step[t] < cfg.max_smc_iters:
                continue
            # done or at the cap: finalized from THIS state, exactly
            # d - insert_step[t] iterations, never from the step in flight
            iters[t] = d - insert_step[t]
            with record_function("stream.finalize"):
                results[t] = csmc_finalize(
                    prior, model, cfg, _slot_substate(state, s)._replace(
                        generator=_fork(generator, _FINALIZE_SALT
                                        + tile_offset + t)))
            if next_tile < T:
                t_new = next_tile
                bg1 = None if bg is None else bg[t_new:t_new + 1]
                with record_function("stream.insert"):
                    sub = csmc_init(_fork(generator,
                                          _INSERT_SALT + tile_offset + t_new),
                                    images[t_new:t_new + 1], prior,
                                    _model_for(model, bg1), cfg)
                    in_flight = _insert_substate(in_flight, sub, s)
                    pool_images = _put(pool_images, s,
                                       images[t_new:t_new + 1])
                    if bg is not None:
                        pool_bg = _put(pool_bg, s, bg1)
                slot_tile[s] = t_new
                # the insert lands in the state in flight: its first step
                # is dispatch d_inflight + 1
                insert_step[t_new] = d_inflight
                next_tile += 1
            else:
                slot_tile[s] = -1  # spent: rides on frozen
    del state, in_flight, pool_images, pool_bg

    out = {}
    for f in SMCResult._fields:
        if f == "history":
            out[f] = None
        elif f == "num_iters":
            out[f] = int(iters.max()) if T else 0
        else:
            out[f] = torch.cat([getattr(results[t], f) for t in range(T)])
    return SMCResult(**out), {"per_tile_iters": iters, "steps": d_inflight,
                              "pool": P}

