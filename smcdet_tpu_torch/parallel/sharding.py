"""The tile axis of the samplers split over a list of devices (port of
``smcdet_tpu/parallel/sharding.py``).

In the JAX package the tile axis of every particle array is sharded over a
1-D device mesh and one SPMD program runs the whole batch. Per-tile CS-SMC
is independent, so here each device runs the samplers on its own
contiguous range of tiles (``tile_shards``) and the caller joins the
results in tile order on the images' device. The shards run one after
another from the host: a list of devices places each range's tensors, it
adds no concurrency. The number of tiles must be divisible by the number
of devices, as in JAX.

- A shard on the caller's generator's device draws from that generator,
  after the shards before it; a shard on another device draws from a
  generator of its own, seeded from one draw of the caller's generator
  (``shard_generator``), so that each call and each aggregation level
  gets a stream of its own. One device on the generator's device is the
  run on that generator, draw for draw: the samplers call every run
  through here, with the images' device as the default list.
- ``to_device`` copies the prior, image model and kernel onto a shard's
  device (the objects themselves when they are there already).
- ``level_split`` splits one aggregation level's tile grid over the
  devices, by JAX's rule (``Aggregate._level_sharding``), applied to the
  level's merged pairs, so that each pair's two children sit on one
  device.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

__all__ = ["as_device", "tile_shards", "shard_generator", "to_device",
           "shard_runs", "level_split"]

# the salt of a shard's own generator (``shard_generator``)
_SHARD_SALT = 20_000_000


def as_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (``"cuda"`` is the
    current card); a CUDA device without a card raises ``RuntimeError``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA card is available "
                               "(torch.cuda.is_available() is False)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def tile_shards(devices, num_tiles: int):
    """``[(device, slice of the tile axis)]``: ``num_tiles`` split into
    ``len(devices)`` equal contiguous ranges, in order. Raises
    ``ValueError`` when the count does not divide."""
    devices = [as_device(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("devices: an empty list")
    if num_tiles % n:
        raise ValueError(f"number of tiles {num_tiles} must be divisible "
                         f"by the number of devices {n}")
    size = num_tiles // n
    return [(d, slice(i * size, (i + 1) * size))
            for i, d in enumerate(devices)]


def shard_generator(generator: torch.Generator, device, index: int,
                    level: int = 0) -> torch.Generator:
    """The generator of shard ``index`` (at aggregation level ``level``) on
    ``device``: ``generator`` itself on its own device, else one on
    ``device`` seeded from one draw of ``generator`` (which advances it)
    salted with ``index`` and ``level``."""
    device = as_device(device)
    if as_device(generator.device) == device:
        return generator
    draw = int(torch.randint(2**62, (1,), generator=generator,
                             device=generator.device))
    words = np.random.SeedSequence(
        [draw, _SHARD_SALT + index, level]).generate_state(2,
                                                           dtype=np.uint32)
    fork = torch.Generator(device=device)
    fork.manual_seed((int(words[0]) << 31) | (int(words[1]) >> 1))
    return fork


def to_device(obj, device):
    """``obj`` with every tensor it holds on ``device``: tensors, tuples
    (named ones too), and the port's own objects (priors, image models,
    PSFs, kernels), copied where a tensor moved; ``obj`` itself where
    nothing moved, and anything else as it is."""
    device = as_device(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, torch.device):
        return obj if as_device(obj) == device else device
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        moved = {f: to_device(getattr(obj, f), device) for f in obj._fields}
        if all(moved[f] is getattr(obj, f) for f in obj._fields):
            return obj
        return obj._replace(**moved)
    if isinstance(obj, (list, tuple)):
        moved = [to_device(v, device) for v in obj]
        if all(m is v for m, v in zip(moved, obj)):
            return obj
        return type(obj)(moved)
    if isinstance(obj, dict):
        moved = {k: to_device(v, device) for k, v in obj.items()}
        if all(moved[k] is v for k, v in obj.items()):
            return obj
        return moved
    if (hasattr(obj, "__dict__") and not isinstance(obj, type)
            and type(obj).__module__.startswith("smcdet_tpu_torch.")):
        moved = {k: to_device(v, device) for k, v in vars(obj).items()}
        if all(moved[k] is v for k, v in vars(obj).items()):
            return obj
        out = copy.copy(obj)
        for k, v in moved.items():
            setattr(out, k, v)
        return out
    return obj


def shard_runs(run, devices, generator, images, prior, model, kernel):
    """``run(generator, images, prior, model, kernel, tiles)`` on each
    device's range of the tiles ``images [T, h, w]`` (``tiles``: the range's
    slice), one after another: the range's images and per-tile background,
    and the prior, model and kernel, on its device, from
    ``shard_generator``'s generator. Returns the runs' outputs in tile
    order; one device runs the whole batch with the caller's model."""
    from smcdet_tpu_torch.inference.smc import _per_tile_background

    T = images.shape[0]
    shards = tile_shards(devices, T)
    bg = (None if len(shards) == 1
          else _per_tile_background(model.background, T))
    out = []
    for i, (dev, tiles) in enumerate(shards):
        mdl = model if bg is None else model.with_background(bg[tiles])
        out.append(run(shard_generator(generator, dev, i),
                       images[tiles].to(dev), to_device(prior, dev),
                       to_device(mdl, dev), to_device(kernel, dev), tiles))
    return out


def level_split(num_devices: int, th: int, tw: int) -> tuple[int, int]:
    """``(a, b)``: the ``th x tw`` grid split into ``a`` row blocks and
    ``b`` column blocks, ``a * b <= num_devices``, with as many devices
    used as divide it (JAX's ``_level_sharding``: ``a`` divides ``th`` and
    the device count, ``b`` divides ``tw`` and what is left; leftover
    devices stay idle where JAX replicates)."""
    best_a, best_b = 1, 1
    for a in range(1, num_devices + 1):
        if num_devices % a or th % a:
            continue
        for b in range(1, num_devices // a + 1):
            if (num_devices // a) % b or tw % b:
                continue
            if a * b > best_a * best_b:
                best_a, best_b = a, b
    return best_a, best_b
