"""Sampler-state checkpointing (port of ``smcdet_tpu/utils/checkpoint.py``).

The runner's resilience is batch-granular result files; this module
snapshots a whole sampler state — an ``SMCResult``, an aggregation state or
raw particle tensors — to one ``.npz``. A state is a ``NamedTuple`` or a
dict whose leaves are tensors, numbers or ``None``, nested to any depth;
each leaf is stored under its dotted field name (``history.temperature``),
so a file reads without the code that wrote it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree"]


def _items(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return list(tree.items())
    return None


def _flatten(tree, prefix=""):
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for name, value in items:
        if "." in str(name):
            raise ValueError(f"field name {name!r} holds a '.'")
        out.update(_flatten(value, f"{prefix}{name}."))
    return out


def save_pytree(path, tree):
    """Save a ``NamedTuple`` / dict of tensors. ``path`` gains a ``.npz``
    suffix; ``None`` leaves are left out. Returns the path written."""
    path = Path(path).with_suffix(".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for name, leaf in _flatten(tree).items():
        if leaf is None:
            continue
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arrays[name.rstrip(".")] = np.asarray(leaf)
    np.savez_compressed(path, **arrays)
    return path


def _rebuild(like, data, prefix, device):
    items = _items(like)
    if items is None:
        name = prefix.rstrip(".")
        if name not in data.files:
            return None
        value = data[name]
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(value).to(device)
        if isinstance(like, (int, float, bool)):
            return type(like)(value)
        return torch.from_numpy(value).to(device) if value.ndim else (
            value.item())
    fields = {str(k): _rebuild(v, data, f"{prefix}{k}.", device)
              for k, v in items}
    if isinstance(like, dict):
        return fields
    return type(like)(**fields)


def load_pytree(path, like, device="cuda"):
    """Load what ``save_pytree`` wrote into the structure of ``like`` (a
    ``NamedTuple`` / dict of the same fields; its leaf values are ignored
    but for their kind), tensors on ``device``."""
    path = Path(path).with_suffix(".npz")
    with np.load(path) as data:
        return _rebuild(like, data, "", torch.device(device))
