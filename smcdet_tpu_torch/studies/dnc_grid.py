"""The divideandconquer suite on a larger image: its configs derived at run
time from the committed ones.

    python -m smcdet_tpu_torch.studies.dnc_grid OUT [--dim 32]
        [--output-dir output/dnc4] [--mala LOCS FLUXES]

writes into ``OUT`` three YAML files for ``dim x dim`` images (default 32,
a 4x4 grid of the committed 8x8 tiles), each one a committed file of
``experiments/divideandconquer/`` with the image size changed:

- ``config.yaml``: ``config.yaml`` with ``prior.image_height/width`` and
  ``image_model.image_height/width`` set to ``dim``, nothing else changed.
  The tree then merges at 16x8, 16x16, 32x16 and 32x32 with 16, 32, 64 and
  128 slots (no ``max_objects_cap``, as committed).
- ``config_singletile.yaml``: ``config_singletile.yaml`` with the same four
  sizes, ``sampler.tile_dim = dim``, ``sampler.num_catalogs`` = the tree's
  total per image (tiles x 512, the committed file's rule) and
  ``prior.max_objects`` scaled with the image's area (8 on 16x16, 32 on
  32x32: about 2.6 times the Poisson mean, as committed), reading the
  tree's tiles.
- with ``--mala``, ``config_mala.yaml``: ``config.yaml``'s copy with
  ``kernel.kind: mala`` and the steps ``(locs_stdev, fluxes_stdev)``,
  reading the tree's tiles and writing under ``{output_dir}/mala``.

``output_dir`` of every file is ``--output-dir`` (the committed 16x16
suite's ``output/`` stays apart); the tree's tiles are
``{output_dir}/divideandconquer/tiles.npz`` (``run_experiment --generate``,
or the JAX package's draw staged there). Then, as for the committed suite:

    python -m smcdet_tpu_torch.run_experiment OUT/config.yaml
    python -m smcdet_tpu_torch.run_experiment OUT/config_singletile.yaml
    python -m smcdet_tpu_torch.studies.compare_singletile \\
        --config OUT/config.yaml
"""

from __future__ import annotations

import argparse
from pathlib import Path

import yaml

from smcdet_tpu_torch.studies import REPO

__all__ = ["COMMITTED", "derived_configs", "main"]

COMMITTED = REPO / "experiments" / "divideandconquer"


def _load(name):
    with open(COMMITTED / name) as f:
        return yaml.safe_load(f)


def _resize(raw, dim):
    for part in ("prior", "image_model"):
        raw[part]["image_height"] = raw[part]["image_width"] = dim


def derived_configs(out_dir, dim: int = 32, output_dir="output/dnc4",
                    mala_steps=None) -> dict:
    """Write the derived configs into ``out_dir``; returns their paths by
    name (``"dnc"``, ``"singletile"`` and, with ``mala_steps``,
    ``"mala"``)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tree = _load("config.yaml")
    tile = tree["sampler"]["tile_dim"]
    if dim % tile or (dim // tile) & (dim // tile - 1):
        raise ValueError(f"dim {dim} is not a power-of-two multiple of the "
                         f"tile side {tile}")
    _resize(tree, dim)
    tree["output_dir"] = str(output_dir)
    single = _load("config_singletile.yaml")
    committed_dim = single["image_model"]["image_height"]
    _resize(single, dim)
    single["output_dir"] = str(output_dir)
    single["data_path"] = str(Path(output_dir) / tree["name"] / "tiles.npz")
    single["sampler"]["tile_dim"] = dim
    single["sampler"]["num_catalogs"] = (
        tree["sampler"]["num_catalogs"] * (dim // tile) ** 2)
    single["prior"]["max_objects"] = round(
        single["prior"]["max_objects"] * (dim / committed_dim) ** 2)
    paths = {"dnc": out_dir / "config.yaml",
             "singletile": out_dir / "config_singletile.yaml"}
    files = {"dnc": tree, "singletile": single}
    if mala_steps is not None:
        mala = _load("config.yaml")
        _resize(mala, dim)
        mala["output_dir"] = str(Path(output_dir) / "mala")
        mala["data_path"] = single["data_path"]
        mala["kernel"].update(kind="mala", locs_stdev=float(mala_steps[0]),
                              fluxes_stdev=float(mala_steps[1]))
        paths["mala"] = out_dir / "config_mala.yaml"
        files["mala"] = mala
    for name, raw in files.items():
        with open(paths[name], "w") as f:
            yaml.safe_dump(raw, f, sort_keys=False)
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.dnc_grid",
        description="Write the divideandconquer configs for dim x dim "
                    "images.")
    parser.add_argument("out_dir")
    parser.add_argument("--dim", type=int, default=32)
    parser.add_argument("--output-dir", default="output/dnc4")
    parser.add_argument("--mala", type=float, nargs=2, default=None,
                        metavar=("LOCS_STDEV", "FLUXES_STDEV"))
    args = parser.parse_args(argv)
    for name, path in derived_configs(args.out_dir, args.dim,
                                      args.output_dir, args.mala).items():
        print(f"{name}: {path}")


if __name__ == "__main__":
    main()
