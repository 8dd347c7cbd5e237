"""CS-SMC over the m71 fixture with its generating hyperparameters (port of
``experiments/m71/run_smc_oracle.py``, without JAX):

    python -m smcdet_tpu_torch.studies.run_smc_oracle [--num-images N]
        [--device cuda]

The m71 suite infers with the hyperparameters fitted on the fixture's fit
patch (``params_path``), the honest real-data protocol. This run loads
``experiments/m71/config.yaml`` without that overlay, so the literal prior
and image-model values in the file, the fixture's generating ones, are used
(``load_config(apply_params=False)``): the gap between ``output/m71`` and
``output/m71oracle`` is what the hyperparameter fit costs. Score it with
``python -m smcdet_tpu_torch.analyze output/m71oracle --tiles
experiments/m71/data/m71/tiles.npz``. ``--device`` defaults to ``cuda`` and
is never swapped for another device.
"""

from __future__ import annotations

import argparse

__all__ = ["oracle_config", "main"]

NAME = "m71oracle"


def oracle_config(num_images=None, output_dir=None):
    """The m71 suite's config without the fitted-params overlay, named
    ``m71oracle``, its relative ``data_path`` resolved against the suite
    directory."""
    from smcdet_tpu_torch.config import load_config
    from smcdet_tpu_torch.studies.m71_fixture import M71

    cfg = load_config(M71 / "config.yaml", apply_params=False)
    cfg.name = NAME
    cfg.data_path = str(M71 / cfg.data_path)
    if num_images is not None:
        cfg.num_images = num_images
    if output_dir is not None:
        cfg.output_dir = str(output_dir)
    return cfg


def main(argv=None):
    import torch

    from smcdet_tpu_torch.run_experiment import _check_device
    from smcdet_tpu_torch.runner import run_experiment

    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.run_smc_oracle",
        description="CS-SMC over the m71 fixture under its generating "
                    "hyperparameters.")
    parser.add_argument("--num-images", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    _check_device(device)
    out = run_experiment(oracle_config(args.num_images), method="smc",
                         device=device)
    print(f"results in {out}")
    return out


if __name__ == "__main__":
    main()
