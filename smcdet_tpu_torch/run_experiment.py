"""Run an experiment suite through the port (the CLI of
``experiments/common.py``, without JAX):

    python -m smcdet_tpu_torch.run_experiment experiments/basic/config.yaml \\
        [--num-images N] [--job-index i --num-jobs n] [--device cuda]
    python -m smcdet_tpu_torch.run_experiment experiments/cells \\
        --config config.yaml --generate
    python -m smcdet_tpu_torch.run_experiment experiments/m71 --method mcmc

The experiment is a config file, or a suite directory with ``--config``
naming the file in it (default ``config.yaml``); a relative ``data_path``
that does not exist from the working directory is read from the suite
directory (``experiments/m71/config.yaml`` reads
``experiments/m71/data/m71/tiles.npz``). ``--generate`` writes the
simulated tiles to ``{output_dir}/{name}/tiles.npz`` instead of running;
for a suite with per-tile backgrounds and no tiles of its own (the
m71semisynthetic configs) it renders the m71 fixture's ``--catalog`` stars
on ``--device`` instead (``smcdet_tpu_torch/semisynthetic.py``):

    python -m smcdet_tpu_torch.run_experiment experiments/m71semisynthetic \\
        --config config_reach.yaml --generate --catalog reach

``--method mcmc`` runs the saturated MH chain baseline (one chain per tile,
the config's ``mcmc`` settings) instead of CS-SMC.

``--distributed`` joins the process group named by the environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; gloo) before
the run, and each process then takes the batches of its rank; it raises
when the environment names no group. Two job processes on one card:

    MASTER_ADDR=localhost MASTER_PORT=29511 WORLD_SIZE=2 RANK=0 \
        python -m smcdet_tpu_torch.run_experiment experiments/basic \
        --distributed &
    MASTER_ADDR=localhost MASTER_PORT=29511 WORLD_SIZE=2 RANK=1 \
        python -m smcdet_tpu_torch.run_experiment experiments/basic \
        --distributed
``--device`` defaults to ``cuda`` and is never swapped for another device:
without a CUDA card, pass ``--device cpu`` to run the plain PyTorch
versions of the kernels.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from smcdet_tpu_torch.config import load_config


def _config_path(experiment: str, config: str | None) -> Path:
    path = Path(experiment)
    if path.is_dir():
        return path / (config or "config.yaml")
    if config is not None:
        raise SystemExit("--config names a file in a suite directory; give "
                         "the directory, not a config file")
    return path


def load_suite_config(experiment: str, config: str | None = None):
    """The config of a suite (a config file, or a suite directory and the
    file in it), its relative ``data_path`` and ``params_path`` resolved
    against the suite directory when they do not exist from the working
    directory (the JAX experiment scripts run from there)."""
    path = _config_path(experiment, config)
    cfg = load_config(path)
    for name in ("data_path", "params_path"):
        value = getattr(cfg, name)
        if value is not None and not Path(value).exists():
            local = path.parent / value
            if local.exists():
                setattr(cfg, name, str(local))
    return cfg


def _check_device(device):
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available "
                         "(torch.cuda.is_available() is False)")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.run_experiment",
        description="Run an experiment suite (CS-SMC, and the aggregation "
                    "when the config enables it, or the MH chain baseline) "
                    "with the PyTorch port.")
    parser.add_argument("experiment",
                        help="config YAML, or a suite directory")
    parser.add_argument("--config", default=None,
                        help="config file in the suite directory (default "
                             "config.yaml)")
    parser.add_argument("--num-images", type=int, default=None)
    parser.add_argument("--job-index", type=int, default=0)
    parser.add_argument("--num-jobs", type=int, default=1)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--method", default="smc", choices=("smc", "mcmc"),
                        help="CS-SMC (default) or the MH chain baseline")
    parser.add_argument("--generate", action="store_true",
                        help="write the simulated (or, for the "
                             "m71semisynthetic suites, rendered) tiles.npz "
                             "and exit")
    parser.add_argument("--distributed", action="store_true",
                        help="join the process group named by MASTER_ADDR "
                             "/ MASTER_PORT / WORLD_SIZE / RANK (gloo); each "
                             "process then runs the batches of its rank")
    parser.add_argument("--catalog", default=None,
                        choices=("padded", "intile", "reach"),
                        help="with --generate on an m71semisynthetic suite: "
                             "the fixture catalog to render (default "
                             "padded)")
    args = parser.parse_args(argv)

    cfg = load_suite_config(args.experiment, args.config)
    if args.num_images is not None:
        cfg.num_images = args.num_images
    device = torch.device(args.device)
    if args.generate:
        from smcdet_tpu_torch import semisynthetic
        from smcdet_tpu_torch.runner import simulate_tiles

        if semisynthetic.renders_fixture(cfg):
            _check_device(device)
            tiles = semisynthetic.render_tiles(
                cfg, args.catalog or "padded", cfg.num_images, device)
        elif args.catalog is not None:
            raise SystemExit("--catalog applies to the m71semisynthetic "
                             "suites only")
        else:
            tiles = simulate_tiles(cfg)
        out_dir = Path(cfg.output_dir) / cfg.name
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / "tiles.npz"
        np.savez_compressed(path, **tiles)
        print(f"saved {tiles['images'].shape[0]} tiles to {path}")
        return

    _check_device(device)
    from smcdet_tpu_torch.runner import run_experiment

    if args.distributed:
        from smcdet_tpu_torch.parallel.distributed import (
            initialize_distributed,
        )

        initialize_distributed(require=True)
    try:
        out = run_experiment(cfg, method=args.method,
                             job_index=args.job_index,
                             num_jobs=args.num_jobs, device=device)
    finally:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    print(f"results in {out}")


if __name__ == "__main__":
    main()
