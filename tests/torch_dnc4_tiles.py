"""Write ``tests/data/divideandconquer32_tiles.npz``: the JAX package's draw
of the divideandconquer suite on 32x32 images (a 4x4 grid of 8x8 tiles),
which ``tests/torch_synthetic_suites.py --dnc4`` and ``chip_smoke.py``
``[dnc4]`` run on the card, where JAX is not installed:

    JAX_PLATFORMS=cpu python tests/torch_dnc4_tiles.py [--num-images 100]

The config is ``smcdet_tpu_torch.studies.dnc_grid``'s derived one (the
committed ``config.yaml`` with the image 32x32, seed 5); the draw is the JAX
runner's ``simulate_tiles`` on it, as ``generate_images.py`` draws the
committed suite's tiles. A few hundred KB.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / "tests" / "data" / "divideandconquer32_tiles.npz"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-images", type=int, default=100)
    parser.add_argument("--out", default=str(OUT))
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from smcdet_tpu import config as jcfg
    from smcdet_tpu.runner import simulate_tiles
    from smcdet_tpu_torch.studies.dnc_grid import derived_configs

    with tempfile.TemporaryDirectory() as tmp:
        cfg = jcfg.load_config(derived_configs(tmp, 32)["dnc"])
    cfg.num_images = args.num_images
    tiles = simulate_tiles(cfg)
    np.savez_compressed(args.out, **tiles)
    print(f"saved {tiles['images'].shape[0]} images "
          f"{tiles['images'].shape[1:]} to {args.out}; true counts "
          f"{np.bincount(tiles['true_counts']).tolist()}")


if __name__ == "__main__":
    main()
