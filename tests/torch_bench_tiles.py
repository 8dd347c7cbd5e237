"""Write the bench's tiles for the port: ``smcdet_tpu_torch/bench_tiles.npz``.

``bench.py`` simulates its M71 tiles with ``generate_images(jax.random.key(7),
...)``: 16 tiles for ``--quick`` and 332 for the full frame. Only JAX can
make that draw, and the port's bench (``smcdet_tpu_torch/bench.py``) runs
where there is no JAX, so the draw is made here once and committed:

    JAX_PLATFORMS=cpu python tests/torch_bench_tiles.py

The file holds ``images_<n>`` (float32 ``[n, 8, 8]``) and
``pruned_counts_<n>`` (int32 ``[n]``) for n = 16 and 332.
``tests/test_torch_bench.py`` holds the committed file to a fresh draw.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SIZES = (16, 332)
OUT = ROOT / "smcdet_tpu_torch" / "bench_tiles.npz"


def bench_tiles(sizes=SIZES):
    """``{"images_<n>", "pruned_counts_<n>"}`` of ``bench.py``'s draw at
    each size, as numpy arrays."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import bench
    from smcdet_tpu.models.simulate import generate_images

    out = {}
    for n in sizes:
        _, prior, model, _, _ = bench.build_problem(num_tiles=n)
        sim = generate_images(jax.random.key(7), prior, model,
                              flux_threshold=0.7, loc_threshold_lower=0.0,
                              loc_threshold_upper=float(model.width),
                              num_images=n)
        out[f"images_{n}"] = np.asarray(sim.images, dtype=np.float32)
        out[f"pruned_counts_{n}"] = np.asarray(sim.pruned_counts,
                                               dtype=np.int32)
    return out


def main():
    tiles = bench_tiles()
    np.savez_compressed(OUT, **tiles)
    print(f"wrote {OUT} ({OUT.stat().st_size} B): "
          + ", ".join(f"{k} {v.shape}" for k, v in tiles.items()))


if __name__ == "__main__":
    main()
