"""Semi-synthetic M71 tiles: the real per-tile catalogs of the m71 fixture
rendered through the fitted M71 image model over the real per-tile sky
backgrounds (port of ``experiments/m71semisynthetic/generate_images.py``).

The fixture (``tiles.npz`` beside the suite's ``params_path``, written by
``experiments/m71/prepare_data.py``) holds three catalogs a tile, chosen by
``catalog``:

- ``padded`` (``padded_*``): the stars within the 4-px padded window, so
  boundary tiles carry their neighbours' spill-over as the real pixels do;
- ``intile`` (``true_*``): only the in-tile stars (the no-spill ablation);
- ``reach`` (``reach_*``): every star whose radius-8 render reaches the
  tile (the full photon budget).

The rate is rendered on ``device``; the Gaussian noise comes from a CPU
generator seeded with the config's ``seed``, so the tiles are the same on
every machine. It is the generate step of the m71semisynthetic suites:

    python -m smcdet_tpu_torch.run_experiment experiments/m71semisynthetic \\
        [--config config_nospill.yaml] --generate [--catalog intile]

writes ``{output_dir}/{name}/tiles.npz`` with the keys of the JAX script's
file, which ``run_experiment`` then reads with its backgrounds.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from smcdet_tpu_torch.config import ExperimentConfig, build_image_model

__all__ = ["CATALOGS", "fixture_path", "renders_fixture", "render_tiles"]

# --catalog -> the fixture's array prefix
CATALOGS = {"padded": "padded", "intile": "true", "reach": "reach"}
# the fixture's arrays copied to the rendered file
_KEPT = ("checkerboard", "true_counts", "true_locs", "true_fluxes",
         "padded_counts", "padded_locs", "padded_fluxes", "tile_index")


def renders_fixture(cfg: ExperimentConfig) -> bool:
    """Whether a suite's tiles are the fixture's catalogs rendered anew:
    per-tile backgrounds, fitted params and no tiles of its own (a
    simulation has no background maps)."""
    return (cfg.data_path is None and cfg.use_tile_backgrounds
            and cfg.params_path is not None)


def fixture_path(cfg: ExperimentConfig) -> Path:
    """The fixture the suite's fitted params were made with: ``tiles.npz``
    beside ``params_path``."""
    return Path(cfg.params_path).parent / "tiles.npz"


def render_tiles(cfg: ExperimentConfig, catalog: str = "padded",
                 num_images: int | None = None, device="cuda",
                 fixture=None) -> dict:
    """Render the first ``num_images`` (default all) tiles of the fixture
    (default ``fixture_path(cfg)``) from its ``catalog`` stars with the
    config's (fitted) image model and each tile's background map. Returns
    a dict of numpy arrays with the keys of the JAX script's
    ``tiles.npz``."""
    if catalog not in CATALOGS:
        raise ValueError(f"catalog must be one of {sorted(CATALOGS)}, got "
                         f"{catalog!r}")
    path = Path(fixture) if fixture is not None else fixture_path(cfg)
    if not path.exists():
        raise FileNotFoundError(
            f"{path} missing: the m71 fixture is written by "
            "experiments/m71/prepare_data.py")
    device = torch.device(device)
    with np.load(path) as m71:
        data = {k: m71[k] for k in m71.files}
    n = data["images"].shape[0]
    if num_images is not None:
        n = min(n, num_images)
    src = CATALOGS[catalog]

    def on_device(name):
        return torch.as_tensor(data[name][:n], dtype=torch.float32,
                               device=device)

    backgrounds = on_device("background")
    model = build_image_model(cfg.image_model, device).with_background(
        backgrounds)
    images = model.sample(torch.Generator().manual_seed(cfg.seed),
                          on_device(f"{src}_locs"),
                          on_device(f"{src}_fluxes"))
    out = {"images": images.cpu().numpy(),
           "background": backgrounds.cpu().numpy()}
    out.update({k: data[k][:n] for k in _KEPT})
    return out
