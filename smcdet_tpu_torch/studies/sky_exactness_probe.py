"""The fixture's sky-reconstruction error (port of
``experiments/m71/sky_exactness_probe.py``):

    python -m smcdet_tpu_torch.studies.sky_exactness_probe --data-dir D
        --out OUT.json

The fixture generates the frame's sky through the same nearest-grid
ALLSKY interpolation the reader uses (``make_fixture`` writes the grid and
the sky it rendered with; ``ingest.sdss.read_frame`` rebuilds the
background from the grid), so the pipeline's per-tile background equals
the generating sky up to the float32 round trip. This regenerates the
r-band's generating sky and compares it pixel by pixel with what the
reader makes of ``D``'s r frame.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from smcdet_tpu_torch.data_prep.make_fixture import (
    BANDS,
    CAMCOL,
    FIELD,
    GAINS,
    RBAND,
    RUN,
    generating_sky,
)
from smcdet_tpu_torch.ingest.sdss import read_frame

__all__ = ["sky_exactness", "main"]


def sky_exactness(data_dir):
    """The report for the fixture under ``data_dir``."""
    gen_sky_e = generating_sky(BANDS[RBAND])
    frame = (Path(data_dir) / "sdss" / str(RUN) / str(CAMCOL) / str(FIELD)
             / f"frame-r-{RUN:06d}-{CAMCOL}-{FIELD:04d}.fits")
    rd = np.asarray(read_frame(str(frame), float(GAINS[RBAND]))["background"])
    d = np.abs(rd - gen_sky_e)
    return {
        "frame": frame.name,
        "sky_range_electrons": [
            float(gen_sky_e.min()), float(gen_sky_e.max())
        ],
        "max_abs_err_electrons": float(d.max()),
        "max_rel_err": float((d / np.abs(gen_sky_e)).max()),
        "conclusion": (
            "reader background == generating sky to float32 round-trip "
            "precision; frame-level sky structure contributes ~0 to the "
            "m71 coverage residual by construction"
        ),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m smcdet_tpu_torch.studies.sky_exactness_probe",
        description="The reader's sky against the fixture's generating sky.")
    parser.add_argument("--data-dir", required=True,
                        help="a fixture written by data_prep.make_fixture")
    parser.add_argument("--out", default="output/m71/sky_exactness.json")
    args = parser.parse_args(argv)
    report = sky_exactness(args.data_dir)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
