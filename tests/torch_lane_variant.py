"""A copy of this checkout's kernel package with other lane counts per
particle, to time against this checkout's with
``tests/torch_kernel_compare.py --parent OUT``:

    python3 tests/torch_lane_variant.py OUT [--mh-8x8 L] \\
        [--k3 bridge16x8=L bridge16x16=L] \\
        [--k4 8x8=L 16x16=L bridge16x8=L bridge16x16=L]

writes ``OUT/smcdet_tpu_torch`` (the package is all that the comparison
reads from an earlier checkout) with the 8x8 MH lanes ``kLanes8x8`` of
``csrc/mh_sweep_k2.cu`` (K1's and K2's 8x8 kinds: compare with ``--kernel
K1 K2``), K3's ``kLanesBridge*`` (``csrc/mh_sweep_k3.cu``: ``--kernel K3``)
and K4's ``kLanes*`` (``csrc/mala_sweep_k4.cu``) set as asked, and
``ops/mala_sweep.py:K4_LANES`` set to match, so that the copy's plain
version sums in its kernel's lane order (the plain MH version sums with
``.sum``, whatever K3's lanes). It fails if a constant is not where it
expects it. ``k3_source_lanes`` and ``k4_source_lanes`` read K3's and K4's
constants; ``K4_LANES`` must repeat K4's.
"""

from __future__ import annotations

import argparse
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# K3's lane constants by joined tile
K3_TARGETS = {"bridge16x8": ("kLanesBridge16x8", (16, 8)),
              "bridge16x16": ("kLanesBridge16x16", (16, 16))}
# K4's lane constants and their K4_LANES keys
K4_TARGETS = {"8x8": ("kLanes8x8", ((8, 8), False)),
              "16x16": ("kLanes16x16", ((16, 16), False)),
              "bridge16x8": ("kLanesBridge16x8", ((16, 8), True)),
              "bridge16x16": ("kLanesBridge16x16", ((16, 16), True))}


def _constants(text: str) -> dict:
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (kLanes\w*) = (\d+);", text)}


def k4_source_lanes(pkg: Path = ROOT / "smcdet_tpu_torch") -> dict:
    """K4's lanes per particle as ``csrc/mala_sweep_k4.cu`` sets them, keyed
    as ``ops/mala_sweep.py:K4_LANES``."""
    found = _constants((pkg / "csrc" / "mala_sweep_k4.cu").read_text())
    return {key: found[name] for name, key in K4_TARGETS.values()}


def k3_source_lanes(pkg: Path = ROOT / "smcdet_tpu_torch") -> dict:
    """K3's lanes per particle as ``csrc/mh_sweep_k3.cu`` sets them, keyed
    by joined tile ``(height, width)``."""
    found = _constants((pkg / "csrc" / "mh_sweep_k3.cu").read_text())
    return {key: found[name] for name, key in K3_TARGETS.values()}


def _set_constant(text: str, name: str, value: int) -> str:
    out, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};",
                     text)
    if n != 1:
        raise ValueError(f"constant {name} not found once")
    return out


def write_variant(out: Path, mh_8x8=None, k4=None, k3=None) -> Path:
    """Copy ``smcdet_tpu_torch`` into ``out`` with the 8x8 MH lanes
    ``mh_8x8``, K3's ``k3`` and K4's ``k4`` (``{target: lanes}``, targets
    as in ``K3_TARGETS`` and ``K4_TARGETS``); returns the copy's package
    directory."""
    pkg = out / "smcdet_tpu_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(ROOT / "smcdet_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    if mh_8x8 is not None:
        src = pkg / "csrc" / "mh_sweep_k2.cu"
        src.write_text(_set_constant(src.read_text(), "kLanes8x8", mh_8x8))
    if k3:
        src = pkg / "csrc" / "mh_sweep_k3.cu"
        text = src.read_text()
        for target, lanes in k3.items():
            text = _set_constant(text, K3_TARGETS[target][0], lanes)
        src.write_text(text)
    if k4:
        src = pkg / "csrc" / "mala_sweep_k4.cu"
        ops = pkg / "ops" / "mala_sweep.py"
        text, py = src.read_text(), ops.read_text()
        for target, lanes in k4.items():
            name, key = K4_TARGETS[target]
            text = _set_constant(text, name, lanes)
            py, n = re.subn(rf"({re.escape(repr(key))}: )\d+",
                            rf"\g<1>{lanes}", py)
            if n != 1:
                raise ValueError(f"K4_LANES has no entry {key}")
        src.write_text(text)
        ops.write_text(py)
    return pkg


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out", type=Path)
    parser.add_argument("--mh-8x8", type=int)
    parser.add_argument("--k3", nargs="+", default=[],
                        metavar="TARGET=LANES")
    parser.add_argument("--k4", nargs="+", default=[],
                        metavar="TARGET=LANES")
    opts = parser.parse_args(argv)

    def lanes_of(items, option, targets):
        out = {}
        for item in items:
            target, _, lanes = item.partition("=")
            if target not in targets or not lanes.isdigit():
                parser.error(f"{option} takes TARGET=LANES with TARGET one "
                             f"of {', '.join(targets)}")
            out[target] = int(lanes)
        return out

    k3 = lanes_of(opts.k3, "--k3", K3_TARGETS)
    k4 = lanes_of(opts.k4, "--k4", K4_TARGETS)
    print(write_variant(opts.out, opts.mh_8x8, k4, k3))


if __name__ == "__main__":
    sys.exit(main())
