"""A copy of this checkout's kernel package with other lane counts per
particle, to time against this checkout's with
``tests/torch_kernel_compare.py --parent OUT``:

    python3 tests/torch_lane_variant.py OUT [--mh-8x8 L] \\
        [--k3 bridge16x8=L bridge16x16=L] \\
        [--k4 8x8=L 16x16=L bridge16x8=L bridge16x16=L] \\
        [--k2g CAP=L ...] [--k3g CAP=L ...] \\
        [--contract SOURCE ...] [--set SOURCE:NAME=VALUE ...]

writes ``OUT/smcdet_tpu_torch`` (the package is all that the comparison
reads from an earlier checkout) with the 8x8 MH lanes ``kLanes8x8`` of
``csrc/mh_sweep_k2.cu`` (K1's and K2's 8x8 kinds: compare with ``--kernel
K1 K2``), K3's ``kLanesBridge*`` (``csrc/mh_sweep_k3.cu``: ``--kernel K3``)
and K4's ``kLanes*`` (``csrc/mala_sweep_k4.cu``) set as asked, and
``ops/mala_sweep.py:K4_LANES`` set to match, so that the copy's plain
version sums in its kernel's lane order (the plain MH version sums with
``.sum``, whatever K3's lanes). ``--k2g`` and ``--k3g`` set the lanes of
the pixel classes of the tile target (K2g and K4g) and of the bridge (K3g
and K4g): ``kLanesTile<CAP>`` and ``kLanesBridge<CAP>`` of
``csrc/mh_sweep_classes.cuh``, and ``ops/mh_sweep.py:GENERIC_CLASS_LANES``
with them; ``--contract``
compiles the named sources (``mh_sweep_k2g.cu`` ...) without their
``-fmad=false`` (``_build.py:SOURCE_FLAGS``), so that multiplies and adds
contract into FMAs; ``--set`` sets any other ``constexpr int`` of a source in
``csrc/`` that the plain version does not repeat (a block size, the blocks
an SM that ``__launch_bounds__`` names, the pixels K2g's and K3g's loop
unrolls, ``kUnroll``). It fails if a constant is not where it expects it.
``k3_source_lanes``, ``k4_source_lanes`` and ``generic_source_lanes`` read
K3's, K4's and the pixel classes' constants; ``K4_LANES`` must repeat K4's
and ``GENERIC_CLASS_LANES`` the classes'.
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
# the pixel classes of K2g, K3g and K4g, the header that holds their lanes,
# and each target's constants
GENERIC_CLASSES = (64, 128, 256, 512, 1024, 2048, 4096)
GENERIC_SOURCE = "mh_sweep_classes.cuh"
GENERIC_PREFIXES = {False: "kLanesTile", True: "kLanesBridge"}


def _constants(text: str) -> dict:
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w*) = (\d+);", text)}


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


def generic_source_lanes(pkg: Path = ROOT / "smcdet_tpu_torch") -> dict:
    """The pixel classes' lanes per particle as
    ``csrc/mh_sweep_classes.cuh`` sets them, keyed as
    ``ops/mh_sweep.py:GENERIC_CLASS_LANES``: ``(class, bridge target)``."""
    found = _constants((pkg / "csrc" / GENERIC_SOURCE).read_text())
    return {(cap, bridge): found[f"{prefix}{cap}"]
            for bridge, prefix in GENERIC_PREFIXES.items()
            for cap in GENERIC_CLASSES}


def _set_constant(text: str, name: str, value: int) -> str:
    out, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};",
                     text)
    if n != 1:
        raise ValueError(f"constant {name} not found once")
    return out


def write_variant(out: Path, mh_8x8=None, k4=None, k3=None, k2g=None,
                  k3g=None, contract=(), constants=()) -> Path:
    """Copy ``smcdet_tpu_torch`` into ``out`` with the 8x8 MH lanes
    ``mh_8x8``, K3's ``k3`` and K4's ``k4`` (``{target: lanes}``, targets
    as in ``K3_TARGETS`` and ``K4_TARGETS``), K2g's ``k2g`` and K3g's
    ``k3g`` (``{class: lanes}``), the sources ``contract`` compiled without
    ``-fmad=false``, and ``constants`` (``(source, name, value)``) set;
    returns the copy's package directory."""
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
    for bridge, lanes in ((False, k2g), (True, k3g)):
        if not lanes:
            continue
        prefix = GENERIC_PREFIXES[bridge]
        src, ops = pkg / "csrc" / GENERIC_SOURCE, pkg / "ops" / "mh_sweep.py"
        text, py = src.read_text(), ops.read_text()
        for cap, value in lanes.items():
            text = _set_constant(text, f"{prefix}{cap}", value)
            py, n = re.subn(rf"({re.escape(repr((cap, bridge)))}: )\d+",
                            rf"\g<1>{value}", py)
            if n != 1:
                raise ValueError(f"GENERIC_CLASS_LANES has no entry "
                                 f"{(cap, bridge)}")
        src.write_text(text)
        ops.write_text(py)
    for source, name, value in constants:
        src = pkg / "csrc" / source
        src.write_text(_set_constant(src.read_text(), name, value))
    if contract:
        build = pkg / "_build.py"
        py = build.read_text()
        for name in contract:
            py, n = re.subn(rf'"{re.escape(name)}",\s*', "", py)
            if n != 1:
                raise ValueError(f"SOURCE_FLAGS does not list {name}")
        build.write_text(py)
    return pkg


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out", type=Path)
    parser.add_argument("--mh-8x8", type=int)
    parser.add_argument("--k3", nargs="+", default=[],
                        metavar="TARGET=LANES")
    parser.add_argument("--k4", nargs="+", default=[],
                        metavar="TARGET=LANES")
    parser.add_argument("--k2g", nargs="+", default=[], metavar="CAP=LANES")
    parser.add_argument("--k3g", nargs="+", default=[], metavar="CAP=LANES")
    parser.add_argument("--contract", nargs="+", default=[],
                        metavar="SOURCE")
    parser.add_argument("--set", nargs="+", default=[],
                        metavar="SOURCE:NAME=VALUE")
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
    classes = [str(cap) for cap in GENERIC_CLASSES]
    k2g = {int(c): v for c, v in lanes_of(opts.k2g, "--k2g",
                                          classes).items()}
    k3g = {int(c): v for c, v in lanes_of(opts.k3g, "--k3g",
                                          classes).items()}
    constants = []
    for item in opts.set:
        source, _, rest = item.partition(":")
        name, _, value = rest.partition("=")
        if not (source and name and value.isdigit()):
            parser.error("--set takes SOURCE:NAME=VALUE")
        constants.append((source, name, int(value)))
    print(write_variant(opts.out, opts.mh_8x8, k4, k3, k2g, k3g,
                        opts.contract, constants))


if __name__ == "__main__":
    sys.exit(main())
