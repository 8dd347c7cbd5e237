"""The machine code (SASS) of a kernel library, as ``cuobjdump -sass``
prints it: split by kernel, with the branch labels renumbered per kernel so
that two builds of one kernel compare equal, and the static instruction
counts of a kernel's loops (``tests/torch_k2_compare.py`` reads them).
``dump`` needs the CUDA toolkit's ``cuobjdump`` (beside ``nvcc``).
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path

__all__ = ["cuobjdump_path", "dump", "functions", "instructions", "loops",
           "loop_sizes", "stable_name"]

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_ADDRESS = re.compile(r"\b0x([0-9a-f]+)\b")
_ANY_LABEL = re.compile(r"\.L_x_\d+|\.A_\d+")
# an anonymous namespace in a mangled name: its length, then an identifier
# that carries a hash of the source file's path
_ANONYMOUS = re.compile(r"(\d+)_GLOBAL__N__")


def cuobjdump_path() -> str:
    """``cuobjdump`` beside the ``nvcc`` that builds the kernels."""
    from smcdet_tpu_torch import _build

    return str(Path(_build.nvcc_path()).with_name("cuobjdump"))


def stable_name(text: str) -> str:
    """``text`` with the identifier of every anonymous namespace in a
    mangled name (which carries a hash of the source file's path) replaced
    by ``_GLOBAL__N_``, so that one kernel built from two checkouts has one
    name."""
    out, pos = [], 0
    for m in _ANONYMOUS.finditer(text):
        if m.start() < pos:
            continue
        out.append(text[pos:m.start()] + "_GLOBAL__N_")
        pos = m.start(1) + len(m.group(1)) + int(m.group(1))
    return "".join(out) + text[pos:]


def functions(text: str) -> dict[str, list[str]]:
    """Split ``cuobjdump -sass`` output into ``{kernel name: [line, ...]}``
    (mangled names through ``stable_name``): each instruction without its
    address and encoding, and each label as ``L<k>:``, with labels numbered
    from 0 in each kernel in the order they first appear. A branch to an
    address becomes a branch to a label put before the instruction at that
    address."""
    raw: dict[str, list[tuple[str | None, str]]] = {}
    current = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = raw.setdefault(stable_name(m.group(1)), [])
        elif current is not None and _LABEL.match(line):
            current.append((None, _LABEL.match(line).group(1) + ":"))
        elif current is not None and _INSTRUCTION.search(line):
            m = _INSTRUCTION.search(line)
            current.append((m.group(1), stable_name(m.group(2))))
    return {name: _normalise(body) for name, body in raw.items()}


def _normalise(body):
    targets = {int(a, 16) for _, text in body if _is_branch(text)
               for a in _ADDRESS.findall(text)}
    lines = []
    for addr, text in body:
        if addr is not None and int(addr, 16) in targets:
            lines.append(f".A_{int(addr, 16)}:")
        if _is_branch(text):
            text = _ADDRESS.sub(lambda m: f".A_{int(m.group(1), 16)}", text)
        lines.append(text)
    names: dict[str, str] = {}
    return [_ANY_LABEL.sub(
        lambda m: names.setdefault(m.group(0), f"L{len(names)}"), text)
        for text in lines]


def _is_branch(text: str) -> bool:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return bool(words) and words[0].split(".")[0] == "BRA"


def dump(lib) -> dict[str, list[str]]:
    """``functions`` of ``cuobjdump -sass lib``."""
    out = subprocess.run([cuobjdump_path(), "-sass", str(lib)],
                         capture_output=True, text=True, check=True)
    return functions(out.stdout)


def instructions(body: list[str]) -> int:
    """The number of instructions in a kernel (labels not counted)."""
    return sum(not line.endswith(":") for line in body)


def loops(body: list[str]) -> list[tuple[int, int, int]]:
    """Every loop of a kernel: ``(start, end, instructions)`` for each
    branch back to a label at ``start`` from the branch at ``end`` (indices
    into ``body``), with the static instruction count between them, the
    branch included; largest first."""
    where = {}
    found = []
    for i, line in enumerate(body):
        if line.endswith(":"):
            where[line[:-1]] = i
        elif _is_branch(line):
            for label in re.findall(r"\bL\d+\b", line.split("BRA", 1)[1]):
                if label in where:
                    start = where[label]
                    found.append((start, i, instructions(body[start:i + 1])))
    return sorted(found, key=lambda s: -s[2])


def loop_sizes(body: list[str]) -> tuple[int, int]:
    """The static instruction counts of the largest loop and of the largest
    loop nested strictly inside it (0 where there is none)."""
    spans = loops(body)
    if not spans:
        return 0, 0
    start, end, outer = spans[0]
    inner = [n for s, e, n in spans[1:]
             if start <= s and e <= end and (s, e) != (start, end)]
    return outer, max(inner, default=0)
