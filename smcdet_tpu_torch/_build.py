"""Build the CUDA kernels in ``csrc/`` at first use and load them.

``nvcc`` compiles every ``csrc/*.cu`` into an object for Hopper (``sm_90a``),
one process per source, all started together, and links the objects into
one shared library with a plain C interface; ``ctypes`` loads it. The
library lands in ``build/smcdet_tpu_torch/`` of the checkout, named by a
hash of the sources, headers and flags, so an edited source is rebuilt and
an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "SOURCE_FLAGS", "build", "load_library",
           "nvcc_path"]

_SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "smcdet_tpu_torch"
# no --use_fast_math: it changes expf/logf against the plain versions
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# flags of one source only. K4 rounds every multiply and add on its own, as
# its plain version's separate tensor ops do (no contraction into FMAs), so
# that MALA's drift, which amplifies last-bit differences over the sweeps,
# starts from the plain version's bits (csrc/mala_sweep_k4.cu). What that
# costs K4 is measured by tests/torch_k4_contraction.py (PERF.md). K4g's
# pixel classes round so for the same reason. The wide routes of K2g, K3g
# and K4g round so too: they work a proposal's caches out twice, in the pass
# that sums its likelihood and in the one that writes it on accept, and the
# two must give the same bits (csrc/mh_sweep_generic.cuh). K2g's and K3g's
# pixel classes render once a sweep; they round so for their caches:
# contracted, the 800-sweep caches drifted 7.1e-7 from a fresh render
# against 6.1e-7, for 6-9% of time (PERF.md).
SOURCE_FLAGS = {name: ["-fmad=false"] for name in (
    "mala_sweep_k4.cu", "mh_sweep_k2g.cu", "mh_sweep_k3g.cu",
    "mh_sweep_wide.cu", "mala_sweep_k4g.cu", "mala_sweep_k4g_bridge.cu",
    "mala_sweep_wide.cu")}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return found


def _sources():
    return sorted(_SRC_DIR.glob("*.cu"))


def _digest(source_flags: dict) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(source_flags.items())).encode())
    for src in sorted(_SRC_DIR.glob("*.cu*")):  # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(source_flags: dict | None = None) -> dict:
    """Compile the kernels unless an up-to-date library exists.

    ``source_flags`` replaces ``SOURCE_FLAGS`` for a variant library, which
    lands beside the default one under its own hash. Returns ``{"path",
    "seconds", "log"}``: the library, the wall time of the parallel compile
    and the link (0.0 when reused) and ``nvcc``'s ``-Xptxas -v`` report
    (registers, shared memory and spills per kernel).
    """
    if source_flags is None:
        source_flags = SOURCE_FLAGS
    lib = BUILD_DIR / f"libsmcdet_kernels_{_digest(source_flags)}.so"
    log_file = lib.with_suffix(".log")
    if lib.is_file():
        log = log_file.read_text() if log_file.is_file() else ""
        return {"path": lib, "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{lib.stem}.{os.getpid()}"
    start = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *source_flags.get(src.name, []), "-c", "-o",
             str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [p.returncode for p in procs if p.returncode != 0]
    tmp = lib.with_name(f"{tag}.so.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        log += link.stdout + link.stderr
        failed = [link.returncode] if link.returncode != 0 else []
    seconds = time.perf_counter() - start
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    log_file.write_text(log)
    os.replace(tmp, lib)
    return {"path": lib, "seconds": seconds, "log": log}


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process).
    Each op module declares the ``argtypes`` of its own entry point."""
    return ctypes.CDLL(str(build()["path"]))
