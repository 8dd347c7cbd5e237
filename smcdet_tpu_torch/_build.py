"""Build the CUDA kernels in ``csrc/`` at first use and load them.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface for Hopper (``sm_90a``); ``ctypes`` loads it. The library lands in
``build/smcdet_tpu_torch/`` of the checkout, named by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
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

__all__ = ["NVCC_FLAGS", "build", "load_library", "nvcc_path"]

_SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "smcdet_tpu_torch"
# no --use_fast_math: it changes expf/logf against the plain versions
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


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


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels unless an up-to-date library exists.

    Returns ``{"path", "seconds", "log"}``: the library, the compile time
    (0.0 when reused) and ``nvcc``'s ``-Xptxas -v`` report (registers,
    shared memory and spills per kernel).
    """
    sources = _sources()
    lib = BUILD_DIR / f"libsmcdet_kernels_{_digest(sources)}.so"
    log_file = lib.with_suffix(".log")
    if lib.is_file():
        log = log_file.read_text() if log_file.is_file() else ""
        return {"path": lib, "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_file.write_text(log)
    os.replace(tmp, lib)
    return {"path": lib, "seconds": seconds, "log": log}


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process).
    Each op module declares the ``argtypes`` of its own entry point."""
    return ctypes.CDLL(str(build()["path"]))
