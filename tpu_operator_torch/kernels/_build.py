"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes),
built at first use into the build directory and keyed by a hash of the
source and the flags: an edited source builds anew, an unchanged one loads
from the cache. The build directory is ``$GPU_COMPILATION_CACHE_DIR`` when
that is set (a host path that outlives the pod, which the ``prewarm``
component fills ahead of the validations), else ``build/tpu_operator_torch/``
at the repository root. :func:`build_all` starts one ``nvcc`` per source,
all at once.

No fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

from .. import consts

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: the build directory when ``$GPU_COMPILATION_CACHE_DIR`` is unset
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_operator_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each build, by source
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                   "bin", "nvcc")):
        if candidate and os.access(candidate, os.X_OK):
            return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels cannot be built")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_dir() -> Path:
    cache_dir = os.environ.get(consts.COMPILATION_CACHE_DIR_ENV)
    return Path(cache_dir) if cache_dir else BUILD_DIR


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _tmp(out: Path) -> Path:
    return out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")


def _start(name: str, nvcc: str, out: Path) -> subprocess.Popen:
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(_tmp(out)), str(CSRC / f"{name}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen, out: Path, timeout: float) -> None:
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out after {timeout}s building {name}.cu")
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(_tmp(out), out)  # atomic: a concurrent loader never sees a partial .so


def build_all(timeout: float = 600.0) -> Dict[str, float]:
    """Build every source not yet in the cache, one ``nvcc`` each, started
    together. Returns the seconds each build took (0.0 for a cache hit)."""
    with _lock:
        pending = {name: library_path(name) for name in sources()}
        pending = {n: p for n, p in pending.items() if not p.exists()}
        seconds = {name: 0.0 for name in sources()}
        if not pending:
            return seconds
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        procs = {name: _start(name, nvcc, out) for name, out in pending.items()}
        for name, proc in procs.items():
            _finish(name, proc, pending[name], timeout)
            seconds[name] = round(time.perf_counter() - t0, 3)
        return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
    path = library_path(name)
    if not path.exists():
        build_all()
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
