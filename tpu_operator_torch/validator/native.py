"""Locating, and building at first use, the port's native binaries
(counterpart of tpu_operator/validator/native.py): ``gpu-probe``, the
driver installer's startup probe, and ``gpu-exporter``, the node-status
exporter.

Resolution order, the reference's: an explicit environment override, then
``$PATH`` (a node image installs them there, e.g. with the Makefile in
``tpu_operator_torch/native/``), then the build directory. The sources are
in ``tpu_operator_torch/native/``; each is built with ``g++`` at first use
into ``build/tpu_operator_torch/native/`` under the checkout, keyed by a
hash of the source and the flags, as ``kernels/_build.py`` keys the CUDA
sources. Without a compiler, or where the build fails (a compiler error,
a build directory that cannot be written), the finder logs why and the
caller takes its Python path; :func:`build` itself raises.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

SOURCES = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_operator_torch" / "native"
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-std=c++17")
#: binary name -> source file
BINARIES = {"gpu-probe": "gpu_probe.cc", "gpu-exporter": "gpu_exporter.cc"}

log = logging.getLogger(__name__)


def find_compiler() -> Optional[str]:
    return shutil.which("g++")


def binary_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update((SOURCES / BINARIES[name]).read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}"


def build(names: Iterable[str] = tuple(BINARIES), timeout: float = 120.0) -> Dict[str, float]:
    """Build each binary not yet built, one after another. Returns the
    seconds each took (0.0 when already built). Raises without a compiler
    or when a build fails."""
    cxx = find_compiler()
    if cxx is None:
        raise RuntimeError("g++ not found: the native probe and exporter cannot be built")
    seconds = {}
    for name in names:
        out = binary_path(name)
        seconds[name] = 0.0
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            done = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCES / BINARIES[name])],
                                  capture_output=True, text=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"{cxx} timed out after {timeout}s building {name}") from None
        if done.returncode != 0:
            raise RuntimeError(f"{cxx} failed building {name} (rc {done.returncode}):\n"
                               f"{done.stdout}{done.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent finder never runs a partial file
        seconds[name] = round(time.perf_counter() - t0, 3)
    return seconds


def find_native_binary(name: str, env_override: str,
                       disable_env: Optional[str] = None) -> Optional[str]:
    """The binary to run, or None: the caller then takes its Python path."""
    if disable_env and os.environ.get(disable_env) == "0":
        return None
    explicit = os.environ.get(env_override)
    if explicit and os.access(explicit, os.X_OK):
        return explicit
    found = shutil.which(name)
    if found:
        return found
    built = binary_path(name)
    if not built.exists():
        if find_compiler() is None:
            return None
        try:
            build([name])
        except (RuntimeError, OSError) as e:
            log.warning("%s not built (%s); taking the Python path", name, e)
            return None
    return str(built)
