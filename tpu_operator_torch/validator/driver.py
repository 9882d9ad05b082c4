"""NVIDIA driver validation (counterpart of tpu_operator/validator/driver.py).

"Driver ready" on a GPU node means: the CUDA driver library
(``libcuda.so.1``) is at the install path and the GPU device nodes
(``/dev/nvidia[0-9]*``) are visible. Both are cheap file checks. The
driver daemon and the native probe come in a later slice.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import List, Optional

from .. import consts
from .status import StatusFiles

log = logging.getLogger(__name__)


def discover_devices(dev_globs=None) -> List[str]:
    patterns = dev_globs or os.environ.get(consts.GPU_DEV_GLOBS_ENV, "").split(",")
    if not patterns or patterns == [""]:
        patterns = list(consts.GPU_DEV_GLOBS)
    found: List[str] = []
    for pattern in patterns:
        found.extend(sorted(glob.glob(pattern)))
    return found


#: where GPU node images preinstall the CUDA driver library; override
#: with $GPU_HOST_DRIVER_PATHS (colon-separated)
HOST_DRIVER_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libcuda.so.1",
    "/usr/lib64/libcuda.so.1",
    "/usr/local/nvidia/lib64/libcuda.so.1",
    "/home/kubernetes/bin/nvidia/lib64/libcuda.so.1",
)


def find_host_driver(paths=None) -> Optional[str]:
    """First pre-installed host libcuda that passes the ELF check."""
    if paths is None:
        env = os.environ.get("GPU_HOST_DRIVER_PATHS")
        paths = env.split(":") if env else HOST_DRIVER_PATHS
    for path in paths:
        if path and is_valid_driver_lib(path):
            return path
    return None


def driver_lib_path(install_dir: str) -> str:
    return os.path.join(install_dir, consts.DRIVER_LIB)


def is_valid_driver_lib(path: str) -> bool:
    """Regular file with an ELF header (the same check the TPU side makes
    of libtpu.so)."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"\x7fELF"
    except OSError:
        return False


def validate_host(status: Optional[StatusFiles] = None,
                  require_devices: bool = True) -> bool:
    """Adopt the host's pre-installed driver (driver.enabled=false: the
    platform owns it). Writes the same barrier keys as :func:`validate`,
    with ``source=host``."""
    status = status or StatusFiles()
    so = find_host_driver()
    if not so:
        log.error("host-driver validation failed: no pre-installed %s "
                  "found (looked at %s)", consts.DRIVER_LIB,
                  os.environ.get("GPU_HOST_DRIVER_PATHS")
                  or ":".join(HOST_DRIVER_PATHS))
        return False
    devices = discover_devices()
    if require_devices and not devices:
        log.error("host-driver validation failed: no GPU device nodes")
        return False
    status.write("driver", {"libtpu": so, "devices": devices,
                            "source": "host"})
    log.info("host-driver adoption ok: %s, %d device nodes", so, len(devices))
    return True


def validate(install_dir: str, status: Optional[StatusFiles] = None,
             require_devices: bool = True) -> bool:
    """The driver-validation init container: probe, then write the barrier.

    The barrier keeps the TPU operator's key names (``libtpu`` holds the
    driver library's path) so the shared barrier readers parse it."""
    status = status or StatusFiles()
    so = driver_lib_path(install_dir)
    if not is_valid_driver_lib(so):
        log.error("driver validation failed: %s missing or not an ELF", so)
        return False
    devices = discover_devices()
    if require_devices and not devices:
        log.error("driver validation failed: no GPU device nodes")
        return False
    record = {"libtpu": so, "devices": devices}
    # an installer records the pinned driver version here; preserve it
    # across re-validation (feature discovery labels nodes from it)
    previous = status.read("driver") or {}
    if "libtpu_version" in previous:
        record["libtpu_version"] = previous["libtpu_version"]
    status.write("driver", record)
    log.info("driver validation ok: %s, %d device nodes", so, len(devices))
    return True


# -- what a container needs to use a GPU (device plugin and CDI) ------------------

def gpu_node(minor: int, dev_dir: Optional[str] = None) -> str:
    """The GPU's own device node: ``/dev/nvidia<minor>``."""
    return os.path.join(dev_dir or consts.DEV_DIR, consts.GPU_DEV_NODE.format(minor=minor))


def control_nodes(dev_dir: Optional[str] = None) -> List[str]:
    """The control nodes every CUDA process opens, those present."""
    paths = [os.path.join(dev_dir or consts.DEV_DIR, n) for n in consts.GPU_CONTROL_NODES]
    return [p for p in paths if os.path.exists(p)]


def driver_lib_files(install_dir: str) -> List[str]:
    """The driver library files a GPU container mounts, those present:
    ``libcuda.so.1``, ``libnvidia-ml.so.1`` and the file ``libcuda.so.1``
    resolves to. Files, never their directory, which holds the host's libc
    as well."""
    files = [p for p in (os.path.join(install_dir, n) for n in consts.DRIVER_LIB_FILES)
             if os.path.exists(p)]
    real = os.path.realpath(driver_lib_path(install_dir))
    if os.path.exists(real) and real not in files:
        files.append(real)
    return files
