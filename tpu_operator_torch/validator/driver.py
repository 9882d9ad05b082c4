"""NVIDIA driver validation (counterpart of tpu_operator/validator/driver.py).

"Driver ready" on a GPU node means: the CUDA driver library
(``libcuda.so.1``) is at the install path and the GPU device nodes
(``/dev/nvidia[0-9]*``) are visible. Both are cheap file checks, which the
native ``gpu-probe`` makes for the installer's startup probe (:func:`probe`)
without starting an interpreter. On an NVIDIA H100 80GB HBM3 host at
700 W (``chip_smoke.py`` phase 11, PERF.md §6) one exec took 10.9-23.6 ms
from a torch-free Python process; the Python ``-c driver-probe`` process
took 315-374 ms.

The installer (:func:`install`, :func:`daemon`) places the user-space
driver libraries the operand image bundles (``$GPU_DRIVER_SRC``) on the
host path, atomically, and records the driver version in the barrier.
Nothing is downloaded and no kernel module is built: the node's kernel
driver is the platform's.
"""

from __future__ import annotations

import glob
import logging
import os
import shutil
import subprocess
import time
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


#: where GPU node images preinstall the CUDA driver library, in the
#: reference's order (the platform's install dir first, then the
#: distribution's, then a local install); override with
#: $GPU_HOST_DRIVER_PATHS (colon-separated)
HOST_DRIVER_PATHS = (
    "/home/kubernetes/bin/nvidia/lib64/libcuda.so.1",
    "/usr/lib/x86_64-linux-gnu/libcuda.so.1",
    "/usr/lib64/libcuda.so.1",
    "/usr/local/nvidia/lib64/libcuda.so.1",
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


def find_probe_binary() -> Optional[str]:
    """The native ``gpu-probe`` (``tpu_operator_torch/native``): a kubelet
    exec probe firing every few seconds pays no interpreter start, which
    is most of the Python probe's time (figures in the module docstring)."""
    from .native import find_native_binary

    return find_native_binary("gpu-probe", consts.PROBE_BIN_ENV)


def probe(install_dir: str, require_devices: bool = True) -> bool:
    """The installer's startup probe: cheap, no side effects, no CUDA
    context. Runs the native probe when found, else the same file checks."""
    binary = find_probe_binary()
    if binary:
        args = [binary, f"--install-dir={install_dir}"]
        if not require_devices:
            args.append("--no-require-devices")
        try:
            return subprocess.run(args, capture_output=True, timeout=10).returncode == 0
        except (OSError, subprocess.TimeoutExpired) as e:
            log.warning("native probe failed (%s); falling back to file checks", e)
    return is_valid_driver_lib(driver_lib_path(install_dir)) and \
        (not require_devices or bool(discover_devices()))


def find_bundled_driver() -> Optional[str]:
    """The directory of driver libraries the operand image bundles
    (``$GPU_DRIVER_SRC``), if it holds ``libcuda.so.1``."""
    src = os.environ.get(consts.DRIVER_SRC_ENV)
    if src and os.path.exists(os.path.join(src, consts.DRIVER_LIB)):
        return src
    return None


def _nvml_driver_version(nvml_lib=None) -> str:
    from .. import nvml

    try:
        with nvml.session(nvml_lib) as s:
            return s.driver_version()
    except nvml.NvmlError as e:
        log.warning("NVML gives no driver version (%s); recording 'unknown'", e)
        return "unknown"


def install(install_dir: str, driver_version: Optional[str] = None,
            status: Optional[StatusFiles] = None, nvml_lib=None) -> bool:
    """Place the bundled driver libraries on the host path (the installer
    DaemonSet's job): each of ``libcuda.so.1`` and ``libnvidia-ml.so.1``
    the bundle holds is copied to a temporary file beside its target, then
    swapped in with ``os.replace``, so a reader never sees a torn library.
    Without a bundle, a preinstalled target is kept, or the install fails.

    The barrier gets the reference's keys: ``libtpu`` (the driver
    library's path), ``libtpu_version`` and ``devices``. The version is
    ``driver_version``, else ``$GPU_DRIVER_VERSION``, else NVML's."""
    status = status or StatusFiles()
    os.makedirs(install_dir, exist_ok=True)
    target = driver_lib_path(install_dir)
    source = find_bundled_driver()
    if source is None:
        if os.path.exists(target):
            log.info("no bundled driver; keeping preinstalled %s", target)
        else:
            log.error("no bundled driver (%s) and nothing preinstalled at %s",
                      consts.DRIVER_SRC_ENV, target)
            return False
    elif os.path.abspath(source) != os.path.abspath(install_dir):
        for name in consts.DRIVER_LIB_FILES:
            src = os.path.join(source, name)
            if not os.path.exists(src):
                continue
            dst = os.path.join(install_dir, name)
            tmp = dst + ".tmp"
            shutil.copyfile(src, tmp)  # follows the bundle's symlinks
            os.replace(tmp, dst)
            log.info("installed %s -> %s", src, dst)
    version = (driver_version or os.environ.get(consts.DRIVER_VERSION_ENV)
               or _nvml_driver_version(nvml_lib))
    status.write("driver", {"libtpu": target, "libtpu_version": version,
                            "devices": discover_devices()})
    return True


def daemon(install_dir: str, driver_version: Optional[str] = None,
           status: Optional[StatusFiles] = None, heartbeat_interval: float = 30.0,
           max_beats: Optional[int] = None, nvml_lib=None) -> int:
    """The installer DaemonSet's main loop: install once, write the CDI
    spec when ``$GPU_CDI_ENABLED`` is 1, then heartbeat the
    ``driver-heartbeat`` barrier so the node-status exporter can tell a
    wedged installer."""
    status = status or StatusFiles()
    if not install(install_dir, driver_version, status, nvml_lib):
        return 1
    if os.environ.get(consts.CDI_ENABLED_ENV) == "1":
        from . import cdi

        cdi.run(install_dir, os.environ.get(consts.CDI_DIR_ENV, cdi.DEFAULT_CDI_DIR))
    beats = 0
    while max_beats is None or beats < max_beats:
        time.sleep(heartbeat_interval)
        status.write("driver-heartbeat", {"beat": beats})
        beats += 1
    return 0


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
