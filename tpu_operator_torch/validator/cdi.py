"""CDI (Container Device Interface) spec for the node's GPUs (counterpart
of tpu_operator/validator/cdi.py).

One device per GPU, ``gpu<i>`` in PCI bus-id order (the device plugin's
unit ``gpu-<i>``), and ``all``: each with its own device node
(``/dev/nvidia<minor>``, from NVML) and ``NVIDIA_VISIBLE_DEVICES`` /
``CUDA_VISIBLE_DEVICES`` set to its UUID. Common edits: the control nodes
present and the driver library files, read-only. Runtimes with CDI
support (containerd >= 1.7, cri-o) inject GPUs from it, and the device
plugin's Allocate names these devices in CDI mode (``GPU_USE_CDI=1``).
No CUDA context is opened: NVML answers.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional

from .. import consts, nvml
from .driver import control_nodes, driver_lib_files, gpu_node

log = logging.getLogger(__name__)

CDI_VERSION = "0.6.0"
CDI_KIND = consts.CDI_KIND
DEFAULT_CDI_DIR = "/etc/cdi"
SPEC_FILENAME = "nvidia.com-gpu.json"


def device_name(index: int) -> str:
    return f"gpu{index}"


def qualified_name(index: int) -> str:
    """What the device plugin's Allocate returns for GPU ``index`` in CDI mode."""
    return f"{CDI_KIND}={device_name(index)}"


def _visible(uuids: List[str]) -> List[str]:
    joined = ",".join(uuids)
    return [f"NVIDIA_VISIBLE_DEVICES={joined}", f"CUDA_VISIBLE_DEVICES={joined}"]


def generate_spec(install_dir: str = consts.DEFAULT_DRIVER_LIB_DIR,
                  gpus: Optional[List[nvml.Gpu]] = None,
                  dev_dir: Optional[str] = None) -> dict:
    """The spec for ``gpus`` (default: NVML's, in PCI bus-id order)."""
    gpus = gpus if gpus is not None else nvml.gpus()
    common_edits: dict = {}
    controls = control_nodes(dev_dir)
    if controls:
        common_edits["deviceNodes"] = [{"path": n, "permissions": "rw"} for n in controls]
    libs = driver_lib_files(install_dir)
    if libs:
        common_edits["mounts"] = [{"hostPath": f, "containerPath": f, "options": ["ro", "rbind"]}
                                  for f in libs]
    nodes = [gpu_node(g.minor, dev_dir) for g in gpus]
    devices = [{"name": device_name(i),
                "containerEdits": {"deviceNodes": [{"path": node, "permissions": "rw"}],
                                   "env": _visible([g.uuid])}}
               for i, (g, node) in enumerate(zip(gpus, nodes))]
    # composite device: every GPU on the host in one grant
    if devices:
        devices.append({"name": "all", "containerEdits": {
            "deviceNodes": [{"path": n, "permissions": "rw"} for n in nodes],
            "env": _visible([g.uuid for g in gpus])}})
    return {"cdiVersion": CDI_VERSION, "kind": CDI_KIND, "containerEdits": common_edits,
            "devices": devices}


def write_spec(spec: dict, cdi_dir: str = DEFAULT_CDI_DIR) -> str:
    """Write atomically: runtimes re-scan the dir and must never read a
    torn spec."""
    os.makedirs(cdi_dir, exist_ok=True)
    path = os.path.join(cdi_dir, SPEC_FILENAME)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(spec, f, indent=2)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def run(install_dir: str = consts.DEFAULT_DRIVER_LIB_DIR,
        cdi_dir: str = DEFAULT_CDI_DIR) -> int:
    """Write the node's spec; 1 when NVML reports no GPU. Raises
    :class:`~tpu_operator_torch.nvml.NvmlError` without NVML."""
    spec = generate_spec(install_dir)
    if not spec["devices"]:
        log.error("cdi: NVML reports no GPU; not writing a spec")
        return 1
    path = write_spec(spec, cdi_dir)
    log.info("cdi: wrote %s with %d device(s)", path, len(spec["devices"]) - 1)
    return 0
