"""Node attribute extraction and filtering (counterpart of
tpu_operator/nodeinfo/node_info.py, for GPU nodes).

A node is a GPU node when any of these hold: node feature discovery's PCI
vendor label for NVIDIA, ``feature.node.kubernetes.io/pci-10de.present``
(the signal NVIDIA's own operator keys on, state_manager.go:113-117);
GKE's ``cloud.google.com/gke-accelerator`` with an ``nvidia-`` value; the
operator's own ``tpu.ai/gpu.present`` marker; or a non-zero
``nvidia.com/gpu`` capacity.
"""

from __future__ import annotations

import dataclasses

from .. import consts
from ..utils import deep_get, parse_quantity


def gpu_capacity(node: dict) -> int:
    raw = deep_get(node, "status", "capacity", consts.GPU_RESOURCE_NAME, default=0)
    try:
        return int(parse_quantity(raw))
    except ValueError:
        return 0


def is_gpu_node(node: dict) -> bool:
    labels = deep_get(node, "metadata", "labels", default={}) or {}
    if labels.get(consts.NFD_NVIDIA_PCI_LABEL) == "true":
        return True
    if str(labels.get(consts.GKE_ACCELERATOR_LABEL, "")).startswith(consts.GKE_NVIDIA_PREFIX):
        return True
    if labels.get(consts.GPU_PRESENT_LABEL) == "true":
        return True
    return gpu_capacity(node) > 0


@dataclasses.dataclass
class NodeAttributes:
    """Attributes mined from a node's labels (attributes.go:58-71 analog)."""

    name: str = ""
    hostname: str = ""
    arch: str = ""
    os: str = ""
    accelerator: str = ""   # e.g. nvidia-h100-80gb
    #: a GPU node has no slice topology label; kept for the reference's shape
    topology: str = ""
    chip_count: int = 0

    @classmethod
    def from_node(cls, node: dict) -> "NodeAttributes":
        labels = deep_get(node, "metadata", "labels", default={}) or {}
        return cls(
            name=deep_get(node, "metadata", "name", default=""),
            hostname=labels.get("kubernetes.io/hostname", ""),
            arch=labels.get("kubernetes.io/arch", ""),
            os=labels.get("kubernetes.io/os", ""),
            accelerator=labels.get(consts.GKE_ACCELERATOR_LABEL,
                                   labels.get(consts.TPU_CHIP_TYPE_LABEL, "")),
            chip_count=gpu_capacity(node),
        )

