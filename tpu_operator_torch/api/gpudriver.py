"""GPUDriver CRD (tpu.ai/v1alpha1): a per-node-pool driver instance
(counterpart of tpu_operator/api/tpudriver.py; NVIDIA's NVIDIADriver,
api/nvidia/v1alpha1/nvidiadriver_types.go:40-186).

Lets the node pools of one fleet run different driver versions, each
instance selecting its nodes by ``nodeSelector``; no node may be claimed by
two instances. The spec has the ClusterPolicy's driver field shape
(``driverVersion``, ``installDir`` the driver library directory). The
controller pools the selected nodes by GPU model (``state/nodepool.py``)
and renders one driver DaemonSet per pool.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .. import consts
from .common import ComponentSpec, SpecValidationError, UpgradePolicySpec
from .k8s_schemas import NODE_AFFINITY, TOLERATIONS
from .specbase import spec_field

GPU_DRIVER_API_VERSION = "tpu.ai/v1alpha1"
GPU_DRIVER_KIND = "GPUDriver"

#: NVIDIA's has gpu, vgpu and vgpu-host-manager; the port installs one kind
DRIVER_TYPES = ("standard",)


@dataclasses.dataclass
class GPUDriverSpec(ComponentSpec):
    """Desired driver deployment for the node pools this instance selects."""

    DEFAULT_IMAGE_ENV: str = dataclasses.field(default="DRIVER_IMAGE", repr=False)

    driver_type: str = spec_field(
        "standard", doc="Driver flavor; one standard flavor (NVIDIA's "
                        "operator has gpu/vgpu/vgpu-host-manager).",
        enum=DRIVER_TYPES)
    driver_version: Optional[str] = spec_field(
        None, doc="Driver version the installer records on the selected "
                  "pools (defaults to the version NVML reports).",
        pattern=r"^[a-zA-Z0-9._+-]+$")
    install_dir: str = spec_field(
        consts.DEFAULT_DRIVER_LIB_DIR,
        doc="Host directory the driver installer writes the driver "
            "libraries into.",
        pattern=r"^/.*$")
    node_selector: Dict[str, str] = spec_field(
        dict, doc="Nodes this driver instance manages; empty selects every "
                  "GPU node (tpu.ai/gpu.present=true).")
    labels: Dict[str, str] = spec_field(
        dict, doc="Extra labels for this instance's DaemonSets.")
    annotations: Dict[str, str] = spec_field(
        dict, doc="Extra annotations for this instance's DaemonSets.")
    tolerations: List[Dict[str, Any]] = spec_field(
        list, doc="Tolerations for this instance's driver pods.",
        schema=TOLERATIONS)
    node_affinity: Optional[Dict[str, Any]] = spec_field(
        None, schema=NODE_AFFINITY)
    priority_class_name: str = spec_field(
        "system-node-critical",
        doc="PriorityClass assigned to the driver pods.")
    upgrade_policy: UpgradePolicySpec = spec_field(UpgradePolicySpec)

    def get_node_selector(self) -> Dict[str, str]:
        """Defaults to every GPU node (NVIDIA's GetNodeSelector)."""
        return dict(self.node_selector) if self.node_selector else {consts.GPU_PRESENT_LABEL: "true"}

    def validate(self, path: str = "spec") -> List[str]:
        errors = super().validate(path)
        if self.driver_type not in DRIVER_TYPES:
            errors.append(f"{path}.driverType: invalid {self.driver_type!r}")
        errors += self.upgrade_policy.validate(f"{path}.upgradePolicy")
        return errors


@dataclasses.dataclass
class GPUDriver:
    name: str
    spec: GPUDriverSpec
    obj: Dict[str, Any]

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "GPUDriver":
        if obj.get("kind") != GPU_DRIVER_KIND:
            raise SpecValidationError(f"not a GPUDriver: kind={obj.get('kind')!r}")
        return cls(
            name=obj.get("metadata", {}).get("name", ""),
            spec=GPUDriverSpec.from_dict(obj.get("spec", {})),
            obj=obj,
        )

    @property
    def status(self) -> Dict[str, Any]:
        return self.obj.setdefault("status", {})

