"""The operator's API types (counterpart of tpu_operator/api/): the
ClusterPolicy, the per-pool GPUDriver, and the CRD schema generator and
validator built from their spec dataclasses."""

from .clusterpolicy import (
    CLUSTER_POLICY_API_VERSION,
    CLUSTER_POLICY_KIND,
    ClusterPolicy,
    ClusterPolicySpec,
    State,
)
from .gpudriver import (
    GPU_DRIVER_API_VERSION,
    GPU_DRIVER_KIND,
    GPUDriver,
    GPUDriverSpec,
)

__all__ = [
    "CLUSTER_POLICY_API_VERSION",
    "CLUSTER_POLICY_KIND",
    "ClusterPolicy",
    "ClusterPolicySpec",
    "GPU_DRIVER_API_VERSION",
    "GPU_DRIVER_KIND",
    "GPUDriver",
    "GPUDriverSpec",
    "State",
]
