"""The operator's API types (counterpart of tpu_operator/api/; the
TPUDriver kind and the CRD schema generator wait for their slices)."""

from .clusterpolicy import (
    CLUSTER_POLICY_API_VERSION,
    CLUSTER_POLICY_KIND,
    ClusterPolicy,
    ClusterPolicySpec,
    State,
)

__all__ = [
    "CLUSTER_POLICY_API_VERSION",
    "CLUSTER_POLICY_KIND",
    "ClusterPolicy",
    "ClusterPolicySpec",
    "State",
]
