"""Kind registry: maps (apiVersion, kind) -> REST resource metadata (copy
of tpu_operator/client/scheme.py, with the per-pool driver kind named
``GPUDriver``).

The reference gets this from client-go's scheme + RESTMapper; we keep a small
explicit table covering every GVK the operator touches (the reference's new
engine does the same with an allowlist of supported GVKs,
internal/state/state_skel.go:62-165).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from .errors import KindNotServedError


@dataclass(frozen=True)
class KindInfo:
    plural: str
    namespaced: bool = True


class Scheme:
    def __init__(self) -> None:
        self._kinds: Dict[Tuple[str, str], KindInfo] = {}

    def register(self, api_version: str, kind: str, plural: str, namespaced: bool = True) -> None:
        self._kinds[(api_version, kind)] = KindInfo(plural=plural, namespaced=namespaced)

    def info(self, api_version: str, kind: str) -> KindInfo:
        try:
            return self._kinds[(api_version, kind)]
        except KeyError:
            # a real apiserver answers 404 for an unserved group/kind (e.g.
            # optional CRDs like monitoring.coreos.com not installed); the
            # distinct type keeps typo'd kinds loud at `except NotFoundError`
            # sites that mean "object absent"
            raise KindNotServedError(f"kind not registered in scheme: {api_version}/{kind}")

    def is_namespaced(self, api_version: str, kind: str) -> bool:
        return self.info(api_version, kind).namespaced


def default_scheme() -> Scheme:
    s = Scheme()
    core = [
        ("Pod", "pods", True),
        ("Node", "nodes", False),
        ("Namespace", "namespaces", False),
        ("Service", "services", True),
        ("ServiceAccount", "serviceaccounts", True),
        ("ConfigMap", "configmaps", True),
        ("Secret", "secrets", True),
        ("Event", "events", True),
        ("Endpoints", "endpoints", True),
        ("PersistentVolumeClaim", "persistentvolumeclaims", True),
        ("Namespace", "namespaces", False),
    ]
    for kind, plural, namespaced in core:
        s.register("v1", kind, plural, namespaced)

    s.register("apps/v1", "DaemonSet", "daemonsets")
    s.register("apps/v1", "Deployment", "deployments")
    s.register("apps/v1", "StatefulSet", "statefulsets")
    s.register("apps/v1", "ReplicaSet", "replicasets")
    s.register("batch/v1", "Job", "jobs")

    s.register("rbac.authorization.k8s.io/v1", "Role", "roles")
    s.register("rbac.authorization.k8s.io/v1", "RoleBinding", "rolebindings")
    s.register("rbac.authorization.k8s.io/v1", "ClusterRole", "clusterroles", namespaced=False)
    s.register("rbac.authorization.k8s.io/v1", "ClusterRoleBinding", "clusterrolebindings", namespaced=False)

    s.register("coordination.k8s.io/v1", "Lease", "leases")
    s.register("node.k8s.io/v1", "RuntimeClass", "runtimeclasses", namespaced=False)
    s.register("scheduling.k8s.io/v1", "PriorityClass", "priorityclasses", namespaced=False)
    s.register("policy/v1", "PodDisruptionBudget", "poddisruptionbudgets")
    s.register("apiextensions.k8s.io/v1", "CustomResourceDefinition", "customresourcedefinitions", namespaced=False)

    s.register("monitoring.coreos.com/v1", "ServiceMonitor", "servicemonitors")
    s.register("monitoring.coreos.com/v1", "PrometheusRule", "prometheusrules")

    # the operator's own API group: tpu.ai/v1 ClusterPolicy names the
    # operator, not the accelerator, so the port keeps it; the per-pool
    # driver kind names the accelerator
    s.register("tpu.ai/v1", "ClusterPolicy", "clusterpolicies", namespaced=False)
    s.register("tpu.ai/v1alpha1", "GPUDriver", "gpudrivers", namespaced=False)
    return s
