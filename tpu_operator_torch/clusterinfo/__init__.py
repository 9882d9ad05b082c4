"""Cluster facts (counterpart of tpu_operator/clusterinfo/__init__.py;
NVIDIA's controllers/clusterinfo/clusterinfo.go).

Caches or fetches what a support bundle and the reconciles need: the
Kubernetes version and the cluster's container runtime. The runtime is read
from ``node.status.nodeInfo.containerRuntimeVersion`` across nodes
(clusterinfo.go:246-294); the most common one wins. (NVIDIA's falls back to
the CR's defaultRuntime, which configures its container toolkit; the port,
like the reference, has no toolkit layer, so that field is absent.)
"""

from __future__ import annotations

import logging
from collections import Counter
from typing import Optional

from ..client.interface import Client
from ..utils import deep_get

log = logging.getLogger(__name__)


class ClusterInfo:
    def __init__(self, client: Client, one_shot: bool = False):
        self._client = client
        self._one_shot = one_shot
        self._k8s_version: Optional[str] = None
        self._runtime: Optional[str] = None

    def kubernetes_version(self) -> str:
        if self._k8s_version is None or not self._one_shot:
            self._k8s_version = self._fetch_version()
        return self._k8s_version

    def _fetch_version(self) -> str:
        getter = getattr(self._client, "server_version", None)
        if getter is not None:
            try:
                return getter()
            except Exception as e:
                log.warning("server version fetch failed: %s", e)
        # fall back to the kubelet versions the nodes report
        for node in self._client.list("v1", "Node"):
            v = deep_get(node, "status", "nodeInfo", "kubeletVersion")
            if v:
                return v
        return "unknown"

    def container_runtime(self, default: str = "containerd") -> str:
        if self._runtime is not None and self._one_shot:
            return self._runtime
        counts: Counter = Counter()
        for node in self._client.list("v1", "Node"):
            raw = deep_get(node, "status", "nodeInfo", "containerRuntimeVersion", default="")
            if "://" in raw:
                counts[raw.split("://", 1)[0]] += 1
        self._runtime = counts.most_common(1)[0][0] if counts else default
        return self._runtime
