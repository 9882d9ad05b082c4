"""Watch-event predicates (copy of tpu_operator/controllers/predicates.py;
controller-runtime predicate funcs, as NVIDIA's clusterpolicy_controller.go:
256-352 filters node events)."""

from __future__ import annotations

from typing import Dict

from ..client.interface import WatchEvent
from ..utils import deep_get


class NodeChangeFilter:
    """Predicate gating node events to meaningful transitions.

    Kubelets PATCH node status every ~10s (heartbeat conditions); on a
    1000-node fleet that is a constant stream of MODIFIED events, and
    re-enqueueing reconciles for each one keeps the operator sweeping
    forever. NVIDIA's operator filters node watches to label
    changes that matter (clusterpolicy_controller.go:256-352,
    addWatchNewGPUNode). Here the fingerprint covers everything the
    operator actually consumes from a Node: labels (GPU
    presence/deploy gates), annotations (upgrade bookkeeping),
    spec (unschedulable/taints), and capacity/allocatable (extended
    resources). Status conditions and heartbeat timestamps are
    deliberately outside it."""

    def __init__(self):
        self._seen: Dict[str, tuple] = {}

    @staticmethod
    def _fingerprint(node: dict) -> tuple:
        meta = node.get("metadata", {}) or {}
        return (
            tuple(sorted((meta.get("labels") or {}).items())),
            tuple(sorted((meta.get("annotations") or {}).items())),
            repr(node.get("spec") or {}),
            tuple(sorted((deep_get(node, "status", "capacity",
                                   default={}) or {}).items())),
            tuple(sorted((deep_get(node, "status", "allocatable",
                                   default={}) or {}).items())),
        )

    def significant(self, event: WatchEvent) -> bool:
        name = deep_get(event.object, "metadata", "name", default="")
        if event.type == "DELETED":
            self._seen.pop(name, None)
            return True
        fingerprint = self._fingerprint(event.object)
        old = self._seen.get(name)
        self._seen[name] = fingerprint
        # unchanged ADDED covers relist resyncs replaying known nodes
        return old != fingerprint


def filtered_node_mapper(inner):
    """Wrap a watch mapper so heartbeat-only node events map to nothing.
    Each call owns a fresh NodeChangeFilter (per-controller state)."""
    node_filter = NodeChangeFilter()

    def mapper(event: WatchEvent):
        if not node_filter.significant(event):
            return []
        return inner(event)

    return mapper
