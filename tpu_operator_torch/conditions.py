"""CR status condition updaters (copy of tpu_operator/conditions/).

The Ready/Error condition pair; reasons follow NVIDIA's operator's
vocabulary (internal/conditions/consts.go) with the operator's additions.
"""

from __future__ import annotations

from typing import List, Optional

from .utils import deep_get, rfc3339_now

READY = "Ready"
ERROR = "Error"

# Reasons (reference internal/conditions/consts.go)
REASON_READY = "Ready"
REASON_RECONCILE_FAILED = "ReconcileFailed"
REASON_OPERAND_NOT_READY = "OperandNotReady"
REASON_NO_GPU_NODES = "NoGPUNodes"
REASON_DISCOVERY_LABELS_MISSING = "DiscoveryLabelsMissing"
REASON_CONFLICTING_NODE_SELECTOR = "ConflictingNodeSelector"
REASON_DRIVER_NOT_READY = "DriverNotReady"
REASON_SLICE_PARTITION_FAILED = "SlicePartitionFailed"

#: auxiliary condition type: a node's slice partitioner rejected its
#: desired partition (tpu.ai/slice.config.state=failed) — surfaced on the
#: ClusterPolicy so an impossible split is visible without scraping node
#: labels (MIG analog: mig.config.state=failed)
SLICE_PARTITION_FAILED = "SlicePartitionFailed"

#: auxiliary condition type: one or more nodes are somewhere in the
#: chip-health machine (degraded/quarantined/remediating/failed) — the
#: cluster-level rollup of the per-node tpu.ai/health-state labels
NODE_HEALTH_DEGRADED = "NodeHealthDegraded"
REASON_NODE_HEALTH_DEGRADED = "NodeHealthDegraded"

#: auxiliary condition type: rollup of per-node serving-SLO verdicts
#: (tpu.ai/serving-slo). True = every node that ran the serving probe met
#: its SLO; False = at least one node is failing; absent until any node
#: has published a verdict (absence is no-information, like the workload
#: health annotation)
SERVING_VALIDATED = "ServingValidated"
REASON_SERVING_SLO_MET = "ServingSLOMet"
REASON_SERVING_SLO_FAILED = "ServingSLOFailed"
#: every serving label disappeared (validation disabled, nodes replaced)
#: AFTER a verdict had been rolled up: the condition goes Unknown rather
#: than freezing at its last True/False
REASON_SERVING_NOT_REPORTING = "ServingNotReporting"


def make_condition(type_: str, status: str, reason: str, message: str = "") -> dict:
    return {
        "type": type_,
        "status": status,
        "reason": reason,
        "message": message,
        "lastTransitionTime": rfc3339_now(),
    }


def is_new_error(obj: dict, reason: str, message: str) -> bool:
    """True when (reason, message) differs from the object's current
    Error=True condition — the gate for emitting a Warning Event exactly once
    per distinct failure instead of on every requeue/resync sweep."""
    for c in deep_get(obj, "status", "conditions", default=[]) or []:
        if c.get("type") == ERROR and c.get("status") == "True":
            return c.get("reason") != reason or c.get("message") != message
    return True


def set_condition(conditions: List[dict], new: dict) -> List[dict]:
    """Upsert by type; keep lastTransitionTime when status is unchanged."""
    for i, existing in enumerate(conditions):
        if existing.get("type") == new["type"]:
            if existing.get("status") == new["status"]:
                new["lastTransitionTime"] = existing.get("lastTransitionTime", new["lastTransitionTime"])
            conditions[i] = new
            return conditions
    conditions.append(new)
    return conditions


def mark_ready(obj: dict, message: str = "All operands are ready") -> None:
    """Mutate obj.status.conditions to Ready; caller persists the status."""
    _mark(obj, [
        make_condition(READY, "True", REASON_READY, message),
        make_condition(ERROR, "False", REASON_READY, ""),
    ])


def mark_error(obj: dict, reason: str, message: str) -> None:
    _mark(obj, [
        make_condition(READY, "False", reason, ""),
        make_condition(ERROR, "True", reason, message),
    ])


def _mark(obj: dict, new_conditions: List[dict]) -> None:
    status = obj.setdefault("status", {})
    conditions = status.setdefault("conditions", [])
    generation = obj.get("metadata", {}).get("generation")
    for c in new_conditions:
        if generation is not None:
            c["observedGeneration"] = generation
        set_condition(conditions, c)
    # which spec revision this status describes (metav1 convention) — lets
    # clients detect a status that lags a just-edited spec
    if generation is not None:
        status["observedGeneration"] = generation


def get_condition(obj: dict, type_: str) -> Optional[dict]:
    for c in obj.get("status", {}).get("conditions", []):
        if c.get("type") == type_:
            return c
    return None
