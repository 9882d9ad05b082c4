"""Serving SLO validation: CLI glue between the probe and the barrier
(counterpart of tpu_operator/validator/serving.py).

- The **health gate**: a quarantined, remediating or failed node must not
  certify serving SLOs. The probe is skipped and the barrier written
  fail-CLOSED (``passed: false`` with a ``skipped_reason``). Health state
  comes from the pod env (``GPU_HEALTH_STATE``) or, when a client is
  available, the node's ``tpu.ai/health-state`` label.
- The **barrier contract**: the serving barrier is written on both pass
  and fail, so a node whose decode tail regresses flips its label. A probe
  that cannot run (no CUDA device, a capture that fails) is a failed
  verdict with a ``probe-error`` reason, never a fallback to the CPU.
"""

from __future__ import annotations

import json
import logging
import os
from typing import TYPE_CHECKING, Optional, Sequence

from .. import consts
from ..utils import deep_get
from .status import StatusFiles

if TYPE_CHECKING:  # the operator reads parse_serving_detail without torch
    from ..device import DeviceLike

log = logging.getLogger(__name__)

#: health states that fail the serving probe closed (degraded still serves)
GATED_HEALTH_STATES = ("quarantined", "remediating", "failed")

#: standalone probe pod (workload.py WORKLOAD_POD_TEMPLATE analog)
SERVING_POD_TEMPLATE = {
    "apiVersion": "v1",
    "kind": "Pod",
    "metadata": {"name": "gpu-serving-validation",
                 "labels": {"app": "gpu-serving-validation"}},
    "spec": {
        "restartPolicy": "Never",
        "tolerations": [{"key": consts.GPU_RESOURCE_NAME, "operator": "Exists",
                         "effect": "NoSchedule"}],
        "containers": [{
            "name": "gpu-serving",
            "image": "FILLED_BY_VALIDATOR",
            "command": ["gpu-validator"],
            "args": ["-c", "serving"],
            "env": [{"name": "STATUS_DIR", "value": "FILLED_BY_VALIDATOR"}],
        }],
    },
}


def node_health_state(client=None, node_name: Optional[str] = None) -> Optional[str]:
    """This node's health state, best source first: the pod env
    (``GPU_HEALTH_STATE``), then the node label via the apiserver. None =
    unknown/healthy (absence of the label is the healthy steady state)."""
    state = os.environ.get(consts.HEALTH_STATE_ENV)
    if state:
        return state
    node_name = node_name or os.environ.get("NODE_NAME", "")
    if client is None or not node_name:
        return None
    try:
        node = client.get("v1", "Node", node_name)
        return deep_get(node, "metadata", "labels", consts.HEALTH_STATE_LABEL)
    except Exception as e:
        # can't read the label -> don't gate: the probe's own numbers are
        # still a real verdict, and health owns quarantine enforcement
        log.debug("serving: health-state lookup failed: %s", e)
        return None


def run_serving(status: StatusFiles,
                batch_sizes: Sequence[int] = (1, 4, 8),
                steps_per_batch: int = 32,
                max_decode_p99_ms: float = 200.0,
                min_throughput_tokens_per_s: float = 0.0,
                min_slo_attainment: float = 0.99,
                client=None, node_name: Optional[str] = None,
                device: DeviceLike = None) -> int:
    """One probe cycle: health gate, probe, barrier write, exit code."""
    from ..serving.probe import run_probe, skipped_report

    thresholds = {"max_decode_p99_ms": max_decode_p99_ms,
                  "min_throughput_tokens_per_s": min_throughput_tokens_per_s,
                  "min_slo_attainment": min_slo_attainment}
    state = node_health_state(client, node_name)
    if state in GATED_HEALTH_STATES:
        report = skipped_report(f"health-state={state}", thresholds)
        log.warning("serving probe skipped, failing closed: node is %s", state)
    else:
        try:
            report = run_probe(
                batch_sizes=batch_sizes, steps_per_batch=steps_per_batch,
                max_decode_p99_ms=max_decode_p99_ms,
                min_throughput_tokens_per_s=min_throughput_tokens_per_s,
                min_slo_attainment=min_slo_attainment, device=device)
        except Exception as e:
            # a probe that can't run (no card, capture failure) is a failed
            # serving verdict, not a crash: fail closed with the reason
            log.exception("serving probe crashed")
            report = skipped_report(f"probe-error: {e}"[:200], thresholds)
    payload = report.to_dict()
    # stamp the template hash the probe ran under into the frontier, so the
    # operator can tell a curve measured under the node's current template
    # from one that predates a template change
    if payload.get("frontier") is not None:
        payload["frontier"]["template"] = os.environ.get(consts.TEMPLATE_HASH_ENV, "")
    print(json.dumps(payload))
    status.write("serving", payload)
    return 0 if report.passed else 1


def serving_detail(report: dict) -> str:
    """Compact annotation value for the measured numbers (commas/decimals
    are not label-safe, so detail rides in an annotation)."""
    if report.get("skipped_reason"):
        return f"skipped={report['skipped_reason']}"
    return (f"p99_ms={report.get('decode_p99_ms', 0)},"
            f"tokens_per_s={report.get('throughput_tokens_per_s', 0)},"
            f"attainment={report.get('slo_attainment', 0)}")


def parse_serving_detail(detail) -> dict:
    """Inverse of :func:`serving_detail`: ``{"p99_ms", "tokens_per_s",
    "attainment"}`` or ``{"skipped": reason}``; ``{}`` on absent or garbled
    annotations (a half-written value degrades to "no numbers")."""
    if not detail or not isinstance(detail, str):
        return {}
    if detail.startswith("skipped="):
        return {"skipped": detail[len("skipped="):]}
    out: dict = {}
    for part in detail.split(","):
        key, sep, value = part.partition("=")
        if not sep:
            continue
        try:
            out[key.strip()] = float(value)
        except ValueError:
            continue
    return out
