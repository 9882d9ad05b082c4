"""GPU feature discovery (counterpart of tpu_operator/validator/feature_discovery.py).

Mines the GPU type, count and memory from the node itself and writes the
operator's ``tpu.ai/tpu.*`` labels, then mirrors the node-local barrier
verdicts and span log to the node for the operator. Sources, best first:
CUDA enumeration (``torch.cuda.get_device_properties``: the device's name
and memory), GKE's own accelerator label (passthrough), then device-node
counting.

GPUs have no GKE topology label, so the port writes no topology label.

The agent is resident on every node and runs a pass every minute, so
enumeration must not create a CUDA context: a context pins hundreds of MiB
on every GPU for the DaemonSet's life. ``device_count`` and
``get_device_properties`` need none; ``mem_get_info`` would (``info``
uses it, once).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import torch

from .. import consts, tracing
from ..client import preconditioned_patch
from ..device import DeviceLike, resolve_device
from ..utils import deep_get
from .driver import discover_devices
from .status import StatusFiles

log = logging.getLogger(__name__)

#: CUDA device name prefix (lower case) -> GKE's accelerator name, first
#: match wins (the 80 GB A100 before the 40 GB one)
_KIND_TO_TYPE = {
    "nvidia h100 80gb": "nvidia-h100-80gb",
    "nvidia h200": "nvidia-h200-141gb",
    "nvidia a100-sxm4-80gb": "nvidia-a100-80gb",
    "nvidia a100": "nvidia-tesla-a100",
    "nvidia l4": "nvidia-l4",
}


def chip_type_from_kind(device_kind: str) -> str:
    kind = device_kind.lower()
    for prefix, label in _KIND_TO_TYPE.items():
        if kind.startswith(prefix):
            return label
    return kind.replace(" ", "-") or "unknown"


def _status_dir(status_dir: Optional[str]) -> str:
    return status_dir or os.environ.get("STATUS_DIR", consts.VALIDATION_STATUS_DIR)


def discover(device: DeviceLike = None, status_dir: Optional[str] = None) -> Dict[str, str]:
    """The label set this node should carry. On ``cuda`` (the default) the
    GPUs are enumerated without a context, and the call raises without
    CUDA; ``device="cpu"`` enumerates nothing and counts device nodes."""
    labels: Dict[str, str] = {}
    chip_count = 0
    if resolve_device(device).type == "cuda":
        chip_count = torch.cuda.device_count()
        props = torch.cuda.get_device_properties(0)
        labels[consts.TPU_CHIP_TYPE_LABEL] = chip_type_from_kind(props.name)
        gib = round(props.total_memory / (1 << 30))
        if gib:
            labels[consts.TPU_MEMORY_LABEL] = f"{gib}Gi"
    if chip_count == 0:
        chip_count = len(discover_devices())
    if chip_count:
        labels[consts.TPU_CHIP_COUNT_LABEL] = str(chip_count)
    version = _driver_version(status_dir)
    if version:
        labels[consts.TPU_LIBTPU_VERSION_LABEL] = version
    return labels


def _driver_version(status_dir: Optional[str] = None) -> str:
    """The driver version an installer recorded in the driver barrier (the
    barrier keeps the TPU operator's key, ``libtpu_version``); "" when
    unknown."""
    record = StatusFiles(_status_dir(status_dir)).read("driver") or {}
    version = record.get("libtpu_version", "")
    return version if isinstance(version, str) and version != "bundled" else ""


def workload_health_verdict(status_dir: Optional[str] = None) -> Optional[str]:
    """The workload barrier's verdict for the operator's health sweep:
    ``"passed"`` | ``"failed"`` | ``"failed:<gpu,gpu>"`` | ``"corrupt"``;
    None while the barrier is unwritten (a fresh node: no information, not
    a failure). GPU attribution rides the value, an annotation, since label
    values cannot hold commas."""
    from .status import failed_local_chips

    status = StatusFiles(_status_dir(status_dir))
    info = status.read("workload")
    if info is None:
        if os.path.exists(status.path("workload")):
            return "corrupt"  # present but unparsable: fail safe
        return None
    if info.get("passed") is not False:
        return "passed"
    failed = failed_local_chips(info, len(discover_devices()))
    if failed:
        return "failed:" + ",".join(str(c) for c in sorted(failed))
    return "failed"


def serving_slo_verdict(status_dir: Optional[str] = None):
    """The serving barrier's verdict for the ``tpu.ai/serving-slo`` label and
    its detail annotation: ``("passed"|"failed"|"corrupt", detail)``, with
    ``skipped=corrupt`` as the detail of a corrupt barrier so stale numbers
    never outlive their verdict; ``(None, "")`` while it is unwritten."""
    from .serving import serving_detail

    status = StatusFiles(_status_dir(status_dir))
    info = status.read("serving")
    if info is None:
        if os.path.exists(status.path("serving")):
            return "corrupt", "skipped=corrupt"
        return None, ""
    if "passed" not in info:
        # valid JSON without a verdict: only an explicit pass may certify
        return "corrupt", "skipped=corrupt"
    verdict = "passed" if info.get("passed") is True else "failed"
    return verdict, serving_detail(info)


def serving_frontier_value(status_dir: Optional[str] = None) -> Optional[str]:
    """The ``tpu.ai/serving-frontier`` annotation value: the measured curve
    in the compact codec; ``""`` (clear it) when the barrier is failing,
    corrupt or has no curve, since measured capacity must not outlive its
    verdict; None while the barrier is unwritten (annotation untouched)."""
    from ..serving import frontier as frontier_schema

    status = StatusFiles(_status_dir(status_dir))
    info = status.read("serving")
    if info is None:
        if os.path.exists(status.path("serving")):
            return ""
        return None
    if info.get("passed") is not True:
        return ""
    fr = frontier_schema.from_dict(info.get("frontier"))
    if fr is None:
        return ""
    return frontier_schema.encode_annotation(fr)


def sync_node_labels(client, node_name: str, device: DeviceLike = None,
                     status_dir: Optional[str] = None) -> Dict[str, str]:
    """One discovery pass: compute the labels, mirror GKE's, patch what
    drifted; then mirror the barrier verdicts, the drain ack and the span
    log to the node's annotations."""
    from ..health import drain as drainproto
    from ..joinprofile.records import SpanLog, encode_annotation
    from ..serving import frontier as frontier_schema

    status_dir = _status_dir(status_dir)
    node = client.get("v1", "Node", node_name)
    current = deep_get(node, "metadata", "labels", default={}) or {}
    desired = discover(device, status_dir)
    if consts.GKE_ACCELERATOR_LABEL in current:
        desired.setdefault(consts.TPU_CHIP_TYPE_LABEL, current[consts.GKE_ACCELERATOR_LABEL])
    patch = {k: v for k, v in desired.items() if current.get(k) != v}
    if patch:
        client.patch("v1", "Node", node_name, {"metadata": {"labels": patch}})
        log.info("feature discovery: %s labels %s", node_name, patch)
    # the workload verdict the operator's health machine reads
    verdict = workload_health_verdict(status_dir)
    current_ann = deep_get(node, "metadata", "annotations", consts.WORKLOAD_HEALTH_ANNOTATION)
    if verdict is not None and verdict != current_ann:
        client.patch("v1", "Node", node_name, {"metadata": {
            "annotations": {consts.WORKLOAD_HEALTH_ANNOTATION: verdict}}})
        log.info("feature discovery: %s workload health -> %s", node_name, verdict)
    # the barrier's drain-ack stamp, mirrored for the operator's drain gate
    # and cleared when the stamp goes; preconditioned on the version read,
    # since this races the health sweep's retirement of the episode and a
    # blind patch from a stale read would resurrect a retired ack
    ack_value = drainproto.ack_annotation_value(
        drainproto.read_drain_ack(StatusFiles(status_dir)))
    current_ack = deep_get(node, "metadata", "annotations", consts.DRAIN_ACK_ANNOTATION)
    if ack_value != current_ack:
        def build_ack(fresh: dict) -> Optional[dict]:
            fresh_ack = deep_get(fresh, "metadata", "annotations",
                                 consts.DRAIN_ACK_ANNOTATION)
            if fresh_ack == ack_value:
                return None  # mirrored (or cleared) by someone else meanwhile
            return {"metadata": {"annotations": {consts.DRAIN_ACK_ANNOTATION: ack_value}}}

        preconditioned_patch(client, "v1", "Node", node_name, build_ack)
        if ack_value:
            log.info("feature discovery: %s drain ack -> %s", node_name, ack_value)
    # the serving verdict gates traffic placement; its numbers ride the
    # detail annotation, patched on any drift so a corrupt barrier replaces
    # stale numbers with its marker
    serving, detail = serving_slo_verdict(status_dir)
    if serving is not None:
        if serving != current.get(consts.SERVING_SLO_LABEL):
            client.patch("v1", "Node", node_name, {"metadata": {
                "labels": {consts.SERVING_SLO_LABEL: serving}}})
            log.info("feature discovery: %s serving SLO -> %s", node_name, serving)
        current_detail = deep_get(node, "metadata", "annotations",
                                  consts.SERVING_SLO_ANNOTATION)
        if detail != current_detail:
            client.patch("v1", "Node", node_name, {"metadata": {
                "annotations": {consts.SERVING_SLO_ANNOTATION: detail}}})
    # the measured frontier: published on a passing barrier, cleared (merge-
    # patch delete) when it fails or goes corrupt
    frontier_value = serving_frontier_value(status_dir)
    if frontier_value is not None:
        current_frontier = deep_get(node, "metadata", "annotations",
                                    consts.SERVING_FRONTIER_ANNOTATION)
        if (current_frontier or None) != (frontier_value or None):
            client.patch("v1", "Node", node_name, {"metadata": {
                "annotations": {consts.SERVING_FRONTIER_ANNOTATION: frontier_value or None}}})
            log.info("feature discovery: %s serving frontier %s", node_name,
                     "updated" if frontier_value else "cleared")
        # a curve measured under the node's CURRENT template satisfies a
        # pending re-probe request
        if frontier_value:
            fr = frontier_schema.decode_annotation(frontier_value)
            reprobe = deep_get(node, "metadata", "annotations",
                               consts.SERVING_REPROBE_ANNOTATION)
            live_template = current.get(consts.TEMPLATE_HASH_LABEL, "")
            if reprobe and fr is not None and fr.template and fr.template == live_template:
                client.patch("v1", "Node", node_name, {"metadata": {
                    "annotations": {consts.SERVING_REPROBE_ANNOTATION: None}}})
    # the node's span log, size-bounded, for the operator's join profiler
    spans_value = encode_annotation(SpanLog(status_dir).read())
    current_spans = deep_get(node, "metadata", "annotations", consts.TRACE_SPANS_ANNOTATION)
    if spans_value and spans_value != current_spans:
        client.patch("v1", "Node", node_name, {"metadata": {
            "annotations": {consts.TRACE_SPANS_ANNOTATION: spans_value}}})
    return desired


def run(client, node_name: Optional[str] = None, sleep_interval: float = 60.0,
        iterations: Optional[int] = None, device: DeviceLike = None,
        status_dir: Optional[str] = None) -> int:
    """The labeler loop: a pass every ``sleep_interval`` s, forever unless
    ``iterations`` is given. Fails closed without CUDA unless
    ``device="cpu"``: it raises before the first pass."""
    node_name = node_name or os.environ.get("NODE_NAME", "")
    if not node_name:
        log.error("feature discovery: NODE_NAME unset")
        return 1
    resolve_device(device)
    count = 0
    while iterations is None or count < iterations:
        try:
            sync_node_labels(client, node_name, device, status_dir)
        except Exception:
            log.exception("feature discovery pass failed")
        # the status dir is mounted read-only in the cluster, so this write
        # fails quietly there; the open root published at entry stands
        tracing.flush_spans()
        count += 1
        if iterations is not None and count >= iterations:
            break
        time.sleep(sleep_interval)
    return 0
