"""Kubernetes Event recording (counterpart of tpu_operator/events.py).

:func:`record` is the operator's EventRecorder: a repeat of an identical
Event (same involved object, type, reason, message) bumps the stored
Event's ``count`` instead of minting a new object. :func:`record_once` is
the node agents' exactly-once announcement: the Event's name is
content-addressed from the involved object, the reason and a ``token``, so
the create itself is the test-and-set. Both are best-effort: a failed
write never breaks the caller. When a trace is active its id rides on the
Event as the ``tpu.ai/trace-id`` annotation.
"""

from __future__ import annotations

import hashlib
import logging
import uuid
from typing import Optional

from . import consts, tracing
from .client import is_conflict
from .utils import rfc3339_now

log = logging.getLogger(__name__)

NORMAL = "Normal"
WARNING = "Warning"


def _involved_ref(involved: dict) -> dict:
    meta = involved.get("metadata", {})
    return {
        "apiVersion": involved.get("apiVersion"),
        "kind": involved.get("kind"),
        "name": meta.get("name"),
        "namespace": meta.get("namespace", ""),
        "uid": meta.get("uid", ""),
    }


def _find_existing(client, namespace: str, ref: dict, type_: str, reason: str,
                   message: str, component: str) -> Optional[dict]:
    """The stored Event for the same (involved object, type, reason,
    message, component); emitters are transition-gated, so the list is short."""
    for event in client.list("v1", "Event", namespace):
        if (event.get("reason") == reason and event.get("type") == type_
                and event.get("message") == message
                and event.get("source", {}).get("component") == component):
            got = event.get("involvedObject", {})
            if all(got.get(k) == ref.get(k) for k in ("kind", "name", "uid")):
                return event
    return None


def record(client, namespace: str, involved: dict, type_: str, reason: str,
           message: str, component: str = "gpu-operator") -> Optional[dict]:
    """Record an Event, aggregating a repeat of an identical one."""
    meta = involved.get("metadata", {})
    now = rfc3339_now()
    message = message[:1024]
    ref = _involved_ref(involved)
    trace_id = tracing.current_trace_id()
    try:
        existing = _find_existing(client, namespace, ref, type_, reason, message, component)
        if existing is not None:
            existing["count"] = int(existing.get("count") or 1) + 1
            existing["lastTimestamp"] = now
            if trace_id:
                existing.setdefault("metadata", {}).setdefault(
                    "annotations", {})[consts.TRACE_ID_ANNOTATION] = trace_id
            return client.update(existing)
    except Exception as e:
        # aggregation is an optimisation: any failure falls through to create
        log.debug("event aggregation failed (%s %s): %s", reason, meta.get("name"), e)
    stem = meta.get("name", "unknown")[:50].rstrip("-.") or "unknown"
    event = {
        "apiVersion": "v1",
        "kind": "Event",
        "metadata": {"name": f"{stem}.{uuid.uuid4().hex[:12]}", "namespace": namespace},
        "involvedObject": ref,
        "type": type_,
        "reason": reason,
        "message": message,
        "source": {"component": component},
        "firstTimestamp": now,
        "lastTimestamp": now,
        "count": 1,
    }
    if trace_id:
        event["metadata"]["annotations"] = {consts.TRACE_ID_ANNOTATION: trace_id}
    try:
        return client.create(event)
    except Exception as e:
        log.debug("event write failed (%s %s): %s", reason, meta.get("name"), e)
        return None


def record_once(client, namespace: str, involved: dict, type_: str, reason: str,
                message: str, token: str, component: str = "tpu-operator") -> Optional[dict]:
    """Create the Event for (``involved``, ``reason``, ``token``) unless it
    exists. Returns the created Event, or None when it already existed or
    the write failed."""
    meta = involved.get("metadata", {})
    now = rfc3339_now()
    stem = meta.get("name", "unknown")[:50].rstrip("-.") or "unknown"
    digest = hashlib.sha1(f"{reason}:{token}".encode()).hexdigest()[:12]
    event = {
        "apiVersion": "v1",
        "kind": "Event",
        "metadata": {"name": f"{stem}.{digest}", "namespace": namespace},
        "involvedObject": _involved_ref(involved),
        "type": type_,
        "reason": reason,
        "message": message[:1024],
        "source": {"component": component},
        "firstTimestamp": now,
        "lastTimestamp": now,
        "count": 1,
    }
    trace_id = tracing.current_trace_id()
    if trace_id:
        event["metadata"]["annotations"] = {consts.TRACE_ID_ANNOTATION: trace_id}
    try:
        return client.create(event)
    except Exception as e:
        if is_conflict(e):
            return None  # someone announced this token first: by design
        log.debug("event write failed (%s %s): %s", reason, meta.get("name"), e)
        return None
