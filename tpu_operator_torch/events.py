"""Kubernetes Events recorded exactly once (counterpart of the
``record_once`` path of tpu_operator/events.py).

The Event's name is content-addressed from the involved object, the reason
and a ``token``, so the create itself is the test-and-set: a second emitter
of the same announcement collides with 409 AlreadyExists and stands down.
Best-effort: a failed write never breaks the caller. When a trace is
active its id rides on the Event as the ``tpu.ai/trace-id`` annotation.
"""

from __future__ import annotations

import hashlib
import logging
import time
from typing import Optional

from . import consts, tracing
from .client import is_conflict

log = logging.getLogger(__name__)

NORMAL = "Normal"
WARNING = "Warning"


def rfc3339_now() -> str:
    """UTC now, in the second-precision RFC 3339 form of metav1.Time."""
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


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
        "involvedObject": {
            "apiVersion": involved.get("apiVersion"),
            "kind": involved.get("kind"),
            "name": meta.get("name"),
            "namespace": meta.get("namespace", ""),
            "uid": meta.get("uid", ""),
        },
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
