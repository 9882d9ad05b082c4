"""Helpers for plain-dict Kubernetes objects (copy of
tpu_operator/utils/objects.py, the helpers the port uses)."""

from __future__ import annotations

import re
import time
from typing import Any, Mapping, Optional


def deep_get(obj: Optional[Mapping], *path: str, default: Any = None) -> Any:
    """Walk nested mappings; return ``default`` on any missing step."""
    cur: Any = obj
    for step in path:
        if not isinstance(cur, Mapping) or step not in cur:
            return default
        cur = cur[step]
    return cur


def rfc3339_now() -> str:
    """UTC now in the second-precision RFC 3339 form of metav1.Time."""
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def deep_merge(base: dict, overlay: Mapping) -> dict:
    """Merge ``overlay`` into ``base`` in place: mappings merge per key, any
    other value (lists included) replaces."""
    for key, value in overlay.items():
        if isinstance(value, Mapping) and isinstance(base.get(key), dict):
            deep_merge(base[key], value)
        else:
            base[key] = value if not isinstance(value, Mapping) else dict(value)
    return base


def json_merge_patch(target: dict, patch: Mapping) -> dict:
    """RFC 7386 JSON merge patch: null deletes, mappings recurse, the rest
    replaces."""
    for key, value in patch.items():
        if value is None:
            target.pop(key, None)
        elif isinstance(value, Mapping):
            node = target.get(key)
            if not isinstance(node, dict):
                node = target[key] = {}
            json_merge_patch(node, value)
        else:
            target[key] = value
    return target


def pod_requests_resource(pod: Mapping, resource: str) -> bool:
    """True when any container of the pod, init containers included,
    requests or limits ``resource``."""
    spec = pod.get("spec") or {}
    for field in ("initContainers", "containers"):
        for container in spec.get(field, []) or []:
            resources = container.get("resources") or {}
            if any(resource in (resources.get(section) or {})
                   for section in ("limits", "requests")):
                return True
    return False


_QUANTITY_RE = re.compile(r"^([0-9.]+)([a-zA-Z]*)$")
_SUFFIXES = {
    "": 1,
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
    "m": 1e-3,
}


def parse_quantity(value: Any) -> float:
    """Parse a k8s resource quantity ("4", "500m", "1Gi") to a float."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _QUANTITY_RE.match(str(value))
    if not m or m.group(2) not in _SUFFIXES:
        raise ValueError(f"unparseable quantity: {value!r}")
    return float(m.group(1)) * _SUFFIXES[m.group(2)]
