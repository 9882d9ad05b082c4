"""Object helpers of the validator and the operator (copies of
tpu_operator/utils/objects.py and tpu_operator/utils/hash.py), and the CUDA
device-order pin every sweep process gets (torch-free, for the processes
that must not import torch)."""

from __future__ import annotations

import copy
import json
import re
import time
from typing import Any, Mapping, MutableMapping, Optional

from . import consts


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


_FNV_OFFSET_32 = 0x811C9DC5
_FNV_PRIME_32 = 0x01000193


def fnv32a(data: bytes) -> int:
    h = _FNV_OFFSET_32
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME_32) & 0xFFFFFFFF
    return h


def object_hash(obj: Any) -> str:
    """FNV-32a of the canonical (key-sorted) JSON of ``obj``, in hex: the
    operator's hash, so both sides compute the same drain-plan identity."""
    payload = json.dumps(obj, sort_keys=True, separators=(",", ":"), default=str)
    return format(fnv32a(payload.encode("utf-8")), "x")


def template_fingerprint(template: dict) -> str:
    """Whole-pod-template fingerprint, the fingerprint label itself left
    out (it is derived from the rest of the template)."""
    doc = copy.deepcopy(template or {})
    labels = doc.get("metadata", {}).get("labels")
    if labels:
        labels.pop(consts.TEMPLATE_HASH_LABEL, None)
    return object_hash(doc)


def pin_device_order(env: MutableMapping[str, str]) -> MutableMapping[str, str]:
    """Set ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` in ``env`` unless the caller
    chose an order, and return it. CUDA reads it once, at its first call in
    a process, so a sweep process gets it before it touches CUDA: then
    ordinal ``i`` is the ``i``-th GPU in PCI order, the device plugin's unit
    ``i`` (whose device node is that GPU's minor), and a barrier's failing
    local GPU ``i`` gates the GPU that failed."""
    env.setdefault(consts.CUDA_DEVICE_ORDER_ENV, consts.CUDA_DEVICE_ORDER)
    return env
