"""Deterministic object hashing (copy of tpu_operator/utils/hash.py): FNV-32a
over canonical, key-sorted JSON."""

from __future__ import annotations

import copy
import json
from typing import Any

from .. import consts

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
