"""Compact span records: the wire format between operand pods and the
operator (copy of tpu_operator/joinprofile/records.py).

A record is a small dict (short keys — the payload rides a node annotation
with etcd's 256 KiB object budget in mind):

====  ========================================================
i     span_id (16 hex)
p     parent span_id ("" for a remote root's operator-side parent)
t     trace_id (32 hex)
n     span name
s     start (unix seconds)
d     duration seconds (None while the span is still open)
st    status (ok / error / unset)
a     attributes (flat dict, only JSON scalars)
====  ========================================================

Size bound: the host-path log keeps the newest
``MAX_LOG_RECORDS`` records; the annotation mirror truncates to
``MAX_ANNOTATION_RECORDS`` records and ``MAX_ANNOTATION_BYTES`` encoded
bytes, dropping OLDEST first — the freshest validation cycle is the one
the operator is stitching.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional

log = logging.getLogger(__name__)

#: host-path span log: newest-N bound so a year of revalidation cycles
#: cannot grow the file past a few tens of KiB
MAX_LOG_RECORDS = 200

#: annotation mirror bounds (newest-first): etcd charges the whole Node
#: object for every annotation byte
MAX_ANNOTATION_RECORDS = 64
MAX_ANNOTATION_BYTES = 16384

#: the span-log file name inside the validation status dir
SPAN_LOG_NAME = "trace-spans.json"


def _scalar_attrs(attrs: dict) -> dict:
    return {k: v for k, v in (attrs or {}).items()
            if isinstance(v, (str, int, float, bool)) or v is None}


def span_to_records(root) -> List[dict]:
    """Flatten a span tree into compact records (start order)."""
    out = []
    for sp in root.walk():
        out.append({
            "i": sp.span_id,
            "p": sp.parent_id or "",
            "t": sp.trace_id,
            "n": sp.name,
            "s": round(sp.start_unix, 3),
            "d": (round(sp.duration_s, 4)
                  if sp.duration_s is not None else None),
            "st": sp.status,
            "a": _scalar_attrs(sp.attributes),
        })
    return out


def valid_record(rec) -> bool:
    return (isinstance(rec, dict) and isinstance(rec.get("i"), str)
            and isinstance(rec.get("t"), str)
            and isinstance(rec.get("n"), str)
            and isinstance(rec.get("s"), (int, float)))


class SpanLog:
    """The bounded span-record file inside a node's validation status dir.

    Strictly best-effort on the write side: feature discovery mounts the
    status dir read-only and operands may race the file — a failed append
    is a dropped record, never a failed validation. Reads tolerate
    corruption by returning []."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, SPAN_LOG_NAME)

    def read(self) -> List[dict]:
        try:
            with open(self.path, encoding="utf-8", errors="replace") as f:
                raw = json.load(f)
        except FileNotFoundError:
            return []
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            # torn write / truncation / binary garbage: a crash mid-append
            # (or a racing operand) may leave a half-written file behind.
            # Empty-with-warning, never raise — span history is advisory
            # and the next atomic append replaces the file wholesale.
            log.warning("span log %s unreadable (%s: %s); treating as empty",
                        self.path, type(e).__name__, e)
            return []
        if not isinstance(raw, list):
            log.warning("span log %s is not a JSON list; treating as empty",
                        self.path)
            return []
        return [r for r in raw if valid_record(r)]

    def append(self, records: List[dict]) -> bool:
        """Merge records by span id (new wins — an open record published at
        trace start is replaced by its closed version at exit), keep the
        newest ``MAX_LOG_RECORDS`` by start time, write atomically."""
        merged = {r["i"]: r for r in self.read()}
        for rec in records:
            if valid_record(rec):
                merged[rec["i"]] = rec
        bounded = sorted(merged.values(), key=lambda r: r["s"])[-MAX_LOG_RECORDS:]
        tmp = self.path + ".tmp"
        try:
            os.makedirs(self.directory, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(bounded, f, separators=(",", ":"))
            os.replace(tmp, self.path)  # atomic: readers never see a partial log
        except OSError as e:
            log.debug("span log append skipped (%s)", e)
            return False
        return True

    def sink(self):
        """A :func:`tpu_operator_torch.tracing.remote_trace` sink writing this
        log: converts the root span's subtree and appends."""
        def _sink(root) -> None:
            self.append(span_to_records(root))
        return _sink


def encode_annotation(records: List[dict],
                      max_records: int = MAX_ANNOTATION_RECORDS,
                      max_bytes: int = MAX_ANNOTATION_BYTES) -> str:
    """Newest-``max_records`` records as compact JSON, shrunk further (still
    newest-first retention) until the encoding fits ``max_bytes``. "" when
    nothing survives — the caller clears the annotation."""
    keep = sorted((r for r in records if valid_record(r)),
                  key=lambda r: r["s"])[-max_records:]
    while keep:
        encoded = json.dumps(keep, separators=(",", ":"))
        if len(encoded.encode()) <= max_bytes:
            return encoded
        keep = keep[1:]  # drop the oldest until the mirror fits
    return ""


def decode_annotation(value: Optional[str]) -> List[dict]:
    if not value:
        return []
    try:
        raw = json.loads(value)
    except (json.JSONDecodeError, TypeError):
        return []
    if not isinstance(raw, list):
        return []
    return [r for r in raw if valid_record(r)]
