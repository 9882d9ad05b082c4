"""The serving frontier: a versioned latency-vs-throughput curve (copy of
tpu_operator/serving/frontier.py; pure Python, schema and codec unchanged,
so either package's consumers parse either package's curves).

For each decode batch depth the probe (serving/probe.py) measures the
steady-state tokens/s and the per-step p99, so a consumer can answer *how
many tokens per second does this node serve while staying under the SLO
ceiling?* The answer trades batch depth against latency, which is why it
is a curve, not a scalar.

``from_dict`` accepts version-less payloads forever and reads them as v1;
unknown *newer* versions are rejected (None), never guessed at.

The annotation codec (``encode_annotation``/``decode_annotation``) is the
fleet transport: feature discovery mirrors the barrier's frontier onto the
``tpu.ai/serving-frontier`` node annotation in a compact semicolon format
bounded by ``MAX_ANNOTATION_BYTES``. Truncation drops the deepest points
first and the truncated payload always re-parses.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

#: current schema version; bump only with a migration path in from_dict
FRONTIER_VERSION = 1

#: hard bound on the encoded ``tpu.ai/serving-frontier`` annotation value.
#: Annotations ride every Node GET/watch event, so the curve must stay a
#: few hundred bytes, not the 16 KiB the span-log mirror is allowed.
MAX_ANNOTATION_BYTES = 1024

#: p99 bucket upper bounds (ms) for the
#: ``tpu_operator_serving_frontier_tokens_per_s{pool,p99_bucket}`` family.
P99_BUCKETS_MS = (5.0, 10.0, 25.0, 50.0, 100.0, 250.0)


def p99_bucket(p99_ms: float) -> str:
    """Map a measured p99 to its metric bucket label (``le10`` ... ``inf``)."""
    for bound in P99_BUCKETS_MS:
        if p99_ms <= bound:
            return f"le{int(bound)}"
    return "inf"


@dataclasses.dataclass
class FrontierPoint:
    """One measured point: decode depth -> (tail latency, throughput)."""

    batch: int
    p99_ms: float
    tokens_per_s: float
    #: how many timed steps produced this point — consumers judge
    #: confidence by it (a p99 over 8 samples is the max, not a tail)
    samples: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Frontier:
    """A node's measured latency-vs-throughput curve."""

    points: List[FrontierPoint]
    model_dim: int = 0
    #: unix seconds at probe time — staleness is judged against this
    measured_at: float = 0.0
    #: node template hash the curve was measured under; a node whose
    #: live template label departs this value needs a re-probe
    template: str = ""
    version: int = FRONTIER_VERSION

    def best_tokens_per_s(self, max_p99_ms: float) -> float:
        """Peak throughput among points meeting the p99 ceiling — the
        number the autoscaler divides demand by. 0.0 when no point
        qualifies (the node cannot serve this SLO at any depth)."""
        return max((p.tokens_per_s for p in self.points
                    if p.p99_ms <= max_p99_ms), default=0.0)

    def best_depth(self, max_p99_ms: float) -> int:
        """Deepest batch still inside the SLO — the admission ceiling."""
        best = 0.0
        depth = 0
        for p in self.points:
            if p.p99_ms <= max_p99_ms and p.tokens_per_s >= best:
                best, depth = p.tokens_per_s, p.batch
        return depth

    def min_samples(self) -> int:
        return min((p.samples for p in self.points), default=0)

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "model_dim": self.model_dim,
            "measured_at": self.measured_at,
            "template": self.template,
            "points": [p.to_dict() for p in self.points],
        }


def from_dict(payload: Optional[dict]) -> Optional[Frontier]:
    """Parse a barrier/debug payload. Version-less dicts are v1 forever;
    versions newer than this code understands return None (fail closed to
    'no frontier', which downgrades consumers to their fallback paths)."""
    if not isinstance(payload, dict):
        return None
    version = payload.get("version", FRONTIER_VERSION)
    if not isinstance(version, int) or version < 1 or version > FRONTIER_VERSION:
        return None
    raw_points = payload.get("points")
    if not isinstance(raw_points, list):
        return None
    points: List[FrontierPoint] = []
    try:
        for rp in raw_points:
            points.append(FrontierPoint(
                batch=int(rp["batch"]),
                p99_ms=float(rp["p99_ms"]),
                tokens_per_s=float(rp["tokens_per_s"]),
                samples=int(rp.get("samples", 0))))
    except (KeyError, TypeError, ValueError):
        return None
    try:
        return Frontier(
            points=points,
            model_dim=int(payload.get("model_dim", 0)),
            measured_at=float(payload.get("measured_at", 0.0)),
            template=str(payload.get("template", "")),
            version=version)
    except (TypeError, ValueError):
        return None


def _encode_point(p: FrontierPoint) -> str:
    return f"{p.batch}:{p.p99_ms:g}:{p.tokens_per_s:g}:{p.samples}"


def encode_annotation(frontier: Frontier,
                      max_bytes: int = MAX_ANNOTATION_BYTES) -> str:
    """Compact node-annotation form::

        v=1;at=1754550000;t=<template>;p=1:0.4:2500:32,4:0.9:4400:32,...

    Points are sorted shallow-to-deep and dropped deep-end-first until the
    value fits ``max_bytes``; every truncation point yields a payload
    ``decode_annotation`` re-parses to a valid (shorter) frontier."""
    points = sorted(frontier.points, key=lambda p: p.batch)
    head = f"v={frontier.version};at={frontier.measured_at:g}"
    if frontier.template:
        head += f";t={frontier.template}"
    while True:
        body = ",".join(_encode_point(p) for p in points)
        value = f"{head};p={body}" if body else head
        if len(value.encode("utf-8")) <= max_bytes or not points:
            return value
        points = points[:-1]


def decode_annotation(value: Optional[str]) -> Optional[Frontier]:
    """Inverse of ``encode_annotation``. Garbage degrades to None (no
    frontier), never a sweep crash — same contract as
    ``parse_serving_detail``."""
    if not value or not isinstance(value, str):
        return None
    version = FRONTIER_VERSION
    measured_at = 0.0
    template = ""
    points: List[FrontierPoint] = []
    try:
        for part in value.split(";"):
            if not part or "=" not in part:
                continue
            key, _, raw = part.partition("=")
            if key == "v":
                version = int(raw)
            elif key == "at":
                measured_at = float(raw)
            elif key == "t":
                template = raw
            elif key == "p" and raw:
                for enc in raw.split(","):
                    b, p99, tps, samples = enc.split(":")
                    points.append(FrontierPoint(
                        batch=int(b), p99_ms=float(p99),
                        tokens_per_s=float(tps), samples=int(samples)))
    except (TypeError, ValueError):
        return None
    if version < 1 or version > FRONTIER_VERSION:
        return None
    return Frontier(points=points, measured_at=measured_at,
                    template=template, version=version)
