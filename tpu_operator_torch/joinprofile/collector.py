"""Operator-side join-trace collector (copy of
tpu_operator/joinprofile/collector.py).

:class:`JoinProfiler` subscribes to the tracer (``Tracer.on_finalize``) for
operator-side reconcile spans and to the ClusterPolicy reconcile sweep
(:meth:`observe`) for node state + the ``tpu.ai/trace-spans`` annotation
feature discovery mirrors up from each node's span log. From those it
maintains, per node, one merged end-to-end join trace:

* window: first sweep that saw the node -> node schedulable AND policy
  ready, extended on both ends to cover node-side spans outside it (agents
  may start before the first sweep observes the node; validation reports
  after readiness).
* operator intervals: every reconcile root span overlapping the window.
* a ``ds-rollout-wait`` interval tiling the whole not-yet-ready span of
  the window — the level-driven analog of "waiting on operands": any
  instant not explained by something more specific was spent waiting for
  DaemonSets to roll out (image pull + container start included).
* node intervals: decoded span records (validator entrypoints, barrier
  waits, the set-up window the spans call ``xla-compile``, serving probes).

The critical-path sweep-line (:mod:`.critical_path`) turns that into the
per-phase attribution served on ``/debug/join-traces`` and observed into
``tpu_operator_join_phase_seconds`` once per completed join. A node is
schedulable once it has ``nvidia.com/gpu`` capacity.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque
from typing import List, Optional

from .. import consts, tracing
from ..utils import deep_get
from .critical_path import attribute, phase_of, record_intervals
from .records import decode_annotation

log = logging.getLogger(__name__)

#: completed joins wait this many sweeps for the feature-discovery mirror
#: before the histogram is fed without node-side spans
_EMIT_GRACE_SWEEPS = 5


class JoinProfiler:
    def __init__(self, metrics=None, max_nodes: int = 256,
                 latency_window: int = 512, max_sweeps: int = 512):
        self.metrics = metrics
        self.max_nodes = max_nodes
        self._lock = threading.Lock()
        #: reconcile root durations (all controllers) for the p50/p99 summary
        self._latency: deque = deque(maxlen=latency_window)
        #: (start_unix, end_unix, controller, trace_id) per finalized root
        self._sweeps: deque = deque(maxlen=max_sweeps)
        self._nodes: "OrderedDict[str, dict]" = OrderedDict()
        self._trace_parent: Optional[str] = None

    # -- tracer feed (worker threads) -----------------------------------------
    def on_trace(self, root) -> None:
        """Tracer.on_finalize subscriber: runs on whichever worker finalized
        the trace, so everything mutates under the lock."""
        if root.duration_s is None:
            return
        with self._lock:
            self._latency.append(root.duration_s)
            self._sweeps.append((root.start_unix,
                                 root.start_unix + root.duration_s,
                                 str(root.attributes.get("controller", "")),
                                 root.trace_id))
        if self.metrics is not None:
            try:
                summary = self.reconcile_latency()
                for quantile in ("p50", "p99"):
                    self.metrics.reconcile_latency.labels(
                        quantile=quantile).set(summary[f"{quantile}_s"])
            except Exception:  # telemetry must never break a reconcile
                log.debug("reconcile latency gauge update failed",
                          exc_info=True)

    def reconcile_latency(self) -> dict:
        with self._lock:
            vals = sorted(self._latency)
        if not vals:
            return {"count": 0, "p50_s": 0.0, "p99_s": 0.0}

        def q(p: float) -> float:
            return vals[min(len(vals) - 1, int(p * len(vals)))]

        return {"count": len(vals), "p50_s": round(q(0.50), 6),
                "p99_s": round(q(0.99), 6)}

    # -- reconcile-sweep feed -------------------------------------------------
    def observe(self, policy, nodes: List[dict], results) -> None:
        """One ClusterPolicy sweep's view: per-node schedulability, the
        mirrored span records, and whether the policy as a whole is ready.
        Called from inside the reconcile (worker thread)."""
        now = time.time()
        ready = bool(getattr(results, "ready", False))
        emit: List[str] = []
        with self._lock:
            self._trace_parent = tracing.join_traceparent(policy.obj)
            for node in nodes:
                name = deep_get(node, "metadata", "name")
                if not name:
                    continue
                rec = self._nodes.get(name)
                if rec is None:
                    rec = {"first_seen": now, "schedulable_at": None,
                           "completed_at": None, "pending_until": now,
                           "prepull_at": None,
                           "records": [], "post_sweeps": 0, "emitted": False}
                    self._nodes[name] = rec
                    while len(self._nodes) > self.max_nodes:
                        self._nodes.popitem(last=False)
                schedulable = deep_get(
                    node, "status", "capacity",
                    consts.GPU_RESOURCE_NAME) is not None
                if schedulable and rec["schedulable_at"] is None:
                    rec["schedulable_at"] = now
                if rec["prepull_at"] is None:
                    # labeler's pre-pull stamp: background pulls started
                    # here, long before any DS pod scheduled
                    stamp = deep_get(node, "metadata", "annotations",
                                     consts.IMAGE_PREPULL_ANNOTATION)
                    if stamp is not None:
                        try:
                            rec["prepull_at"] = float(stamp)
                        except (TypeError, ValueError):
                            pass
                mirrored = decode_annotation(deep_get(
                    node, "metadata", "annotations",
                    consts.TRACE_SPANS_ANNOTATION))
                if mirrored:
                    rec["records"] = mirrored
                if rec["completed_at"] is None:
                    if schedulable and ready:
                        rec["completed_at"] = now
                    else:
                        # the not-ready portion of the window tiles as
                        # DS-rollout wait; more specific intervals override
                        # it instant-by-instant in the sweep line
                        rec["pending_until"] = now
                if rec["completed_at"] is not None and not rec["emitted"]:
                    rec["post_sweeps"] += 1
                    if mirrored or rec["records"] or (
                            rec["post_sweeps"] > _EMIT_GRACE_SWEEPS):
                        rec["emitted"] = True
                        emit.append(name)
        for name in emit:
            self._emit_join_metrics(name)

    def _emit_join_metrics(self, name: str) -> None:
        if self.metrics is None:
            return
        trace = self.join_trace(name)
        if trace is None:
            return
        try:
            for phase, seconds in trace["attribution"]["phases"].items():
                self.metrics.join_phase_seconds.labels(
                    phase=phase).observe(seconds)
        except Exception:  # telemetry must never break a reconcile
            log.debug("join phase histogram observe failed", exc_info=True)

    # -- merged traces --------------------------------------------------------
    def _expected_ids(self):
        parsed = tracing.parse_traceparent(self._trace_parent)
        return parsed if parsed else (None, None)

    def join_trace(self, name: str) -> Optional[dict]:
        """The merged end-to-end join trace for one node, or None."""
        with self._lock:
            rec = self._nodes.get(name)
            if rec is None:
                return None
            rec = dict(rec, records=list(rec["records"]))
            sweeps = list(self._sweeps)
            trace_id, parent_span_id = self._expected_ids()
        start = rec["first_seen"]
        end = rec["completed_at"] or rec["pending_until"]
        record_ids = {r["i"] for r in rec["records"]}
        orphans = [r["i"] for r in rec["records"]
                   if (trace_id is not None and r.get("t") != trace_id)
                   or (r.get("p") and r["p"] not in record_ids
                       and r["p"] != parent_span_id)]
        node_intervals = record_intervals(rec["records"])
        # the window extends over node-side spans on BOTH ends: validation
        # often reports after the schedulable+ready moment (FD mirrors on
        # its own cadence — the north star is "schedulable + validated"),
        # and node agents can start before the operator's first sweep
        # observes the node (sweep latency, node clock skew). Clipping
        # those spans away would under-report the phases they measured.
        for _, t0, t1 in node_intervals:
            start = min(start, t0)
            end = max(end, t1)
        operator_intervals = [("reconcile", s, e) for s, e, _, _ in sweeps
                              if e > start and s < end]
        rollout_end = rec["completed_at"] or rec["pending_until"]
        intervals = list(operator_intervals) + node_intervals
        if rollout_end > start:
            intervals.append(("ds-rollout-wait", start, rollout_end))
        # background image pre-pulls run from the labeler's stamp until
        # the node turns schedulable (the plugin DS pod is up — pulls are
        # done by then); higher priority than the rollout tile, lower than
        # any node-side span, so "waiting" honestly reads as "pulling"
        prepull_at = rec.get("prepull_at")
        if prepull_at is not None:
            prepull_end = rec["schedulable_at"] or rollout_end
            if prepull_end > prepull_at:
                intervals.append(("image-prepull", prepull_at, prepull_end))
        attribution = attribute(intervals, (start, end))
        return {
            "node": name,
            "trace_id": trace_id,
            "traceparent": self._trace_parent,
            "window": {
                "start_unix": round(start, 3),
                "end_unix": round(end, 3),
                "schedulable_at": rec["schedulable_at"],
                "completed_at": rec["completed_at"],
                "complete": rec["completed_at"] is not None,
            },
            "attribution": attribution,
            "operator_sweeps": len(operator_intervals),
            "node_spans": [
                dict(r, phase=phase_of(r.get("n", ""))) for r in rec["records"]],
            "orphan_spans": orphans,
        }

    def join_traces(self, limit: Optional[int] = None,
                    node: Optional[str] = None) -> List[dict]:
        with self._lock:
            names = list(self._nodes)
        if node is not None:
            names = [n for n in names if n == node]
        if limit is not None:
            limit = max(0, int(limit))
            names = names[-limit:] if limit else []
        return [t for t in (self.join_trace(n) for n in names)
                if t is not None]

    def stats(self) -> dict:
        with self._lock:
            return {
                "nodes_tracked": len(self._nodes),
                "completed_joins": sum(
                    1 for r in self._nodes.values()
                    if r["completed_at"] is not None),
                "sweeps_buffered": len(self._sweeps),
                "traceparent": self._trace_parent,
            }
