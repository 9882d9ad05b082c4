"""The CapacityCollector: the operator-side half of the measured frontier
(counterpart of tpu_operator/capacity/collector.py).

Node agents measure (serving/probe.py) and mirror
(validator/feature_discovery.py); this module aggregates. One ``observe``
pass per reconcile sweep turns the fleet's ``tpu.ai/serving-frontier``
annotations (on a GPU node, the curve its serving probe measured on the
card) into:

- **pool capacity curves** — per p99 bucket, the median tokens/s a node
  of the pool serves inside that ceiling — exported as
  ``tpu_operator_serving_frontier_tokens_per_s{pool,p99_bucket}`` and the
  ``/debug/capacity`` payload;
- **staleness** — ``frontier_age_seconds`` per node, plus the
  template-change detector: a node whose live ``tpu.ai/template-hash``
  label departed the hash its curve was measured under gets a
  ``tpu.ai/serving-reprobe`` request (feature discovery clears it once a
  curve measured under the current template lands);
- **drift** — a node whose at-SLO throughput falls below
  ``drift_tolerance`` of its pool's median fires ONE ``FrontierDrift``
  Warning Event per episode (edge-triggered on the healthy->drifting
  transition, like the autoscaler's saturation alert) and counts once in
  ``frontier_drift_total``;
- **the autoscaler's number** — :meth:`tokens_per_node`: the fleet's
  median measured at-SLO throughput per node, 0.0 when no node has a
  usable curve (consumers fall back to the per-slice constant).

The collector holds no durable state: every pass recomputes from cluster
state, so a restarted operator re-derives the same view (drift episodes
re-announce after a restart — an ongoing operator-attention condition,
same stance as autoscale saturation).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

from .. import consts, events
from ..client.interface import Client
from ..client.preconditions import preconditioned_patch
from ..controllers.metrics import OperatorMetrics
from ..serving import frontier as frontier_schema
from ..state.nodepool import get_node_pools
from ..utils import deep_get

log = logging.getLogger(__name__)

REASON_DRIFT = "FrontierDrift"

#: a node serving under this fraction of its pool's median at-SLO
#: throughput has drifted off the pool envelope
DEFAULT_DRIFT_TOLERANCE = 0.5

#: drift detection needs a quorum: a median over one node is the node
#: itself and every curve would trivially sit on its own envelope
MIN_POOL_QUORUM = 2


def _median(vals: List[float]) -> float:
    if not vals:
        return 0.0
    ordered = sorted(vals)
    mid = len(ordered) // 2
    if len(ordered) % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


class CapacityCollector:
    def __init__(self, client: Client, namespace: str,
                 metrics: Optional[OperatorMetrics] = None,
                 max_p99_ms: float = 200.0,
                 drift_tolerance: float = DEFAULT_DRIFT_TOLERANCE,
                 now=time.time):
        self.client = client
        self.namespace = namespace
        self.metrics = metrics or OperatorMetrics()
        #: SLO ceiling the at-SLO throughput reads the curve at; the
        #: autoscale sweep refreshes it from spec.serving each pass
        self.max_p99_ms = max_p99_ms
        self.drift_tolerance = drift_tolerance
        self.now = now
        #: node -> drifting? — the edge detector (one Event per episode)
        self._drifting: Dict[str, bool] = {}
        self._pools: Dict[str, dict] = {}
        self._nodes: Dict[str, dict] = {}

    # -- aggregation ----------------------------------------------------------
    def observe(self, nodes: List[dict]) -> None:
        """One aggregation pass over the fleet's GPU nodes. Pure
        computation plus bounded publication: the re-probe request on
        template change and the edge-triggered drift Event."""
        now = self.now()
        frontiers: Dict[str, frontier_schema.Frontier] = {}
        nodes_by_name = {deep_get(n, "metadata", "name", default=""): n
                         for n in nodes}
        # built aside and swapped in once the gauges are set: the debug
        # endpoint and the consumers read from other threads
        node_info: Dict[str, dict] = {}
        pools: Dict[str, dict] = {}
        for node in nodes:
            name = deep_get(node, "metadata", "name", default="")
            fr = frontier_schema.decode_annotation(deep_get(
                node, "metadata", "annotations",
                consts.SERVING_FRONTIER_ANNOTATION))
            if fr is None or not fr.points:
                continue
            frontiers[name] = fr
            age = max(0.0, now - fr.measured_at) if fr.measured_at else 0.0
            self.metrics.serving_frontier_age.labels(node=name).set(
                round(age, 3))
            live_template = deep_get(node, "metadata", "labels",
                                     consts.TEMPLATE_HASH_LABEL) or ""
            stale = bool(fr.template and live_template
                         and fr.template != live_template)
            if stale:
                self._request_reprobe(node, live_template)
            node_info[name] = {
                "at_slo_tokens_per_s": fr.best_tokens_per_s(self.max_p99_ms),
                "best_depth": fr.best_depth(self.max_p99_ms),
                "age_s": round(age, 3),
                "min_samples": fr.min_samples(),
                "template_stale": stale,
                "points": len(fr.points),
            }

        for pool in get_node_pools(nodes):
            members = [n for n in pool.node_names if n in frontiers]
            curve: Dict[str, float] = {}
            for bound in frontier_schema.P99_BUCKETS_MS:
                vals = [frontiers[n].best_tokens_per_s(bound)
                        for n in members]
                vals = [v for v in vals if v > 0]
                if vals:
                    curve[frontier_schema.p99_bucket(bound)] = round(
                        _median(vals), 1)
            at_slo = [(n, frontiers[n].best_tokens_per_s(self.max_p99_ms))
                      for n in members]
            measured = [tps for _, tps in at_slo if tps > 0]
            median_tps = _median(measured)
            for bucket, tps in curve.items():
                self.metrics.serving_frontier_tokens_per_s.labels(
                    pool=pool.name, p99_bucket=bucket).set(tps)
            pools[pool.name] = {
                "nodes": len(pool.node_names),
                "reporting": len(members),
                "curve": curve,
                "tokens_per_node_at_slo": round(median_tps, 1),
            }
            self._detect_drift(pool.name, at_slo, median_tps, nodes_by_name)
        self._nodes, self._pools = node_info, pools

        # nodes whose frontier vanished (cleared on a failing barrier,
        # node deleted) close their drift episode so the next appearance
        # re-announces instead of staying suppressed forever
        for name in list(self._drifting):
            if name not in frontiers:
                self._drifting.pop(name)

    def _detect_drift(self, pool: str, at_slo, median_tps: float,
                      nodes_by_name: Dict[str, dict]) -> None:
        if len([1 for _, tps in at_slo if tps > 0]) < MIN_POOL_QUORUM:
            for name, _ in at_slo:
                self._drifting.pop(name, None)
            return
        for name, tps in at_slo:
            drifting = 0 < tps < median_tps * self.drift_tolerance
            was = self._drifting.get(name, False)
            self._drifting[name] = drifting
            if drifting and not was:
                self.metrics.serving_frontier_drift.labels(pool=pool).inc()
                node = nodes_by_name.get(name)
                if node is not None:
                    # Edge-triggered alert (fires on the healthy->drifting
                    # transition only); repeats across operator restarts
                    # are *wanted* — drift is an ongoing operator-attention
                    # condition, not an episode step.
                    events.record(
                        self.client, self.namespace, node, events.WARNING,
                        REASON_DRIFT,
                        f"node {name} serving frontier departed pool "
                        f"{pool}'s envelope: {tps:.1f} tokens/s at SLO vs "
                        f"pool median {median_tps:.1f} (tolerance "
                        f"{self.drift_tolerance:.0%})")
                log.warning("capacity: frontier drift on %s (pool %s): "
                            "%.1f vs median %.1f", name, pool, tps,
                            median_tps)

    def _request_reprobe(self, node: dict, live_template: str) -> None:
        """Ask the node agent for a fresh curve: the template changed
        after the frontier was measured. Idempotent — the annotation
        carries the invalidating hash, so repeat sweeps converge to one
        write and feature discovery clears it once a curve measured under
        the live template lands."""
        name = deep_get(node, "metadata", "name", default="")

        def build(fresh: dict) -> Optional[dict]:
            if deep_get(fresh, "metadata", "annotations",
                        consts.SERVING_REPROBE_ANNOTATION) == live_template:
                return None
            return {"metadata": {"annotations": {
                consts.SERVING_REPROBE_ANNOTATION: live_template}}}

        preconditioned_patch(self.client, "v1", "Node", name, build)

    # -- consumers ------------------------------------------------------------
    def tokens_per_node(self, pool: Optional[str] = None) -> float:
        """Measured at-SLO tokens/s one node serves: the pool's median, or
        the fleet-wide median over reporting nodes when ``pool`` is None
        or unknown. 0.0 = no usable curve — callers MUST fall back to
        their constant predictor, never divide by this blindly."""
        if pool is not None and pool in self._pools:
            return float(self._pools[pool]["tokens_per_node_at_slo"])
        measured = [info["at_slo_tokens_per_s"]
                    for info in self._nodes.values()
                    if info["at_slo_tokens_per_s"] > 0]
        return round(_median(measured), 1)

    def drifting_nodes(self) -> List[str]:
        return sorted(n for n, d in self._drifting.items() if d)

    def stale_nodes(self) -> List[str]:
        return sorted(n for n, info in self._nodes.items()
                      if info["template_stale"])

    def debug_state(self) -> dict:
        """The ``/debug/capacity`` payload: pools, curves, per-node
        frontier summaries, open drift episodes."""
        return {
            "max_p99_ms": self.max_p99_ms,
            "tokens_per_node_at_slo": self.tokens_per_node(),
            "pools": dict(sorted(self._pools.items())),
            "nodes": dict(sorted(self._nodes.items())),
            "drifting": self.drifting_nodes(),
            "template_stale": self.stale_nodes(),
        }
