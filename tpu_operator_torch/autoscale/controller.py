"""The autoscaler controller: traffic signal in, bounded pool resizes out
(counterpart of tpu_operator/autoscale/controller.py).

Registered in ``controllers/manager.py`` beside the ClusterPolicy/
GPUDriver/upgrade reconcilers, behind the same CachedClient -> WriteBatcher
-> RetryingClient -> FencedClient chain — every decision-state write is
fenced + preconditioned, so the crash and split-brain invariants of the
leader fence hold for capacity changes too.

Signals: the ``tpu.ai/traffic-snapshot`` ClusterPolicy annotation (queue
depth, backlog chips, rolling SLO attainment — published per tick by the
traffic scenario; the annotation patch IS the watch event that wakes this
reconciler) plus the per-node serving rollup (``tpu.ai/serving-slo-detail``).

Actuation goes through the *existing* machinery:

- scale-up REGISTERS nodes (create is a fenced flush barrier) carrying the
  pool's selector labels, then stands back — the event-driven join path
  labels, renders, and validates them like any other node. Node
  registration is the actuation boundary: a cloud deployment would back it
  with a node-group API; the simulator's kubelet animates it directly.
- scale-down NEVER bare-deletes: it publishes a ``tpu.ai/planned-retile``
  annotation (the drain protocol's vocabulary, reason ``scale-down``) on the
  emptiest drain-exempt-clean node, emits exactly one ``RetilePlanned``
  Event per plan (content-addressed ``record_once``), and removes the node
  only after the workload's drain-ack lands or the deadline expires
  (counted as a miss). One resize in flight per pool, ever.

A node's size is its ``nvidia.com/gpu`` capacity, where the reference reads
``google.com/tpu``; the default for a node that reports none is a GPU count.
A node registered for a pool keyed on feature discovery's GPU model also
carries node feature discovery's NVIDIA PCI label, the mark the pool's
members have (a TPU pool's accelerator label is itself the mark).

Decision state (per-pool target, cooldown, delay bookkeeping, the in-flight
resize record) persists in the ``tpu.ai/autoscale-state`` ClusterPolicy
annotation BEFORE actuation — an operator killed mid-resize resumes the
half-finished episode from cluster state alone and converges to exactly
one completed re-tile.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

from .. import consts, events, tracing
from ..api.clusterpolicy import AutoscaleSpec, ClusterPolicy
from ..client.batch import batch_window
from ..client.errors import AlreadyExistsError, NotFoundError
from ..client.interface import Client, WatchEvent
from ..client.preconditions import preconditioned_patch
from ..controllers.metrics import OperatorMetrics
from ..controllers.predicates import filtered_node_mapper
from ..controllers.runtime import Controller, Reconciler, Request, Result
from ..health import drain as drain_protocol
from ..migrate import controller as migrate_protocol
from ..nodeinfo import is_gpu_node
from ..provenance import DecisionJournal, episode_id
from ..state.nodepool import get_node_pools
from ..utils import deep_get
from .engine import PoolDecision, PoolState, decide
from .predictor import TrendPredictor

log = logging.getLogger(__name__)

RESYNC_PERIOD_S = float(os.environ.get("GPU_OPERATOR_RESYNC_S", "300"))

#: forecast horizon: roughly one node-join latency ahead, so capacity
#: ordered now is serving by the time the forecast materializes
DEFAULT_HORIZON_S = 60.0

REASON_SCALED_UP = "AutoscaleUp"
REASON_SCALED_DOWN = "AutoscaleDown"
REASON_SATURATED = "AutoscaleSaturated"
REASON_PLANNED = "RetilePlanned"


def parse_snapshot(raw: Optional[str]) -> Optional[dict]:
    """The traffic-snapshot annotation payload, or None for absent/corrupt
    (a corrupt snapshot must never wedge the reconciler — the fleet simply
    holds until the next tick overwrites it)."""
    if not raw:
        return None
    try:
        data = json.loads(raw)
    except ValueError:
        return None
    return data if isinstance(data, dict) and "ts" in data else None


#: the GPUs a node that reports no ``nvidia.com/gpu`` capacity counts for
#: (the reference's default is 4 TPU chips, one v5e host)
DEFAULT_GPUS_PER_NODE = 8


def _node_chips(node: dict, default: int) -> int:
    """The node's accelerator count: its ``nvidia.com/gpu`` capacity, else
    the chip-count label, else ``default``."""
    cap = deep_get(node, "status", "capacity", consts.GPU_RESOURCE_NAME)
    if cap is None:
        cap = deep_get(node, "metadata", "labels",
                       consts.TPU_CHIP_COUNT_LABEL)
    try:
        chips = int(cap)
    except (TypeError, ValueError):
        return default
    return chips if chips > 0 else default


class AutoscaleReconciler(Reconciler):
    name = "autoscale"

    def __init__(self, client: Client, namespace: Optional[str] = None,
                 metrics: Optional[OperatorMetrics] = None,
                 chips_per_node: int = DEFAULT_GPUS_PER_NODE,
                 horizon_s: float = DEFAULT_HORIZON_S,
                 now=time.time,
                 journal: Optional[DecisionJournal] = None,
                 capacity=None):
        self.client = client
        self.namespace = namespace or os.environ.get(
            consts.NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
        self.metrics = metrics or OperatorMetrics()
        self.journal = journal or DecisionJournal()
        self.default_chips_per_node = chips_per_node
        self.horizon_s = horizon_s
        self.now = now
        #: the fleet capacity observatory (capacity.CapacityCollector) —
        #: optional: without it (or before any node reports a frontier)
        #: every decision takes the per-slice-constant fallback path
        self.capacity = capacity
        #: in-memory predictors (backlog chips, token rate, SLO
        #: attainment) — the window refills from the per-tick snapshot
        #: stream after a restart; only *decision* state needs crash
        #: durability
        self._backlog = TrendPredictor()
        self._token_demand = TrendPredictor()
        self._attainment = TrendPredictor()
        self._last_snapshot_ts: float = 0.0
        self._last_saturated = False
        self._last_decisions: List[PoolDecision] = []
        self._last_frontier_tokens: float = 0.0

    def debug_state(self) -> dict:
        return {
            "autoscale": {
                "backlog_level": round(self._backlog.level, 3),
                "backlog_slope": round(self._backlog.slope(), 6),
                "token_demand_level": round(self._token_demand.level, 3),
                "attainment_level": round(self._attainment.level, 4),
                "frontier_tokens_per_node": round(
                    self._last_frontier_tokens, 1),
                "decisions": [
                    {"pool": d.pool, "current": d.current,
                     "target": d.target, "action": d.action,
                     "hold": d.hold_reason}
                    for d in self._last_decisions],
            },
        }

    # -- singleton resolution (same discipline as the policy reconciler) ------
    def _resolve_policy(self, request: Request) -> Optional[ClusterPolicy]:
        policies = self.client.list("tpu.ai/v1", "ClusterPolicy")
        if not policies:
            return None
        policies.sort(key=lambda p: (
            p["metadata"].get("creationTimestamp", ""),
            p["metadata"]["name"]))
        primary = policies[0]
        if primary["metadata"]["name"] != request.name:
            return None
        return ClusterPolicy.from_obj(primary)

    # -- persisted decision state ---------------------------------------------
    def _load_states(self, policy: ClusterPolicy) -> Dict[str, PoolState]:
        raw = deep_get(policy.obj, "metadata", "annotations",
                       consts.AUTOSCALE_STATE_ANNOTATION)
        if not raw:
            return {}
        try:
            data = json.loads(raw)
        except ValueError:
            log.warning("autoscale: corrupt state annotation; resetting")
            return {}
        if not isinstance(data, dict):
            return {}
        return {pool: PoolState.from_dict(st)
                for pool, st in sorted(data.items())
                if isinstance(st, dict)}

    def _persist_states(self, policy: ClusterPolicy,
                        states: Dict[str, PoolState]) -> None:
        payload = json.dumps(
            {pool: st.to_dict() for pool, st in sorted(states.items())},
            sort_keys=True)

        def build(fresh: dict) -> Optional[dict]:
            current = deep_get(fresh, "metadata", "annotations",
                               consts.AUTOSCALE_STATE_ANNOTATION)
            if current == payload:
                return None
            return {"metadata": {"annotations": {
                consts.AUTOSCALE_STATE_ANNOTATION: payload}}}

        preconditioned_patch(self.client, "tpu.ai/v1", "ClusterPolicy",
                             policy.name, build)
        # keep the in-hand object current: later code this sweep (and the
        # batcher's optimistic projection) must see what was just written
        policy.obj.setdefault("metadata", {}).setdefault(
            "annotations", {})[consts.AUTOSCALE_STATE_ANNOTATION] = payload

    # -- signal ingestion -----------------------------------------------------
    def _ingest_signals(self, spec: AutoscaleSpec,
                        policy: ClusterPolicy, nodes: List[dict]) -> None:
        self._backlog.window_s = float(spec.window_s)
        self._token_demand.window_s = float(spec.window_s)
        self._attainment.window_s = float(spec.window_s)
        snap = parse_snapshot(deep_get(
            policy.obj, "metadata", "annotations",
            consts.TRAFFIC_SNAPSHOT_ANNOTATION))
        if snap is not None:
            ts = float(snap["ts"])
            if ts > self._last_snapshot_ts:
                self._last_snapshot_ts = ts
                self._backlog.observe(ts, float(snap.get("backlog_chips",
                                                         0.0)))
                if snap.get("demand_tokens_per_s") is not None:
                    self._token_demand.observe(
                        ts, float(snap["demand_tokens_per_s"]))
                if snap.get("attainment") is not None:
                    self._attainment.observe(ts, float(snap["attainment"]))
        elif self._last_snapshot_ts == 0.0:
            # no traffic feed yet: fall back to the serving rollup so an
            # SLO breach alone (attainment annotations on nodes) can still
            # trigger defensive scale-up
            from ..validator.serving import parse_serving_detail

            ratios = []
            for node in nodes:
                detail = parse_serving_detail(deep_get(
                    node, "metadata", "annotations",
                    consts.SERVING_SLO_ANNOTATION))
                if "attainment" in detail:
                    ratios.append(float(detail["attainment"]))
            if ratios:
                self._attainment.observe(self.now(),
                                         sum(ratios) / len(ratios))

    def _slo_breach(self, spec: AutoscaleSpec) -> bool:
        if not self._attainment.samples:
            return False
        projected = self._attainment.forecast(self.horizon_s)
        current = self._attainment.samples[-1][1]
        return min(current, projected) < spec.target_slo_attainment

    # -- actuation ------------------------------------------------------------
    def _pods_on(self, node_name: str) -> List[dict]:
        # cluster-wide: user GPU workloads live in arbitrary namespaces
        return self.client.list(
            "v1", "Pod", None,
            field_selector={"spec.nodeName": node_name})

    def _select_victim(self, pool_nodes: List[dict]) -> Optional[dict]:
        """The emptiest drain-exempt-clean node: zero pods that a drain
        would have to move. Prefer autoscaler-registered nodes (we grew
        them; static capacity is the admin's), then fewest non-exempt
        pods, then name for determinism. Returns None when every node
        still carries real workload pods — the pool holds rather than
        planning a drain it knows will run its full deadline."""
        ranked: List[Tuple[int, int, str, dict]] = []
        for node in pool_nodes:
            name = node["metadata"]["name"]
            busy = sum(1 for pod in self._pods_on(name)
                       if not consts.drain_exempt(pod, self.namespace))
            managed = deep_get(node, "metadata", "labels",
                               consts.AUTOSCALE_MANAGED_LABEL) is not None
            ranked.append((busy, 0 if managed else 1, name, node))
        ranked.sort(key=lambda r: r[:3])
        if not ranked or ranked[0][0] > 0:
            return None
        return ranked[0][3]

    def _publish_plan(self, node_name: str, fingerprint: str,
                      deadline: float) -> None:
        plan = drain_protocol.RetilePlan(
            fingerprint=fingerprint, deadline=deadline,
            reason=drain_protocol.REASON_SCALE_DOWN)
        payload = plan.to_json()

        def build(fresh: dict) -> Optional[dict]:
            if deep_get(fresh, "metadata", "annotations",
                        consts.RETILE_PLAN_ANNOTATION) == payload:
                return None
            return {"metadata": {"annotations": {
                consts.RETILE_PLAN_ANNOTATION: payload}}}

        preconditioned_patch(self.client, "v1", "Node", node_name, build)

    def _request_migration(self, node_name: str) -> None:
        payload = json.dumps(
            {"reason": drain_protocol.REASON_SCALE_DOWN}, sort_keys=True)

        def build(fresh: dict) -> Optional[dict]:
            if deep_get(fresh, "metadata", "annotations",
                        consts.MIGRATE_REQUEST_ANNOTATION) == payload:
                return None
            return {"metadata": {"annotations": {
                consts.MIGRATE_REQUEST_ANNOTATION: payload}}}

        preconditioned_patch(self.client, "v1", "Node", node_name, build)

    def _stamp_episode(self, node_name: str, eid: str) -> None:
        """Chain downstream subsystems into this scale-down's provenance
        episode: the migration reconciler and the health machine read the
        node's episode annotation and tag their own decision records with
        the same id instead of forking a parallel episode."""
        def build(fresh: dict) -> Optional[dict]:
            if deep_get(fresh, "metadata", "annotations",
                        consts.PROVENANCE_EPISODE_ANNOTATION) == eid:
                return None
            return {"metadata": {"annotations": {
                consts.PROVENANCE_EPISODE_ANNOTATION: eid}}}

        preconditioned_patch(self.client, "v1", "Node", node_name, build)

    def _migration_verdict(self, node: dict) -> Optional[bool]:
        """Terminal outcome of a delegated migration episode: True once
        the tenant restored on its destination, False when the episode
        failed (fall back to a counted force-removal), None while still
        in flight. Crash-repairs the request annotation the same way
        _publish_plan repairs a lost plan."""
        state = migrate_protocol.migration_state(node)
        if state is None:
            if migrate_protocol.migrate_request(node) is None:
                # crashed after recording intent but before the request
                # landed: repair the missing half
                self._request_migration(node["metadata"]["name"])
            return None
        phase = state.get("phase")
        if phase == migrate_protocol.PHASE_DONE:
            return True
        if phase == migrate_protocol.PHASE_FAILED:
            return False
        return None

    def _begin_scale_down(self, spec: AutoscaleSpec, policy: ClusterPolicy,
                          pool: str, victim: dict,
                          states: Dict[str, PoolState], now: float) -> None:
        name = victim["metadata"]["name"]
        fingerprint = drain_protocol.plan_fingerprint(
            f"scale-down:{name}", [])
        deadline = now + float(policy.spec.health.drain_deadline_s)
        state = states[pool]
        migrate = policy.spec.migrate.is_enabled()
        state.resize = {"node": name, "fingerprint": fingerprint,
                        "direction": "down",
                        "deadline": round(deadline, 3)}
        if migrate:
            state.resize["migrate"] = True
        # durable intent FIRST: the state record is what a restarted
        # operator resumes from; the plan annotation and Event repair
        # idempotently behind it
        self._persist_states(policy, states)
        eid = episode_id("scale-down", name, fingerprint)
        self._stamp_episode(name, eid)
        self.journal.record_decision(
            "autoscale", "scale-down", eid,
            trigger={"type": "traffic-snapshot", "pool": pool},
            inputs={"backlog_forecast_chips":
                    round(self._backlog.forecast(self.horizon_s), 3),
                    "attainment": round(self._attainment.level, 4),
                    "drain_deadline_s":
                    float(policy.spec.health.drain_deadline_s)},
            decision={"pool": pool, "victim": name, "plan": fingerprint,
                      "path": "migrate" if migrate else "drain"},
            alternatives=[
                {"option": "hold", "reason": "forecast stayed below the "
                 "pool target past scaleDownDelayS"},
                ({"option": "drain-in-place", "reason": "spec.migrate "
                  "enabled: the tenant moves instead of checkpointing "
                  "to a deadline"} if migrate else
                 {"option": "migrate", "reason": "spec.migrate disabled"})],
            actuations=([{"verb": "migrate-request", "kind": "Node",
                          "name": name}] if migrate else
                        [{"verb": "plan", "kind": "Node", "name": name}]),
            node=name)
        if migrate:
            # scale-down rides the migration subsystem: the migration
            # reconciler drains the tenant and restores it on another
            # node's slice before we remove this one; it owns the plan
            # annotation and the RetilePlanned Event for the episode
            self._request_migration(name)
            log.info("autoscale: requested migration-backed scale-down "
                     "of %s (pool %s)", name, pool)
            return
        self._publish_plan(name, fingerprint, deadline)
        events.record_once(
            self.client, self.namespace, victim, events.NORMAL,
            REASON_PLANNED,
            f"autoscale scale-down of pool {pool}: drain planned for "
            f"{name} (deadline "
            f"{policy.spec.health.drain_deadline_s}s, plan {fingerprint})",
            token=fingerprint)
        log.info("autoscale: planned scale-down of %s (pool %s, plan %s)",
                 name, pool, fingerprint)

    def _advance_resize(self, spec: AutoscaleSpec, policy: ClusterPolicy,
                        pool: str, states: Dict[str, PoolState],
                        nodes_by_name: Dict[str, dict],
                        now: float) -> Optional[float]:
        """Drive the pool's in-flight scale-down one step. Returns a
        requeue delay while the drain window is open, None once the pool
        is idle again."""
        state = states[pool]
        rec = state.resize or {}
        node = nodes_by_name.get(rec.get("node", ""))
        if node is None:
            # node gone: the resize completed (possibly in a previous
            # incarnation of this process) — retire the record and close
            # the provenance episode so it cannot read as stuck forever
            if rec.get("fingerprint"):
                self.journal.record_decision(
                    "autoscale", "scale-down-complete",
                    episode_id("scale-down", rec.get("node", ""),
                               rec["fingerprint"]),
                    trigger={"type": "node-gone"},
                    decision={"pool": pool, "node": rec.get("node", "")},
                    outcome="node-deleted",
                    node=rec.get("node") or None)
            state.resize = None
            state.cooldown_until = now + float(spec.cooldown_s)
            self._persist_states(policy, states)
            return None
        if rec.get("migrate"):
            verdict = self._migration_verdict(node)
            if verdict is None:
                return 2.0
            acked = verdict
            detail = "migrated" if acked else "migration failed"
        else:
            plan = drain_protocol.node_plan(node)
            deadline = float(rec.get("deadline", now))
            if plan is None or plan.fingerprint != rec.get("fingerprint"):
                # crashed after recording intent but before the plan
                # landed: repair the missing half
                self._publish_plan(node["metadata"]["name"],
                                   rec["fingerprint"], deadline)
                plan = drain_protocol.RetilePlan(
                    fingerprint=rec["fingerprint"], deadline=deadline,
                    reason=drain_protocol.REASON_SCALE_DOWN)
            # unconditional: content-addressed on the fingerprint, so a
            # crash between plan publish and announcement repairs the
            # lost Event, while an already-landed announcement collides
            # (AlreadyExists) and stands down — exactly-once either way
            events.record_once(
                self.client, self.namespace, node, events.NORMAL,
                REASON_PLANNED,
                f"autoscale scale-down of pool {pool}: drain planned "
                f"for {node['metadata']['name']} (plan "
                f"{rec['fingerprint']})",
                token=rec["fingerprint"])
            acked = (drain_protocol.node_acked_plan(node)
                     == rec.get("fingerprint"))
            if not acked and not plan.expired(now):
                return max(0.25, plan.deadline - now + 0.1)
            detail = "acked" if acked else "deadline expired"
        if not acked:
            self.metrics.drain_deadline_missed.inc()
        name = node["metadata"]["name"]
        # write-ahead provenance: the closing record (with the node-delete
        # actuation it licenses) lands before the delete itself, so a kill
        # between record and delete replays into the same content-addressed
        # record and the chain never shows an unexplained delete
        self.journal.record_decision(
            "autoscale", "scale-down-complete",
            episode_id("scale-down", name, rec.get("fingerprint", "")),
            trigger={"type": "drain-ack" if acked else "deadline"},
            inputs={"detail": detail},
            decision={"pool": pool, "node": name, "forced": not acked},
            actuations=[{"verb": "delete", "kind": "Node", "name": name}],
            outcome="node-deleted",
            node=name)
        # the drain either completed or timed out (fail-safe): remove the
        # node, then its (exclusively drain-exempt) leftover pods —
        # DaemonSet pods a real apiserver would garbage-collect
        try:
            self.client.delete("v1", "Node", name)
        except NotFoundError:
            pass
        for pod in self._pods_on(name):
            try:
                self.client.delete("v1", "Pod", pod["metadata"]["name"],
                                   deep_get(pod, "metadata", "namespace"))
            except NotFoundError:
                pass
        nodes_by_name.pop(name, None)
        state.resize = None
        state.cooldown_until = now + float(spec.cooldown_s)
        self._persist_states(policy, states)
        self.metrics.autoscale_resizes.labels(
            pool=pool, direction="down").inc()
        # Aggregated completion note: record() folds repeats into one
        # Event's count, the path is unreachable on crash replay (the
        # resize record was cleared by _persist_states above), and the
        # protocol announcement is the content-addressed RetilePlanned
        # record_once at episode start.
        # opalint: disable=exactly-once-event
        events.record(self.client, self.namespace, policy.obj,
                      events.NORMAL, REASON_SCALED_DOWN,
                      f"pool {pool}: drained and removed {name} "
                      f"({detail})")
        log.info("autoscale: completed scale-down of %s (pool %s, %s)",
                 name, pool, detail)
        return None

    def _scale_up(self, spec: AutoscaleSpec, policy: ClusterPolicy,
                  pool: str, count: int, states: Dict[str, PoolState],
                  nodes_by_name: Dict[str, dict], now: float) -> None:
        state = states[pool]
        template = dict(state.template or {})
        if not template:
            log.warning("autoscale: pool %s has no label template; "
                        "cannot register nodes", pool)
            return
        if not is_gpu_node({"metadata": {"labels": template}}):
            # a pool keyed on feature discovery's GPU model (no GKE
            # accelerator label) does not mark a node a GPU node: mark the
            # registered node as node feature discovery marks the pool's
            # members, so the join path and the next census claim it
            template[consts.NFD_NVIDIA_PCI_LABEL] = "true"
        template[consts.AUTOSCALE_MANAGED_LABEL] = pool
        if pool in (spec.preemptible_pools or []):
            template[consts.PREEMPTIBLE_POOL_LABEL] = "true"
        created = []
        for _ in range(count):
            name = f"{pool}-a{state.seq}"
            while name in nodes_by_name:
                state.seq += 1
                name = f"{pool}-a{state.seq}"
            state.seq += 1
            obj = {"apiVersion": "v1", "kind": "Node",
                   "metadata": {"name": name, "labels": dict(template)},
                   "status": {}}
            try:
                # Scale-UP converges by name idempotence instead of
                # write-ahead intent: node names derive from the
                # persisted seq, AlreadyExists on replay is absorbed
                # below, and the next census counts landed nodes so
                # decide() re-derives the same target (proven by the
                # crash-point matrix); persisting cooldown first would
                # instead strand a crash window where capacity was
                # ordered but never created.
                # opalint: disable=state-before-actuation
                self.client.create(obj)
            except AlreadyExistsError:
                pass  # crash replay: this node already landed
            nodes_by_name[name] = obj
            created.append(name)
            self.metrics.autoscale_resizes.labels(
                pool=pool, direction="up").inc()
        state.cooldown_until = now + float(spec.cooldown_s)
        self._persist_states(policy, states)
        self.journal.record_decision(
            "autoscale", "scale-up", episode_id("scale-up", pool, created),
            trigger={"type": "traffic-snapshot", "pool": pool},
            inputs={"backlog_forecast_chips":
                    round(self._backlog.forecast(self.horizon_s), 3),
                    "attainment": round(self._attainment.level, 4),
                    "frontier_tokens_per_node":
                    round(self._last_frontier_tokens, 1)},
            decision={"pool": pool, "registered": created},
            alternatives=[{"option": "hold", "reason": "forecast demand "
                           "above capacity headroom for the horizon"}],
            actuations=[{"verb": "create", "kind": "Node", "name": n}
                        for n in created],
            outcome="nodes-registered")
        # Aggregated informational Event: record() folds a replay into
        # the existing Event's count (same reason/message stem), and
        # scale-up multiplicity is not protocol-bearing — no peer acts
        # on this announcement.
        # opalint: disable=exactly-once-event
        events.record(self.client, self.namespace, policy.obj,
                      events.NORMAL, REASON_SCALED_UP,
                      f"pool {pool}: registered {len(created)} node(s): "
                      + ", ".join(created))
        log.info("autoscale: pool %s scaled up by %d (%s)", pool,
                 len(created), ", ".join(created))

    # -- the sweep ------------------------------------------------------------
    def reconcile(self, request: Request) -> Result:
        # fallback root span: protocol Events (RetilePlanned & co.) must
        # carry tpu.ai/trace-id even when this sweep runs outside the
        # runtime worker's root (benches, direct drives)
        with tracing.ensure_trace("reconcile", controller=self.name,
                                  request=request.name):
            with batch_window(self.client):
                return self._reconcile(request)

    def _reconcile(self, request: Request) -> Result:
        policy = self._resolve_policy(request)
        if policy is None:
            return Result()
        spec = policy.spec.autoscale
        if not spec.is_enabled():
            self.metrics.autoscale_target_nodes.clear()
            self._last_decisions = []
            return Result()
        now = self.now()
        nodes = [n for n in self.client.list("v1", "Node")
                 if is_gpu_node(n)]
        nodes_by_name = {n["metadata"]["name"]: n for n in nodes}
        states = self._load_states(policy)
        self._ingest_signals(spec, policy, nodes)
        demand_chips = self._backlog.forecast(self.horizon_s)
        slo_breach = self._slo_breach(spec)

        requeues: List[float] = []
        # in-flight resizes advance FIRST: a completed drain deletes its
        # node and frees the pool for the decision pass below
        for pool_name in sorted(states):
            if states[pool_name].resize is not None:
                delay = self._advance_resize(spec, policy, pool_name,
                                             states, nodes_by_name, now)
                if delay is not None:
                    requeues.append(delay)

        # pool census AFTER resize advancement (a completed drain just
        # removed its node); label templates are remembered in durable
        # state so a fully revoked preemptible pool (zero members left)
        # still exists as intent, at size 0
        nodes = list(nodes_by_name.values())
        pools = get_node_pools(nodes)
        pool_sizes: Dict[str, int] = {}
        pool_members: Dict[str, List[dict]] = {}
        for pool in pools:
            pool_sizes[pool.name] = pool.size
            pool_members[pool.name] = [nodes_by_name[n]
                                       for n in pool.node_names
                                       if n in nodes_by_name]
            state = states.setdefault(pool.name, PoolState(target=pool.size))
            if pool.node_selector and state.template != pool.node_selector:
                state.template = dict(pool.node_selector)
        for pool_name, state in states.items():
            if pool_name not in pool_sizes and state.template:
                pool_sizes[pool_name] = 0
                pool_members[pool_name] = []

        chip_counts = [_node_chips(n, self.default_chips_per_node)
                       for n in nodes]
        chips_per_node = (round(sum(chip_counts) / len(chip_counts))
                          if chip_counts else self.default_chips_per_node)

        # the measured-frontier path: aggregate the fleet's serving
        # frontiers (the collector also drives staleness/drift detection
        # off this same pass) and size the fleet by what a node
        # MEASURABLY serves at the SLO instead of the per-slice constant;
        # tokens_per_node() == 0.0 (no usable curve) or a missing token
        # feed falls back to the chip-constant path inside nodes_needed
        frontier_tokens = 0.0
        demand_tokens = 0.0
        if self.capacity is not None:
            self.capacity.max_p99_ms = float(
                policy.spec.serving.max_decode_p99_ms)
            self.capacity.observe(nodes)
            frontier_tokens = self.capacity.tokens_per_node()
            demand_tokens = self._token_demand.forecast(self.horizon_s)
        self._last_frontier_tokens = frontier_tokens

        decisions = decide(spec, pool_sizes, demand_chips, chips_per_node,
                           slo_breach, states, now,
                           demand_tokens_per_s=demand_tokens,
                           frontier_tokens_per_node=frontier_tokens)
        self._last_decisions = decisions

        capacity_chips = sum(chip_counts)
        self.metrics.autoscale_headroom_ratio.set(
            capacity_chips / max(demand_chips, 1.0))
        saturated = False
        for d in decisions:
            self.metrics.autoscale_target_nodes.labels(pool=d.pool).set(
                d.target)
            if (d.target >= spec.pool_max(d.pool)
                    and d.target * chips_per_node
                    < demand_chips * (1.0 + spec.headroom_pct / 100.0)):
                saturated = True
            if d.action == "up":
                self._scale_up(spec, policy, d.pool, d.target - d.current,
                               states, nodes_by_name, now)
            elif d.action == "down":
                victim = self._select_victim(pool_members.get(d.pool, []))
                if victim is None:
                    log.info("autoscale: pool %s wants scale-down but no "
                             "drain-clean node; holding", d.pool)
                else:
                    self._begin_scale_down(spec, policy, d.pool, victim,
                                           states, now)
                    requeues.append(max(
                        0.25, policy.spec.health.drain_deadline_s + 0.1))
            elif d.hold_reason == "cooldown":
                requeues.append(max(0.25,
                                    states[d.pool].cooldown_until - now))
            elif d.hold_reason == "scale-down-delay":
                below = states[d.pool].below_since or now
                requeues.append(max(
                    0.25, below + spec.scale_down_delay_s - now + 0.05))

        if saturated and not self._last_saturated:
            # Edge-triggered alert (fires on the False->True transition
            # only) whose repeats across operator restarts are *wanted*:
            # saturation is an ongoing operator-attention condition, not
            # an episode step.
            # opalint: disable=exactly-once-event
            events.record(self.client, self.namespace, policy.obj,
                          events.WARNING, REASON_SATURATED,
                          "demand exceeds every pool's maxNodes ceiling; "
                          "fleet is saturated at its configured bounds")
        self._last_saturated = saturated

        self._persist_states(policy, states)
        if requeues:
            return Result(requeue_after=max(0.25, min(requeues)))
        return Result()


# -- watch wiring --------------------------------------------------------------

def _all_policy_requests(client: Client) -> List[Request]:
    return [Request(name=p["metadata"]["name"])
            for p in client.list("tpu.ai/v1", "ClusterPolicy")]


def setup_autoscale_controller(client: Client,
                               reconciler: AutoscaleReconciler) -> Controller:
    controller = Controller(reconciler)

    def map_policy(event: WatchEvent) -> List[Request]:
        # includes every traffic-snapshot annotation patch: the per-tick
        # signal feed IS the reconcile trigger
        return [Request(name=event.object["metadata"]["name"])]

    # node add/remove/label changes resize pools out-of-band (joins
    # completing, preemptible revocations); status heartbeats filtered
    map_node = filtered_node_mapper(
        lambda event: _all_policy_requests(client))

    controller.watches("tpu.ai/v1", "ClusterPolicy", map_policy)
    controller.watches("v1", "Node", map_node)
    controller.resyncs(lambda: _all_policy_requests(client),
                       period=RESYNC_PERIOD_S)
    return controller
