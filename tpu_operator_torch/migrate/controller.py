"""The MigrationReconciler: zero-loss cross-node migration (counterpart of
tpu_operator/migrate/controller.py).

Orchestrates drain-node-A -> transfer manifest -> restore-tenant-on-node-B
as a crash-durable state machine. The episode record lives in the
``tpu.ai/migration-state`` annotation on the SOURCE node and is written
fenced + preconditioned BEFORE every actuation — a mid-migration operator
kill resumes from cluster state alone, and every announcement is
content-addressed (``record_once`` on the plan fingerprint), so replays
converge to exactly one restore and zero duplicate Events.

Phases::

    draining ──ack──────────────► transferring ──► restoring ──► done
        │                            ▲                 │
        └─deadline─► snapshotting ───┘ (ok)            └─dst gone─► transferring
                         │                                          (new dst, seq+1)
                         └─failed/timeout─► failed  (counted force-retile fallback)

Wired as the autoscaler's scale-down and preemptible-revocation path:
``_begin_scale_down`` stamps ``tpu.ai/migrate-request`` instead of
publishing a bare drain plan, and only deletes the node once this
reconciler reports a terminal phase.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

from .. import consts, events, tracing
from ..api.clusterpolicy import ClusterPolicy
from ..client.batch import batch_window
from ..client.errors import NotFoundError
from ..client.interface import Client, WatchEvent
from ..client.preconditions import preconditioned_patch
from ..controllers.metrics import OperatorMetrics
from ..controllers.predicates import filtered_node_mapper
from ..controllers.runtime import Controller, Reconciler, Request, Result
from ..health import drain as drain_protocol
from ..nodeinfo import is_gpu_node
from ..provenance import DecisionJournal, episode_id
from ..utils import deep_get, register_shared
from .checkpoint import dumps_compact

log = logging.getLogger(__name__)

RESYNC_PERIOD_S = float(os.environ.get("GPU_OPERATOR_RESYNC_S", "300"))
#: how long a cached state row older than this process's last write counts
#: as that write still on its way (the batcher's 2 s deadline, a watch
#: delivery, with room); past it the older row is taken as written by
#: someone else
OWN_WRITE_LAG_S = 30.0

PHASE_DRAINING = "draining"
PHASE_SNAPSHOTTING = "snapshotting"
PHASE_TRANSFERRING = "transferring"
PHASE_RESTORING = "restoring"
PHASE_DONE = "done"
PHASE_FAILED = "failed"
#: phases with an episode still in flight (everything non-terminal)
ACTIVE_PHASES = (PHASE_DRAINING, PHASE_SNAPSHOTTING,
                 PHASE_TRANSFERRING, PHASE_RESTORING)

REASON_PLANNED = "RetilePlanned"
REASON_SNAPSHOT_REQUESTED = "MigrationSnapshotRequested"
REASON_SNAPSHOT_TAKEN = "TransparentSnapshotTaken"
REASON_SNAPSHOT_FAILED = "MigrationSnapshotFailed"
REASON_RESTORED = "MigrationRestored"
REASON_COMPLETED = "MigrationCompleted"
REASON_FAILED = "MigrationFailed"
REASON_BLOCKED = "MigrationBlocked"


def migration_state(node: dict) -> Optional[dict]:
    """The node's migration-state annotation payload, or None for
    absent/corrupt (a corrupt record must never wedge the sweep — the
    request annotation re-seeds a fresh episode)."""
    raw = deep_get(node, "metadata", "annotations",
                   consts.MIGRATION_STATE_ANNOTATION)
    if not raw:
        return None
    try:
        data = json.loads(raw)
    except ValueError:
        return None
    return data if isinstance(data, dict) and data.get("phase") else None


def migrate_request(node: dict) -> Optional[dict]:
    raw = deep_get(node, "metadata", "annotations",
                   consts.MIGRATE_REQUEST_ANNOTATION)
    if not raw:
        return None
    try:
        data = json.loads(raw)
    except ValueError:
        return None
    return data if isinstance(data, dict) else None


def _parse_json_annotation(node: dict, key: str) -> Optional[dict]:
    raw = deep_get(node, "metadata", "annotations", key)
    if not raw:
        return None
    try:
        data = json.loads(raw)
    except ValueError:
        return None
    return data if isinstance(data, dict) else None


class MigrationReconciler(Reconciler):
    name = "migrate"

    def __init__(self, client: Client, namespace: Optional[str] = None,
                 metrics: Optional[OperatorMetrics] = None,
                 now=time.time,
                 journal: Optional[DecisionJournal] = None):
        self.client = client
        self.namespace = namespace or os.environ.get(
            consts.NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
        self.metrics = metrics or OperatorMetrics()
        self.now = now
        self.journal = journal or DecisionJournal()
        #: process-local census of in-flight episodes (src -> phase) for
        #: the migrations_in_progress gauge; rebuilt from annotations as
        #: requests arrive, so a restart under-counts for at most one sweep
        self._active: Dict[str, str] = register_shared(
            "MigrationController._active", {})
        #: the seq of the last state row this process persisted per source,
        #: and when: the row waits in the write batcher while other
        #: controllers hold their windows open (up to its 2 s deadline), and
        #: a cached row behind it is this process's own past, not a state
        #: to advance again
        self._persisted_seq: Dict[str, Tuple[int, float]] = {}

    def debug_state(self) -> dict:
        return {"migrate": {"active": dict(sorted(self._active.items()))}}

    # -- policy ---------------------------------------------------------------
    def _policy(self) -> Optional[ClusterPolicy]:
        policies = self.client.list("tpu.ai/v1", "ClusterPolicy")
        if not policies:
            return None
        policies.sort(key=lambda p: (
            p["metadata"].get("creationTimestamp", ""),
            p["metadata"]["name"]))
        return ClusterPolicy.from_obj(policies[0])

    # -- durable state --------------------------------------------------------
    def _persist_state(self, node_name: str, state: dict) -> None:
        payload = dumps_compact(state)

        def build(fresh: dict) -> Optional[dict]:
            if deep_get(fresh, "metadata", "annotations",
                        consts.MIGRATION_STATE_ANNOTATION) == payload:
                return None
            return {"metadata": {"annotations": {
                consts.MIGRATION_STATE_ANNOTATION: payload}}}

        preconditioned_patch(self.client, "v1", "Node", node_name, build)
        self._persisted_seq[node_name] = (int(state.get("seq", 0)),
                                          time.monotonic())
        if state.get("phase") in ACTIVE_PHASES:
            self._active[node_name] = state["phase"]
        else:
            self._active.pop(node_name, None)
        self.metrics.migrations_in_progress.set(len(self._active))

    def _annotate(self, node_name: str, key: str, value: str) -> None:
        def build(fresh: dict) -> Optional[dict]:
            if deep_get(fresh, "metadata", "annotations", key) == value:
                return None
            return {"metadata": {"annotations": {key: value}}}

        preconditioned_patch(self.client, "v1", "Node", node_name, build)

    def _clear(self, node_name: str, keys: List[str]) -> None:
        def build(fresh: dict) -> Optional[dict]:
            anns = deep_get(fresh, "metadata", "annotations",
                            default={}) or {}
            patch = {k: None for k in keys if anns.get(k) is not None}
            if not patch:
                return None
            return {"metadata": {"annotations": patch}}

        preconditioned_patch(self.client, "v1", "Node", node_name, build)

    # -- destination selection ------------------------------------------------
    def _pods_on(self, node_name: str) -> List[dict]:
        return self.client.list(
            "v1", "Pod", None,
            field_selector={"spec.nodeName": node_name})

    def _pick_destination(self, src: str,
                          exclude: Tuple[str, ...] = ()) -> Optional[str]:
        """The healthiest, emptiest GPU node that is not already a party
        to a migration — name-ordered for determinism. None when the
        fleet has nowhere to restore (the episode holds and the
        migration-stuck alert surfaces it)."""
        ranked: List[Tuple[int, str]] = []
        for node in self.client.list("v1", "Node"):
            name = node["metadata"]["name"]
            if name == src or name in exclude or not is_gpu_node(node):
                continue
            health = deep_get(node, "metadata", "labels",
                              consts.HEALTH_STATE_LABEL)
            if health not in (None, "", "healthy", "recovered"):
                continue
            anns = deep_get(node, "metadata", "annotations",
                            default={}) or {}
            if (consts.MIGRATION_INBOUND_ANNOTATION in anns
                    or consts.MIGRATION_STATE_ANNOTATION in anns
                    or consts.MIGRATE_REQUEST_ANNOTATION in anns):
                continue
            busy = sum(1 for pod in self._pods_on(name)
                       if not consts.drain_exempt(pod, self.namespace))
            ranked.append((busy, name))
        ranked.sort()
        return ranked[0][1] if ranked else None

    # -- transfer record ------------------------------------------------------
    def _inbound_payload(self, state: dict) -> dict:
        """The destination's transfer record, built ONLY from the durable
        state row so a crash-replay re-stamps a byte-identical value."""
        inbound = {"plan": state["plan"], "src": state["src"],
                   "step": int(state.get("step") or 0)}
        if state.get("manifest"):
            inbound["manifest"] = state["manifest"]
        return inbound

    def _repair_done_cleanup(self, state: dict) -> None:
        """Retire a completed episode's working annotations, idempotently
        and plan-guarded: finalize's cleanup spans TWO objects, so a kill
        between them leaves one half behind — every terminal sweep
        converges it. The plan/ack clears are fingerprint-matched so a
        health episode's own drain on the same node is never touched."""
        name, dst, fp = state["src"], state.get("dst"), state["plan"]

        def build(fresh: dict) -> Optional[dict]:
            anns = deep_get(fresh, "metadata", "annotations",
                            default={}) or {}
            patch = {k: None for k in
                     (consts.MIGRATE_REQUEST_ANNOTATION,
                      consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION,
                      consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION)
                     if anns.get(k) is not None}
            plan = drain_protocol.node_plan(fresh)
            if plan is not None and plan.fingerprint == fp:
                patch[consts.RETILE_PLAN_ANNOTATION] = None
            if drain_protocol.node_acked_plan(fresh) == fp:
                patch[consts.DRAIN_ACK_ANNOTATION] = None
            if not patch:
                return None
            return {"metadata": {"annotations": patch}}

        preconditioned_patch(self.client, "v1", "Node", name, build)
        if not dst:
            return
        try:
            dst_node = self.client.get("v1", "Node", dst)
        except NotFoundError:
            return
        inbound = _parse_json_annotation(
            dst_node, consts.MIGRATION_INBOUND_ANNOTATION)
        if inbound and inbound.get("plan") == fp:
            self._clear(dst, [consts.MIGRATION_INBOUND_ANNOTATION])

    # -- event helpers --------------------------------------------------------
    def _once(self, involved: dict, type_: str, reason: str, message: str,
              token: str) -> None:
        events.record_once(self.client, self.namespace, involved, type_,
                           reason, message, token=token)

    # -- provenance -----------------------------------------------------------
    def _episode_for(self, node: dict, state: dict) -> str:
        """The episode this migration belongs to: adopt the node's episode
        annotation when an upstream subsystem (the autoscaler's scale-down,
        a health remediation) opened one, otherwise mint a deterministic id
        from the plan and stamp it so downstream records chain here. Runs
        idempotently every pass — a crash replay re-derives the same id."""
        eid = deep_get(node, "metadata", "annotations",
                       consts.PROVENANCE_EPISODE_ANNOTATION)
        if eid:
            return str(eid)
        eid = episode_id("migrate", state["src"], state["plan"])
        self._annotate(state["src"], consts.PROVENANCE_EPISODE_ANNOTATION,
                       eid)
        return eid

    # -- the episode ----------------------------------------------------------
    def _publish_plan(self, node_name: str, fingerprint: str,
                      deadline: float) -> None:
        plan = drain_protocol.RetilePlan(
            fingerprint=fingerprint, deadline=deadline,
            reason=drain_protocol.REASON_MIGRATE)
        self._annotate(node_name, consts.RETILE_PLAN_ANNOTATION,
                       plan.to_json())

    def _begin(self, node: dict, req: dict, policy: ClusterPolicy,
               now: float) -> Optional[dict]:
        name = node["metadata"]["name"]
        dst = req.get("dst") or self._pick_destination(name)
        if dst is None:
            # Holding-state alert emitted while the episode has NOT
            # started (no durable state written yet): record() aggregates
            # the re-fires into one Event's count, which is the desired
            # "still blocked" signal.
            # opalint: disable=exactly-once-event
            events.record(self.client, self.namespace, node,
                          events.WARNING, REASON_BLOCKED,
                          f"{name}: migration requested but no eligible "
                          f"destination node; holding")
            return None
        fingerprint = drain_protocol.plan_fingerprint(
            f"migrate:{name}->{dst}", [])
        deadline = now + float(policy.spec.health.drain_deadline_s)
        state = {"phase": PHASE_DRAINING, "src": name, "dst": dst,
                 "plan": fingerprint,
                 "reason": str(req.get("reason", "manual")),
                 "seq": 1, "at_risk": 0, "step": None,
                 "deadline": round(deadline, 3),
                 "started_at": round(now, 3)}
        # durable intent FIRST: the state record is what a restarted
        # operator resumes from; plan annotation and Event repair
        # idempotently behind it (the draining branch re-publishes both)
        self._persist_state(name, state)
        log.info("migrate: episode %s -> %s begun (plan %s, reason %s)",
                 name, dst, fingerprint, state["reason"])
        return state

    def _advance(self, state: dict, node: dict, policy: ClusterPolicy,
                 now: float) -> Tuple[dict, Optional[float]]:
        """Drive one episode one step. Returns (state, requeue delay);
        a None delay means the episode is terminal (or externally
        driven)."""
        name = state["src"]
        fp = state["plan"]
        spec = policy.spec.migrate
        phase = state["phase"]
        eid = self._episode_for(node, state)

        if phase == PHASE_DRAINING:
            deadline = float(state["deadline"])
            # repair the plan + announcement halves idempotently: a crash
            # between the state write and either publish lands here. The
            # decision record rides the same idempotent repair — content-
            # addressed, so every pass converges to exactly one record.
            self.journal.record_decision(
                "migrate", "migrate", eid,
                trigger={"type": "annotation",
                         "key": consts.MIGRATE_REQUEST_ANNOTATION,
                         "reason": state.get("reason", "manual")},
                decision={"src": name, "dst": state["dst"], "plan": fp},
                alternatives=[
                    {"option": "force-retile", "reason": "migration moves "
                     "the tenant with zero lost steps; force is the "
                     "counted fallback, not the plan"}],
                actuations=[{"verb": "plan", "kind": "Node", "name": name}],
                node=name)
            self._publish_plan(name, fp, deadline)
            self._once(node, events.NORMAL, REASON_PLANNED,
                       f"migration of {name} -> {state['dst']}: drain "
                       f"planned (plan {fp})", token=fp)
            node = self.client.get("v1", "Node", name)
            if drain_protocol.node_acked_plan(node) == fp:
                ack = _parse_json_annotation(
                    node, consts.DRAIN_ACK_ANNOTATION) or {}
                state = dict(state, phase=PHASE_TRANSFERRING,
                             step=int(ack.get("step", 0)),
                             seq=state["seq"] + 1)
                self._persist_state(name, state)
                return state, 0.0
            if now >= deadline:
                if float(spec.snapshot_wait_s) > 0:
                    state = dict(
                        state, phase=PHASE_SNAPSHOTTING,
                        snapshot_deadline=round(
                            now + float(spec.snapshot_wait_s), 3),
                        seq=state["seq"] + 1)
                    self._persist_state(name, state)
                    return state, 0.0
                return self._fail(
                    state, node,
                    "drain deadline expired and transparent snapshots "
                    "are disabled (spec.migrate.snapshotWaitS=0)")
            return state, max(0.25, deadline - now + 0.1)

        if phase == PHASE_SNAPSHOTTING:
            snap_deadline = float(state.get("snapshot_deadline", now))
            self.journal.record_decision(
                "migrate", "migrate-snapshot", eid,
                trigger={"type": "deadline", "plan": fp},
                decision={"src": name, "dst": state["dst"], "plan": fp},
                alternatives=[
                    {"option": "bare-force-retile", "reason": "spec."
                     "migrate.snapshotWaitS > 0: a transparent snapshot "
                     "preserves the tenant's steps"}],
                actuations=[{"verb": "snapshot", "kind": "Node",
                             "name": name}],
                node=name)
            self._annotate(
                name, consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION,
                dumps_compact({"plan": fp,
                               "deadline": round(snap_deadline, 3)}))
            self._once(node, events.NORMAL, REASON_SNAPSHOT_REQUESTED,
                       f"{name}: drain deadline passed without an ack for "
                       f"plan {fp}; requesting a transparent snapshot "
                       f"instead of a bare force-retile", token=fp)
            node = self.client.get("v1", "Node", name)
            result = _parse_json_annotation(
                node, consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION)
            if result and result.get("plan") == fp:
                if result.get("ok"):
                    self._once(node, events.NORMAL, REASON_SNAPSHOT_TAKEN,
                               f"{name}: transparent snapshot captured at "
                               f"step {result.get('step')} (plan {fp}); "
                               f"the workload never participated",
                               token=fp)
                    self.metrics.migration_snapshots.inc()
                    state = dict(state, phase=PHASE_TRANSFERRING,
                                 step=int(result.get("step", 0)),
                                 manifest=result.get("manifest"),
                                 seq=state["seq"] + 1)
                    self._persist_state(name, state)
                    return state, 0.0
                return self._fail(state, node,
                                  f"transparent snapshot failed: "
                                  f"{result.get('error', 'unknown')}")
            if now >= snap_deadline:
                return self._fail(state, node,
                                  "transparent snapshot never "
                                  "materialized before its deadline")
            return state, max(0.25, snap_deadline - now + 0.1)

        if phase == PHASE_TRANSFERRING:
            dst = state["dst"]
            try:
                dst_node = self.client.get("v1", "Node", dst)
            except NotFoundError:
                return self._retarget(state, node, now)
            # the transfer record is the restore's durable intent: it
            # lives on the DESTINATION, so the restore half survives the
            # source node vanishing (preemptible revocation)
            self.journal.record_decision(
                "migrate", "migrate-restore", eid,
                trigger={"type": "phase", "from": PHASE_TRANSFERRING},
                decision={"src": name, "dst": dst, "plan": fp},
                actuations=[{"verb": "restore", "kind": "Node",
                             "name": dst}],
                node=name)
            self._annotate(dst, consts.MIGRATION_INBOUND_ANNOTATION,
                           dumps_compact(self._inbound_payload(state)))
            state = dict(state, phase=PHASE_RESTORING,
                         restore_deadline=round(
                             now + float(spec.restore_wait_s), 3),
                         seq=state["seq"] + 1)
            self._persist_state(name, state)
            return state, 0.25

        if phase == PHASE_RESTORING:
            dst = state["dst"]
            try:
                dst_node = self.client.get("v1", "Node", dst)
            except NotFoundError:
                return self._retarget(state, node, now)
            restore = _parse_json_annotation(
                dst_node, consts.MIGRATION_RESTORE_ANNOTATION)
            if restore and restore.get("plan") == fp:
                if restore.get("ok"):
                    return self._finalize(state, node, dst_node,
                                          int(restore.get("step", 0)))
                return self._fail(state, node,
                                  f"restore on {dst} failed: "
                                  f"{restore.get('error', 'unknown')}")
            # repair the transfer record: the durable state row and the
            # inbound annotation are writes to DIFFERENT objects, so a
            # kill (or batch flush order) can land "restoring" without
            # the record the destination's agent needs — re-stamp it
            # idempotently (the payload is deterministic, so this is a
            # no-op on the crash-free path)
            self._annotate(dst, consts.MIGRATION_INBOUND_ANNOTATION,
                           dumps_compact(self._inbound_payload(state)))
            if now >= float(state.get("restore_deadline", now + 1)):
                return self._fail(state, node,
                                  f"restore on {dst} never completed "
                                  f"before its deadline")
            return state, 0.5

        return state, None  # terminal (done/failed): externally retired

    def _retarget(self, state: dict, node: dict,
                  now: float) -> Tuple[dict, Optional[float]]:
        """The destination vanished mid-episode (spot revocation): pick a
        new one and replay the transfer — the step/manifest ride the
        durable state record, so nothing is lost."""
        lost = state["dst"]
        new_dst = self._pick_destination(state["src"], exclude=(lost,))
        if new_dst is None:
            # Holding-state alert: the episode is parked (state
            # unchanged, retried in 2 s) and record()'s count aggregation
            # is the desired "still waiting for an eligible destination"
            # signal, not a protocol step.
            # opalint: disable=exactly-once-event
            events.record(self.client, self.namespace, node,
                          events.WARNING, REASON_BLOCKED,
                          f"{state['src']}: destination {lost} vanished "
                          f"mid-migration and no replacement is eligible; "
                          f"holding")
            return state, 2.0
        log.info("migrate: destination %s vanished; re-targeting %s -> %s",
                 lost, state["src"], new_dst)
        self.journal.record_decision(
            "migrate", "migrate-retarget",
            self._episode_for(node, state),
            trigger={"type": "watch", "what": "destination-gone"},
            decision={"src": state["src"], "lost": lost, "dst": new_dst,
                      "plan": state["plan"]},
            node=state["src"])
        state = dict(state, phase=PHASE_TRANSFERRING, dst=new_dst,
                     seq=state["seq"] + 1)
        self._persist_state(state["src"], state)
        return state, 0.0

    def _finalize(self, state: dict, node: dict, dst_node: dict,
                  step: int) -> Tuple[dict, Optional[float]]:
        name, dst, fp = state["src"], state["dst"], state["plan"]
        self._once(dst_node, events.NORMAL, REASON_RESTORED,
                   f"tenant from {name} restored on {dst} at step {step} "
                   f"(plan {fp}): zero steps lost", token=fp)
        self._once(node, events.NORMAL, REASON_COMPLETED,
                   f"migration {name} -> {dst} complete at step {step} "
                   f"(plan {fp})", token=fp)
        # retire the episode's working annotations; the terminal state
        # record stays for cfgtool/autoscaler until the node itself goes
        state = dict(state, phase=PHASE_DONE, step=step,
                     seq=state["seq"] + 1)
        self.journal.record_decision(
            "migrate", "migrate-complete",
            self._episode_for(node, state),
            trigger={"type": "annotation",
                     "key": consts.MIGRATION_RESTORE_ANNOTATION},
            decision={"src": name, "dst": dst, "plan": fp, "step": step},
            outcome="restored",
            node=name)
        self._repair_done_cleanup(state)
        self._persist_state(name, state)
        self.metrics.migrations_total.labels(outcome="completed").inc()
        log.info("migrate: %s -> %s done at step %d (plan %s)",
                 name, dst, step, fp)
        return state, None

    def _fail(self, state: dict, node: dict,
              message: str) -> Tuple[dict, Optional[float]]:
        name, fp = state["src"], state["plan"]
        reason = (REASON_SNAPSHOT_FAILED
                  if state["phase"] == PHASE_SNAPSHOTTING
                  else REASON_FAILED)
        self._once(node, events.WARNING, reason,
                   f"{name}: migration failed ({message}); falling back "
                   f"to the counted force-retile path (plan {fp})",
                   token=fp)
        self._clear(name, [consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION])
        state = dict(state, phase=PHASE_FAILED, error=message,
                     seq=state["seq"] + 1)
        self.journal.record_decision(
            "migrate", "migrate-failed",
            self._episode_for(node, state),
            trigger={"type": "deadline", "plan": fp},
            inputs={"error": message},
            decision={"src": name, "dst": state.get("dst"), "plan": fp},
            outcome="failed",
            node=name)
        self._persist_state(name, state)
        self.metrics.migrations_total.labels(outcome="failed").inc()
        log.warning("migrate: %s failed: %s (plan %s)", name, message, fp)
        return state, None

    # -- the sweep ------------------------------------------------------------
    def reconcile(self, request: Request) -> Result:
        # fallback root span: protocol Events (RetilePlanned, Migration*)
        # must carry tpu.ai/trace-id even when this sweep runs outside
        # the runtime worker's root (benches, direct drives)
        with tracing.ensure_trace("reconcile", controller=self.name,
                                  request=request.name):
            with batch_window(self.client):
                return self._reconcile(request)

    def _reconcile(self, request: Request) -> Result:
        try:
            node = self.client.get("v1", "Node", request.name)
        except NotFoundError:
            # a vanished source is handled by the surviving destination's
            # inbound record; a vanished destination by _retarget on the
            # source's next pass
            self._active.pop(request.name, None)
            self._persisted_seq.pop(request.name, None)
            self.metrics.migrations_in_progress.set(len(self._active))
            return Result()
        state = migration_state(node)
        seq, at = self._persisted_seq.get(request.name, (0, 0.0))
        if (state is not None and int(state.get("seq", 0)) < seq
                and time.monotonic() - at < OWN_WRITE_LAG_S):
            # read-your-writes: the row this process wrote last has not
            # reached the cache yet; advancing the older one would finalize
            # (and count) the episode twice
            return Result(requeue_after=0.25)
        policy = self._policy()
        if policy is None:
            return Result()
        req = migrate_request(node)
        if state is None and req is None:
            return Result()
        if not policy.spec.migrate.is_enabled():
            if req is not None:
                log.info("migrate: request on %s ignored "
                         "(spec.migrate.enabled=false)", request.name)
            return Result()
        now = self.now()
        if state is None:
            state = self._begin(node, req, policy, now)
            if state is None:
                return Result(requeue_after=5.0)
        elif state["phase"] in (PHASE_DONE, PHASE_FAILED):
            # retired episode: re-migrating requires the admin (or the
            # autoscaler's node delete) to clear the state annotation
            # first — the terminal record is the exactly-once guard. A
            # completed episode still repairs its two-object cleanup: a
            # kill between finalize's src and dst patches must not leave
            # a stale transfer record behind
            if state["phase"] == PHASE_DONE:
                self._repair_done_cleanup(state)
            return Result()
        delay: Optional[float] = 0.0
        while delay == 0.0:
            state, delay = self._advance(state, node, policy, now)
        if delay is not None:
            return Result(requeue_after=max(0.25, delay))
        return Result()


# -- watch wiring --------------------------------------------------------------

def _all_node_requests(client: Client) -> List[Request]:
    return [Request(name=n["metadata"]["name"])
            for n in client.list("v1", "Node")
            if (deep_get(n, "metadata", "annotations",
                         consts.MIGRATE_REQUEST_ANNOTATION)
                or deep_get(n, "metadata", "annotations",
                            consts.MIGRATION_STATE_ANNOTATION)
                or deep_get(n, "metadata", "annotations",
                            consts.MIGRATION_INBOUND_ANNOTATION))]


def setup_migration_controller(client: Client,
                               reconciler: MigrationReconciler
                               ) -> Controller:
    controller = Controller(reconciler)

    def map_node(event: WatchEvent) -> List[Request]:
        name = event.object["metadata"]["name"]
        requests = [Request(name=name)]
        # a destination's annotation change (snapshot result, restore
        # result, inbound landing) must wake the SOURCE's episode too
        anns = deep_get(event.object, "metadata", "annotations",
                        default={}) or {}
        for key in (consts.MIGRATION_INBOUND_ANNOTATION,
                    consts.MIGRATION_RESTORE_ANNOTATION):
            raw = anns.get(key)
            if raw:
                try:
                    src = json.loads(raw).get("src")
                except (ValueError, AttributeError):
                    src = None
                if src and src != name:
                    requests.append(Request(name=str(src)))
        return requests

    controller.watches("v1", "Node", filtered_node_mapper(map_node))
    controller.resyncs(lambda: _all_node_requests(client),
                       period=RESYNC_PERIOD_S)
    return controller
