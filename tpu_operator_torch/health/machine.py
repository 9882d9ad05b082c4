"""Per-node GPU-health degraded-state machine (counterpart of
tpu_operator/health/machine.py).

Closes the detect -> degrade -> remediate -> recover loop for GPUs that go
bad AFTER node join: the revalidation sweep keeps the node-local workload
barrier fresh, feature discovery publishes its verdict as the
``tpu.ai/workload-health`` node annotation, and this machine — driven from
the ClusterPolicy reconcile sweep — walks the node through

    healthy -> degraded -> quarantined -> remediating -> recovered | failed

persisting every step in the ``tpu.ai/health-state`` node label and
``-since``/attempt/flap annotations, so an operator crash at any point
resumes mid-remediation from cluster state alone.

Design decisions mirrored from the upgrade machine:

- state label + RFC3339 ``-since`` annotation written in ONE patch; the
  since value drives wait budgets across operator restarts
- bounded remediation: attempt 1 recycles the node's
  ``gpu-operator-validator`` pods (the init chain re-runs every validation
  against the live GPUs); attempts >= 2 also restart its ``gpu-driver``
  pods (a driver reinstall). Attempts are persisted in an annotation so a
  crash never resets the budget.
- sticky ``failed`` records the driver-DS template fingerprint — it clears
  only when the template actually changes (new driver supersedes the
  failure) or an admin removes the health label
- flap damping: N healthy->degraded transitions inside a window trip a
  STICKY quarantine with exactly one Event, then the machine stops writing
  for that node (bounded label/API writes under flapping, the drift-heal
  damper's pattern)

One deliberate difference from the reference: each episode gets its own
id. The reference mints ``episode_id("health", node, verdict)``, so a
node's second episode with the same verdict string rejoins its first,
closed one, and the journal drops the new records as crash replays. Here
the id also holds the node's ``tpu.ai/health-state-since`` as read when
the id is first minted (a value the node keeps across an operator
restart), the protocol Events' exactly-once tokens carry the episode, and
an admin's label clear wipes the stamped id with the other annotations.

And one repair: the admin's label clear out of sticky ``failed`` or flap
quarantine also lifts the cordon the machine set (``cordonOnQuarantine``),
as its other exits do; the reference leaves such a node unschedulable.
"""

from __future__ import annotations

import calendar
import dataclasses
import json
import logging
import time
from typing import Dict, List, Optional

from .. import consts, events
from ..client.errors import ApiError, FencedError, NotFoundError
from ..client.interface import Client
from ..client.preconditions import preconditioned_patch
from ..provenance import DecisionJournal, episode_id
from ..utils import deep_get, template_fingerprint
from . import drain

log = logging.getLogger(__name__)

#: no label = healthy (the steady state writes nothing, like upgrade UNKNOWN)
HEALTHY = ""
DEGRADED = "degraded"
QUARANTINED = "quarantined"
REMEDIATING = "remediating"
RECOVERED = "recovered"
FAILED = "failed"

STATES = (DEGRADED, QUARANTINED, REMEDIATING, RECOVERED, FAILED)

#: component labels of the pods remediation recycles (stamped by the port's
#: manifests: state-operator-validation and state-driver)
VALIDATOR_COMPONENT = "gpu-operator-validator"
DRIVER_COMPONENT = "gpu-driver"


def node_health_state(node: dict) -> str:
    return deep_get(node, "metadata", "labels", consts.HEALTH_STATE_LABEL,
                    default=HEALTHY)


def parse_workload_health(node: dict) -> Optional[bool]:
    """The node's published barrier verdict: True = passing, False =
    failing or corrupt, None = no information (feature discovery has not
    published yet / node predates the annotation) — absence must never be
    treated as failure, or every fresh node would start degraded."""
    raw = deep_get(node, "metadata", "annotations",
                   consts.WORKLOAD_HEALTH_ANNOTATION)
    if not raw:
        return None
    return raw == "passed"


def failed_gpus_from_annotation(node: dict) -> Optional[List[int]]:
    """GPU ids carried by a ``failed:<csv>`` verdict (None when the
    failure is unattributed or the verdict is not a failure)."""
    raw = deep_get(node, "metadata", "annotations",
                   consts.WORKLOAD_HEALTH_ANNOTATION) or ""
    if not raw.startswith("failed:"):
        return None
    try:
        return sorted(int(c) for c in raw[len("failed:"):].split(",") if c)
    except ValueError:
        return None


@dataclasses.dataclass
class HealthCounts:
    healthy: int = 0
    degraded: int = 0
    quarantined: int = 0
    remediating: int = 0
    recovered: int = 0
    failed: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    def merged(self, other: "HealthCounts") -> "HealthCounts":
        return HealthCounts(**{
            field.name: getattr(self, field.name) + getattr(other, field.name)
            for field in dataclasses.fields(self)})


class HealthStateMachine:
    def __init__(self, client: Client, namespace: str, policy=None,
                 now=time.time, migrate=None, journal=None):
        from ..api.clusterpolicy import HealthSpec

        self.client = client
        self.namespace = namespace
        self.policy = policy or HealthSpec()
        #: decision-provenance journal: every actuating edge of the machine
        #: (plan publish, snapshot request, counted force, pod recycle,
        #: terminal recover/failed) records the decision that licensed it
        self.journal = journal or DecisionJournal()
        #: the ClusterPolicy's ``migrate`` sub-spec as given (a free-form
        #: object until the migration controller's slice; None when
        #: absent): when ``enabled`` with ``snapshotWaitS`` > 0 (default
        #: 30), an expired drain deadline requests a transparent snapshot
        #: through the node's migrate agent before any counted force-retile
        self.migrate = migrate
        self._now = now  # injectable clock for budget/flap tests
        #: remediation actions fired THIS sweep — the reconciler adds this
        #: to the tpu_operator_remediation_attempts_total counter
        self.attempts_fired = 0
        #: drain deadlines that expired without a workload ack THIS sweep
        #: (force path taken) — feeds
        #: tpu_operator_drain_deadline_missed_total
        self.deadline_misses = 0
        #: nodes currently inside an open drain window (plan published,
        #: no ack yet) — feeds the tpu_operator_drains_in_progress gauge
        self.plans_pending = 0
        #: transparent snapshots that replaced a force-retile THIS sweep —
        #: feeds tpu_operator_migration_snapshots_total
        self.snapshots_taken = 0

    # -- cluster inspection ---------------------------------------------------
    def _pods_on(self, node_name: str, component: str) -> List[dict]:
        return self.client.list(
            "v1", "Pod", self.namespace,
            label_selector={"app.kubernetes.io/component": component},
            field_selector={"spec.nodeName": node_name})

    def _delete_pod(self, pod: dict) -> None:
        try:
            self.client.delete("v1", "Pod", pod["metadata"]["name"],
                               pod["metadata"].get("namespace"))
        except NotFoundError:
            pass

    def _driver_ds_for(self, node: dict) -> Optional[dict]:
        from ..state.skel import node_matches_selector

        for ds in self.client.list("apps/v1", "DaemonSet", self.namespace):
            component = deep_get(ds, "spec", "template", "metadata", "labels",
                                 "app.kubernetes.io/component")
            if component != DRIVER_COMPONENT:
                continue
            selector = deep_get(ds, "spec", "template", "spec",
                                "nodeSelector", default={})
            if node_matches_selector(node, selector):
                return ds
        return None

    @staticmethod
    def _template_fingerprint(ds: Optional[dict]) -> str:
        """Driver-DS pod-template fingerprint (same value the upgrade
        machine records): sticky failed/flap states clear when it changes,
        because a rolled driver supersedes the failed remediation."""
        tpl = deep_get(ds or {}, "spec", "template", default={})
        return deep_get(tpl, "metadata", "labels",
                        consts.TEMPLATE_HASH_LABEL) or template_fingerprint(tpl)

    # -- node writes ----------------------------------------------------------
    # Every write goes through the rv-preconditioned helper: the patch
    # carries the resourceVersion of the node it was computed from, a
    # competing writer (a newer leader's sweep racing past the epoch fence,
    # or feature discovery mirroring node-local state) surfaces as 409, and
    # the mutation is re-derived against the fresh object instead of
    # clobbering it. Transitions additionally re-validate the state label
    # they were decided from and decline when another writer already
    # advanced the machine.

    def _mirror(self, node: dict, fresh: dict) -> None:
        """Fold the server's post-write object back into the sweep's
        snapshot so the rest of the sweep works against what actually
        landed (the old code mirrored the patch; the helper gives us the
        authoritative result instead)."""
        meta = node.setdefault("metadata", {})
        fresh_meta = fresh.get("metadata", {})
        meta["labels"] = dict(fresh_meta.get("labels") or {})
        meta["annotations"] = dict(fresh_meta.get("annotations") or {})
        meta["resourceVersion"] = fresh_meta.get("resourceVersion")
        if "spec" in fresh:
            node["spec"] = dict(fresh["spec"])

    def _set_state(self, node: dict, state: str,
                   extra_annotations: Optional[Dict[str, Optional[str]]] = None
                   ) -> bool:
        """Label + since-annotation in one rv-preconditioned patch,
        mirrored locally (the sweep keeps working against its snapshot).
        Returns False when the transition was declined because a competing
        writer already moved the node past the state this decision was
        made from (the next sweep re-derives)."""
        name = node["metadata"]["name"]
        expected = node_health_state(node)
        log.info("health: node %s -> %s", name, state or "healthy")
        since = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                              time.gmtime(self._now())) if state else None
        ann_patch: Dict[str, Optional[str]] = {
            consts.HEALTH_STATE_SINCE_ANNOTATION: since}
        if not state:
            # back to healthy: drop episode bookkeeping. The flap history
            # deliberately SURVIVES (flap damping must see recoveries that
            # immediately re-degrade); it is pruned by its window.
            ann_patch[consts.HEALTH_ATTEMPTS_ANNOTATION] = None
            ann_patch[consts.HEALTH_FAILED_TEMPLATE_ANNOTATION] = None
            ann_patch[consts.HEALTH_FLAP_STICKY_ANNOTATION] = None
            ann_patch[consts.RETILE_PLAN_ANNOTATION] = None
            ann_patch[consts.DRAIN_ACK_ANNOTATION] = None
            ann_patch[consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION] = None
            ann_patch[consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION] = None
            # episode over: the next degrade mints a fresh chain
            ann_patch[consts.PROVENANCE_EPISODE_ANNOTATION] = None
        ann_patch.update(extra_annotations or {})
        declined = []

        def build(fresh: dict) -> Optional[dict]:
            if node_health_state(fresh) != expected:
                # another writer advanced the machine since this sweep's
                # snapshot: the transition is stale — drop it, don't clobber
                declined.append(node_health_state(fresh))
                return None
            return {"metadata": {
                "labels": {consts.HEALTH_STATE_LABEL: state or None},
                "annotations": dict(ann_patch),
            }}

        fresh = preconditioned_patch(self.client, "v1", "Node", name, build)
        self._mirror(node, fresh)
        if declined:
            log.warning("health: node %s transition %r -> %r declined "
                        "(concurrent writer moved it to %r)", name,
                        expected or "healthy", state or "healthy",
                        declined[-1] or "healthy")
            return False
        return True

    def _annotate(self, node: dict, key: str, value: Optional[str]) -> None:
        current = deep_get(node, "metadata", "annotations", key)
        if current == value:
            return

        def build(fresh: dict) -> Optional[dict]:
            if deep_get(fresh, "metadata", "annotations", key) == value:
                return None  # someone already wrote it; drift-gate holds
            return {"metadata": {"annotations": {key: value}}}

        fresh = preconditioned_patch(self.client, "v1", "Node",
                                     node["metadata"]["name"], build)
        self._mirror(node, fresh)

    def _episode_for(self, node: dict) -> str:
        """Adopt the node's stamped episode (a prior sweep of this machine
        already opened one) or mint one and stamp it. The id must replay
        identically after a crash, so it is derived from the node's state,
        never from a uuid: the verdict that started the episode and the
        node's ``-since`` stamp as read now, which the node keeps across a
        restart and which differs for every episode a return to healthy
        separates (the verdict alone would fold a second episode into a
        first, closed one). The stamp is whole seconds: two episodes of one
        node minted in the same second would share an id, and none is that
        short (each waits for feature discovery to publish its verdict)."""
        eid = deep_get(node, "metadata", "annotations",
                       consts.PROVENANCE_EPISODE_ANNOTATION)
        if eid:
            return eid
        anns = deep_get(node, "metadata", "annotations", default={}) or {}
        eid = episode_id("health", node["metadata"]["name"],
                         anns.get(consts.WORKLOAD_HEALTH_ANNOTATION) or "",
                         anns.get(consts.HEALTH_STATE_SINCE_ANNOTATION) or "")
        try:
            self._annotate(node, consts.PROVENANCE_EPISODE_ANNOTATION, eid)
        except ApiError:
            pass  # stamping is best-effort; the journal still chains on eid
        return eid

    def _cordon(self, node: dict, unschedulable: bool) -> None:
        def build(fresh: dict) -> Optional[dict]:
            if fresh.get("spec", {}).get("unschedulable") == (unschedulable or None):
                return None
            return {"spec": {"unschedulable": unschedulable or None}}

        fresh = preconditioned_patch(self.client, "v1", "Node",
                                     node["metadata"]["name"], build)
        node.setdefault("spec", {})["unschedulable"] = (
            fresh.get("spec", {}).get("unschedulable"))

    def _state_age(self, node: dict) -> float:
        """Seconds in the current state; absent/corrupt stamps now and
        returns 0 (fresh budget beats instant escalation — same rule as
        the upgrade machine)."""
        raw = deep_get(node, "metadata", "annotations",
                       consts.HEALTH_STATE_SINCE_ANNOTATION)
        if raw:
            try:
                since = calendar.timegm(time.strptime(raw, "%Y-%m-%dT%H:%M:%SZ"))
                return max(0.0, self._now() - since)
            except ValueError:
                pass
        self._set_state(node, node_health_state(node))
        return 0.0

    def _event(self, node: dict, type_: str, reason: str, message: str,
               token: Optional[str] = None) -> None:
        """With ``token``, the announcement is content-addressed and
        structurally exactly-once (see :func:`events.record_once`): the
        protocol Events whose multiplicity the drain/remediation contract
        pins (one RetilePlanned per plan fingerprint, one
        NodeHealthRemediating per attempt) pass one, so a crash-repair
        re-emit racing a lagging Event cache — or a deposed leader's
        not-yet-fenced sweep — cannot mint a duplicate."""
        if token is not None:
            events.record_once(self.client, self.namespace, node, type_,
                               reason, message, token=token)
        else:
            events.record(self.client, self.namespace, node, type_, reason,
                          message)

    def _event_exists(self, node: dict, reason: str, needle: str) -> bool:
        """Crash-repair probe: is there a stored Event for this node with
        ``reason`` whose message mentions ``needle``? Used by the write-
        ahead patterns below — the annotation is the durable intent, the
        Event its announcement; a crash between the two writes loses the
        Event, and the resumed sweep re-emits it exactly once. Fails open
        (True) on list errors: a re-emitted duplicate aggregates into a
        count bump, but never blocking the sweep on Event reads matters
        more."""
        try:
            for event in self.client.list("v1", "Event", self.namespace):
                if (event.get("reason") == reason
                        and deep_get(event, "involvedObject", "name")
                        == node["metadata"]["name"]
                        and needle in (event.get("message") or "")):
                    return True
        except ApiError as e:
            log.debug("health: event-repair probe failed: %s", e)
            return True
        return False

    # -- flap damping ---------------------------------------------------------
    def _flap_history(self, node: dict) -> List[int]:
        raw = deep_get(node, "metadata", "annotations",
                       consts.HEALTH_FLAP_HISTORY_ANNOTATION) or ""
        out = []
        for part in raw.split(","):
            try:
                out.append(int(part))
            except ValueError:
                continue
        cutoff = self._now() - self.policy.flap_window_s
        return [t for t in out if t >= cutoff]

    def _record_degraded_entry(self, node: dict, expected: str) -> bool:
        """Append a healthy->degraded transition to the flap history.
        Returns True when the damper tripped (threshold entries inside the
        window) — the caller then goes sticky-quarantined instead of
        degraded. The append is computed from the FRESH node inside the
        preconditioned write, so two sweeps racing (crash-restart replay,
        or a deposed leader's last write) cannot double-append or drop a
        competing writer's entry; ``expected`` is the state this decision
        was made from — a sweep working off a stale snapshot (the
        transition already landed) must not inflate the history."""
        stamp = int(self._now())

        def build(fresh: dict) -> Optional[dict]:
            if node_health_state(fresh) != expected:
                return None  # stale snapshot: the transition already landed
            history = self._flap_history(fresh)
            if stamp not in history:
                history = history + [stamp]
            value = ",".join(str(t) for t in history)
            if deep_get(fresh, "metadata", "annotations",
                        consts.HEALTH_FLAP_HISTORY_ANNOTATION) == value:
                return None  # replayed write (crash between patch and ack)
            return {"metadata": {"annotations": {
                consts.HEALTH_FLAP_HISTORY_ANNOTATION: value}}}

        fresh = preconditioned_patch(self.client, "v1", "Node",
                                     node["metadata"]["name"], build)
        self._mirror(node, fresh)
        return len(self._flap_history(node)) >= self.policy.flap_threshold

    # -- remediation ----------------------------------------------------------
    def _attempt_message(self, name: str, attempt: int) -> str:
        """The NodeHealthRemediating Event text — shared by the normal
        attempt paths and the crash-repair re-emit so the messages match
        byte-for-byte (Event aggregation keys on the message)."""
        limit = self.policy.max_remediation_attempts
        if attempt <= 1:
            return (f"{name}: remediation attempt 1/{limit} "
                    f"(validator recycle, forced revalidation)")
        return (f"{name}: remediation attempt {attempt}/{limit}"
                f" (driver restart + revalidation)")

    def _remediate(self, node: dict, attempt: int) -> None:
        """One bounded remediation attempt. Attempt 1: recycle the node's
        validator pods — the DS controller recreates them and the init
        chain re-runs the full validation sweep against the live GPUs
        (the forced local revalidation). Attempts >= 2 escalate: also
        restart the driver pods (a driver reinstall) before revalidating."""
        name = node["metadata"]["name"]
        # recorded from inside the actuating function so the crash-repair
        # re-fire in _process_node replays into the SAME content-addressed
        # record (trigger/decision are keyed on the attempt number only)
        self.journal.record_decision(
            "health", "remediate", self._episode_for(node),
            trigger={"type": "attempt", "n": attempt},
            inputs={"limit": self.policy.max_remediation_attempts},
            decision={"attempt": attempt, "node": name,
                      "action": ("validator-recycle" if attempt <= 1
                                 else "driver-restart+revalidation")},
            actuations=[{"verb": "recycle", "kind": "Node", "name": name}],
            node=name)
        self.attempts_fired += 1
        if attempt >= 2:
            for pod in self._pods_on(name, DRIVER_COMPONENT):
                self._delete_pod(pod)
        for pod in self._pods_on(name, VALIDATOR_COMPONENT):
            self._delete_pod(pod)

    # -- coordinated drain (planned re-tiles) ---------------------------------
    @staticmethod
    def _plan_message(name: str, plan, deadline_s: float) -> str:
        """The RetilePlanned Event text — shared by the publish path and
        the crash-repair re-emit so the two produce byte-identical
        messages (Event aggregation keys on the message)."""
        return (f"{name}: planned {plan.reason} (layout {plan.fingerprint}"
                + (f", GPUs {plan.blocked} gated" if plan.blocked else "")
                + f"); workloads have {deadline_s}s to checkpoint "
                  f"and ack before the forced drain")

    def _drain_gate(self, node: dict) -> bool:
        """Coordination gate on the quarantined->remediating edge: returns
        True when remediation/re-tiling may proceed — no drain window
        configured, the workload acked the published plan, or the deadline
        expired (fail-safe force; counted as a miss). Returns False while
        the window is open: the plan is published (annotation + ONE
        RetilePlanned Event) and the node simply stays quarantined until
        the next sweep. Everything the gate consults lives on the node, so
        an operator restarted mid-drain resumes without re-announcing."""
        deadline_s = getattr(self.policy, "drain_deadline_s", 0) or 0
        if deadline_s <= 0:
            return True
        name = node["metadata"]["name"]
        labels = deep_get(node, "metadata", "labels", default={}) or {}
        partition = labels.get(consts.TPU_SLICE_CONFIG_LABEL)
        blocked = failed_gpus_from_annotation(node) or []
        fingerprint = drain.plan_fingerprint(partition, blocked)
        plan = drain.node_plan(node)
        if plan is None or plan.fingerprint != fingerprint:
            # publish (or supersede — more GPUs failed mid-drain). The
            # annotation is the write-ahead intent and lands FIRST; the
            # Event is its announcement. A restarted operator finds the
            # matching annotation below and never double-announces.
            reason = (drain.REASON_RETILE if partition and blocked
                      else drain.REASON_REMEDIATE)
            new_plan = drain.RetilePlan(
                fingerprint=fingerprint,
                deadline=self._now() + deadline_s,
                reason=reason, blocked=blocked)
            # decision record lands before the plan annotation it licenses
            # (write-ahead provenance: a crash between the two replays into
            # the same content-addressed record, never a duplicate)
            episode = self._episode_for(node)
            self.journal.record_decision(
                "health", "drain-plan", episode,
                trigger={"type": "verdict", "plan": fingerprint},
                inputs={"blocked_gpus": blocked,
                        "deadline_s": deadline_s},
                decision={"reason": reason, "plan": fingerprint,
                          "node": name},
                alternatives=[{"option": "force-immediate",
                               "rejected": "drain window configured; "
                                           "workloads get the deadline to "
                                           "checkpoint and ack"}],
                actuations=[{"verb": "plan", "kind": "Node", "name": name}],
                node=name)
            self._annotate(node, consts.RETILE_PLAN_ANNOTATION,
                           new_plan.to_json())
            self._event(node, events.NORMAL, "RetilePlanned",
                        self._plan_message(name, new_plan, deadline_s),
                        token=f"{episode}:{fingerprint}")
            self.plans_pending += 1
            return False
        if not self._event_exists(node, "RetilePlanned", fingerprint):
            # crash repair: a kill between the annotation landing and its
            # Event leaves the plan announced to machines but not humans —
            # and "exactly one RetilePlanned per episode" would read as
            # zero. Re-emit against the stored plan (same deadline, so the
            # message matches what the original would have said).
            self._event(node, events.NORMAL, "RetilePlanned",
                        self._plan_message(name, plan, deadline_s),
                        token=f"{self._episode_for(node)}:{plan.fingerprint}")
        if drain.node_acked_plan(node) == fingerprint:
            return True
        if plan.expired(self._now()):
            verdict = self._snapshot_gate(node, fingerprint)
            if verdict is not None:
                return verdict
            # snapshot window still open: the node keeps its quarantine
            self.plans_pending += 1
            return False
        self.plans_pending += 1
        return False

    def _snapshot_wait_s(self) -> float:
        migrate = self.migrate or {}
        if not migrate.get("enabled"):
            return 0.0
        return float(migrate.get("snapshotWaitS", 30) or 0)

    def _force_expired(self, node: dict, fingerprint: str,
                       detail: str) -> bool:
        """Today's counted force-retile — the fallback every snapshot
        failure degrades to (fail-safe: the machine is never wedged)."""
        name = node["metadata"]["name"]
        self.deadline_misses += 1
        # the force is a decision in its own right (not just the tail of
        # the plan decision): it records the deadline trigger and the
        # rejected wait alternative so `gpuop-cfg explain` shows WHY the
        # workload lost its window
        episode = self._episode_for(node)
        self.journal.record_decision(
            "health", "drain-force", episode,
            trigger={"type": "deadline", "plan": fingerprint},
            inputs={"detail": detail},
            decision={"forced": True, "plan": fingerprint, "node": name},
            alternatives=[{"option": "keep-waiting",
                           "rejected": "deadline expired; the machine is "
                                       "never wedged"}],
            actuations=[{"verb": "force-retile", "kind": "Node",
                         "name": name}],
            node=name)
        self._event(node, events.WARNING, "RetileDeadlineExpired",
                    f"{name}: {detail} for plan {fingerprint}; "
                    f"force-proceeding", token=f"{episode}:{fingerprint}")
        return True

    def _snapshot_gate(self, node: dict, fingerprint: str
                       ) -> Optional[bool]:
        """The transparent-snapshot path on an expired drain deadline
        (CRIUgpu, arXiv 2502.16631): instead of a bare force-retile, ask
        the node's migrate agent for an operator-driven snapshot the
        workload never participates in, and only fall back to the counted
        force when the snapshot itself fails or times out. Returns True
        to proceed (snapshot landed, or counted force), None while the
        snapshot window is open. Same write-ahead discipline as the plan:
        the request annotation is the durable intent, the Event its
        announcement, and everything lives on the node so a restarted
        operator resumes without re-requesting."""
        wait = self._snapshot_wait_s()
        if wait <= 0:
            return self._force_expired(
                node, fingerprint,
                "drain deadline passed without a workload ack")
        name = node["metadata"]["name"]
        raw = deep_get(node, "metadata", "annotations",
                       consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION)
        request = None
        if raw:
            try:
                request = json.loads(raw)
            except ValueError:
                request = None
        if (not isinstance(request, dict)
                or request.get("plan") != fingerprint):
            payload = json.dumps(
                {"plan": fingerprint,
                 "deadline": round(self._now() + wait, 3)},
                sort_keys=True)
            self.journal.record_decision(
                "health", "snapshot-request", self._episode_for(node),
                trigger={"type": "deadline", "plan": fingerprint},
                inputs={"snapshot_wait_s": wait},
                decision={"plan": fingerprint, "node": name,
                          "path": "transparent-snapshot"},
                alternatives=[{"option": "force-retile",
                               "rejected": "migrate agent can capture a "
                                           "restorable checkpoint first"}],
                actuations=[{"verb": "snapshot", "kind": "Node",
                             "name": name}],
                node=name)
            self._annotate(node,
                           consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION,
                           payload)
            self._event(node, events.NORMAL, "MigrationSnapshotRequested",
                        f"{name}: drain deadline passed without a "
                        f"workload ack for plan {fingerprint}; requesting "
                        f"a transparent snapshot before any force-retile",
                        token=f"{self._episode_for(node)}:{fingerprint}")
            return None
        if not self._event_exists(node, "MigrationSnapshotRequested",
                                  fingerprint):
            # crash repair: annotation landed, announcement lost
            self._event(node, events.NORMAL, "MigrationSnapshotRequested",
                        f"{name}: drain deadline passed without a "
                        f"workload ack for plan {fingerprint}; requesting "
                        f"a transparent snapshot before any force-retile",
                        token=f"{self._episode_for(node)}:{fingerprint}")
        raw = deep_get(node, "metadata", "annotations",
                       consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION)
        result = None
        if raw:
            try:
                result = json.loads(raw)
            except ValueError:
                result = None
        if isinstance(result, dict) and result.get("plan") == fingerprint:
            if result.get("ok"):
                self.snapshots_taken += 1
                self._event(node, events.NORMAL, "TransparentSnapshotTaken",
                            f"{name}: transparent snapshot captured at "
                            f"step {result.get('step')} for plan "
                            f"{fingerprint}; proceeding with a restorable "
                            f"checkpoint, no steps lost",
                            token=f"{self._episode_for(node)}:{fingerprint}")
                return True
            return self._force_expired(
                node, fingerprint,
                f"transparent snapshot failed "
                f"({result.get('error', 'unknown')})")
        try:
            snap_deadline = float(request.get("deadline", 0) or 0)
        except (TypeError, ValueError):
            snap_deadline = 0.0
        if self._now() >= snap_deadline:
            return self._force_expired(
                node, fingerprint,
                "transparent snapshot never materialized")
        return None

    # -- the sweep ------------------------------------------------------------
    def process(self, nodes: List[dict]) -> HealthCounts:
        counts = HealthCounts()
        for node in nodes:
            try:
                state = self._process_node(node)
            except FencedError:
                # deposed mid-sweep: propagate so the runtime requeues the
                # whole sweep without counting an error (BreakerOpenError
                # treatment) — swallowing it per-node would let a deposed
                # leader keep iterating the fleet
                raise
            except ApiError as e:
                log.warning("health: node %s sweep error: %s",
                            node["metadata"]["name"], e)
                state = node_health_state(node)
            if state == HEALTHY:
                counts.healthy += 1
            else:
                setattr(counts, state, getattr(counts, state) + 1)
        return counts

    def _process_node(self, node: dict) -> str:
        name = node["metadata"]["name"]
        state = node_health_state(node)
        verdict = parse_workload_health(node)
        anns = deep_get(node, "metadata", "annotations", default={}) or {}

        if state == HEALTHY:
            # manual label clear is the admin escape hatch out of BOTH
            # sticky states: wipe every health annotation (including the
            # flap history — without this the next degraded would re-trip
            # sticky quarantine instantly) and start fresh
            leftovers = [k for k in (consts.HEALTH_STATE_SINCE_ANNOTATION,
                                     consts.HEALTH_ATTEMPTS_ANNOTATION,
                                     consts.HEALTH_FLAP_STICKY_ANNOTATION,
                                     consts.HEALTH_FAILED_TEMPLATE_ANNOTATION,
                                     consts.HEALTH_FLAP_HISTORY_ANNOTATION,
                                     consts.RETILE_PLAN_ANNOTATION,
                                     consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION,
                                     consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION,
                                     # the failed episode's id: the next
                                     # degrade opens a new one
                                     consts.PROVENANCE_EPISODE_ANNOTATION)
                         if k in anns]
            if leftovers and (consts.HEALTH_FLAP_STICKY_ANNOTATION in anns
                              or consts.HEALTH_FAILED_TEMPLATE_ANNOTATION in anns):
                def build(fresh: dict) -> Optional[dict]:
                    fresh_anns = deep_get(fresh, "metadata", "annotations",
                                          default={}) or {}
                    gone = [k for k in leftovers if k in fresh_anns]
                    if not gone:
                        return None  # another sweep already wiped them
                    return {"metadata": {
                        "annotations": {k: None for k in gone}}}

                self._mirror(node, preconditioned_patch(
                    self.client, "v1", "Node", name, build))
                anns = deep_get(node, "metadata", "annotations",
                                default={}) or {}
                # the machine's own cordon goes with the episode, as on its
                # other exits (the template resets, recovery, clear_all)
                if self.policy.cordon_on_quarantine:
                    self._cordon(node, False)
            if verdict is False:
                if self._record_degraded_entry(node, HEALTHY):
                    if not self._set_state(node, QUARANTINED,
                                           extra_annotations={
                            consts.HEALTH_FLAP_STICKY_ANNOTATION:
                                self._template_fingerprint(
                                    self._driver_ds_for(node))}):
                        return node_health_state(node)
                    if self.policy.cordon_on_quarantine:
                        self._cordon(node, True)
                    # exactly ONE Event: the sticky branch below never
                    # writes again until template change or manual clear
                    self._event(node, events.WARNING, "NodeHealthFlapping",
                                f"{name}: {self.policy.flap_threshold} "
                                f"health flaps within "
                                f"{self.policy.flap_window_s}s; sticky "
                                f"quarantine until driver template changes "
                                f"or the {consts.HEALTH_STATE_LABEL} label "
                                f"is cleared")
                    return QUARANTINED
                if not self._set_state(node, DEGRADED):
                    # a concurrent sweep (or this one racing a stale
                    # informer snapshot) already advanced the node: the
                    # Event belongs to the writer whose transition landed
                    return node_health_state(node)
                self._event(node, events.WARNING, "NodeHealthDegraded",
                            f"{name}: workload barrier regressed "
                            f"({anns.get(consts.WORKLOAD_HEALTH_ANNOTATION)})")
                return DEGRADED
            return HEALTHY

        if state == FAILED:
            # sticky: clears only on template change (rolled driver
            # supersedes the failure) — manual label clear is handled by
            # the HEALTHY branch above once the admin removes the label
            recorded = anns.get(consts.HEALTH_FAILED_TEMPLATE_ANNOTATION)
            fingerprint = self._template_fingerprint(self._driver_ds_for(node))
            if recorded is not None and recorded != fingerprint:
                if self.policy.cordon_on_quarantine:
                    self._cordon(node, False)
                if not self._set_state(node, HEALTHY):
                    return node_health_state(node)
                self._event(node, events.NORMAL, "NodeHealthReset",
                            f"{name}: driver template changed; retrying "
                            f"health remediation from scratch")
                return HEALTHY
            return FAILED

        if state == QUARANTINED and consts.HEALTH_FLAP_STICKY_ANNOTATION in anns:
            # flap-damped: NO writes until the template rolls or an admin
            # clears the label (bounded API writes under flapping)
            recorded = anns[consts.HEALTH_FLAP_STICKY_ANNOTATION]
            fingerprint = self._template_fingerprint(self._driver_ds_for(node))
            if recorded and recorded != fingerprint:
                if self.policy.cordon_on_quarantine:
                    self._cordon(node, False)
                if not self._set_state(node, HEALTHY, extra_annotations={
                        consts.HEALTH_FLAP_HISTORY_ANNOTATION: None}):
                    return node_health_state(node)
                self._event(node, events.NORMAL, "NodeHealthReset",
                            f"{name}: driver template changed; flap "
                            f"quarantine lifted")
                return HEALTHY
            return QUARANTINED

        if state == DEGRADED:
            if verdict is not False:
                # one-sweep blip (or verdict withdrawn): back to healthy
                # without the full recovery ceremony
                if not self._set_state(node, HEALTHY):
                    return node_health_state(node)
                self._event(node, events.NORMAL, "NodeHealthRecovered",
                            f"{name}: workload barrier recovered before "
                            f"quarantine")
                return HEALTHY
            # still failing on a later sweep: confirmed, quarantine
            if not self._set_state(node, QUARANTINED):
                return node_health_state(node)
            if self.policy.cordon_on_quarantine:
                self._cordon(node, True)
            self._event(node, events.WARNING, "NodeHealthQuarantined",
                        f"{name}: GPU failure confirmed; unit(s) "
                        f"quarantined"
                        + (f" (GPUs {failed_gpus_from_annotation(node)})"
                           if failed_gpus_from_annotation(node) else ""))
            return QUARANTINED

        if state == QUARANTINED:
            if verdict is True:
                return self._recover(node)
            if not self._drain_gate(node):
                # drain window open: workloads are checkpointing; the
                # partitioner holds the layout and we hold the pods until
                # ack or deadline (re-checked every sweep, never wedged)
                return QUARANTINED
            if not self._set_state(node, REMEDIATING, extra_annotations={
                    consts.HEALTH_ATTEMPTS_ANNOTATION: "1"}):
                # the transition didn't land — firing the recycle anyway
                # would be a remediation attempt with no durable record
                return node_health_state(node)
            self._remediate(node, 1)
            self._event(node, events.NORMAL, "NodeHealthRemediating",
                        self._attempt_message(name, 1),
                        token=f"{self._episode_for(node)}:attempt-1")
            return REMEDIATING

        if state == REMEDIATING:
            attempts = 1
            try:
                attempts = int(anns.get(consts.HEALTH_ATTEMPTS_ANNOTATION, "1"))
            except ValueError:
                pass
            if not self._event_exists(node, "NodeHealthRemediating",
                                      f"remediation attempt {attempts}/"):
                # crash repair — BEFORE the recovery transition below, or a
                # node that revalidated while the operator was down exits
                # the machine with the attempt unannounced forever. The
                # attempts annotation is the write-ahead record of attempt
                # N: a kill between it landing and the pod recycle (or its
                # Event) leaves the attempt recorded but never fired, and
                # the node would sit out the whole wait budget for a
                # recycle that never happened. Re-fire the idempotent
                # recycle (only while the verdict still fails — recycling
                # a node that already revalidated is pointless disruption)
                # and emit the missing announcement either way.
                if verdict is not True:
                    self._remediate(node, attempts)
                self._event(node, events.NORMAL, "NodeHealthRemediating",
                            self._attempt_message(name, attempts),
                            token=f"{self._episode_for(node)}:attempt-{attempts}")
            if verdict is True:
                return self._recover(node)
            if self._state_age(node) < self.policy.remediation_wait_s:
                return REMEDIATING  # give the attempt time to produce a verdict
            if attempts >= self.policy.max_remediation_attempts:
                ds = self._driver_ds_for(node)
                # outcome record ahead of the sticky transition: a crash
                # between the two replays into the same record, and the
                # episode still closes
                self.journal.record_decision(
                    "health", "health-failed", self._episode_for(node),
                    trigger={"type": "budget", "attempts": attempts},
                    decision={"node": name, "sticky": True},
                    outcome="failed", node=name)
                if not self._set_state(node, FAILED, extra_annotations={
                        consts.HEALTH_FAILED_TEMPLATE_ANNOTATION:
                            self._template_fingerprint(ds)}):
                    return node_health_state(node)
                self._event(node, events.WARNING, "NodeHealthFailed",
                            f"{name}: {attempts} remediation attempt(s) "
                            f"exhausted; sticky failed until the driver "
                            f"template changes or the "
                            f"{consts.HEALTH_STATE_LABEL} label is cleared")
                return FAILED
            attempts += 1
            # restamp since (fresh budget) + bump attempts in one patch
            if not self._set_state(node, REMEDIATING, extra_annotations={
                    consts.HEALTH_ATTEMPTS_ANNOTATION: str(attempts)}):
                return node_health_state(node)
            self._remediate(node, attempts)
            self._event(node, events.NORMAL, "NodeHealthRemediating",
                        self._attempt_message(name, attempts),
                        token=f"{self._episode_for(node)}:attempt-{attempts}")
            return REMEDIATING

        if state == RECOVERED:
            if verdict is False:
                # relapse: straight back to degraded (flap history records
                # it via the next healthy->degraded entry... but this IS a
                # flap — record it here so recover/relapse cycles trip the
                # damper even though the label never touched healthy)
                if self._record_degraded_entry(node, RECOVERED):
                    if not self._set_state(node, QUARANTINED,
                                           extra_annotations={
                            consts.HEALTH_FLAP_STICKY_ANNOTATION:
                                self._template_fingerprint(
                                    self._driver_ds_for(node))}):
                        return node_health_state(node)
                    if self.policy.cordon_on_quarantine:
                        self._cordon(node, True)
                    self._event(node, events.WARNING, "NodeHealthFlapping",
                                f"{name}: relapse after recovery tripped "
                                f"flap damping; sticky quarantine")
                    return QUARANTINED
                if not self._set_state(node, DEGRADED):
                    return node_health_state(node)
                self._event(node, events.WARNING, "NodeHealthDegraded",
                            f"{name}: relapsed after recovery")
                return DEGRADED
            # settled: leave the machine (label cleared, flap history kept)
            self._set_state(node, HEALTHY)
            return node_health_state(node)

        # unknown label value (manual edit): treat as degraded-equivalent
        # input and let the verdict route it
        log.warning("health: node %s has unknown state %r", name, state)
        self._set_state(node, DEGRADED if verdict is False else HEALTHY)
        return node_health_state(node)

    def _recover(self, node: dict) -> str:
        name = node["metadata"]["name"]
        # closing outcome lands before the transition (write-ahead): a kill
        # between record and label write replays into the same record, and
        # an episode whose node recovered never reads as stuck-open
        self.journal.record_decision(
            "health", "health-recover", self._episode_for(node),
            trigger={"type": "verdict", "value": "passed"},
            decision={"node": name},
            outcome="recovered", node=name)
        if self.policy.cordon_on_quarantine:
            self._cordon(node, False)
        if not self._set_state(node, RECOVERED, extra_annotations={
                consts.HEALTH_ATTEMPTS_ANNOTATION: None,
                # episode over: retire the drain-protocol artifacts (the
                # plan is never cleared MID-episode — a partitioner still
                # waiting on it would otherwise wedge pending forever)
                consts.RETILE_PLAN_ANNOTATION: None,
                consts.DRAIN_ACK_ANNOTATION: None,
                consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION: None,
                consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION: None}):
            return node_health_state(node)
        self._event(node, events.NORMAL, "NodeHealthRecovered",
                    f"{name}: workload barrier passing again; restoring "
                    f"configured layout")
        return RECOVERED

    def clear_all(self, nodes: List[dict]) -> None:
        """health.enabled=false: remove our labels/annotations (but keep
        sticky-failed visible? No — disabled means disabled; an admin
        turning the machine off gets their nodes back untouched)."""
        for node in nodes:
            anns = deep_get(node, "metadata", "annotations", default={}) or {}
            has_ann = any(k in anns for k in (
                consts.HEALTH_STATE_SINCE_ANNOTATION,
                consts.HEALTH_ATTEMPTS_ANNOTATION,
                consts.HEALTH_FLAP_HISTORY_ANNOTATION,
                consts.HEALTH_FLAP_STICKY_ANNOTATION,
                consts.HEALTH_FAILED_TEMPLATE_ANNOTATION,
                consts.RETILE_PLAN_ANNOTATION,
                consts.DRAIN_ACK_ANNOTATION,
                consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION,
                consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION))
            if node_health_state(node) == HEALTHY and not has_ann:
                continue
            if self.policy.cordon_on_quarantine:
                self._cordon(node, False)
            self._set_state(node, HEALTHY, extra_annotations={
                consts.HEALTH_FLAP_HISTORY_ANNOTATION: None})
