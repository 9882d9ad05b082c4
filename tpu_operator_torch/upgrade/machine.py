"""Per-node rolling driver-upgrade state machine (counterpart of
tpu_operator/upgrade/machine.py; NVIDIA's k8s-operator-libs
pkg/upgrade, states at consts.go:43-67).

Each node's progress is a node label, so the machine resumes from cluster
state alone: the operator may die at any point and the next sweep goes on
where it stopped.

    (an outdated driver pod)
    upgrade-required -> cordon-required -> wait-for-jobs-required
    -> pod-deletion-required -> drain-required -> pod-restart-required
    -> validation-required -> uncordon-required -> upgrade-done
    (a drain past its budget, a failed or crash-looping new driver or
    validator pod -> upgrade-failed)

A driver pod is outdated when it predates its DaemonSet's current pod
template: the render-stamped ``tpu.ai/template-hash`` label, which the
DaemonSet controller copies onto its pods, else a normalised essence of the
template. The pod-deletion step evicts the node's ``nvidia.com/gpu``
consumers, the drain every other pod the policy selects; both go through
the Eviction subresource, so PodDisruptionBudgets hold them back until the
step's budget runs out.

Three deliberate differences from the reference, each a fault of it:

- the upgrade lifts only its own cordon. The reference uncordons every node
  at ``uncordon-required`` and in ``clear_all``, an admin's cordon or the
  health machine's included. Here the node records, when its upgrade first
  cordons it, whether it was schedulable then
  (``tpu.ai/tpu-driver-upgrade-cordoned``); the record survives a retry out
  of ``upgrade-failed`` and goes when the node leaves the machine;
- a crash-looping pod fails the upgrade. A DaemonSet pod never reaches
  phase ``Failed`` (restartPolicy Always), so the reference waits forever on
  a broken new driver. Here a driver pod of the new template, or a recycled
  validator pod, fails the node when it is ``Failed``, or any of its
  containers waits in ``CrashLoopBackOff`` or has restarted more than
  :data:`~tpu_operator_torch.consts.UPGRADE_CRASH_LOOP_RESTARTS` times; and
  a pod that restarts in place, ready between its crashes, does not take
  the node out of ``upgrade-failed`` (a replaced pod, or a new template, does);
- the upgrade keeps its own episode id (``tpu.ai/upgrade-episode-id``). The
  reference adopts and then clears ``tpu.ai/episode-id``, which the health
  machine keeps its live episode in, closing that episode as ``done``.
"""

from __future__ import annotations

import calendar
import dataclasses
import json
import logging
import time
from typing import Dict, List, Optional

from .. import consts, events
from ..api.common import UpgradePolicySpec
from ..client.batch import coalesced_patch
from ..client.errors import ApiError, NotFoundError, TooManyRequestsError
from ..client.interface import Client
from ..provenance import DecisionJournal, episode_id
from ..state.skel import is_pod_ready, node_matches_selector
from ..utils import deep_get, pod_requests_resource, template_fingerprint

log = logging.getLogger(__name__)

# states (reference upgrade/consts.go:43-67)
UNKNOWN = ""
UPGRADE_REQUIRED = "upgrade-required"
CORDON_REQUIRED = "cordon-required"
WAIT_FOR_JOBS_REQUIRED = "wait-for-jobs-required"
POD_DELETION_REQUIRED = "pod-deletion-required"
DRAIN_REQUIRED = "drain-required"
POD_RESTART_REQUIRED = "pod-restart-required"
VALIDATION_REQUIRED = "validation-required"
UNCORDON_REQUIRED = "uncordon-required"
DONE = "upgrade-done"
FAILED = "upgrade-failed"

STATES = (UPGRADE_REQUIRED, CORDON_REQUIRED, WAIT_FOR_JOBS_REQUIRED,
          POD_DELETION_REQUIRED, DRAIN_REQUIRED, POD_RESTART_REQUIRED,
          VALIDATION_REQUIRED, UNCORDON_REQUIRED, DONE, FAILED)

IN_PROGRESS_STATES = (CORDON_REQUIRED, WAIT_FOR_JOBS_REQUIRED,
                      POD_DELETION_REQUIRED, DRAIN_REQUIRED,
                      POD_RESTART_REQUIRED, VALIDATION_REQUIRED,
                      UNCORDON_REQUIRED)

#: component labels of the pods the upgrade restarts and recycles
#: (manifests/state-driver, manifests/state-operator-validation)
DRIVER_COMPONENT = "gpu-driver"
VALIDATOR_COMPONENT = "gpu-operator-validator"

#: the operand components every eviction sweep exempts (one set, in consts)
OPERAND_COMPONENTS = consts.OPERAND_COMPONENTS


def node_upgrade_state(node: dict) -> str:
    return deep_get(node, "metadata", "labels", consts.UPGRADE_STATE_LABEL, default=UNKNOWN)


def crash_looping(pod: dict) -> bool:
    """Whether a pod has failed for the upgrade's purposes: phase ``Failed``,
    or an init or main container waiting in ``CrashLoopBackOff`` or
    restarted more than ``UPGRADE_CRASH_LOOP_RESTARTS`` times."""
    if deep_get(pod, "status", "phase") == "Failed":
        return True
    for key in ("initContainerStatuses", "containerStatuses"):
        for status in deep_get(pod, "status", key, default=[]) or []:
            if deep_get(status, "state", "waiting", "reason") == "CrashLoopBackOff":
                return True
            if int(status.get("restartCount") or 0) > consts.UPGRADE_CRASH_LOOP_RESTARTS:
                return True
    return False


def restarted(pod: dict) -> bool:
    """Whether any container of the pod has restarted in place."""
    return any(int(status.get("restartCount") or 0) > 0
               for key in ("initContainerStatuses", "containerStatuses")
               for status in deep_get(pod, "status", key, default=[]) or [])


@dataclasses.dataclass
class UpgradeStateCounts:
    pending: int = 0
    in_progress: int = 0
    done: int = 0
    failed: int = 0
    available: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    def merged(self, other: "UpgradeStateCounts") -> "UpgradeStateCounts":
        return UpgradeStateCounts(**{
            field.name: getattr(self, field.name) + getattr(other, field.name)
            for field in dataclasses.fields(self)})


class UpgradeStateMachine:
    def __init__(self, client: Client, namespace: str,
                 policy: Optional[UpgradePolicySpec] = None,
                 now=time.time, journal=None):
        self.client = client
        self.namespace = namespace
        self.policy = policy or UpgradePolicySpec()
        self._now = now  # injectable clock for the budget tests
        #: the decision journal: the upgrade's first cordon, every forced
        #: drain and the done and failed outcomes record what licensed them
        self.journal = journal or DecisionJournal()
        #: the smallest ``Retry-After`` a budget-blocked eviction answered
        #: this sweep: the controller comes back after it, not the full period
        self.retry_after_hint: Optional[float] = None
        #: node -> (state, since stamp) this machine wrote last: the
        #: controller waits for its cache to show them before the next sweep
        self.written: Dict[str, tuple] = {}

    # -- cluster inspection ---------------------------------------------------
    def _pods_on(self, node_name: str, component: Optional[str] = None,
                 all_namespaces: bool = False) -> List[dict]:
        """Pods on the node. A component names the operator's own operand
        pods (its namespace); the drain's sweeps are cluster-wide, as
        ``kubectl drain`` is: user workloads live in any namespace."""
        label_selector = {"app.kubernetes.io/component": component} if component else None
        return self.client.list("v1", "Pod",
                                None if all_namespaces else self.namespace,
                                label_selector=label_selector,
                                field_selector={"spec.nodeName": node_name})

    def _driver_ds_for(self, node: dict) -> Optional[dict]:
        for ds in self.client.list("apps/v1", "DaemonSet", self.namespace):
            component = deep_get(ds, "spec", "template", "metadata", "labels",
                                 "app.kubernetes.io/component")
            if component != DRIVER_COMPONENT:
                continue
            selector = deep_get(ds, "spec", "template", "spec", "nodeSelector", default={})
            if node_matches_selector(node, selector):
                return ds
        return None

    @staticmethod
    def _template_essence(spec: dict) -> dict:
        """What the template governs of a pod spec, for the fallback
        comparison: image, command, args and env of each container and init
        container, as an order-free multiset. Container names, volumes and
        every field admission or the control plane rewrites are left out:
        they would read as drift that never settles."""
        def containers(kind):
            return sorted(json.dumps(
                {"image": c.get("image"), "command": c.get("command"),
                 "args": c.get("args"), "env": c.get("env")},
                sort_keys=True, default=str)
                for c in spec.get(kind) or [])

        return {"containers": containers("containers"),
                "initContainers": containers("initContainers")}

    @classmethod
    def _pod_outdated(cls, pod: dict, ds: dict) -> bool:
        """Whether the pod predates the DaemonSet's current pod template.
        The render stamps the whole template's fingerprint as a template
        label, which the DaemonSet controller copies onto its pods: the pod's
        label against the template's is exact (env, init containers,
        volumes), where ``metadata.generation`` would also move on edits that
        roll nothing. A pod without the label under a stamped template
        predates the stamp. Unstamped templates fall back to the essence."""
        want_hash = deep_get(ds, "spec", "template", "metadata", "labels",
                             consts.TEMPLATE_HASH_LABEL)
        if want_hash:
            return deep_get(pod, "metadata", "labels",
                            consts.TEMPLATE_HASH_LABEL) != want_hash
        want = deep_get(ds, "spec", "template", "spec", default={})
        have = deep_get(pod, "spec", default={})
        if not want.get("containers") or not have.get("containers"):
            return False
        return cls._template_essence(want) != cls._template_essence(have)

    # -- node operations ------------------------------------------------------
    def _set_state(self, node: dict, state: str,
                   extra_annotations: Optional[Dict[str, Optional[str]]] = None
                   ) -> None:
        name = node["metadata"]["name"]
        log.info("upgrade: node %s -> %s", name, state or "<clear>")
        since = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                              time.gmtime(self._now())) if state else None
        ann_patch: Dict[str, Optional[str]] = {
            consts.UPGRADE_STATE_SINCE_ANNOTATION: since}
        if not state:
            # leaving the machine: its bookkeeping goes with it, the
            # episode too (the next template drift opens a new one)
            for key in (consts.UPGRADE_FAILED_TEMPLATE_ANNOTATION,
                        consts.UPGRADE_REVALIDATED_ANNOTATION,
                        consts.UPGRADE_CORDONED_ANNOTATION,
                        consts.UPGRADE_EPISODE_ANNOTATION):
                ann_patch[key] = None
        ann_patch.update(extra_annotations or {})
        coalesced_patch(self.client, "v1", "Node", name, {"metadata": {
            "labels": {consts.UPGRADE_STATE_LABEL: state or None},
            "annotations": ann_patch,
        }})
        self.written[name] = (state, since)
        meta = node.setdefault("metadata", {})
        meta.setdefault("labels", {})[consts.UPGRADE_STATE_LABEL] = state
        anns = meta.setdefault("annotations", {})
        for key, value in ann_patch.items():
            if value is None:
                anns.pop(key, None)
            else:
                anns[key] = value

    @staticmethod
    def _template_fingerprint(ds: Optional[dict]) -> str:
        """The fingerprint of the DaemonSet's whole pod template (the
        render's stamp when there is one, the value ``_pod_outdated``
        compares): a failed upgrade is retried, and validators recycled,
        once per template. Edits to the DaemonSet object alone leave it."""
        tpl = deep_get(ds or {}, "spec", "template", default={})
        return deep_get(tpl, "metadata", "labels",
                        consts.TEMPLATE_HASH_LABEL) or template_fingerprint(tpl)

    def _episode_for(self, node: dict, ds: Optional[dict]) -> str:
        """The node's upgrade episode: the one stamped in the upgrade's own
        annotation, or one minted from the node and the template the upgrade
        rolls to (content-derived, so a crash replays into it) and stamped.
        The health machine's ``tpu.ai/episode-id`` is never read or written."""
        eid = deep_get(node, "metadata", "annotations", consts.UPGRADE_EPISODE_ANNOTATION)
        if eid:
            return eid
        eid = episode_id("upgrade", node["metadata"]["name"], self._template_fingerprint(ds))
        try:
            self._annotate(node, consts.UPGRADE_EPISODE_ANNOTATION, eid)
        except ApiError:
            pass  # the stamp is best-effort; the journal chains on eid
        return eid

    def _mark_failed(self, node: dict, ds: Optional[dict]) -> None:
        """``upgrade-failed`` with the failing template's fingerprint, in one
        patch: the node is retried only once the template changes, so a
        failure stays visible instead of looping cordon, evict, fail."""
        # the outcome lands before the transition (a crash between the two
        # replays into the same record)
        self.journal.record_decision(
            "upgrade", "upgrade-failed", self._episode_for(node, ds),
            trigger={"type": "budget", "template": self._template_fingerprint(ds)},
            decision={"node": node["metadata"]["name"], "sticky": True},
            outcome="failed", node=node["metadata"]["name"])
        self._set_state(node, FAILED, extra_annotations={
            consts.UPGRADE_FAILED_TEMPLATE_ANNOTATION: self._template_fingerprint(ds)})

    def _warn(self, node: dict, ds: Optional[dict], reason: str, message: str,
              step: str = "") -> None:
        """A Warning Event, once per episode, template and step: a sweep
        that reads the node from a lagging cache and takes the same edge
        again announces nothing twice."""
        events.record_once(self.client, self.namespace, node, events.WARNING, reason, message,
                           token=f"{self._episode_for(node, ds)}:"
                                 f"{self._template_fingerprint(ds)}:{step}")

    def _driver_failed(self, node: dict, ds: Optional[dict], what: str) -> str:
        """A driver or validator pod of the new template failed: the Event,
        then ``upgrade-failed``."""
        self._warn(node, ds, "DriverUpgradeFailed",
                   f"{what} failed or crash-looping during upgrade on {node['metadata']['name']}")
        self._mark_failed(node, ds)
        return FAILED

    def _state_age(self, node: dict) -> float:
        """Seconds the node has been in its state, across operator restarts.
        A missing or unreadable stamp starts the clock now: a fresh budget
        beats an instant escalation."""
        raw = deep_get(node, "metadata", "annotations", consts.UPGRADE_STATE_SINCE_ANNOTATION)
        if raw:
            try:
                since = calendar.timegm(time.strptime(raw, "%Y-%m-%dT%H:%M:%SZ"))
                return max(0.0, self._now() - since)
            except ValueError:
                pass
        self._set_state(node, node_upgrade_state(node))  # stamp now
        return 0.0

    def _cordon(self, node: dict, unschedulable: bool) -> None:
        # coalesced: an eviction flushes the batch first, so the cordon is
        # on the apiserver before any eviction it gates
        coalesced_patch(self.client, "v1", "Node", node["metadata"]["name"],
                        {"spec": {"unschedulable": unschedulable or None}})

    def _drain_exempt(self, pod: dict) -> bool:
        return consts.drain_exempt(pod, self.namespace)

    @staticmethod
    def _requests_gpu(pod: dict) -> bool:
        """A GPU request in any container, init containers included."""
        return pod_requests_resource(pod, consts.GPU_RESOURCE_NAME)

    def _gpu_consumer_pods(self, node_name: str) -> List[dict]:
        """The node's pods that hold GPUs and must go before the driver
        restarts. Finished pods hold none; a pod with no phase counts as live."""
        return [pod for pod in self._pods_on(node_name, all_namespaces=True)
                if not self._drain_exempt(pod)
                and deep_get(pod, "status", "phase") not in ("Succeeded", "Failed")
                and self._requests_gpu(pod)]

    def _delete_pod(self, pod: dict) -> None:
        try:
            self.client.delete("v1", "Pod", pod["metadata"]["name"],
                               pod["metadata"].get("namespace"))
        except NotFoundError:
            pass

    def _evict_pod(self, pod: dict) -> bool:
        """Evict through the Eviction subresource. True when accepted (or the
        pod is gone already), False when a disruption budget refused it."""
        try:
            self.client.evict(pod["metadata"]["name"], pod["metadata"].get("namespace"))
            return True
        except TooManyRequestsError as e:
            retry_after = getattr(e, "retry_after", None)
            if retry_after is not None and (self.retry_after_hint is None
                                            or retry_after < self.retry_after_hint):
                self.retry_after_hint = retry_after
            return False
        except NotFoundError:
            return True

    @staticmethod
    def _uses_empty_dir(pod: dict) -> bool:
        return any("emptyDir" in v for v in deep_get(pod, "spec", "volumes", default=[]) or [])

    def _present_of(self, candidates: List[dict]) -> set:
        """(name, namespace) of the candidates the apiserver still has: one
        LIST per namespace, not one GET per pod."""
        present = set()
        for ns in {p["metadata"].get("namespace") for p in candidates}:
            for live in self.client.list("v1", "Pod", ns):
                present.add((live["metadata"]["name"], ns))
        return present

    def _annotate(self, node: dict, key: str, value: Optional[str]) -> None:
        """An idempotent annotation write, mirrored into the snapshot."""
        if deep_get(node, "metadata", "annotations", key) == value:
            return
        coalesced_patch(self.client, "v1", "Node", node["metadata"]["name"],
                        {"metadata": {"annotations": {key: value}}})
        annotations = node.setdefault("metadata", {}).setdefault("annotations", {})
        if value is None:
            annotations.pop(key, None)
        else:
            annotations[key] = value

    def _evict_with_budget(self, node: dict, pods: List[dict], *,
                           timeout_s: int, force: bool,
                           delete_empty_dir: bool, what: str,
                           ds: Optional[dict] = None) -> Optional[str]:
        """The drain's core (the reference's drain manager around kubectl's
        eviction helper): evict every target; once the budget has run out,
        force-delete where allowed, else fail the node. Returns None when
        every target is gone or forced (advance), ``"wait"`` to retry next
        sweep, or ``FAILED``.

        An accepted eviction whose pod never finishes terminating (a stuck
        finalizer, a dead kubelet) counts against the budget too: past it
        the pod is force-deleted where ``force`` allows, and past twice the
        budget, force tried and the pod still there, the node fails."""
        name = node["metadata"]["name"]
        blocked_empty = [p for p in pods if self._uses_empty_dir(p) and not delete_empty_dir]
        candidates = [p for p in pods if p not in blocked_empty]
        pdb_blocked = [p for p in candidates if not self._evict_pod(p)]
        # an accepted eviction is not a gone pod: those still listed are
        # terminating and use the budget
        present = self._present_of(candidates) if candidates else set()
        terminating = [p for p in candidates if p not in pdb_blocked
                       and (p["metadata"]["name"], p["metadata"].get("namespace")) in present]
        if not blocked_empty and not pdb_blocked and not terminating:
            self._annotate(node, consts.UPGRADE_FORCE_ATTEMPTED_ANNOTATION, None)
            return None
        if timeout_s > 0 and self._state_age(node) > timeout_s:
            if blocked_empty:
                # force never means data loss: emptyDir pods need
                # deleteEmptyDir (kubectl drain --delete-emptydir-data)
                self._warn(node, ds, "UpgradeDrainFailed",
                           f"{what} on {name}: pods with emptyDir data "
                           f"block the drain and deleteEmptyDir=false")
                self._mark_failed(node, ds)
                return FAILED
            if force:
                force_attempted = deep_get(node, "metadata", "annotations",
                                           consts.UPGRADE_FORCE_ATTEMPTED_ANNOTATION) == what
                if terminating and force_attempted and self._state_age(node) > 2 * timeout_s:
                    # force was tried (the annotation says so, not the
                    # age: the operator may have been down past the budget)
                    # and the pod is still there: fail rather than repeat
                    self._warn(node, ds, "UpgradeDrainFailed",
                               f"{what} on {name}: {len(terminating)} pod(s) "
                               f"still terminating {2 * timeout_s}s after drain "
                               f"began despite force-delete")
                    self._mark_failed(node, ds)
                    return FAILED
                # the escalation is a decision of its own, recorded with the
                # pods it deletes before the deletes land
                self.journal.record_decision(
                    "upgrade", "drain-force", self._episode_for(node, ds),
                    trigger={"type": "deadline", "what": what},
                    inputs={"timeout_s": timeout_s, "pdb_blocked": len(pdb_blocked),
                            "terminating": len(terminating)},
                    decision={"forced": True, "node": name, "what": what},
                    alternatives=[{"option": "keep-evicting",
                                   "rejected": "budget expired with force=true"}],
                    actuations=[{"verb": "delete", "kind": "Pod",
                                 "name": p["metadata"]["name"]}
                                for p in pdb_blocked + terminating],
                    node=name)
                for pod in pdb_blocked + terminating:
                    self._delete_pod(pod)
                self._annotate(node, consts.UPGRADE_FORCE_ATTEMPTED_ANNOTATION, what)
                self._warn(node, ds, "UpgradeDrainForced",
                           f"{what} on {name}: "
                           f"{len(pdb_blocked) + len(terminating)} pod(s) "
                           f"force-deleted after {timeout_s}s budget "
                           f"(PDB overridden / termination stuck)", step=what)
                return None
            self._warn(node, ds, "UpgradeDrainFailed",
                       f"{what} on {name}: "
                       f"{len(pdb_blocked) + len(terminating)} pod(s) "
                       f"still present (PDB-blocked or stuck "
                       f"terminating) after {timeout_s}s and force=false")
            self._mark_failed(node, ds)
            return FAILED
        return "wait"

    # -- the sweep ------------------------------------------------------------
    def _resolve_max_unavailable(self, total: int) -> int:
        """The ceiling of unavailable nodes: a number, or a percentage
        rounded up as the reference's GetScaledValueFromIntOrPercent does;
        unset means none."""
        raw = self.policy.max_unavailable
        if not raw:
            return total
        raw = str(raw)
        if raw.endswith("%"):
            return -(-total * int(raw[:-1]) // 100)
        return int(raw)

    @staticmethod
    def _node_unavailable(node: dict) -> bool:
        """Cordoned or not Ready (the reference's GetCurrentUnavailableNodes):
        a node down for any reason uses the availability budget. No
        conditions read as Ready."""
        if deep_get(node, "spec", "unschedulable"):
            return True
        for cond in deep_get(node, "status", "conditions", default=[]) or []:
            if cond.get("type") == "Ready":
                return cond.get("status") != "True"
        return False

    def process(self, nodes: List[dict]) -> UpgradeStateCounts:
        counts = UpgradeStateCounts()
        in_progress = sum(1 for n in nodes if node_upgrade_state(n) in IN_PROGRESS_STATES)
        max_parallel = self.policy.max_parallel_upgrades or len(nodes)
        max_unavailable = self._resolve_max_unavailable(len(nodes))
        unavailable = sum(1 for n in nodes if self._node_unavailable(n))

        for node in nodes:
            before = node_upgrade_state(node)
            was_unavailable = self._node_unavailable(node)
            try:
                state = self._process_node(node, in_progress, max_parallel,
                                           unavailable, max_unavailable)
            except ApiError as e:
                log.warning("upgrade: node %s sweep error: %s", node["metadata"]["name"], e)
                state = before
            if state == UPGRADE_REQUIRED:
                counts.pending += 1
            elif state in IN_PROGRESS_STATES:
                counts.in_progress += 1
            elif state == DONE:
                counts.done += 1
            elif state == FAILED:
                counts.failed += 1
            else:
                counts.available += 1
            if state in IN_PROGRESS_STATES and before not in IN_PROGRESS_STATES:
                in_progress += 1
                if not was_unavailable:
                    # the upgrade's cordon made it unavailable; a node that
                    # already was is in the sum already
                    unavailable += 1
        return counts

    def _process_node(self, node: dict, in_progress: int, max_parallel: int,
                      unavailable: int = 0,
                      max_unavailable: Optional[int] = None) -> str:
        name = node["metadata"]["name"]
        state = node_upgrade_state(node)
        ds = self._driver_ds_for(node)
        driver_pods = self._pods_on(name, DRIVER_COMPONENT)

        if state in (UNKNOWN, DONE):
            if ds and any(self._pod_outdated(p, ds) for p in driver_pods):
                self._set_state(node, UPGRADE_REQUIRED)
                return UPGRADE_REQUIRED
            if state == DONE:
                self._set_state(node, UNKNOWN)  # settled: the node reads available
            return UNKNOWN

        if state == FAILED:
            # the ways out of upgrade-failed without label surgery: the
            # template rolled again (retry from the top), or the node's
            # driver pods match the template and are ready (validate, then
            # uncordon through the normal chain)
            recorded = deep_get(node, "metadata", "annotations",
                                consts.UPGRADE_FAILED_TEMPLATE_ANNOTATION)
            template_changed = recorded is None or recorded != self._template_fingerprint(ds)
            if ds and driver_pods and template_changed \
                    and any(self._pod_outdated(p, ds) for p in driver_pods):
                self._set_state(node, UPGRADE_REQUIRED)
                state = UPGRADE_REQUIRED  # the throttle applies below
            elif driver_pods and not any(crash_looping(p) or restarted(p) for p in driver_pods) \
                    and not (ds and any(self._pod_outdated(p, ds) for p in driver_pods)):
                # current and healthy pods; outdated ready pods are what the
                # upgrade was to replace, and a pod restarting in place
                # between its crashes is the failure still: no recovery
                if all(is_pod_ready(p) for p in driver_pods):
                    # the recovery's validation must really run again
                    self._annotate(node, consts.UPGRADE_REVALIDATED_ANNOTATION, None)
                    self._set_state(node, VALIDATION_REQUIRED)
                    state = VALIDATION_REQUIRED
                else:
                    return FAILED
            else:
                return FAILED

        if state == UPGRADE_REQUIRED:
            if in_progress >= max_parallel:
                return state  # maxParallelUpgrades
            if (max_unavailable is not None and unavailable >= max_unavailable
                    and not self._node_unavailable(node)):
                # the availability floor: no new cordon while the pool is at
                # its ceiling of unavailable nodes, whatever made them so. A
                # node that is unavailable already may go on: its upgrade
                # costs no availability (and a not-Ready node may be wedged
                # by the very driver the upgrade replaces)
                return state
            # the episode's root decision, recorded before the cordon it
            # licenses
            self.journal.record_decision(
                "upgrade", "upgrade", self._episode_for(node, ds),
                trigger={"type": "template-drift",
                         "template": self._template_fingerprint(ds)},
                inputs={"max_parallel": max_parallel, "max_unavailable": max_unavailable},
                decision={"node": name, "template": self._template_fingerprint(ds)},
                alternatives=[{"option": "hold",
                               "rejected": "parallelism and availability "
                                           "budgets permit the upgrade"}],
                actuations=[{"verb": "cordon", "kind": "Node", "name": name}],
                node=name)
            # whose cordon this is, written once per stay in the machine (a
            # retry out of upgrade-failed finds it and keeps it)
            if deep_get(node, "metadata", "annotations",
                        consts.UPGRADE_CORDONED_ANNOTATION) is None:
                self._annotate(node, consts.UPGRADE_CORDONED_ANNOTATION,
                               "false" if deep_get(node, "spec", "unschedulable") else "true")
            self._cordon(node, True)
            # a fresh attempt: an older attempt's marker must not spare
            # this one its validator recycle
            self._annotate(node, consts.UPGRADE_REVALIDATED_ANNOTATION, None)
            self._set_state(node, CORDON_REQUIRED)
            state = CORDON_REQUIRED  # on through the chain in one sweep

        if state == CORDON_REQUIRED:
            self._cordon(node, True)  # idempotent
            self._set_state(node, WAIT_FOR_JOBS_REQUIRED)
            state = WAIT_FOR_JOBS_REQUIRED

        if state == WAIT_FOR_JOBS_REQUIRED:
            wait_spec = self.policy.wait_for_completion
            if wait_spec.pod_selector:
                key, _, value = wait_spec.pod_selector.partition("=")
                waiting = [p for p in self._pods_on(name, all_namespaces=True)
                           if deep_get(p, "metadata", "labels", key) == (value or None)
                           and deep_get(p, "status", "phase") in ("Running", "Pending")]
                if waiting:
                    # a stuck job must not hold the upgrade forever:
                    # waitForCompletion.timeoutSeconds moves past it (0 waits)
                    if (wait_spec.timeout_seconds > 0
                            and self._state_age(node) > wait_spec.timeout_seconds):
                        self._warn(node, ds, "UpgradeWaitForJobsTimeout",
                                   f"{len(waiting)} job pod(s) on {name} still "
                                   f"running after waitForCompletion budget of "
                                   f"{wait_spec.timeout_seconds}s; proceeding")
                    else:
                        return state
            self._set_state(node, POD_DELETION_REQUIRED)
            state = POD_DELETION_REQUIRED

        if state == POD_DELETION_REQUIRED:
            pd = self.policy.pod_deletion
            outcome = self._evict_with_budget(
                node, self._gpu_consumer_pods(name),
                timeout_s=pd.timeout_seconds, force=pd.force,
                delete_empty_dir=pd.delete_empty_dir,
                what="GPU-consumer pod deletion", ds=ds)
            if outcome == FAILED:
                return FAILED
            if outcome == "wait" or self._gpu_consumer_pods(name):
                return state  # evictions pending
            self._set_state(node, DRAIN_REQUIRED)
            state = DRAIN_REQUIRED

        if state == DRAIN_REQUIRED:
            skip = deep_get(node, "metadata", "labels",
                            consts.UPGRADE_SKIP_DRAIN_LABEL) == "true"
            drain = self.policy.drain
            if drain.enable and not skip:
                def drain_targets() -> List[dict]:
                    sel_key, _, sel_value = drain.pod_selector.partition("=")
                    return [pod for pod in self._pods_on(name, all_namespaces=True)
                            if not self._drain_exempt(pod)
                            and not (sel_key and deep_get(pod, "metadata", "labels", sel_key)
                                     != (sel_value or None))]

                outcome = self._evict_with_budget(
                    node, drain_targets(), timeout_s=drain.timeout_seconds,
                    force=drain.force, delete_empty_dir=drain.delete_empty_dir,
                    what="node drain", ds=ds)
                if outcome == FAILED:
                    return FAILED
                # accepted is not gone: the driver does not restart under
                # workloads still running out their grace period
                if outcome == "wait" or drain_targets():
                    return state
            self._set_state(node, POD_RESTART_REQUIRED)
            state = POD_RESTART_REQUIRED

        if state == POD_RESTART_REQUIRED:
            outdated = [p for p in self._pods_on(name, DRIVER_COMPONENT)
                        if ds and self._pod_outdated(p, ds)]
            for pod in outdated:
                self._delete_pod(pod)
            if outdated:
                return state  # the DaemonSet controller restarts them
            fresh = self._pods_on(name, DRIVER_COMPONENT)
            if not fresh:
                return state
            if any(crash_looping(p) for p in fresh):
                return self._driver_failed(node, ds, "driver pod")
            if not all(is_pod_ready(p) for p in fresh):
                return state
            self._set_state(node, VALIDATION_REQUIRED)
            state = VALIDATION_REQUIRED

        if state == VALIDATION_REQUIRED:
            if any(crash_looping(p) for p in self._pods_on(name, DRIVER_COMPONENT)):
                # the new driver failed after it was first ready
                return self._driver_failed(node, ds, "driver pod")
            # the validator pods certify the old driver: recycle them once
            # per template (the annotation is the crash-safe marker) so the
            # validation runs again against the new one
            fingerprint = self._template_fingerprint(ds)
            recycled_for = deep_get(node, "metadata", "annotations",
                                    consts.UPGRADE_REVALIDATED_ANNOTATION)
            if recycled_for != fingerprint:
                for pod in self._pods_on(name, VALIDATOR_COMPONENT):
                    self._delete_pod(pod)
                self._annotate(node, consts.UPGRADE_REVALIDATED_ANNOTATION, fingerprint)
                return state
            # a deleted pod stays listed while it terminates, Ready: only
            # pods not being deleted may certify
            validators = [p for p in self._pods_on(name, VALIDATOR_COMPONENT)
                          if not deep_get(p, "metadata", "deletionTimestamp")]
            if any(crash_looping(p) for p in validators):
                return self._driver_failed(node, ds, "validator pod")
            if not validators or not all(is_pod_ready(p) for p in validators):
                return state
            self._set_state(node, UNCORDON_REQUIRED)
            state = UNCORDON_REQUIRED

        if state == UNCORDON_REQUIRED:
            ours = deep_get(node, "metadata", "annotations",
                            consts.UPGRADE_CORDONED_ANNOTATION) == "true"
            self.journal.record_decision(
                "upgrade", "upgrade-done", self._episode_for(node, ds),
                trigger={"type": "validation", "template": self._template_fingerprint(ds)},
                decision={"node": name, "uncordon": ours},
                actuations=[{"verb": "uncordon", "kind": "Node", "name": name}] if ours else [],
                outcome="done", node=name)
            if ours:
                self._cordon(node, False)
            # the cordon's record is spent: a later upgrade of this node
            # records anew
            self._set_state(node, DONE, extra_annotations={
                consts.UPGRADE_CORDONED_ANNOTATION: None})
            return DONE

        return state

    def clear_all(self, nodes: List[dict], preserve_failed: bool = False) -> UpgradeStateCounts:
        """Take every node out of the machine (autoUpgrade off; the
        reference's removeNodeUpgradeStateLabels), lifting only the
        upgrade's own cordons.

        With ``preserve_failed`` (a frozen pool), an ``upgrade-failed`` node
        keeps its label and cordon: freezing a pool must not make a broken
        driver look available. Returns the counts of what the pass did: the
        kept nodes as ``failed``, the rest as ``available``."""
        counts = UpgradeStateCounts()
        for node in nodes:
            state = node_upgrade_state(node)
            if preserve_failed and state == FAILED:
                counts.failed += 1
                continue
            counts.available += 1
            if state == UNKNOWN:
                continue
            if deep_get(node, "metadata", "annotations",
                        consts.UPGRADE_CORDONED_ANNOTATION) == "true":
                self._cordon(node, False)
            self._set_state(node, UNKNOWN)
        return counts
