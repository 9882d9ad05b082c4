"""The upgrade reconciler (counterpart of
tpu_operator/controllers/upgrade_controller.py; NVIDIA's
controllers/upgrade_controller.go:81-198): drives the per-node upgrade
machine from each pool's upgrade policy, publishes the upgrade gauges, and
plans a requeue every 2 minutes.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

from .. import consts, tracing
from ..api.clusterpolicy import ClusterPolicy
from ..client.batch import batch_window
from ..client.errors import NotFoundError
from ..client.interface import Client, WatchEvent
from ..nodeinfo import is_gpu_node
from ..upgrade import UpgradeStateMachine, node_upgrade_state
from ..upgrade.machine import DRIVER_COMPONENT, VALIDATOR_COMPONENT, UpgradeStateCounts
from ..utils import deep_get
from .metrics import OperatorMetrics
from .predicates import filtered_node_mapper
from .runtime import Controller, Reconciler, Request, Result

log = logging.getLogger(__name__)

#: NVIDIA's operator plans a requeue every 2 minutes (upgrade_controller.go:59,197)
PLANNED_REQUEUE = 120.0

#: lost-event safety net (watch events and the planned requeue drive the
#: machine); jittered by the runtime so replicas never LIST in lockstep
RESYNC_PERIOD_S = float(os.environ.get("GPU_OPERATOR_RESYNC_S", "300"))

#: how long a sweep waits for the read path to show its own state writes
OWN_WRITES_WAIT_S = 2.0

SINGLETON_REQUEST = Request(name="driver-upgrade")


class UpgradeReconciler(Reconciler):
    name = "upgrade"

    def __init__(self, client: Client, namespace: Optional[str] = None,
                 metrics: Optional[OperatorMetrics] = None,
                 requeue_after: float = PLANNED_REQUEUE, journal=None):
        from ..provenance import DecisionJournal

        self.client = client
        self.namespace = namespace or os.environ.get(consts.NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
        self.metrics = metrics or OperatorMetrics()
        self.requeue_after = requeue_after
        #: the shared decision journal, handed to every machine a sweep
        #: builds (a machine per pool and sweep, one journal)
        self.journal = journal or DecisionJournal()

    def _policy(self) -> Optional[ClusterPolicy]:
        policies = self.client.list("tpu.ai/v1", "ClusterPolicy")
        if not policies:
            return None
        policies.sort(key=lambda p: (p["metadata"].get("creationTimestamp", ""),
                                     p["metadata"]["name"]))
        return ClusterPolicy.from_obj(policies[0])

    def _gpu_nodes(self) -> List[dict]:
        return [n for n in self.client.list("v1", "Node") if is_gpu_node(n)]

    def _group_nodes(self, nodes: List[dict]):
        """Nodes by the upgrade policy that governs them: a node a GPUDriver
        selects follows that instance's ``spec.upgradePolicy`` (a pool's own
        blast radius), the rest the ClusterPolicy's
        ``driver.upgradePolicy``. Instances the GPUDriver controller refuses
        (an invalid spec, a selector in conflict) render nothing, so they
        govern no node here either."""
        from ..api.gpudriver import GPUDriver
        from ..state.skel import node_matches_selector
        from .gpudriver_controller import find_selector_conflicts

        instances = [GPUDriver.from_obj(d) for d in self.client.list("tpu.ai/v1alpha1",
                                                                     "GPUDriver")]
        conflicted = {name for names in find_selector_conflicts(instances, nodes).values()
                      for name in names}
        instances = [inst for inst in instances
                     if inst.name not in conflicted and not inst.spec.validate()]
        groups = [(inst.spec.upgrade_policy, []) for inst in instances]
        selectors = [inst.spec.get_node_selector() for inst in instances]
        rest: List[dict] = []
        for node in nodes:
            for (_, members), selector in zip(groups, selectors):
                if node_matches_selector(node, selector):
                    members.append(node)
                    break
            else:
                rest.append(node)
        return groups, rest

    def reconcile(self, request: Request) -> Result:
        written: dict = {}
        with batch_window(self.client):
            result = self._reconcile(request, written)
        self._await_own_writes(written)
        return result

    def _await_own_writes(self, written: dict) -> None:
        """Hold the next sweep until the read path shows this sweep's state
        writes. Behind an informer cache a sweep started at once (the
        machine's own writes wake it) reads the nodes as they were: it would
        take a node back through steps it has passed, and record their
        decisions again from stale inputs."""
        deadline = time.monotonic() + OWN_WRITES_WAIT_S
        for name, (state, since) in written.items():
            while time.monotonic() < deadline:
                try:
                    node = self.client.get("v1", "Node", name)
                except NotFoundError:
                    break
                if (node_upgrade_state(node) == state and deep_get(
                        node, "metadata", "annotations",
                        consts.UPGRADE_STATE_SINCE_ANNOTATION) == since):
                    break
                time.sleep(0.02)
            else:
                log.warning("upgrade: the cache never showed node %s at %r", name, state)
                return

    def _reconcile(self, request: Request, written: dict) -> Result:
        with tracing.phase_span("plan") as sp:
            policy = self._policy()
            nodes = self._gpu_nodes()
            sp.set_attributes(nodes=len(nodes), policy_present=policy is not None)
        if policy is None:
            # without a ClusterPolicy no driver is rendered, a GPUDriver's
            # neither: no node is governed, and every one is cleared (failed
            # ones too: their driver is gone). Cleared nodes count available
            machine = UpgradeStateMachine(self.client, self.namespace, None,
                                          journal=self.journal)
            self._publish(machine.clear_all(nodes))
            written.update(machine.written)
            return Result()

        groups, rest = self._group_nodes(nodes)
        groups.append((policy.spec.driver.upgrade_policy, rest))

        total = UpgradeStateCounts()
        any_governed = False
        retry_hints: List[float] = []
        with tracing.phase_span("process", groups=len(groups)):
            for group_policy, members in groups:
                machine = UpgradeStateMachine(self.client, self.namespace, group_policy,
                                              journal=self.journal)
                if group_policy is None or not group_policy.auto_upgrade:
                    # a frozen pool: upgrade-failed nodes keep their label and
                    # count failed (freezing must not hide a broken driver);
                    # the rest are cleared and count available
                    total = total.merged(machine.clear_all(members, preserve_failed=True))
                    written.update(machine.written)
                    continue
                any_governed = True
                total = total.merged(machine.process(members))
                written.update(machine.written)
                if machine.retry_after_hint is not None:
                    retry_hints.append(machine.retry_after_hint)

        # published on every sweep, governed or not: a deleted policy or a
        # newly frozen pool leaves no stale value
        self._publish(total)
        if not any_governed:
            return Result()
        if total.pending or total.in_progress:
            log.info("upgrade sweep: %s", total.as_dict())
        if retry_hints:
            # a budget-blocked eviction said when to come back
            return Result(requeue_after=min(self.requeue_after, max(0.5, min(retry_hints))))
        return Result(requeue_after=self.requeue_after)

    def _publish(self, total: UpgradeStateCounts) -> None:
        self.metrics.upgrades_pending.set(total.pending)
        self.metrics.upgrades_in_progress.set(total.in_progress)
        self.metrics.upgrades_done.set(total.done)
        self.metrics.upgrades_failed.set(total.failed)
        self.metrics.upgrades_available.set(total.available)


def setup_upgrade_controller(client: Client, reconciler: UpgradeReconciler) -> Controller:
    controller = Controller(reconciler)

    def singleton(_event: WatchEvent) -> List[Request]:
        return [SINGLETON_REQUEST]

    def map_pod(event: WatchEvent) -> List[Request]:
        component = deep_get(event.object, "metadata", "labels",
                             "app.kubernetes.io/component", default="")
        if component in (DRIVER_COMPONENT, VALIDATOR_COMPONENT):
            return [SINGLETON_REQUEST]
        return []

    controller.watches("tpu.ai/v1", "ClusterPolicy", singleton)
    controller.watches("tpu.ai/v1alpha1", "GPUDriver", singleton)
    # heartbeat-only node updates carry no upgrade signal
    controller.watches("v1", "Node", filtered_node_mapper(singleton))
    # only the operator's own driver and validator pods wake it (restarts,
    # validations); a user pod's drain rides the requeue and the resync, as
    # a cluster-wide pod watch is a firehose on a real apiserver
    controller.watches("v1", "Pod", map_pod, namespace=reconciler.namespace)
    controller.resyncs(lambda: [SINGLETON_REQUEST], period=RESYNC_PERIOD_S)
    return controller
