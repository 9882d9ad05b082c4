"""Multi-node validation: one NCCL rendezvous across every node of a slice
(counterpart of tpu_operator/state/multihost.py; NVIDIA's operator
validates strictly per node).

For every group of schedulable GPU nodes sharing ``tpu.ai/slice.id``:

1. render a headless Service (stable DNS for the rendezvous) and one
   validator pod per node, pinned by nodeName, each running
   ``gpu-validator -c workload-multihost`` with the ``torch.distributed``
   env: ``MASTER_ADDR`` (worker 0's pod DNS name), ``MASTER_PORT``,
   ``WORLD_SIZE`` and ``RANK`` (the worker's index in name order), and
   ``GPU_INIT_TIMEOUT``;
2. wait for every pod to Succeed (the sweep and its NCCL collectives
   passed on every GPU of the slice), then stamp each node with an annotation keyed on the slice
   config hash and tear the pods down;
3. a changed slice membership or driver version invalidates the stamp and
   re-runs validation.

Failure containment: any Failed pod marks the sweep failed for that slice
(state NotReady) and pods are torn down for a clean retry next sweep.
"""

from __future__ import annotations

import calendar
import logging
import os
import time
from typing import Dict, List

from .. import consts, events
from ..api.clusterpolicy import ClusterPolicy
from ..client.batch import coalesced_patch
from ..client.errors import NotFoundError
from ..client.interface import Client
from ..utils import deep_get, object_hash
from .manager import (
    INFO_CLUSTER_POLICY,
    INFO_NAMESPACE,
    INFO_NODES,
    InfoCatalog,
    StateResult,
)
from .skel import StateSkel, SyncState

log = logging.getLogger(__name__)

APP_LABEL = "gpu-multihost-validation"
COORDINATOR_PORT = consts.MASTER_PORT


def slice_groups(nodes: List[dict],
                 resource: str = consts.GPU_RESOURCE_NAME) -> Dict[str, List[dict]]:
    """Group schedulable GPU nodes by slice id; sorted stable worker order."""
    groups: Dict[str, List[dict]] = {}
    for node in nodes:
        labels = deep_get(node, "metadata", "labels", default={}) or {}
        slice_id = labels.get(consts.TPU_SLICE_ID_LABEL)
        if not slice_id:
            continue
        if not deep_get(node, "status", "capacity", resource):
            continue  # not schedulable yet; validated once the plugin is up
        groups.setdefault(slice_id, []).append(node)
    for members in groups.values():
        members.sort(key=lambda n: n["metadata"]["name"])
    return {sid: m for sid, m in groups.items() if len(m) >= 2}


#: wall-clock budget for every worker pod of an attempt to reach
#: Running/Succeeded, measured from pod creation. GPU_INIT_TIMEOUT bounds a
#: RUNNING worker's rendezvous; this bounds the step before it — a pod stuck
#: Pending (node died after the capacity check, taint race, quota) would
#: otherwise hold the sweep NotReady until slice membership happens to
#: change the config hash. Reference wait-budget semantics:
#: validator/main.go:1180-1197 (60 x 5 s, then fail).
SCHEDULING_BUDGET_S = float(os.environ.get(
    "GPU_MULTIHOST_SCHEDULING_BUDGET", "300"))


class MultihostValidationState:
    name = "state-multihost-validation"

    def __init__(self, client: Client,
                 scheduling_budget_s: float = SCHEDULING_BUDGET_S,
                 now=time.time):
        self.client = client
        self.skel = StateSkel(self.name, client)
        self.scheduling_budget_s = scheduling_budget_s
        self._now = now  # injectable clock for budget tests

    # -- manifest builders ----------------------------------------------------
    def _service(self, slice_id: str, namespace: str) -> dict:
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": self._svc_name(slice_id), "namespace": namespace,
                         "labels": {"app": APP_LABEL, consts.MULTIHOST_SLICE_LABEL: slice_id}},
            "spec": {
                "clusterIP": "None",  # headless: per-pod DNS for rendezvous
                "selector": {"app": APP_LABEL, consts.MULTIHOST_SLICE_LABEL: slice_id},
                "ports": [{"name": "coordinator", "port": COORDINATOR_PORT}],
            },
        }

    @staticmethod
    def _svc_name(slice_id: str) -> str:
        return f"gpu-mh-validation-{slice_id}"[:63].rstrip("-")

    def _pod_name(self, slice_id: str, worker: int) -> str:
        return f"gpu-mh-validation-{slice_id}-{worker}"[:63].rstrip("-")

    def _pod(self, slice_id: str, worker: int, node: dict, n: int,
             namespace: str, image: str, config_hash: str,
             resource: str = consts.GPU_RESOURCE_NAME) -> dict:
        master = (f"{self._pod_name(slice_id, 0)}."
                  f"{self._svc_name(slice_id)}.{namespace}.svc")
        gpus = deep_get(node, "status", "capacity", resource, default="1")
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": self._pod_name(slice_id, worker),
                "namespace": namespace,
                "labels": {"app": APP_LABEL, consts.MULTIHOST_SLICE_LABEL: slice_id,
                           consts.MULTIHOST_WORKER_ID_LABEL: str(worker)},
                "annotations": {consts.MULTIHOST_CONFIG_HASH_ANNOTATION: config_hash},
            },
            "spec": {
                "restartPolicy": "Never",
                "nodeName": node["metadata"]["name"],
                "hostname": self._pod_name(slice_id, worker),
                "subdomain": self._svc_name(slice_id),
                "tolerations": [{"key": resource,
                                 "operator": "Exists", "effect": "NoSchedule"}],
                "containers": [{
                    "name": "workload",
                    "image": image,
                    "command": ["gpu-validator"],
                    "args": ["-c", "workload-multihost"],
                    "env": [
                        # the torch.distributed rendezvous the port's
                        # workload-multihost reads: rank 0's pod is the store
                        {"name": "MASTER_ADDR", "value": master},
                        {"name": "MASTER_PORT", "value": str(COORDINATOR_PORT)},
                        # bound the rendezvous: a worker pod that never
                        # starts (node died mid-join) must fail the sweep
                        # closed, not hang it until pod GC
                        {"name": "GPU_INIT_TIMEOUT", "value": "600"},
                        {"name": "WORLD_SIZE", "value": str(n)},
                        {"name": "RANK", "value": str(worker)},
                        {"name": "NODE_NAME", "valueFrom": {
                            "fieldRef": {"fieldPath": "spec.nodeName"}}},
                    ],
                    "resources": {"limits": {resource: str(gpus)}},
                }],
            },
        }

    # -- per-slice reconcile --------------------------------------------------
    def _config_hash(self, policy: ClusterPolicy, members: List[dict]) -> str:
        return object_hash({
            "driver_version": policy.spec.driver.driver_version or policy.spec.driver.version,
            "validator_image": policy.spec.validator.image_path(),
            "members": [m["metadata"]["name"] for m in members],
        })

    def _stamped(self, node: dict, config_hash: str) -> bool:
        return deep_get(node, "metadata", "annotations",
                        consts.MULTIHOST_VALIDATED_ANNOTATION) == config_hash

    def _stamp(self, members: List[dict], config_hash: str) -> None:
        for node in members:
            coalesced_patch(self.client, "v1", "Node",
                            node["metadata"]["name"], {
                                "metadata": {"annotations": {
                                    consts.MULTIHOST_VALIDATED_ANNOTATION:
                                        config_hash}}})

    def _teardown(self, slice_id: str, namespace: str, n_hint: int = 64) -> None:
        for pod in self.client.list("v1", "Pod", namespace,
                                    label_selector={"app": APP_LABEL,
                                                    consts.MULTIHOST_SLICE_LABEL: slice_id}):
            try:
                self.client.delete("v1", "Pod", pod["metadata"]["name"], namespace)
            except NotFoundError:
                pass
        try:
            self.client.delete("v1", "Service", self._svc_name(slice_id), namespace)
        except NotFoundError:
            pass

    def _sync_slice(self, slice_id: str, members: List[dict],
                    policy: ClusterPolicy, namespace: str) -> SyncState:
        config_hash = self._config_hash(policy, members)
        if all(self._stamped(n, config_hash) for n in members):
            self._teardown(slice_id, namespace)
            return SyncState.READY

        n = len(members)
        image = policy.spec.validator.image_path()
        resource = policy.spec.device_plugin.resource_name
        pods = self.client.list("v1", "Pod", namespace,
                                label_selector={"app": APP_LABEL,
                                                consts.MULTIHOST_SLICE_LABEL: slice_id})
        stale = [p for p in pods
                 if deep_get(p, "metadata", "annotations", consts.MULTIHOST_CONFIG_HASH_ANNOTATION)
                 != config_hash]
        if stale:
            log.info("multihost %s: config changed, restarting validation", slice_id)
            self._teardown(slice_id, namespace)
            return SyncState.NOT_READY

        if not pods:
            from .operands import stamp_operator_meta

            log.info("multihost %s: launching %d-way rendezvous", slice_id, n)
            self.skel.create_or_update_objs(
                stamp_operator_meta([self._service(slice_id, namespace)],
                                    policy), owner=policy.obj)
            for worker, node in enumerate(members):
                pod = self._pod(slice_id, worker, node, n, namespace, image,
                                config_hash, resource)
                # these are the pods that actually run GPU workloads:
                # operator-wide metadata and runtimeClass apply here too
                self.skel.create_or_update_objs(
                    stamp_operator_meta([pod], policy), owner=policy.obj)
            return SyncState.NOT_READY

        phases = [deep_get(p, "status", "phase", default="Pending") for p in pods]
        if any(p == "Failed" for p in phases):
            log.warning("multihost %s: validation FAILED (%s); retrying next sweep",
                        slice_id, phases)
            self._teardown(slice_id, namespace)
            return SyncState.NOT_READY
        if len(pods) == n and all(p == "Succeeded" for p in phases):
            log.info("multihost %s: all %d workers passed; stamping nodes", slice_id, n)
            self._stamp(members, config_hash)
            self._teardown(slice_id, namespace)
            return SyncState.READY
        # per-attempt scheduling budget: every worker must be past Pending
        # (and none missing — a GC'd pod can never Succeed) within the
        # budget, else tear down for a clean retry next sweep. Running pods
        # are the rendezvous' problem: GPU_INIT_TIMEOUT fails them closed.
        stuck = (len(pods) < n
                 or any(p not in ("Running", "Succeeded") for p in phases))
        if stuck and self.scheduling_budget_s > 0:
            age = self._attempt_age(pods)
            if age > self.scheduling_budget_s:
                pending = [p["metadata"]["name"] for p in pods
                           if deep_get(p, "status", "phase",
                                       default="Pending")
                           not in ("Running", "Succeeded")]
                message = (f"slice {slice_id}: {len(pending)} worker pod(s) "
                           f"not running {int(age)}s after creation "
                           f"(budget {int(self.scheduling_budget_s)}s), "
                           f"{n - len(pods)} missing; tearing down for retry"
                           f" — stuck: {pending[:4]}")
                log.warning("multihost %s", message)
                events.record(self.client, namespace, pods[0],
                              events.WARNING, "MultihostSchedulingTimeout",
                              message)
                self._teardown(slice_id, namespace)
        return SyncState.NOT_READY

    def _attempt_age(self, pods: List[dict]) -> float:
        """Seconds since the attempt's NEWEST pod was created (generous:
        the budget starts when the full worker set existed). Unparsable or
        missing timestamps read as age 0 — grant a budget, never escalate
        instantly on a malformed fixture."""
        newest = 0.0
        for pod in pods:
            raw = deep_get(pod, "metadata", "creationTimestamp")
            if not raw:
                continue
            try:
                newest = max(newest, calendar.timegm(
                    time.strptime(raw, "%Y-%m-%dT%H:%M:%SZ")))
            except ValueError:
                continue
        return self._now() - newest if newest else 0.0

    # -- state entry ----------------------------------------------------------
    def sync(self, catalog: InfoCatalog) -> StateResult:
        policy: ClusterPolicy = catalog.require(INFO_CLUSTER_POLICY)
        namespace: str = catalog.require(INFO_NAMESPACE)
        if not policy.spec.validator.is_enabled():
            return StateResult(self.name, SyncState.IGNORE, "validator disabled")
        nodes = catalog.get(INFO_NODES) or self.client.list("v1", "Node")
        groups = slice_groups(nodes, policy.spec.device_plugin.resource_name)
        if not groups:
            return StateResult(self.name, SyncState.READY, "no multi-host slices")
        worst = SyncState.READY
        blockers = []
        for slice_id, members in sorted(groups.items()):
            state = self._sync_slice(slice_id, members, policy, namespace)
            if state != SyncState.READY:
                worst = SyncState.NOT_READY
                blockers.append(slice_id)
        message = f"validating slices: {blockers}" if blockers else ""
        return StateResult(self.name, worst, message)
