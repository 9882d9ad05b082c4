"""GPUDriver reconciler: a per-instance driver rollout fanned out per node
pool (counterpart of tpu_operator/controllers/tpudriver_controller.py;
NVIDIA's controllers/nvidiadriver_controller.go:75-207 and
internal/state/driver.go:129-301).

Each GPUDriver selects a set of GPU nodes; they are partitioned into pools
by GPU model (``state/nodepool.py``) and one driver DaemonSet,
``gpu-driver-<instance>-<pool>``, is rendered per pool. Two instances
selecting one node are refused with a ConflictingNodeSelector condition;
the DaemonSets of pools that are gone are deleted. Unlike the reference, an
event on any GPUDriver re-reconciles every instance (``map_instance``), and
an instance's own labels, annotations, tolerations, node affinity and
priority class reach its DaemonSets (the reference renders them from the
ClusterPolicy's ``daemonsets`` settings alone).
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Dict, List, Optional

from .. import consts, events, tracing
from ..api.clusterpolicy import ClusterPolicy, State
from ..api.gpudriver import GPUDriver
from ..client.batch import batch_window
from ..client.errors import ConflictError, NotFoundError
from ..client.interface import Client, WatchEvent
from ..conditions import (
    REASON_CONFLICTING_NODE_SELECTOR,
    REASON_RECONCILE_FAILED,
    is_new_error,
    mark_error,
    mark_ready,
)
from ..nodeinfo import is_gpu_node
from ..state.driver import DriverRenderOverrides, StateDriver
from ..state.nodepool import get_node_pools
from ..state.skel import StateSkel, SyncState, node_matches_selector
from ..utils import deep_get
from .predicates import filtered_node_mapper
from .runtime import Controller, Reconciler, Request, Result

log = logging.getLogger(__name__)

#: DaemonSet label tying a DaemonSet to its owning GPUDriver instance
INSTANCE_LABEL = consts.DRIVER_INSTANCE_LABEL

#: the per-pool DaemonSets' name prefix (the ClusterPolicy's is gpu-driver)
APP_PREFIX = "gpu-driver"

NOT_READY_REQUEUE = 5.0

#: lost-event safety net, not the reconcile cadence (watch-driven);
#: jittered by the runtime so replicas never LIST in lockstep
RESYNC_PERIOD_S = float(os.environ.get("GPU_OPERATOR_RESYNC_S", "300"))


def find_selector_conflicts(instances: List[GPUDriver], nodes: List[dict]) -> Dict[str, List[str]]:
    """node name -> the instances claiming it, where more than one does
    (NVIDIA's internal/validator/validator.go:31-47)."""
    claims: Dict[str, List[str]] = {}
    for instance in instances:
        selector = instance.spec.get_node_selector()
        for node in nodes:
            if node_matches_selector(node, selector):
                claims.setdefault(node["metadata"]["name"], []).append(instance.name)
    return {n: owners for n, owners in claims.items() if len(owners) > 1}


def pool_app_name(instance: str, pool: str) -> str:
    """The DaemonSet name of one instance's pool, cut to 63 characters."""
    return f"{APP_PREFIX}-{instance}-{pool}"[:63].rstrip("-")


class GPUDriverReconciler(Reconciler):
    name = "gpudriver"

    def __init__(self, client: Client, namespace: Optional[str] = None,
                 requeue_after: float = NOT_READY_REQUEUE):
        self.client = client
        self.namespace = namespace or os.environ.get(consts.NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
        self.requeue_after = requeue_after
        self.state_driver = StateDriver(client)

    # -- helpers --------------------------------------------------------------
    def _cluster_policy(self) -> Optional[ClusterPolicy]:
        policies = self.client.list("tpu.ai/v1", "ClusterPolicy")
        if not policies:
            return None
        policies.sort(key=lambda p: (p["metadata"].get("creationTimestamp", ""),
                                     p["metadata"]["name"]))
        return ClusterPolicy.from_obj(policies[0])

    def _write_status(self, obj: dict,
                      unchanged_from: Optional[dict] = None) -> None:
        if unchanged_from is not None and obj.get("status") == unchanged_from:
            return  # identical status: no write
        with tracing.phase_span("status-update") as sp:
            try:
                self.client.update_status(obj)
            except (ConflictError, NotFoundError) as e:
                sp.set_attribute("write_race", str(e))

    # -- reconcile ------------------------------------------------------------
    def reconcile(self, request: Request) -> Result:
        with batch_window(self.client):
            return self._reconcile(request)

    def _reconcile(self, request: Request) -> Result:
        try:
            obj = self.client.get("tpu.ai/v1alpha1", "GPUDriver", request.name)
        except NotFoundError:
            return Result()  # deleted; its DaemonSets go by owner reference
        driver = GPUDriver.from_obj(obj)
        status_as_read = copy.deepcopy(driver.obj.get("status"))

        policy = self._cluster_policy()
        if policy is None:
            driver.status["state"] = State.NOT_READY
            mark_error(driver.obj, REASON_RECONCILE_FAILED,
                       "no ClusterPolicy found; GPUDriver requires one for cluster defaults")
            self._write_status(driver.obj)
            return Result(requeue_after=self.requeue_after)

        errors = driver.spec.validate()
        if errors:
            driver.status["state"] = State.NOT_READY
            mark_error(driver.obj, REASON_RECONCILE_FAILED, "; ".join(errors))
            self._write_status(driver.obj)
            return Result()  # the spec is wrong: requeue only on a CR edit

        all_nodes = [n for n in self.client.list("v1", "Node") if is_gpu_node(n)]
        instances = [GPUDriver.from_obj(o)
                     for o in self.client.list("tpu.ai/v1alpha1", "GPUDriver")]
        conflicts = find_selector_conflicts(instances, all_nodes)
        mine_conflicted = {n for n, owners in conflicts.items() if driver.name in owners}
        if mine_conflicted:
            driver.status["state"] = State.NOT_READY
            message = f"nodes claimed by multiple GPUDrivers: {sorted(mine_conflicted)}"
            if is_new_error(driver.obj, REASON_CONFLICTING_NODE_SELECTOR, message):
                # once per distinct conflict, not per requeue or resync
                events.record(self.client, self.namespace, driver.obj,
                              events.WARNING, REASON_CONFLICTING_NODE_SELECTOR, message)
            mark_error(driver.obj, REASON_CONFLICTING_NODE_SELECTOR, message)
            self._write_status(driver.obj)
            return Result(requeue_after=self.requeue_after)

        selector = driver.spec.get_node_selector()
        selected = [n for n in all_nodes if node_matches_selector(n, selector)]
        pools = get_node_pools(selected)

        skel = StateSkel(f"gpudriver-{driver.name}", self.client)
        desired_names = set()
        applied: List[dict] = []
        for pool in pools:
            app_name = pool_app_name(driver.name, pool.name)
            desired_names.add(app_name)
            # the instance's own labels, annotations, tolerations, node
            # affinity and priority class reach its DaemonSets (the
            # reference's TPUDriverReconciler drops them)
            overrides = DriverRenderOverrides(
                app_name=app_name,
                node_selector={**pool.node_selector, **selector},
                driver_version=driver.spec.driver_version,
                image=driver.spec.image_path(),
                extra_labels={**driver.spec.labels, INSTANCE_LABEL: driver.name,
                              consts.NODE_POOL_LABEL: pool.name},
                annotations=driver.spec.annotations,
                tolerations=driver.spec.tolerations,
                node_affinity=driver.spec.node_affinity,
                priority_class_name=driver.spec.priority_class_name,
            )
            with tracing.phase_span("render", pool=pool.name) as sp:
                objs = self.state_driver.render_objects(policy, self.namespace,
                                                        overrides, driver_spec=driver.spec)
                sp.set_attribute("objects", len(objs))
            with tracing.phase_span("apply", pool=pool.name):
                applied.extend(skel.create_or_update_objs(objs, owner=driver.obj))

        self._cleanup_stale(skel, desired_names)

        status = skel.get_sync_state(applied, nodes=all_nodes)
        if status == SyncState.READY:
            if driver.status.get("state") != State.READY:
                # once per NotReady -> Ready edge, not per resync
                events.record(self.client, self.namespace, driver.obj,
                              events.NORMAL, "Ready", f"{len(pools)} pool(s) ready")
            driver.status["state"] = State.READY
            driver.status["pools"] = {p.name: p.size for p in pools}
            mark_ready(driver.obj, f"{len(pools)} pool(s) ready")
            self._write_status(driver.obj, unchanged_from=status_as_read)
            log.info("GPUDriver %s ready (%d pools, %d nodes)",
                     driver.name, len(pools), len(selected))
            return Result()
        driver.status["state"] = State.NOT_READY
        mark_error(driver.obj, "DriverNotReady", "per-pool driver DaemonSets not ready")
        self._write_status(driver.obj, unchanged_from=status_as_read)
        return Result(requeue_after=self.requeue_after)

    def _cleanup_stale(self, skel: StateSkel, desired_names: set) -> None:
        """Delete the DaemonSets of pools that are gone (NVIDIA's
        cleanupStaleDriverDaemonsets, internal/state/driver.go:181)."""
        for ds in skel.list_owned("apps/v1", "DaemonSet", self.namespace):
            name = ds["metadata"]["name"]
            if name not in desired_names:
                log.info("deleting the DaemonSet of a pool that is gone: %s", name)
                try:
                    self.client.delete("apps/v1", "DaemonSet", name, self.namespace)
                except NotFoundError:
                    pass


def setup_gpudriver_controller(client: Client, reconciler: GPUDriverReconciler) -> Controller:
    controller = Controller(reconciler)

    def all_instances(_event: WatchEvent) -> List[Request]:
        return [Request(name=o["metadata"]["name"])
                for o in client.list("tpu.ai/v1alpha1", "GPUDriver")]

    def map_instance(event: WatchEvent) -> List[Request]:
        # an instance's selector can claim (or free) any other instance's
        # nodes: every instance re-reconciles, so a conflict shows on both
        # at once and clears on the survivor when one goes (the reference
        # maps the event to its own instance only, and the other learns at
        # its next resync)
        own = Request(name=event.object["metadata"]["name"])
        return [own] + [r for r in all_instances(event) if r != own]

    def map_owned(event: WatchEvent) -> List[Request]:
        instance = deep_get(event.object, "metadata", "labels", INSTANCE_LABEL)
        return [Request(name=instance)] if instance else []

    controller.watches("tpu.ai/v1alpha1", "GPUDriver", map_instance)
    # heartbeat-only node updates must not re-reconcile every instance
    controller.watches("v1", "Node", filtered_node_mapper(all_instances))
    controller.watches("apps/v1", "DaemonSet", map_owned,
                       namespace=reconciler.namespace)
    controller.resyncs(lambda: all_instances(None), period=RESYNC_PERIOD_S)
    return controller
