"""state-driver: place the GPU driver's user-space libraries on every GPU
node (counterpart of tpu_operator/state/driver.py; NVIDIA's
internal/state/driver.go).

NVIDIA's operator builds and loads a kernel module per kernel-version pool;
the port's installer places the user-space libraries (``gpu-validator -c
driver-daemon``) into ``hostPaths.driverInstallDir``, and its probe is
"libraries present + device nodes visible". While no GPUDriver exists, the
ClusterPolicy owns one driver DaemonSet for every GPU node (:meth:`sync`);
once any GPUDriver exists, that DaemonSet is deleted and the GPUDriver
controller renders one per node pool through :meth:`render_objects` with
per-pool :class:`DriverRenderOverrides` and the instance's spec.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from .. import consts, tracing
from ..api.clusterpolicy import ClusterPolicy
from ..client.interface import Client
from ..render import Renderer
from .manager import (
    INFO_CLUSTER_POLICY,
    INFO_NAMESPACE,
    INFO_NODES,
    InfoCatalog,
    StateResult,
)
from .skel import StateSkel, SyncState

MANIFEST_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "manifests")

DEFAULT_APP_NAME = "gpu-driver"


@dataclasses.dataclass
class DriverRenderOverrides:
    """Per-pool knobs the GPUDriver controller injects (NVIDIA's
    internal/state/driver.go:94-104): the pool's DaemonSet name and node
    selector, and the instance's own labels, annotations, tolerations,
    node affinity and priority class, which add to (tolerations,
    annotations) or take the place of (priority class) the ClusterPolicy's
    ``daemonsets`` settings."""

    app_name: str = DEFAULT_APP_NAME
    node_selector: Optional[Dict[str, str]] = None
    node_affinity: Optional[dict] = None
    driver_version: Optional[str] = None
    image: Optional[str] = None
    extra_labels: Optional[Dict[str, str]] = None
    annotations: Optional[Dict[str, str]] = None
    tolerations: Optional[List[dict]] = None
    priority_class_name: Optional[str] = None


class StateDriver:
    name = "state-driver"

    def __init__(self, client: Client):
        self.client = client
        self.renderer = Renderer(os.path.join(MANIFEST_DIR, "state-driver"))
        self.skel = StateSkel(self.name, client)

    # -- render data ----------------------------------------------------------
    def render_data(self, policy: ClusterPolicy, namespace: str,
                    overrides: Optional[DriverRenderOverrides] = None,
                    driver_spec=None) -> dict:
        """``driver_spec`` lets the GPUDriver controller put an instance's
        spec in place of the ClusterPolicy's (GPUDriverSpec has the
        DriverSpec field shape)."""
        o = overrides or DriverRenderOverrides()
        driver = driver_spec if driver_spec is not None else policy.spec.driver
        daemonsets = policy.spec.daemonsets
        tolerations = list(daemonsets.tolerations)
        tolerations += [t for t in o.tolerations or [] if t not in tolerations]
        return {
            "app_name": o.app_name,
            "namespace": namespace,
            "deploy_label": consts.deploy_label("driver"),
            "gpu_resource": consts.GPU_RESOURCE_NAME,
            "validation_status_dir": policy.spec.host_paths.validation_status_dir,
            "dev_globs": ",".join(policy.spec.host_paths.dev_globs),
            "trace_parent": tracing.join_traceparent(policy.obj),
            "node_selector": o.node_selector or {},
            "node_affinity": o.node_affinity,
            "extra_labels": o.extra_labels or {},
            "cdi_enabled": policy.spec.cdi.enabled,
            "daemonsets": {
                # autoUpgrade hands the rollout to the port's upgrade machine
                # (upgrade/machine.py), which deletes each node's driver pod
                # in turn: the DS must not replace pods on its own (OnDelete)
                "update_strategy": ("OnDelete" if driver.upgrade_policy.auto_upgrade
                                    else daemonsets.update_strategy),
                "rolling_update": daemonsets.rolling_update,
                "priority_class_name": o.priority_class_name or daemonsets.priority_class_name,
                "tolerations": tolerations,
                "annotations": {**daemonsets.annotations, **(o.annotations or {})},
            },
            "driver": {
                "image": o.image or driver.image_path(),
                "image_pull_policy": driver.image_pull_policy,
                "image_pull_secrets": driver.image_pull_secrets,
                # an explicit spec.hostPaths.driverInstallDir wins over the
                # (ClusterPolicy or per-GPUDriver) driver spec's installDir
                "install_dir": (policy.spec.host_paths.driver_install_dir
                                or driver.install_dir),
                "driver_version": o.driver_version or driver.driver_version,
                "env": [e.to_k8s() for e in driver.env],
                "resources": driver.resources,
            },
        }

    def render_objects(self, policy: ClusterPolicy, namespace: str,
                       overrides: Optional[DriverRenderOverrides] = None,
                       driver_spec=None) -> List[dict]:
        from .operands import stamp_operator_meta

        return stamp_operator_meta(
            self.renderer.render_objects(
                self.render_data(policy, namespace, overrides, driver_spec)),
            policy)

    # -- ClusterPolicy-path sync (one DS for all GPU nodes) -------------------
    def sync(self, catalog: InfoCatalog) -> StateResult:
        policy: ClusterPolicy = catalog.require(INFO_CLUSTER_POLICY)
        namespace: str = catalog.require(INFO_NAMESPACE)
        if self.client.list("tpu.ai/v1alpha1", "GPUDriver"):
            # GPUDriver instances own the driver DaemonSets: hand over and
            # delete the ClusterPolicy's (NVIDIA's state_manager.go:951-961)
            self.skel.delete_objs(self.skel.list_owned("apps/v1", "DaemonSet", namespace))
            return StateResult(self.name, SyncState.IGNORE, "GPUDriver CRs own the driver")
        if not policy.spec.driver.is_enabled():
            self.skel.delete_objs(self.skel.list_owned("apps/v1", "DaemonSet", namespace))
            return StateResult(self.name, SyncState.IGNORE, "driver disabled")
        objs = self.render_objects(policy, namespace)
        applied = self.skel.create_or_update_objs(objs, owner=policy.obj)
        status = self.skel.get_sync_state(applied, nodes=catalog.get(INFO_NODES))
        return StateResult(self.name, status)
