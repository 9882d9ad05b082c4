"""Operand states for the ClusterPolicy DAG (counterpart of
tpu_operator/state/operands.py).

One generic :class:`OperandState` covers what NVIDIA's operator spreads
over per-operand transform code (controllers/object_controls.go): each
operand is "render this state's manifest dir with this sub-spec, apply,
walk readiness, delete when disabled". Per-operand differences live in the
port's own templates (``tpu_operator_torch/manifests``) plus a small
``extras`` hook here. The DAG and the state order are the reference's.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

from .. import consts, tracing
from ..api.clusterpolicy import ClusterPolicy
from ..api.common import ComponentSpec
from ..client.interface import Client
from ..render import Renderer
from ..utils import template_fingerprint
from .driver import MANIFEST_DIR, StateDriver
from .multihost import MultihostValidationState
from .manager import (
    INFO_CLUSTER_POLICY,
    INFO_NAMESPACE,
    INFO_NODES,
    InfoCatalog,
    StateResult,
)
from .skel import StateSkel, SyncState
from ..partitioner.partitioner import DEFAULT_PARTITIONS
from ..validator.driver import HOST_DRIVER_PATHS


#: The operand dependency DAG: state name -> validation barriers its pods
#: gate on (rendered as ``wait_for`` init containers). This is the single
#: source of truth for join-path serialization — templates loop over
#: ``wait_barriers`` instead of hard-coding waits, and the golden and DAG
#: tests pin every template wait to a declared parent.
#:
#: Only REAL data dependencies appear. The device plugin hands the
#: driver's files to workloads and the partitioner regroups live GPUs, so
#: both need the driver barrier; the serving probe certifies a node the
#: whole stack already validated, so it needs the workload barrier.
#: Telemetry, feature discovery, and the node-status exporter are
#: node-scoped observers — they read status files, NVML and sysfs — so they
#: carry NO barrier and roll concurrently with the driver (the pipelined
#: join). The validator state is its own chain (driver -> plugin ->
#: workload init containers), not a wait_for consumer.
OPERAND_DAG: Dict[str, Tuple[str, ...]] = {
    "state-device-plugin": ("driver",),
    "state-slice-partitioner": ("driver",),
    "state-operator-serving": ("workload",),
    "state-operator-validation": (),
    "state-telemetry": (),
    "state-feature-discovery": (),
    "state-node-status-exporter": (),
    "state-operator-metrics": (),
    "state-driver": (),
    "state-multihost-validation": (),
}


def stamp_operator_meta(objs: List[dict], policy: ClusterPolicy) -> List[dict]:
    """Apply operator-wide metadata the CR promises (NVIDIA's
    applyCommonDaemonsetConfig / operator metadata handling): extra
    labels/annotations on every managed object (spec.operator), extra pod
    labels/annotations on every DaemonSet pod template (spec.daemonsets),
    and runtimeClassName when spec.operator.runtimeClass is set."""
    op = policy.spec.operator
    ds_spec = policy.spec.daemonsets

    def merge(meta: dict, key: str, extras: Dict[str, str]) -> None:
        # template-authored keys WIN: a CR-level extra must never clobber
        # e.g. the `app` label the DaemonSet selector matches on (the
        # apiserver rejects selector/template mismatches outright)
        target = meta.setdefault(key, {})
        for k, v in extras.items():
            target.setdefault(k, v)

    # the reference's migration guard, kept so one CR serves both: an
    # early CRD defaulted runtimeClass to "tpu", a value with no
    # RuntimeClass behind it, which reads as unset
    runtime_class = op.runtime_class if op.runtime_class != "tpu" else None

    for obj in objs:
        meta = obj.setdefault("metadata", {})
        if op.labels:
            merge(meta, "labels", op.labels)
        if op.annotations:
            merge(meta, "annotations", op.annotations)
        if obj.get("kind") == "Pod":
            if ds_spec.labels:
                merge(meta, "labels", ds_spec.labels)
            if ds_spec.annotations:
                merge(meta, "annotations", ds_spec.annotations)
            if runtime_class:
                obj.setdefault("spec", {})["runtimeClassName"] = runtime_class
            continue
        if obj.get("kind") != "DaemonSet":
            continue
        tpl = obj.setdefault("spec", {}).setdefault("template", {})
        tpl_meta = tpl.setdefault("metadata", {})
        if ds_spec.labels:
            merge(tpl_meta, "labels", ds_spec.labels)
        if ds_spec.annotations:
            merge(tpl_meta, "annotations", ds_spec.annotations)
        # join-trace context on every operand pod (the env-var twin rides
        # host_env): STABLE per policy — derived from the CR uid, never a
        # per-sweep id, or the template fingerprint below would change
        # every sweep and roll every DaemonSet
        tpl_meta.setdefault("annotations", {}).setdefault(
            tracing.TRACE_ID_ANNOTATION,
            tracing.join_traceparent(policy.obj).split("-")[0])
        if runtime_class:
            tpl.setdefault("spec", {})["runtimeClassName"] = runtime_class
        # LAST template mutation: the DS controller copies template labels
        # onto pods, so this label gives the upgrade machine an exact
        # whole-template currency signal (controller-revision-hash analog)
        tpl_meta.setdefault("labels", {})[consts.TEMPLATE_HASH_LABEL] = \
            template_fingerprint(tpl)
    return objs


def component_data(component: ComponentSpec) -> dict:
    return {
        "image": component.image_path(),
        "image_pull_policy": component.image_pull_policy,
        "image_pull_secrets": component.image_pull_secrets,
        "env": [e.to_k8s() for e in component.env],
        "args": list(component.args),
        "resources": component.resources,
    }


class OperandState:
    """A state that renders one manifest dir from one ClusterPolicy sub-spec."""

    def __init__(
        self,
        name: str,
        operand: str,
        client: Client,
        spec_getter: Callable[[ClusterPolicy], ComponentSpec],
        default_enabled: bool = True,
        extras: Optional[Callable[[ClusterPolicy], dict]] = None,
        app_name: Optional[str] = None,
    ):
        self.name = name
        self.operand = operand
        self.client = client
        self.spec_getter = spec_getter
        self.default_enabled = default_enabled
        self.extras = extras
        self.app_name = app_name or name.replace("state-", "gpu-")
        self.renderer = Renderer(os.path.join(MANIFEST_DIR, name))
        self.skel = StateSkel(name, client)

    def render_data(self, policy: ClusterPolicy, namespace: str) -> dict:
        component = self.spec_getter(policy)
        data = {
            "app_name": self.app_name,
            "namespace": namespace,
            "deploy_label": consts.deploy_label(self.operand),
            "gpu_resource": consts.GPU_RESOURCE_NAME,
            # CR-level host layout (spec.hostPaths) — never the compiled-in
            # defaults, so bare-metal layouts work end to end
            "validation_status_dir": policy.spec.host_paths.validation_status_dir,
            "dev_globs": ",".join(policy.spec.host_paths.dev_globs),
            "handoff_dir": policy.spec.host_paths.partition_handoff_dir,
            # cross-process trace propagation: operand entrypoints parse
            # this into their remote root span's trace context
            "trace_parent": tracing.join_traceparent(policy.obj),
            # image for the barrier-wait init containers: the operator
            # initContainer override wins, else the validator image
            "validator_image": (policy.spec.operator.init_container_image()
                                or policy.spec.validator.image_path()),
            "wait_pull_policy": policy.spec.operator.init_container_pull_policy(),
            # declared DAG parents only: templates render one wait_for init
            # container per entry, so a template cannot re-serialize the
            # join without editing OPERAND_DAG (and the golden + DAG tests)
            "wait_barriers": list(OPERAND_DAG.get(self.name, ())),
            "daemonsets": {
                "update_strategy": policy.spec.daemonsets.update_strategy,
                "rolling_update": policy.spec.daemonsets.rolling_update,
                "priority_class_name": policy.spec.daemonsets.priority_class_name,
                "tolerations": policy.spec.daemonsets.tolerations,
                "annotations": policy.spec.daemonsets.annotations,
            },
            "component": component_data(component),
        }
        if self.extras:
            data.update(self.extras(policy))
        return data

    def render_objects(self, policy: ClusterPolicy, namespace: str) -> List[dict]:
        return stamp_operator_meta(
            self.renderer.render_objects(self.render_data(policy, namespace)),
            policy)

    def sync(self, catalog: InfoCatalog) -> StateResult:
        policy: ClusterPolicy = catalog.require(INFO_CLUSTER_POLICY)
        namespace: str = catalog.require(INFO_NAMESPACE)
        if not self.spec_getter(policy).is_enabled(self.default_enabled):
            for kind_av in (("apps/v1", "DaemonSet"), ("v1", "Service"),
                            ("monitoring.coreos.com/v1", "ServiceMonitor"),
                            ("monitoring.coreos.com/v1", "PrometheusRule")):
                self.skel.delete_objs(self.skel.list_owned(*kind_av, namespace))
            return StateResult(self.name, SyncState.IGNORE, f"{self.operand} disabled")
        objs = self.render_objects(policy, namespace)
        applied = self.skel.create_or_update_objs(objs, owner=policy.obj)
        status = self.skel.get_sync_state(applied, nodes=catalog.get(INFO_NODES))
        return StateResult(self.name, status)


class PrerequisitesState(OperandState):
    """Cluster-scoped prerequisites (reference assets/pre-requisites/).

    NVIDIA's stack needs RuntimeClasses here for its container-toolkit
    hook; the port's device plugin hands device nodes over itself, so this
    reduces to a dedicated PriorityClass for operand DaemonSets.
    """

    def __init__(self, client: Client):
        super().__init__(
            name="pre-requisites",
            operand="driver",  # unused; state is unconditional
            client=client,
            spec_getter=lambda p: p.spec.driver,
        )

    def sync(self, catalog: InfoCatalog) -> StateResult:
        policy: ClusterPolicy = catalog.require(INFO_CLUSTER_POLICY)
        namespace: str = catalog.require(INFO_NAMESPACE)
        objs = stamp_operator_meta(
            self.renderer.render_objects({"namespace": namespace}), policy)
        self.skel.create_or_update_objs(objs, owner=policy.obj)
        return StateResult(self.name, SyncState.READY)


def _duration_seconds(value: str) -> float:
    """'500ms' | '60s' | '1.5s' | '5m' | '1h' -> seconds (spec duration
    strings). Fractional mantissas are valid spec values ("1.5s"); the
    suffix check must come first ("ms" before "s", insertion order) so
    "500ms" is not read as 500 minutes-of-s."""
    s = str(value)
    units = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}
    for suffix, mult in units.items():
        if s.endswith(suffix):
            try:
                return float(s[:-len(suffix)]) * mult
            except ValueError:
                continue  # e.g. "abcs": fall through to the bare parse
    return float(s)


def feature_discovery_extras(policy: ClusterPolicy) -> dict:
    return {"sleep_interval_s":
            _duration_seconds(policy.spec.feature_discovery.sleep_interval)}


def telemetry_extras(policy: ClusterPolicy) -> dict:
    t = policy.spec.telemetry
    return {"metrics_port": t.metrics_port,
            "service_monitor": t.service_monitor or {},
            "metrics_config": t.config or {}}


def node_status_exporter_extras(policy: ClusterPolicy) -> dict:
    return {"metrics_port": policy.spec.node_status_exporter.metrics_port}


def device_plugin_extras(policy: ClusterPolicy) -> dict:
    dp = policy.spec.device_plugin
    return {"resource_name": dp.resource_name,
            "builtin_plugin": dp.builtin_plugin,
            # the plugin hands the driver's files to workload containers
            # from here; without the flag it would fall back to the
            # compiled-in default on other layouts
            "install_dir": policy.spec.driver_dir(),
            # cdi.default switches Allocate() to CDI device references
            # (the specs the driver state writes under /etc/cdi)
            "cdi_default": policy.spec.cdi.enabled and policy.spec.cdi.default,
            "plugin_config": dp.config or {}}


def slice_partitioner_extras(policy: ClusterPolicy) -> dict:
    sp = policy.spec.slice_partitioner
    return {"partitioner_config": sp.config or {},
            "default_partitions": DEFAULT_PARTITIONS,
            "slice_config_label": consts.TPU_SLICE_CONFIG_LABEL,
            "slice_state_label": consts.TPU_SLICE_STATE_LABEL,
            # coordinated drain: health-gated re-tiles wait for the
            # workload's drain-ack up to this deadline (0 = immediate
            # re-tile; also 0 when the health machine is off — no one
            # would publish the plan the partitioner waits on)
            "drain_deadline_s": (policy.spec.health.drain_deadline_s
                                 if policy.spec.health.enabled else 0)}


def serving_extras(policy: ClusterPolicy) -> dict:
    s = policy.spec.serving
    return {"serving_batch_sizes": ",".join(str(b) for b in s.batch_sizes),
            "serving_steps": s.steps_per_batch,
            "serving_max_p99_ms": s.max_decode_p99_ms,
            "serving_min_tokens": s.min_throughput_tokens_per_s,
            "serving_min_attainment": s.min_slo_attainment,
            "probe_interval_s": s.probe_interval_s}


def validator_extras(policy: ClusterPolicy) -> dict:
    v = policy.spec.validator
    return {
        "driver_env": [e.to_k8s() for e in v.driver.env],
        "plugin_env": [e.to_k8s() for e in v.plugin.env],
        "workload_env": [e.to_k8s() for e in v.workload.env],
        "resource_name": policy.spec.device_plugin.resource_name,
        "install_dir": policy.spec.driver_dir(),
        "revalidate_interval_s": v.revalidate_interval_s,
        # driver.enabled=false -> the platform owns the driver: the driver
        # validation adopts the host install instead of requiring ours
        # (validateHostDriver analog, NVIDIA's validator/main.go:694-708),
        # probing the node's library paths through the host root at /host
        "use_host_driver": not policy.spec.driver.is_enabled(),
        "host_driver_paths": ":".join("/host" + p for p in HOST_DRIVER_PATHS),
    }


def operator_metrics_extras(policy: ClusterPolicy) -> dict:
    return {"operator_app": consts.OPERATOR_NAME}


def cluster_policy_states(client: Client) -> List:
    """The ordered state DAG for ClusterPolicy reconciles."""
    return [
        PrerequisitesState(client),
        OperandState("state-operator-metrics", "driver", client,
                     lambda p: p.spec.driver, extras=operator_metrics_extras,
                     app_name=consts.OPERATOR_NAME),
        StateDriver(client),
        OperandState("state-operator-validation", "operator-validator", client,
                     lambda p: p.spec.validator, extras=validator_extras,
                     app_name="gpu-operator-validator"),
        OperandState("state-device-plugin", "device-plugin", client,
                     lambda p: p.spec.device_plugin, extras=device_plugin_extras,
                     app_name="gpu-device-plugin"),
        MultihostValidationState(client),
        OperandState("state-feature-discovery", "feature-discovery", client,
                     lambda p: p.spec.feature_discovery,
                     extras=feature_discovery_extras,
                     app_name="gpu-feature-discovery"),
        OperandState("state-telemetry", "telemetry", client,
                     lambda p: p.spec.telemetry, extras=telemetry_extras,
                     app_name="gpu-telemetry-exporter"),
        OperandState("state-node-status-exporter", "node-status-exporter", client,
                     lambda p: p.spec.node_status_exporter,
                     extras=node_status_exporter_extras,
                     app_name="gpu-node-status-exporter"),
        OperandState("state-slice-partitioner", "slice-partitioner", client,
                     lambda p: p.spec.slice_partitioner, default_enabled=False,
                     extras=slice_partitioner_extras,
                     app_name="gpu-slice-partitioner"),
        # last in the DAG: serving SLOs are only meaningful on a node the
        # whole stack (driver->plugin->workload, partitioning) already
        # certified. Opt-in like the partitioner.
        OperandState("state-operator-serving", "serving", client,
                     lambda p: p.spec.serving, default_enabled=False,
                     extras=serving_extras,
                     app_name="gpu-serving-validator"),
    ]
