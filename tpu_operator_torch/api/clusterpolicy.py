"""ClusterPolicy CRD (tpu.ai/v1): the singleton cluster configuration
(counterpart of tpu_operator/api/clusterpolicy.py, for GPU nodes).

Group and kind stay ``tpu.ai/v1`` ``ClusterPolicy``: the operator's own
API. The defaults name NVIDIA's: the device plugin advertises
``nvidia.com/gpu``; the driver installer places the user-space driver
libraries (``libcuda.so.1``, ``libnvidia-ml.so.1``) in the driver library
directory and records ``driver.driverVersion``; the device globs are the
GPUs' ``/dev/nvidia<minor>``. ``autoscale`` and ``migrate`` are the
reference's sub-specs, read by the fleet autoscaler (``autoscale/``) and the
migration controller (``migrate/controller.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .common import (
    ComponentSpec,
    DaemonsetsSpec,
    EnvVar,
    SpecValidationError,
    UpgradePolicySpec,
)
from .. import consts
from .k8s_schemas import CONFIGMAP_REF, INIT_CONTAINER, SERVICE_MONITOR
from .specbase import SpecBase, spec_field

CLUSTER_POLICY_API_VERSION = "tpu.ai/v1"
CLUSTER_POLICY_KIND = "ClusterPolicy"


class State:
    """CR status.state values (reference clusterpolicy_types.go:1658)."""

    IGNORED = "ignored"
    READY = "ready"
    NOT_READY = "notReady"


@dataclasses.dataclass
class OperatorSpec(SpecBase):
    """Operator-wide settings (reference OperatorSpec).

    NVIDIA's ``defaultRuntime`` (container-toolkit config paths) is absent:
    the port's device plugin hands device nodes and driver files over
    itself (or through CDI), with no toolkit layer to configure."""

    runtime_class: Optional[str] = spec_field(
        None, doc="RuntimeClass name stamped on operand pods (unset: "
                  "none — the operands need no special runtime).")
    init_container: Optional[Dict[str, Any]] = spec_field(
        None, schema=INIT_CONTAINER,
        doc="Image for the barrier-wait init containers injected into "
            "operand pods (unset: the validator image).")
    labels: Dict[str, str] = spec_field(
        dict, doc="Extra labels for operator-managed objects.")
    annotations: Dict[str, str] = spec_field(
        dict, doc="Extra annotations for operator-managed objects.")
    extra: Dict[str, Any] = spec_field(dict)

    def validate(self, path: str = "spec.operator") -> List[str]:
        return []

    def init_container_image(self) -> Optional[str]:
        """Image path from initContainer (repository/image:version, digest
        aware) — resolved by the same logic as every operand image so
        partial specs (image+version, digests) assemble correctly."""
        ic = self.init_container or {}
        if not ic.get("image"):
            return None
        return ComponentSpec.from_dict(
            {k: ic[k] for k in ("repository", "image", "version")
             if ic.get(k)}).image_path()

    def init_container_pull_policy(self) -> str:
        return (self.init_container or {}).get("imagePullPolicy",
                                               "IfNotPresent")


@dataclasses.dataclass
class DriverSpec(ComponentSpec):
    """Driver installer: places the user-space driver libraries on the host
    (``gpu-validator -c driver-daemon``); no kernel-module build."""

    DEFAULT_IMAGE_ENV: str = dataclasses.field(default="DRIVER_IMAGE", repr=False)

    driver_version: Optional[str] = spec_field(
        None, doc="Driver version the installer records (defaults to the "
                  "version NVML reports).",
        pattern=r"^[a-zA-Z0-9._+-]+$")
    install_dir: str = spec_field(
        consts.DEFAULT_DRIVER_LIB_DIR,
        doc="Host directory the driver installer writes the driver "
            "libraries into.",
        pattern=r"^/.*$")
    upgrade_policy: UpgradePolicySpec = spec_field(UpgradePolicySpec)

    def validate(self, path: str = "spec.driver") -> List[str]:
        return super().validate(path) + self.upgrade_policy.validate(f"{path}.upgradePolicy")


@dataclasses.dataclass
class DevicePluginSpec(ComponentSpec):
    """Kubelet device plugin advertising the GPUs to the scheduler."""

    DEFAULT_IMAGE_ENV: str = dataclasses.field(default="DEVICE_PLUGIN_IMAGE", repr=False)

    #: extended resource advertised to the scheduler
    resource_name: str = spec_field(
        consts.GPU_RESOURCE_NAME,
        doc="Extended resource name advertised to the scheduler.",
        pattern=r"^[a-z0-9.-]+/[a-zA-Z0-9._-]+$")
    #: True (default): run the in-repo plugin (``gpu-validator -c
    #: device-plugin``); False: the image's own entrypoint serves the
    #: kubelet API (external device-plugin images)
    builtin_plugin: bool = spec_field(
        True, doc="Run the operator's built-in kubelet device plugin; "
                  "false delegates to the image's own entrypoint.")
    config: Optional[Dict[str, Any]] = spec_field(
        None, schema=CONFIGMAP_REF)


@dataclasses.dataclass
class FeatureDiscoverySpec(ComponentSpec):
    """GPU feature discovery: GPU type, count and memory labels."""

    DEFAULT_IMAGE_ENV: str = dataclasses.field(default="FEATURE_DISCOVERY_IMAGE", repr=False)

    sleep_interval: str = spec_field(
        "60s", doc="Re-label interval.", pattern=r"^[0-9]+(ms|s|m|h)$")

    def validate(self, path: str = "spec.featureDiscovery") -> List[str]:
        errors = super().validate(path)
        # also enforced in Python: CRs arriving via paths that skip the
        # apiserver pattern check (cfgtool files, tests) must fail here,
        # not as a render-time ValueError inside the state sweep
        import re

        if not re.fullmatch(r"[0-9]+(ms|s|m|h)", str(self.sleep_interval)):
            errors.append(f"{path}.sleepInterval: "
                          f"{self.sleep_interval!r} is not a duration "
                          f"(e.g. 500ms, 60s, 5m, 1h)")
        return errors


@dataclasses.dataclass
class TelemetrySpec(ComponentSpec):
    """Out-of-band GPU telemetry over NVML (dcgm-exporter's place)."""

    DEFAULT_IMAGE_ENV: str = dataclasses.field(default="TELEMETRY_EXPORTER_IMAGE", repr=False)

    service_monitor: Optional[Dict[str, Any]] = spec_field(
        None, schema=SERVICE_MONITOR)
    metrics_port: int = spec_field(
        9400, doc="Port the exporter serves /metrics on.",
        minimum=1, maximum=65535)
    #: custom-metrics surface (reference dcgm-exporter metrics ConfigMap,
    #: controllers/object_controls.go:1533-1662): rename/allow/deny metric
    #: families, static labels, runtime endpoint override
    config: Optional[Dict[str, Any]] = spec_field(
        None, schema=CONFIGMAP_REF)


@dataclasses.dataclass
class NodeStatusExporterSpec(ComponentSpec):
    """Per-node validation-status exporter (node-status-exporter analog)."""

    DEFAULT_IMAGE_ENV: str = dataclasses.field(default="VALIDATOR_IMAGE", repr=False)

    metrics_port: int = spec_field(
        8000, doc="Port the node-status exporter serves /metrics on.",
        minimum=1, maximum=65535)


@dataclasses.dataclass
class ValidatorComponentEnv(SpecBase):
    """Extra env for one validator sub-component's container."""

    env: List[EnvVar] = spec_field(list)
    extra: Dict[str, Any] = spec_field(dict)


@dataclasses.dataclass
class ValidatorSpec(ComponentSpec):
    """On-node validator: status-file barriers + the GPU sweep workload."""

    DEFAULT_IMAGE_ENV: str = dataclasses.field(default="VALIDATOR_IMAGE", repr=False)

    driver: ValidatorComponentEnv = spec_field(ValidatorComponentEnv)
    plugin: ValidatorComponentEnv = spec_field(ValidatorComponentEnv)
    workload: ValidatorComponentEnv = spec_field(ValidatorComponentEnv)
    #: sleep-mode periodic re-run of the local sweep, refreshing the
    #: workload barrier (and with it the device plugin's health gate) for
    #: GPUs that degrade after their first pass. 0 = off. A GPU held by a
    #: workload skips the cycle without touching the barrier.
    revalidate_interval_s: int = spec_field(
        300, doc="Re-run the local sweep every N seconds in the "
                 "validator's sleep container, refreshing the workload "
                 "barrier (0 = off; default 300). GPUs held by a "
                 "workload skip the cycle.",
        minimum=0, maximum=86400)


@dataclasses.dataclass
class SlicePartitionerSpec(ComponentSpec):
    """GPU group partitioner: applies the partition named by the node
    label ``tpu.ai/slice.config`` as groups over NVML's link topology."""

    DEFAULT_IMAGE_ENV: str = dataclasses.field(default="SLICE_PARTITIONER_IMAGE", repr=False)

    config: Optional[Dict[str, Any]] = spec_field(
        None, schema=CONFIGMAP_REF)

    def is_enabled(self, default: bool = False) -> bool:
        # opt-in, like MIG in the reference
        return default if self.enabled is None else bool(self.enabled)


@dataclasses.dataclass
class ServingSpec(ComponentSpec):
    """Serving SLO validator: a decode-step probe (one CUDA graph) run on
    every GPU node that measures p50/p99 per-step latency and steady-state
    throughput over a batch ladder. Results land in the ``serving`` barrier
    file →
    ``tpu.ai/serving-slo`` node label → the ``ServingValidated``
    ClusterPolicy condition. Opt-in like the slice partitioner: serving
    fleets turn it on, training-only fleets never pay for it."""

    DEFAULT_IMAGE_ENV: str = dataclasses.field(default="VALIDATOR_IMAGE", repr=False)

    max_decode_p99_ms: float = spec_field(
        200.0, doc="SLO ceiling for p99 per-decode-step latency in "
                   "milliseconds; a probe measuring above this fails.",
        minimum=0.1, maximum=60000)
    min_throughput_tokens_per_s: float = spec_field(
        0.0, doc="SLO floor for steady-state decode throughput "
                 "(tokens/s, summed over the batch); 0 disables the "
                 "throughput gate.",
        minimum=0, maximum=10_000_000)
    min_slo_attainment: float = spec_field(
        0.99, doc="Fraction of probed decode steps that must meet the "
                  "p99 latency SLO for the node to pass.",
        minimum=0, maximum=1)
    batch_sizes: List[int] = spec_field(
        lambda: [1, 4, 8],
        doc="Batch ladder the decode probe walks; per-rung latency and "
            "throughput are measured and the worst rung gates the SLO.")
    steps_per_batch: int = spec_field(
        32, doc="Decode steps timed per batch-ladder rung (after a "
                "warm-up step).",
        minimum=4, maximum=10000)
    probe_interval_s: int = spec_field(
        0, doc="Re-run the serving probe every N seconds in the sleep "
               "container (0 = run once at node join).",
        minimum=0, maximum=86400)

    def is_enabled(self, default: bool = False) -> bool:
        # opt-in, like the slice partitioner
        return default if self.enabled is None else bool(self.enabled)

    def validate(self, path: str = "spec.serving") -> List[str]:
        errors = super().validate(path)
        for b in self.batch_sizes:
            if not isinstance(b, int) or isinstance(b, bool) or b < 1:
                errors.append(f"{path}.batchSizes: {b!r} must be a "
                              f"positive integer")
        if not self.batch_sizes:
            errors.append(f"{path}.batchSizes: must not be empty")
        return errors


@dataclasses.dataclass
class HealthSpec(SpecBase):
    """Continuous health remediation: the per-node degraded-state machine
    driven from the ClusterPolicy reconcile sweep (``health/machine.py``);
    the partitioner reads ``drainDeadlineS`` from here too."""

    enabled: bool = spec_field(
        True, doc="Drive the per-node chip-health state machine from the "
                  "reconcile sweep (degrade/quarantine/remediate nodes "
                  "whose workload barrier regresses).")
    cordon_on_quarantine: bool = spec_field(
        False, doc="Also cordon (mark unschedulable) a node while it is "
                   "quarantined or remediating; uncordoned on recovery.")
    max_remediation_attempts: int = spec_field(
        3, doc="Remediation attempts (validator-pod recycle, then driver-"
               "pod restart) before a node goes sticky failed.",
        minimum=1, maximum=10)
    remediation_wait_s: int = spec_field(
        600, doc="Budget for one remediation attempt to produce a fresh "
                 "verdict before the next attempt (or sticky failed) "
                 "fires.",
        minimum=30, maximum=86400)
    flap_window_s: int = spec_field(
        3600, doc="Flap-damping window: flapThreshold healthy->degraded "
                  "transitions inside this window trip sticky quarantine.",
        minimum=60, maximum=604800)
    flap_threshold: int = spec_field(
        3, doc="healthy->degraded transitions inside flapWindowS that "
               "trip sticky quarantine (cleared by template change or "
               "manual label clear).",
        minimum=2, maximum=100)
    drain_deadline_s: int = spec_field(
        120, doc="Coordinated drain window for planned re-tiles: before "
                 "re-tiling or recycling a workload's pods the operator "
                 "publishes a tpu.ai/planned-retile annotation + "
                 "RetilePlanned Event and waits up to this many seconds "
                 "for the workload's drain-ack (checkpoint + barrier "
                 "stamp). On expiry the re-tile proceeds anyway (fail-"
                 "safe) and the miss is counted. 0 disables coordination "
                 "(immediate re-tile).",
        minimum=0, maximum=86400)
    extra: Dict[str, Any] = spec_field(dict)


@dataclasses.dataclass
class AutoscaleSpec(SpecBase):
    """SLO-driven fleet autoscaler: close the traffic->capacity loop.
    The autoscale controller (``tpu_operator_torch/autoscale``) consumes the
    serving rollup (``tpu.ai/serving-slo-detail``) plus the traffic
    snapshot (queue depth, backlog chips, rolling attainment) and drives
    per-pool node counts — scale-up registers nodes onto the event-driven
    join path, scale-down is a planned re-tile through the drain/handoff
    protocol (never a bare delete). Opt-in like the slice partitioner:
    fixed fleets never pay for it."""

    enabled: bool = spec_field(
        False, doc="Run the fleet autoscaler controller (scale per-pool "
                   "node counts from serving SLO + traffic backlog "
                   "signals).")
    target_slo_attainment: float = spec_field(
        0.99, doc="Fleet-wide serving SLO attainment the autoscaler "
                  "defends; forecast attainment below this triggers "
                  "scale-up before p99 breaches.",
        minimum=0, maximum=1)
    headroom_pct: float = spec_field(
        20.0, doc="Capacity headroom kept above the forecast chip demand "
                  "(percent); absorbs arrival bursts inside one "
                  "decision interval.",
        minimum=0, maximum=500)
    scale_down_delay_s: int = spec_field(
        300, doc="Demand must stay below the scale-down threshold for "
                 "this long before a node is surrendered — the diurnal "
                 "trough filter that stops flap-scaling.",
        minimum=0, maximum=86400)
    cooldown_s: int = spec_field(
        60, doc="Minimum seconds between resizes of the same pool, in "
                "either direction (one in-flight resize per pool is "
                "additionally enforced).",
        minimum=0, maximum=86400)
    window_s: int = spec_field(
        600, doc="Sliding window the predictor (EWMA level + linear "
                 "trend) fits over; samples older than this age out.",
        minimum=10, maximum=86400)
    min_nodes: Dict[str, Any] = spec_field(
        dict, doc="Per-pool floor on node count (pool name -> nodes); "
                  "the key 'default' applies to unlisted pools "
                  "(built-in default 1).",
        schema={"type": "object",
                "additionalProperties": {"type": "integer", "minimum": 0}})
    max_nodes: Dict[str, Any] = spec_field(
        dict, doc="Per-pool ceiling on node count (pool name -> nodes); "
                  "the key 'default' applies to unlisted pools "
                  "(built-in default 32).",
        schema={"type": "object",
                "additionalProperties": {"type": "integer", "minimum": 0}})
    preemptible_pools: List[str] = spec_field(
        list, doc="Pools whose nodes may be revoked by the platform "
                  "without a drain plan (spot/preemptible); the "
                  "autoscaler replaces revoked capacity immediately and "
                  "never counts it toward scale-down savings.")
    extra: Dict[str, Any] = spec_field(dict)

    #: built-in bounds for pools absent from minNodes/maxNodes
    DEFAULT_MIN: int = dataclasses.field(default=1, repr=False)
    DEFAULT_MAX: int = dataclasses.field(default=32, repr=False)

    def pool_min(self, pool: str) -> int:
        m = self.min_nodes or {}
        return int(m.get(pool, m.get("default", self.DEFAULT_MIN)))

    def pool_max(self, pool: str) -> int:
        m = self.max_nodes or {}
        return int(m.get(pool, m.get("default", self.DEFAULT_MAX)))

    def is_enabled(self, default: bool = False) -> bool:
        return default if self.enabled is None else bool(self.enabled)

    def validate(self, path: str = "spec.autoscale") -> List[str]:
        errors: List[str] = []
        for field, mapping in (("minNodes", self.min_nodes),
                               ("maxNodes", self.max_nodes)):
            for pool, n in (mapping or {}).items():
                if not isinstance(n, int) or isinstance(n, bool) or n < 0:
                    errors.append(f"{path}.{field}[{pool}]: {n!r} must be "
                                  f"a non-negative integer")
        pools = set(self.min_nodes or {}) | set(self.max_nodes or {})
        for pool in sorted(pools):
            lo, hi = self.pool_min(pool), self.pool_max(pool)
            if isinstance(lo, int) and isinstance(hi, int) and lo > hi:
                errors.append(f"{path}: pool {pool!r} minNodes {lo} "
                              f"exceeds maxNodes {hi}")
        return errors


@dataclasses.dataclass
class MigrateSpec(SpecBase):
    """Cross-node workload migration (``tpu_operator_torch/migrate``):
    transparent checkpoint/restore in the CRIUgpu mold. When enabled, a
    drain deadline that expires without a workload ack is answered with an
    operator-driven snapshot request to the node's migrate agent (the
    workload never participates) instead of a bare force-retile, and the
    MigrationReconciler can move a tenant drain->transfer->restore onto
    another node's slice with zero steps lost. Opt-in like the
    autoscaler: cooperative-only fleets never pay for it."""

    enabled: bool = spec_field(
        False, doc="Run the MigrationReconciler (cross-node "
                   "drain/transfer/restore episodes driven by the "
                   "tpu.ai/migrate-request annotation) and let the "
                   "autoscaler route scale-down through it.")
    snapshot_wait_s: int = spec_field(
        30, doc="Budget for the node's migrate agent to produce a "
                "transparent snapshot after a drain deadline expires "
                "without an ack; only when this window also closes empty "
                "(or the agent reports failure) does the episode fall "
                "back to the counted force-retile. 0 disables the "
                "snapshot path (a bare force-retile).",
        minimum=0, maximum=86400)
    restore_wait_s: int = spec_field(
        120, doc="Budget for the destination node's migrate agent to "
                 "restore a transferred checkpoint before the episode "
                 "is failed (and the TPUMigrationStuck alert fires).",
        minimum=1, maximum=86400)
    extra: Dict[str, Any] = spec_field(dict)

    def is_enabled(self, default: bool = False) -> bool:
        return default if self.enabled is None else bool(self.enabled)


@dataclasses.dataclass
class PSASpec(SpecBase):
    """Pod Security Admission (reference PSASpec,
    api/nvidia/v1/clusterpolicy_types.go:208-211;
    setPodSecurityLabelsForNamespace, controllers/state_manager.go:600-648).

    Operand pods are privileged (device nodes, hostPaths); on clusters
    enforcing PSA the operator namespace must carry the privileged
    pod-security labels or every operand is rejected at admission."""

    enabled: bool = spec_field(
        False, doc="Label the operator namespace with "
                   "pod-security.kubernetes.io/{enforce,audit,warn}="
                   "privileged.")
    extra: Dict[str, Any] = spec_field(dict)


@dataclasses.dataclass
class HostPathsSpec(SpecBase):
    """Host filesystem layout overrides (reference HostPathsSpec,
    api/nvidia/v1/clusterpolicy_types.go:95-96,153; transformForHostRoot,
    controllers/object_controls.go:726-729).

    Nodes lay out the driver libraries, device nodes and writable runtime
    state differently; every operand template, validator flag and native
    binary honors these instead of compiled-in defaults. The driver
    install root falls back to ``spec.driver.installDir``."""

    validation_status_dir: str = spec_field(
        "/run/tpu/validations",
        doc="Host directory for the node-local validation status-file "
            "barriers (<component>-ready files).",
        pattern=r"^/.*$")
    driver_install_dir: Optional[str] = spec_field(
        None,
        doc="Host directory the driver libraries are installed into; unset "
            "defaults to spec.driver.installDir.",
        pattern=r"^/.*$")
    dev_globs: List[str] = spec_field(
        lambda: list(consts.GPU_DEV_GLOBS),
        doc="Glob patterns for the GPUs' device nodes on the host.")
    partition_handoff_dir: str = spec_field(
        "/var/lib/tpu-partitions",
        doc="Host directory through which the slice partitioner hands the "
            "applied partition to the device plugin.",
        pattern=r"^/.*$")
    extra: Dict[str, Any] = spec_field(dict)

    def validate(self, path: str = "spec.hostPaths") -> List[str]:
        errors = []
        for field, value in (("validationStatusDir", self.validation_status_dir),
                             ("driverInstallDir", self.driver_install_dir),
                             ("partitionHandoffDir", self.partition_handoff_dir)):
            if value is not None and not str(value).startswith("/"):
                errors.append(f"{path}.{field}: must be an absolute path")
        for g in self.dev_globs:
            if not str(g).startswith("/"):
                errors.append(f"{path}.devGlobs: {g!r} must be absolute")
            if "," in str(g):
                # the glob list travels as a comma-joined env var
                # (GPU_DEV_GLOBS) and consumers split on comma — a comma
                # inside one glob would silently corrupt discovery
                errors.append(f"{path}.devGlobs: {g!r} must not contain ','")
        if not self.dev_globs:
            errors.append(f"{path}.devGlobs: must not be empty")
        return errors


@dataclasses.dataclass
class CDISpec(SpecBase):
    """Container Device Interface spec generation (reference CDIConfigSpec)."""

    enabled: bool = spec_field(
        False, doc="Generate CDI specs for the GPUs.")
    default: bool = spec_field(
        False, doc="Use CDI as the default device-injection mechanism.")
    extra: Dict[str, Any] = spec_field(dict)


@dataclasses.dataclass
class ClusterPolicySpec(SpecBase):
    """Desired state of the cluster's GPU software stack: one sub-spec
    per operand."""

    operator: OperatorSpec = spec_field(OperatorSpec)
    daemonsets: DaemonsetsSpec = spec_field(DaemonsetsSpec)
    driver: DriverSpec = spec_field(DriverSpec)
    device_plugin: DevicePluginSpec = spec_field(DevicePluginSpec)
    feature_discovery: FeatureDiscoverySpec = spec_field(FeatureDiscoverySpec)
    telemetry: TelemetrySpec = spec_field(TelemetrySpec)
    node_status_exporter: NodeStatusExporterSpec = spec_field(NodeStatusExporterSpec)
    validator: ValidatorSpec = spec_field(ValidatorSpec)
    slice_partitioner: SlicePartitionerSpec = spec_field(SlicePartitionerSpec)
    serving: ServingSpec = spec_field(ServingSpec)
    cdi: CDISpec = spec_field(CDISpec)
    host_paths: HostPathsSpec = spec_field(HostPathsSpec)
    psa: PSASpec = spec_field(PSASpec)
    health: HealthSpec = spec_field(HealthSpec)
    autoscale: AutoscaleSpec = spec_field(AutoscaleSpec)
    migrate: MigrateSpec = spec_field(MigrateSpec)
    extra: Dict[str, Any] = spec_field(dict)

    def driver_dir(self) -> str:
        """Effective driver install root: hostPaths override, else the
        driver spec's installDir."""
        return self.host_paths.driver_install_dir or self.driver.install_dir

    def validate(self) -> List[str]:
        errors: List[str] = []
        errors += self.operator.validate()
        errors += self.daemonsets.validate()
        errors += self.driver.validate()
        errors += self.host_paths.validate()
        errors += self.autoscale.validate()
        for name in ("device_plugin", "feature_discovery", "telemetry",
                     "node_status_exporter", "validator", "slice_partitioner",
                     "serving"):
            sub: ComponentSpec = getattr(self, name)
            errors += sub.validate(f"spec.{name}")
        return errors


@dataclasses.dataclass
class ClusterPolicy:
    """Typed wrapper around the unstructured CR object."""

    name: str
    spec: ClusterPolicySpec
    obj: Dict[str, Any]

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "ClusterPolicy":
        if obj.get("kind") != CLUSTER_POLICY_KIND:
            raise SpecValidationError(f"not a ClusterPolicy: kind={obj.get('kind')!r}")
        return cls(
            name=obj.get("metadata", {}).get("name", ""),
            spec=ClusterPolicySpec.from_dict(obj.get("spec", {})),
            obj=obj,
        )

    @property
    def status(self) -> Dict[str, Any]:
        return self.obj.setdefault("status", {})

    def set_state(self, state: str, namespace: str = "") -> None:
        self.status["state"] = state
        if namespace:
            self.status["namespace"] = namespace


def new_cluster_policy(name: str = "cluster-policy", spec: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    return {
        "apiVersion": CLUSTER_POLICY_API_VERSION,
        "kind": CLUSTER_POLICY_KIND,
        "metadata": {"name": name},
        "spec": spec or {},
    }
