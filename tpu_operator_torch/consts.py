"""Constants of the port (counterpart of tpu_operator/consts.py).

The port's own copy: only what its modules use, with the accelerator names
swapped for NVIDIA's.

Keys: every ``tpu.ai/...`` label and annotation key that names the
operator's protocol stays as the reference has it: health, serving, slice
config and state, drain, migrate, template hash, trace, operand state and
spec hash. ``tpu.ai`` is the operator's API group, not the accelerator's,
and the node agents and the operator of either package read and write the
same keys. The two keys that name the accelerator on a node take NVIDIA's
(:data:`GPU_PRESENT_LABEL`, :data:`DEPLOY_LABEL_PREFIX`). Env names take
``GPU_`` where the reference's take ``TPU_``.
"""

# -- operator identity -------------------------------------------------------
OPERATOR_NAME = "gpu-operator"
NAMESPACE_ENV = "OPERATOR_NAMESPACE"
DEFAULT_NAMESPACE = "tpu-operator"

# -- labels and annotations the operator writes ---------------------------------
#: every object the state engine creates carries the state that owns it
STATE_LABEL = "tpu.ai/operator.state"
#: fingerprint of what the operator rendered for an object
SPEC_HASH_ANNOTATION = "tpu.ai/operator-spec-hash"
#: consecutive drift heals of one object (the damper's counter)
DRIFT_HEALS_ANNOTATION = "tpu.ai/operator-drift-heals"
#: set on GPU nodes (NVIDIA's operator: nvidia.com/gpu.present)
GPU_PRESENT_LABEL = "tpu.ai/gpu.present"
#: per-operand node kill switches (NVIDIA's: nvidia.com/gpu.deploy.<operand>)
DEPLOY_LABEL_PREFIX = "tpu.ai/gpu.deploy."
#: which stack provides the component on a node: "host" records adoption
#: of a platform-preinstalled driver or device plugin
DRIVER_STACK_LABEL = "tpu.ai/tpu.driver.stack"
PLUGIN_STACK_LABEL = "tpu.ai/tpu.device-plugin.stack"
#: unix seconds the labeller first saw the node: kubelets start pulling
#: operand images then
IMAGE_PREPULL_ANNOTATION = "tpu.ai/image-prepull"
#: DaemonSet labels tying a per-pool driver DaemonSet to its GPUDriver
#: instance and to the node pool it was rendered for
DRIVER_INSTANCE_LABEL = "tpu.ai/driver-instance"
NODE_POOL_LABEL = "tpu.ai/node-pool"
#: the monotonic leader epoch on the operator's Lease, bumped at every
#: acquisition; the write fence checks against it
LEADER_EPOCH_ANNOTATION = "tpu.ai/leader-epoch"
#: read by ``gpuop-cfg status``: the health machine's remediation attempts,
#: and the autoscale and migration controllers' durable state (their
#: controllers wait for their slices)
HEALTH_ATTEMPTS_ANNOTATION = "tpu.ai/health-remediation-attempts"
AUTOSCALE_STATE_ANNOTATION = "tpu.ai/autoscale-state"
MIGRATION_STATE_ANNOTATION = "tpu.ai/migration-state"

# -- the rolling driver upgrade (upgrade/machine.py) ------------------------------
#: the upgrade machine's per-node state, which ``gpuop-cfg status`` shows
UPGRADE_STATE_LABEL = "tpu.ai/tpu-driver-upgrade-state"
#: "true" on a node: the upgrade skips its drain
UPGRADE_SKIP_DRAIN_LABEL = "tpu.ai/tpu-driver-upgrade-drain.skip"
#: when the node entered its current upgrade state (RFC3339): the drain,
#: pod-deletion and wait-for-jobs budgets run from it across restarts
UPGRADE_STATE_SINCE_ANNOTATION = "tpu.ai/tpu-driver-upgrade-state-since"
#: the driver template's fingerprint when the node's upgrade failed:
#: ``upgrade-failed`` is retried only once the template changes
UPGRADE_FAILED_TEMPLATE_ANNOTATION = "tpu.ai/tpu-driver-upgrade-failed-template"
#: set once a drain budget expired and force-delete ran (the value names the
#: drain); pods still there past twice the budget then fail the node
UPGRADE_FORCE_ATTEMPTED_ANNOTATION = "tpu.ai/tpu-driver-upgrade-force-attempted"
#: the driver template the node's validator pods were recycled for: the
#: validation after an upgrade runs once per template against the new driver
UPGRADE_REVALIDATED_ANNOTATION = "tpu.ai/tpu-driver-upgrade-revalidated-for"
#: port only: whether the upgrade's own cordon may be lifted ("true": the
#: node was schedulable when its upgrade first cordoned it; "false": it was
#: cordoned already, by an admin or the health machine, and stays so).
#: Written once per stay in the machine, dropped when the node leaves it
UPGRADE_CORDONED_ANNOTATION = "tpu.ai/tpu-driver-upgrade-cordoned"
#: port only: the upgrade's own decision episode on the node, apart from
#: the health machine's :data:`PROVENANCE_EPISODE_ANNOTATION`
UPGRADE_EPISODE_ANNOTATION = "tpu.ai/upgrade-episode-id"
#: port only: a container that restarted more than this many times counts
#: as crash-looping, as one waiting in ``CrashLoopBackOff`` does: a driver
#: or validator pod of the new template that does so fails the upgrade
UPGRADE_CRASH_LOOP_RESTARTS = 3

# -- multi-node validation -------------------------------------------------------
#: nodes carrying the same value form one multi-node slice
TPU_SLICE_ID_LABEL = "tpu.ai/slice.id"
#: slice-level validation stamp (value: hash of the validated config)
MULTIHOST_VALIDATED_ANNOTATION = "tpu.ai/multihost-validated"
#: rendezvous pods: slice, worker id and the config hash their run validated
MULTIHOST_SLICE_LABEL = "tpu.ai/slice"
MULTIHOST_WORKER_ID_LABEL = "tpu.ai/worker-id"
MULTIHOST_CONFIG_HASH_ANNOTATION = "tpu.ai/config-hash"
#: torch.distributed's default rendezvous port
MASTER_PORT = 29500

# -- labels read from the platform -----------------------------------------------
#: node feature discovery's PCI vendor label for NVIDIA (0x10de), the signal
#: NVIDIA's own operator keys GPU nodes on
NFD_NVIDIA_PCI_LABEL = "feature.node.kubernetes.io/pci-10de.present"
#: GKE's accelerator label value prefix on NVIDIA nodes (nvidia-h100-80gb)
GKE_NVIDIA_PREFIX = "nvidia-"

#: operand names, for deploy labels and state wiring
OPERANDS = (
    "driver",
    "device-plugin",
    "feature-discovery",
    "telemetry",
    "node-status-exporter",
    "operator-validator",
    "slice-partitioner",
    "serving",
)


def deploy_label(operand: str) -> str:
    return DEPLOY_LABEL_PREFIX + operand

# -- node-local paths ---------------------------------------------------------
#: status-file barrier dir (same layout as the TPU operator's, so one set
#: of barrier readers serves both)
VALIDATION_STATUS_DIR = "/run/tpu/validations"
#: where the NVIDIA driver's user-space library lives on a GPU node
DEFAULT_DRIVER_LIB_DIR = "/usr/lib/x86_64-linux-gnu"
#: the CUDA driver library whose presence marks the driver as installed
DRIVER_LIB = "libcuda.so.1"
#: per-GPU device nodes; ``/dev/nvidiactl`` and ``/dev/nvidia-uvm``, the
#: control and unified-memory nodes every CUDA process also opens, are not
#: per-GPU and so never counted
GPU_DEV_GLOBS = ("/dev/nvidia[0-9]*",)
#: env override for GPU_DEV_GLOBS (comma-separated)
GPU_DEV_GLOBS_ENV = "GPU_DEV_GLOBS"

#: schedulable extended resource
GPU_RESOURCE_NAME = "nvidia.com/gpu"

# -- build cache ----------------------------------------------------------------
#: host-path directory the CUDA sources are built into, so that a prewarm
#: (or any earlier validation) leaves libraries a later process loads
#: without ``nvcc``; unset means the build directory under the checkout
COMPILATION_CACHE_DIR_ENV = "GPU_COMPILATION_CACHE_DIR"

# -- node health and serving ----------------------------------------------------
#: per-node chip-health state machine label (healthy -> degraded ->
#: quarantined -> remediating -> recovered | failed)
HEALTH_STATE_LABEL = "tpu.ai/health-state"
#: pod env that carries the node's health state when the template stamps it
HEALTH_STATE_ENV = "GPU_HEALTH_STATE"
#: when the node entered its current health state (RFC3339); drives the
#: confirmation and remediation-wait budgets across operator restarts
HEALTH_STATE_SINCE_ANNOTATION = "tpu.ai/health-state-since"
#: the flap damper: comma-joined epoch seconds of recent healthy->degraded
#: transitions; N inside the window trip sticky quarantine
HEALTH_FLAP_HISTORY_ANNOTATION = "tpu.ai/health-flap-history"
#: set when flap damping tripped: the machine writes nothing for the node
#: until an admin clears the health label or the driver template changes
HEALTH_FLAP_STICKY_ANNOTATION = "tpu.ai/health-flap-sticky"
#: the driver DaemonSet's template fingerprint when remediation ran out:
#: sticky ``failed`` clears only when it changes (or the admin clears the
#: health label)
HEALTH_FAILED_TEMPLATE_ANNOTATION = "tpu.ai/health-failed-template"
#: pod env that carries the node template hash the serving probe ran under
TEMPLATE_HASH_ENV = "GPU_TEMPLATE_HASH"
#: the node's serving-barrier verdict ("passed" | "failed" | "corrupt")
SERVING_SLO_LABEL = "tpu.ai/serving-slo"
#: measured serving numbers for the verdict label (annotation: commas and
#: decimals are not label-safe)
SERVING_SLO_ANNOTATION = "tpu.ai/serving-slo-detail"
#: the node's measured latency-vs-throughput curve, compact codec
#: (serving/frontier.py)
SERVING_FRONTIER_ANNOTATION = "tpu.ai/serving-frontier"
#: operator -> node-agent re-probe request (template hash that invalidated
#: the node's frontier)
SERVING_REPROBE_ANNOTATION = "tpu.ai/serving-reprobe"
#: operator label carrying the node's operand template hash; a frontier
#: measured under it satisfies a pending re-probe request
TEMPLATE_HASH_LABEL = "tpu.ai/template-hash"

# -- node identity (feature discovery) -------------------------------------------
#: GKE's accelerator name for the node's GPUs ("nvidia-h100-80gb")
TPU_CHIP_TYPE_LABEL = "tpu.ai/tpu.chip-type"
TPU_CHIP_COUNT_LABEL = "tpu.ai/tpu.chip-count"
#: device memory per GPU, whole GiB ("80Gi")
TPU_MEMORY_LABEL = "tpu.ai/tpu.memory"
#: the driver version an installer recorded in the driver barrier
TPU_LIBTPU_VERSION_LABEL = "tpu.ai/libtpu.version"
#: GKE's own accelerator label on GPU nodes, passed through as the chip type
GKE_ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"

# -- barrier verdicts and join spans mirrored to the node -----------------------
#: the node's workload-barrier verdict, published by feature discovery for
#: the operator's health sweep: "passed" | "failed" | "failed:<gpu,gpu>" |
#: "corrupt"
WORKLOAD_HEALTH_ANNOTATION = "tpu.ai/workload-health"
#: compact span records mirrored up from the node's host-path span log
#: (``trace-spans.json``), so the operator's join profiler can stitch the
#: node side into the join trace
TRACE_SPANS_ANNOTATION = "tpu.ai/trace-spans"
#: env carrying the operator's join trace context into operand pods
TRACE_PARENT_ENV = "GPU_TRACE_PARENT"
#: an Event's annotation naming the trace it was recorded in
TRACE_ID_ANNOTATION = "tpu.ai/trace-id"

# -- decision provenance ---------------------------------------------------------
#: the episode a node's current incident belongs to: stamped by whichever
#: reconciler opens the episode (the health machine here), read by the
#: others so their decision records chain into it; cleared when the
#: episode ends
PROVENANCE_EPISODE_ANNOTATION = "tpu.ai/episode-id"
#: label on the journal's mirror ConfigMaps (value: the recording
#: subsystem), so the cluster-side journal is one label selector away
PROVENANCE_LABEL = "tpu.ai/provenance"
#: the operator's on-disk journal (JSONL), which survives its restarts;
#: unset keeps the journal in memory and in its mirror ConfigMaps
JOURNAL_PATH_ENV = "GPU_OPERATOR_JOURNAL_PATH"

# -- coordinated drain (planned re-tiles) -----------------------------------------
#: a published re-tile plan (JSON: layout fingerprint, drain deadline,
#: reason, blocked GPUs)
RETILE_PLAN_ANNOTATION = "tpu.ai/planned-retile"
#: the node's drain ack, mirrored by feature discovery from the workload
#: barrier's ``drain_ack`` stamp (its node-local source of truth)
DRAIN_ACK_ANNOTATION = "tpu.ai/drain-ack"
#: host-path file under the status dir that an agent checkpoints into
#: before it acks a drain
DRAIN_CHECKPOINT_FILE = "drain-checkpoint.json"

# -- steady state ---------------------------------------------------------------
#: sleep mode's revalidation period in seconds (0 = off)
REVALIDATE_INTERVAL_ENV = "GPU_REVALIDATE_INTERVAL"

# -- one GPU order everywhere -------------------------------------------------------
#: CUDA's default device order (FASTEST_FIRST) is bound neither to minor
#: numbers nor to PCI order; every sweep process the port starts runs with
#: PCI order unless its caller chose, so that CUDA ordinal i, the device
#: plugin's unit i (NVML's GPUs in PCI order) and a barrier's local chip i
#: name one GPU
CUDA_DEVICE_ORDER_ENV = "CUDA_DEVICE_ORDER"
CUDA_DEVICE_ORDER = "PCI_BUS_ID"

# -- device plumbing (device plugin, CDI, telemetry) ------------------------------
#: the host's device directory
DEV_DIR = "/dev"
#: one GPU's own device node, by its minor number (NVML's, nvidia-smi -q's)
GPU_DEV_NODE = "nvidia{minor}"
#: control nodes every CUDA process opens, not per-GPU: handed to every
#: container that gets a GPU, those present on the host
GPU_CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")
#: the driver's user-space files a GPU container needs, mounted read-only
#: one by one (the directory holding them holds the host's libc too), with
#: the file libcuda.so.1 resolves to
DRIVER_LIB_FILES = ("libcuda.so.1", "libnvidia-ml.so.1")
#: CDI kind of the node's GPUs
CDI_KIND = GPU_RESOURCE_NAME
#: the kubelet's registration socket, in its device-plugin dir
KUBELET_SOCKET = "/var/lib/kubelet/device-plugins/kubelet.sock"
#: the device plugin's socket in that dir
PLUGIN_SOCKET_NAME = "gpu.sock"
#: host-path dir the partitioner publishes applied partitions in (the same
#: path as the TPU operator's, like the status dir)
DEFAULT_HANDOFF_DIR = "/var/lib/tpu-partitions"
HANDOFF_DIR_ENV = "GPU_HANDOFF_DIR"
#: device plugin: Allocate names CDI devices instead of device specs ("1")
USE_CDI_ENV = "GPU_USE_CDI"
#: device plugin: "mounts" hands device paths over as read-only bind
#: mounts (for fake device files, which runtimes refuse as devices)
PLUGIN_DEVICE_INJECTION_ENV = "GPU_PLUGIN_DEVICE_INJECTION"
#: device plugin tunables file (healthIntervalS, absenceGraceS)
PLUGIN_CONFIG_ENV = "GPU_PLUGIN_CONFIG"
#: telemetry custom-metrics config file
TELEMETRY_CONFIG_ENV = "GPU_TELEMETRY_CONFIG"
#: telemetry: a runtime metrics endpoint to scrape (unset: none)
RUNTIME_METRICS_URL_ENV = "GPU_RUNTIME_METRICS_URL"

# -- slice partitioner ------------------------------------------------------------
#: the partition a node should carry (set by the admin or the ClusterPolicy)
TPU_SLICE_CONFIG_LABEL = "tpu.ai/slice.config"
#: the partitioner's progress on it: pending -> success | retiled | failed
TPU_SLICE_STATE_LABEL = "tpu.ai/slice.config.state"
#: the partition table file (the slice-partitioner ConfigMap's mount);
#: unset: the port's default table
PARTITION_CONFIG_ENV = "GPU_PARTITION_CONFIG"
#: seconds a health-gated re-tile waits for the workload's drain ack (0: none)
DRAIN_DEADLINE_ENV = "GPU_DRAIN_DEADLINE_S"

# -- driver installer and native binaries ------------------------------------------
#: a directory of the user-space driver libraries the operand image bundles
DRIVER_SRC_ENV = "GPU_DRIVER_SRC"
#: the driver version to record when ``--driver-version`` is not given
DRIVER_VERSION_ENV = "GPU_DRIVER_VERSION"
#: the driver daemon writes the CDI spec after its install ("1")
CDI_ENABLED_ENV = "GPU_CDI_ENABLED"
CDI_DIR_ENV = "GPU_CDI_DIR"
#: explicit paths of the native probe and exporter
PROBE_BIN_ENV = "GPU_PROBE_BIN"
EXPORTER_BIN_ENV = "GPU_EXPORTER_BIN"
#: "0" keeps ``-c metrics`` on the Python exporter
NATIVE_EXPORTER_ENV = "GPU_NATIVE_EXPORTER"

# -- migrate agent -------------------------------------------------------------------
#: operator -> source node: take a transparent snapshot for this plan
MIGRATE_SNAPSHOT_REQUEST_ANNOTATION = "tpu.ai/migrate-snapshot-request"
#: source node -> operator: the snapshot's outcome
MIGRATE_SNAPSHOT_RESULT_ANNOTATION = "tpu.ai/migrate-snapshot-result"
#: operator -> destination node: restore this inbound migration
MIGRATION_INBOUND_ANNOTATION = "tpu.ai/migration-inbound"
#: destination node -> operator: the restore's outcome
MIGRATION_RESTORE_ANNOTATION = "tpu.ai/migration-restore"
#: the process-state mirror file the training harness keeps under the
#: status dir: the stand-in for process memory a snapshot dumps
MIGRATE_PROCESS_STATE_FILE = "process-state.json"

# -- the operator's own operand pods ---------------------------------------------------
#: every ``app.kubernetes.io/component`` value the operand DaemonSets stamp
#: on their pods (manifests/*/0500_daemonset.yaml). An eviction sweep exempts
#: only these, in the operator's namespace, plus DaemonSet-owned and mirror
#: pods: the label's presence alone is no ownership, and a user's GPU
#: workload labelled ``component=web`` is still drained
OPERAND_COMPONENTS = frozenset({
    "gpu-driver", "gpu-device-plugin", "gpu-operator-validator",
    "gpu-telemetry", "gpu-feature-discovery", "gpu-slice-partitioner",
    "gpu-node-status-exporter", "gpu-serving-validator",
})


def drain_exempt(pod: dict, namespace: str) -> bool:
    """Whether no eviction sweep may target ``pod``: DaemonSet-owned and
    static (mirror) pods, as ``kubectl drain`` skips them, and the
    operator's own operand pods, by namespace and a component of
    :data:`OPERAND_COMPONENTS`."""
    meta = pod.get("metadata") or {}
    for ref in meta.get("ownerReferences") or []:
        if ref.get("kind") == "DaemonSet" and ref.get("controller"):
            return True
    if (meta.get("annotations") or {}).get("kubernetes.io/config.mirror"):
        return True
    component = (meta.get("labels") or {}).get("app.kubernetes.io/component")
    return meta.get("namespace") == namespace and component in OPERAND_COMPONENTS
