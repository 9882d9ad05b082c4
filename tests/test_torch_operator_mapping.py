"""The one mapping from the reference (TPU) operator's inputs and outputs to
the port's (GPU) ones, shared by every operator parity test
(tests/test_torch_operator_*.py, tests/test_torch_gpudriver_controller.py,
tests/test_torch_schema.py, tests/test_torch_cfgtool.py and the health,
provenance and ``/debug`` twins): a ClusterPolicy
spec, a Node, a rendered or applied object, the per-pool driver CR and its
objects, a CRD, ``gpuop-cfg``'s output. Each deliberate difference of the
port is written here once; a parity test maps the reference's side and
requires equality. The per-pool driver's renames: the kind ``TPUDriver``
is ``GPUDriver`` (group and version kept), ``libtpuVersion`` is
``driverVersion``, pools are keyed on the GPU model (:func:`map_pool_name`)
and a pool's DaemonSet is ``gpu-driver-<instance>-<pool>``
(:func:`map_driver_object`); ``validate-partitions`` takes a link class
and a GPU count (:data:`PARTITION_NODES`). The health section states the
GPU-health machine's renames (the pods it recycles, the texts naming GPUs)
and its one deliberate difference, each episode's own id; the upgrade
section its renames, its keys and the three faults of the reference's
upgrade the port does not copy; :data:`DEBUG_ROUTES_LEFT_OUT` the
``/debug`` routes the port does not serve; the autoscale section the
autoscaler's two differences (``nvidia.com/gpu`` capacity, a GPU count by
default) and the names of the nodes it registers; the client-chain section
four faults of the reference's the port repairs; the simulator section the
fleet simulator's GPU fleet and the traffic mix's fallback layout; the
static-checker section each linter's names, the two rules whose idiom the
port maps and what "registered" means for the port's own metric families.
The tests at the end hold the mapping itself: it changes nothing the
port already renders, and it leaves no TPU name behind in what it maps.
"""

import ast
import copy
import json
import re
from pathlib import Path

import yaml

from tpu_operator_torch import consts
from tpu_operator_torch.partitioner.partitioner import DEFAULT_PARTITIONS
from tpu_operator_torch.utils import template_fingerprint

#: the reference's TPU accelerator values -> a GPU model each (GKE's label
#: values), one to one, so node pools map to node pools
ACCELERATORS = {
    "tpu-v5-lite-podslice": "nvidia-h100-80gb",
    "tpu-v5p-slice": "nvidia-a100-80gb",
    "tpu-v4-podslice": "nvidia-l4",
    "tpu-v6e-slice": "nvidia-h200-141gb",
}

#: string rules, in order, applied to every string of a mapped object (keys
#: and values): (pattern, replacement)
STRING_RULES = [
    # the resource, the presence and deploy labels (the two keys this slice
    # renames), the validator binary and its build cache
    (r"google\.com/tpu", consts.GPU_RESOURCE_NAME),
    (r"^tpu\.ai/tpu\.present$", consts.GPU_PRESENT_LABEL),
    (r"^tpu\.ai/tpu\.deploy\.", consts.DEPLOY_LABEL_PREFIX),
    (r"^tpu-validator$", "gpu-validator"),
    (r"/var/cache/tpu-xla", "/var/cache/gpu-kernels"),
    (r"^xla-cache$", "kernel-cache"),
    # the driver: its library dir, version flag, names and device globs
    (r"/home/kubernetes/bin/libtpu", consts.DEFAULT_DRIVER_LIB_DIR),
    (r"^--libtpu-version=", "--driver-version="),
    (r"^/dev/accel\*,/dev/vfio/\*$", ",".join(consts.GPU_DEV_GLOBS)),
    (r"^libtpu-driver$", "gpu-driver"),
    (r"^libtpu-installer$", "gpu-driver-installer"),
    # env names: GPU_ where the reference's take TPU_ (the host driver
    # probe paths name the driver library, not libtpu)
    (r"^TPU_HOST_LIBTPU_PATHS$", "GPU_HOST_DRIVER_PATHS"),
    (r"^TPU_(?=[A-Z])", "GPU_"),
    # object, app, container and group names take gpu-
    (r"^tpu-(?=[a-z])", "gpu-"),
    (r"/etc/tpu-", "/etc/gpu-"),
    (r"^Priority class for tpu-operator ", "Priority class for gpu-operator "),
    (r'job="tpu-', 'job="gpu-'),
    # the per-pool driver kind, in kinds and in messages
    (r"TPUDriver", "GPUDriver"),
]

#: fields whose values keep the reference's (the operator's namespace)
KEEP_KEYS = {"namespace"}

#: each host path where the reference's driver check looks for libtpu (its
#: TPU_HOST_LIBTPU_PATHS, under the host root at /host) -> where the port's
#: looks for the CUDA driver library in the same place, in the same order
HOST_LIBRARY_PATHS = {
    # GKE's node image: the platform's driver install dir
    "/host/home/kubernetes/bin/libtpu.so": ["/host/home/kubernetes/bin/nvidia/lib64/libcuda.so.1"],
    # the distribution's library dir (Debian/Ubuntu, then RHEL)
    "/host/usr/lib/libtpu.so": ["/host/usr/lib/x86_64-linux-gnu/libcuda.so.1",
                                "/host/usr/lib64/libcuda.so.1"],
    # a local install beside the distribution's
    "/host/usr/local/lib/libtpu/libtpu.so": ["/host/usr/local/nvidia/lib64/libcuda.so.1"],
}


def _map_string(text: str) -> str:
    for pattern, repl in STRING_RULES:
        text = re.sub(pattern, repl, text)
    return text


def _map_value(value, key=None):
    if isinstance(value, dict):
        out = {_map_string(k): _map_value(v, k) for k, v in value.items()}
        if out.get("name") == consts.NAMESPACE_ENV and "value" in value:
            out["value"] = value["value"]  # the namespace itself stays
        if out.get("name") == "GPU_HOST_DRIVER_PATHS":
            out["value"] = ":".join(path for ref in value["value"].split(":")
                                    for path in HOST_LIBRARY_PATHS[ref])
        return out
    if isinstance(value, list):
        return [_map_value(v, key) for v in value]
    if isinstance(value, str) and key not in KEEP_KEYS:
        return _map_string(value)
    return value


def map_object(obj: dict) -> dict:
    """A reference rendered or applied object as the port renders it."""
    out = _map_value(copy.deepcopy(obj))
    if out.get("kind") == "ConfigMap" and "config.yaml" in (out.get("data") or {}):
        # a config payload is JSON text (the reference writes YAML), and the
        # default partition table is the port's: GPU groups over NVML's
        # links, not v5e sub-slices
        payload = yaml.safe_load(obj["data"]["config.yaml"]) or {}
        if isinstance(payload, dict) and "v5e-2x2-pair" in (payload.get("partitions") or {}):
            payload = {"version": "v1", "partitions": DEFAULT_PARTITIONS}
        out["data"]["config.yaml"] = json.dumps(payload, sort_keys=True)
    if out.get("kind") == "DaemonSet" and out["metadata"]["name"] == "gpu-operator-validator":
        # the revalidation interval is rendered at 0 too (the reference
        # leaves it out, and its CLI's default of 300 turns "off" on)
        env = out["spec"]["template"]["spec"]["containers"][0]["env"]
        if not any(e["name"] == "GPU_REVALIDATE_INTERVAL" for e in env):
            env.append({"name": "GPU_REVALIDATE_INTERVAL", "value": "0"})
    if out.get("kind") == "PrometheusRule":
        for group in out["spec"]["groups"]:
            for rule in group["rules"]:
                rule["annotations"] = {k: map_alert_text(v)
                                       for k, v in rule["annotations"].items()}
    tpl = out.get("spec", {}).get("template")
    labels = (tpl or {}).get("metadata", {}).get("labels") or {}
    if consts.TEMPLATE_HASH_LABEL in labels:
        labels[consts.TEMPLATE_HASH_LABEL] = template_fingerprint(tpl)
    return out


def map_spec(spec: dict) -> dict:
    """A reference ClusterPolicy spec as the port's CR states it."""
    out = copy.deepcopy(spec)
    driver = out.get("driver") or {}
    if "libtpuVersion" in driver:
        driver["driverVersion"] = driver.pop("libtpuVersion")
    host = out.get("hostPaths") or {}
    if "libtpuInstallDir" in host:
        host["driverInstallDir"] = host.pop("libtpuInstallDir")
    if host.get("devGlobs") == ["/dev/accel*", "/dev/vfio/*"]:
        host["devGlobs"] = list(consts.GPU_DEV_GLOBS)
    plugin = out.get("devicePlugin") or {}
    if plugin.get("resourceName") == "google.com/tpu":
        plugin["resourceName"] = consts.GPU_RESOURCE_NAME
    return out


def map_labels(labels: dict) -> dict:
    """A reference node's labels (or a selector over them) as the port's:
    the accelerator label names the GPU model, there is no slice topology
    label, and the presence and deploy labels are renamed."""
    mapped = {}
    for key, value in labels.items():
        if key == "cloud.google.com/gke-tpu-accelerator":
            mapped[consts.GKE_ACCELERATOR_LABEL] = ACCELERATORS[value]
        elif key == "cloud.google.com/gke-tpu-topology":
            continue  # a GPU node has no slice topology label
        elif key == consts.TPU_CHIP_TYPE_LABEL:
            mapped[key] = ACCELERATORS.get(value, value)
        else:
            mapped[_map_string(key)] = value
    return mapped


def map_node(node: dict) -> dict:
    """A reference TPU Node as the same node with GPUs."""
    out = copy.deepcopy(node)
    labels = out.setdefault("metadata", {}).get("labels") or {}
    if "labels" in out["metadata"]:
        out["metadata"]["labels"] = map_labels(labels)
    for field in ("capacity", "allocatable"):
        section = (out.get("status") or {}).get(field)
        if section and "google.com/tpu" in section:
            section[consts.GPU_RESOURCE_NAME] = section.pop("google.com/tpu")
    return out


def map_crash_site(site: str) -> str:
    """A reference crash-point site (``client/chaos.py:crash_site``: ``VERB
    Kind/name [leaf paths]``) as the port's same write: the object's name
    and each label or annotation key of a patch renamed, the paths sorted
    again."""
    head, _, paths = site.partition(" [")
    verb, _, target = head.partition(" ")
    kind, _, name = target.partition("/")
    if kind != "Event":
        head = f"{verb} {kind}/{_map_string(name)}"
    if not paths:
        return head
    mapped = []
    for path in paths.rstrip("]").split(","):
        for prefix in ("metadata.labels.", "metadata.annotations."):
            if path.startswith(prefix):
                path = prefix + _map_string(path[len(prefix):])
                break
        mapped.append(path)
    return f"{head} [{','.join(sorted(mapped))}]"


def number_journal_sites(sites: list) -> list:
    """Crash sites with each decision journal mirror write (a provenance
    ConfigMap) named by its order among them: the reference keys one on
    its name, the record's content address, and the port on its record's
    decision (``client/chaos.py:crash_site``; a port health episode's id
    holds the node's ``-since`` stamp, so its names change from run to
    run). Neither name maps to the other; the writes line up one for one."""
    order: dict = {}

    def number(site):
        if not re.fullmatch(r"POST ConfigMap/prov[-:]\S+", site):
            return site
        return f"POST ConfigMap/prov-#{order.setdefault(site, len(order))}"
    return [number(x) for x in sites]


# -- the per-pool driver (TPUDriver -> GPUDriver) ---------------------------------

#: the reference samples' libtpu build -> the driver version the port's
#: samples name (``gpuop-cfg sample``)
SAMPLE_DRIVER_VERSIONS = {"2025.1.0": "580.95.05"}
#: the reference samples' TPUDriver instance -> the port's
SAMPLE_INSTANCES = {"v5e-pool": "h100-pool"}


#: ``validate-partitions``' node: the reference checks a table against a TPU
#: generation's chip grid (``--accelerator``, ``--chips``); the port has no
#: chip grid and checks it on N GPUs of one link class (``--link``,
#: ``--gpus``): (accelerator, chips) -> (link class, GPUs)
PARTITION_NODES = {("tpu-v5-lite-podslice", 8): ("nvlink", 8),
                   ("tpu-v4-podslice", 4): ("pcie-switch", 4)}


def map_partition_args(argv: list) -> list:
    """``tpuop-cfg validate-partitions`` arguments as ``gpuop-cfg``'s."""
    args = list(argv)
    accelerator, chips = "tpu-v5-lite-podslice", 8
    if "--accelerator" in args:
        i = args.index("--accelerator")
        accelerator = args.pop(i + 1)
        args.pop(i)
    if "--chips" in args:
        i = args.index("--chips")
        chips = int(args.pop(i + 1))
        args.pop(i)
    link, gpus = PARTITION_NODES[(accelerator, chips)]
    if (link, gpus) == ("nvlink", 8):
        return args  # gpuop-cfg's defaults
    return args + ["--link", link, "--gpus", str(gpus)]


def map_pool_name(name: str) -> str:
    """A reference pool name (the accelerator without ``tpu-``, then the
    slice topology) as the port's: pools are keyed on the GPU model alone,
    so two reference pools of one accelerator are one port pool (the tests
    give each accelerator one topology)."""
    from tpu_operator_torch.state.nodepool import sanitize_name

    for accelerator, gpu in ACCELERATORS.items():
        stem = accelerator.removeprefix("tpu-")
        if name == stem or name.startswith(stem + "-"):
            return sanitize_name(gpu)
    raise KeyError(f"no accelerator for pool {name!r}")


def map_driver_spec(spec: dict) -> dict:
    """A TPUDriver spec as the GPUDriver's: ``driverVersion`` for
    ``libtpuVersion``, the node selector over the port's labels, names and
    paths through the string rules."""
    out = _map_value(copy.deepcopy(spec))
    if "libtpuVersion" in out:
        out["driverVersion"] = out.pop("libtpuVersion")
    if "nodeSelector" in spec:
        out["nodeSelector"] = map_labels(spec["nodeSelector"])
    return out


def map_driver(obj: dict) -> dict:
    """A TPUDriver CR as the GPUDriver the port is given."""
    out = copy.deepcopy(obj)
    out["kind"] = _map_string(obj["kind"])
    out["spec"] = map_driver_spec(obj.get("spec") or {})
    if "status" in obj:
        out["status"] = map_driver_status(obj["status"])
    return out


def map_driver_status(status: dict) -> dict:
    out = _map_value(copy.deepcopy(status))
    if "pools" in status:
        out["pools"] = {map_pool_name(k): v for k, v in status["pools"].items()}
    return out


def map_driver_object(obj: dict, instance: str) -> dict:
    """An object the TPUDriver controller applied for ``instance`` as the
    GPUDriver controller applies it: ``libtpu-driver-<instance>-<pool>``
    becomes ``gpu-driver-<instance>-<GPU-model pool>``, the owning state
    ``tpudriver-<instance>`` becomes ``gpudriver-<instance>``, and the pool
    label and the pool's node selector name the GPU model."""
    prefix = f"libtpu-driver-{instance}-"

    def rename(value):
        if isinstance(value, dict):
            return {k: rename(v) for k, v in value.items()}
        if isinstance(value, list):
            return [rename(v) for v in value]
        if isinstance(value, str) and value.startswith(prefix):
            return f"gpu-driver-{instance}-{map_pool_name(value[len(prefix):])}"
        if value == f"tpudriver-{instance}":
            return f"gpudriver-{instance}"
        return value

    out = map_object(rename(copy.deepcopy(obj)))
    labels = out["metadata"].get("labels") or {}
    if consts.NODE_POOL_LABEL in labels:
        labels[consts.NODE_POOL_LABEL] = map_pool_name(labels[consts.NODE_POOL_LABEL])
    pod = (out.get("spec") or {}).get("template", {}).get("spec")
    if pod and "nodeSelector" in pod:
        ref_selector = obj["spec"]["template"]["spec"]["nodeSelector"]
        pod["nodeSelector"] = map_labels(ref_selector)
    tpl = (out.get("spec") or {}).get("template")
    tpl_labels = (tpl or {}).get("metadata", {}).get("labels") or {}
    if consts.TEMPLATE_HASH_LABEL in tpl_labels:
        tpl_labels[consts.TEMPLATE_HASH_LABEL] = template_fingerprint(tpl)
    return out


def add_driver_own_settings(ds: dict, spec: dict) -> dict:
    """A reference pool DaemonSet (already mapped) as the port renders it
    for a GPUDriver whose spec has its own ``labels``, ``annotations``,
    ``tolerations``, ``nodeAffinity`` and ``priorityClassName``: the
    reference's TPUDriverReconciler drops all five
    (tpu_operator/controllers/tpudriver_controller.py), the port's
    DaemonSet carries them (the labels on the DaemonSet, the rest on its
    pod template; tolerations and annotations beside the ClusterPolicy's,
    the priority class in place of it)."""
    out = copy.deepcopy(ds)
    out["metadata"].setdefault("labels", {}).update(spec.get("labels") or {})
    tpl = out["spec"]["template"]
    if spec.get("annotations"):
        tpl["metadata"].setdefault("annotations", {}).update(spec["annotations"])
    pod = tpl["spec"]
    pod["tolerations"] = pod.get("tolerations", []) + [
        t for t in spec.get("tolerations") or [] if t not in pod.get("tolerations", [])]
    if spec.get("nodeAffinity"):
        pod["affinity"] = {"nodeAffinity": spec["nodeAffinity"]}
    if spec.get("priorityClassName"):
        pod["priorityClassName"] = spec["priorityClassName"]
    labels = tpl["metadata"].get("labels") or {}
    if consts.TEMPLATE_HASH_LABEL in labels:
        labels[consts.TEMPLATE_HASH_LABEL] = template_fingerprint(tpl)
    return out


# -- the GPU-health machine and its journal ---------------------------------------

#: the pods the health machine recycles, by component label: the
#: reference's validator and libtpu driver pods -> the port's validator
#: (manifests/state-operator-validation) and driver (manifests/state-driver)
HEALTH_COMPONENTS = {"tpu-operator-validator": "gpu-operator-validator",
                     "tpu-driver": "gpu-driver"}

#: the health machine's Event and condition texts name GPUs where the
#: reference's name chips (a decision record's ``blocked_chips`` input is
#: ``blocked_gpus``)
HEALTH_TEXT_RULES = [
    ("chip failure confirmed", "GPU failure confirmed"),
    ("(chips [", "(GPUs ["),
    (", chips [", ", GPUs ["),
    ("node chip-health: ", "node GPU health: "),
    ("blocked_chips", "blocked_gpus"),
]


def map_health_text(text: str) -> str:
    """A reference health Event message, condition message or rendered
    decision record as the port writes it."""
    for old, new in HEALTH_TEXT_RULES:
        text = text.replace(old, new)
    return text


# The health machine's one deliberate difference in behaviour: each
# episode has its own id. The reference mints ``episode_id("health",
# node, verdict)`` (tpu_operator/health/machine.py:
# HealthStateMachine._episode_for), so a node's second episode with the
# same verdict string rejoins its first, closed one: the journal drops the
# new episode's records as crash replays, and the protocol Events'
# exactly-once tokens (the plan fingerprint, ``attempt-N``) collide with
# the first episode's, so the second's RetilePlanned,
# RetileDeadlineExpired and first NodeHealthRemediating are never
# announced. The port's id also holds the node's
# ``tpu.ai/health-state-since`` as read when it is first minted, and its
# tokens are ``<episode>:<token>``. Episode ids therefore differ between
# the packages; the twin tests compare them by order of appearance. An
# admin's label clear out of sticky ``failed`` leaves the reference's
# stamped id behind, so the next episode would adopt the closed one
# (:func:`map_health_node_annotations`); the port wipes it with the rest.


def map_health_node_annotations(state: str, annotations: dict) -> dict:
    """A reference node's annotations after a health sweep as the port
    leaves them: a healthy node (no health label) carries no episode id."""
    if state:
        return dict(annotations)
    return {k: v for k, v in annotations.items() if k != consts.PROVENANCE_EPISODE_ANNOTATION}


# -- the rolling driver upgrade ----------------------------------------------------
#
# Kept: the protocol keys tpu.ai/tpu-driver-upgrade-state, -drain.skip,
# -state-since, -failed-template, -force-attempted and -revalidated-for; the
# five tpu_operator_nodes_upgrades_* gauges; the Event reasons
# UpgradeDrainForced, UpgradeDrainFailed, UpgradeWaitForJobsTimeout and
# DriverUpgradeFailed. Renamed: the driver and validator components
# (:data:`HEALTH_COMPONENTS`), a consumer pod is one requesting
# nvidia.com/gpu, nodes are picked by ``nodeinfo.is_gpu_node`` and pools by
# GPUDriver instances, the resync period is $GPU_OPERATOR_RESYNC_S. The
# machine's and the Events' texts (:func:`map_upgrade_text`).
#
# Four faults of the reference the port does not copy, each pinned by its
# own test in tests/test_torch_upgrade.py (the fourth in
# tests/test_torch_upgrade_recycle.py):
# - the upgrade lifts only the cordon it set. The reference uncordons at
#   uncordon-required and in clear_all whatever cordoned the node
#   (tpu_operator/upgrade/machine.py: UpgradeStateMachine._process_node,
#   clear_all). The port records on the node, when its upgrade first cordons
#   it, whether it was schedulable (:data:`UPGRADE_PORT_KEYS`); a node the
#   reference's tests set mid-upgrade and cordoned carries that record on the
#   port's side (:func:`upgrade_cordon_record`);
# - a crash-looping new driver or validator pod fails the upgrade: a
#   container waiting in CrashLoopBackOff, or restarted more than
#   :data:`UPGRADE_CRASH_LOOP_RESTARTS` times, counts as phase Failed does
#   (the reference: ``_process_node``'s pod-restart-required, which reads the
#   phase only, and validation-required, which waits on Ready without end),
#   and a driver pod restarting in place is no way out of upgrade-failed;
# - the upgrade keeps its own episode id (tpu.ai/upgrade-episode-id) where
#   the reference adopts and clears the health machine's tpu.ai/episode-id
#   (``_episode_for``, ``_set_state``): :func:`map_upgrade_node_annotations`;
# - a node is certified only by validator pods its recycle did not delete:
#   the recycle records the uids it deleted
#   (tpu.ai/tpu-driver-upgrade-recycled-validators, in
#   :data:`UPGRADE_PORT_KEYS`, written and cleared with -revalidated-for)
#   and none of them counts, where the reference skips only pods marked
#   terminating and certifies on recycled validators a cache still lists
#   (``_process_node``'s validation-required).

#: a container restarted more than this many times is crash-looping
UPGRADE_CRASH_LOOP_RESTARTS = consts.UPGRADE_CRASH_LOOP_RESTARTS

#: the port's additions to the upgrade's keys
UPGRADE_PORT_KEYS = {consts.UPGRADE_CORDONED_ANNOTATION, consts.UPGRADE_EPISODE_ANNOTATION,
                     consts.UPGRADE_RECYCLED_VALIDATORS_ANNOTATION}

#: the upgrade's texts: (the reference's, the port's)
UPGRADE_TEXT_RULES = [
    ("TPU-consumer pod deletion", "GPU-consumer pod deletion"),
    ("driver pod entered Failed during upgrade on",
     "driver pod failed or crash-looping during upgrade on"),
]


def map_upgrade_text(text: str) -> str:
    """A reference upgrade Event message as the port writes it."""
    for old, new in UPGRADE_TEXT_RULES:
        text = text.replace(old, new)
    return text


def map_upgrade_node_annotations(annotations: dict) -> dict:
    """A reference node's annotations after an upgrade sweep as the port
    leaves them, the cordon record aside: its episode id is the upgrade's
    own, and the forced drain's name is the port's text."""
    out = {}
    for key, value in annotations.items():
        if key == consts.PROVENANCE_EPISODE_ANNOTATION:
            key = consts.UPGRADE_EPISODE_ANNOTATION
        elif key == consts.UPGRADE_FORCE_ATTEMPTED_ANNOTATION:
            value = map_upgrade_text(value)
        out[key] = value
    return out


def upgrade_cordon_record(state: str, unschedulable: bool) -> dict:
    """The cordon record a port node carries where the reference's tests
    place a node in ``state``: one its upgrade cordoned, while schedulable,
    from cordon-required on."""
    from tpu_operator_torch.upgrade import machine

    if unschedulable and state in machine.IN_PROGRESS_STATES + (machine.FAILED,):
        return {consts.UPGRADE_CORDONED_ANNOTATION: "true"}
    return {}


#: the reference's /debug routes the port's health server does not answer
#: (tpu_operator/controllers/manager.py:DEBUG_ROUTES): none, since the port
#: has the race sanitizer and its /debug/opsan
DEBUG_ROUTES_LEFT_OUT: set = set()


# -- the autoscaler, the capacity collector and the migration controller ----------
#
# Kept: the keys tpu.ai/traffic-snapshot, tpu.ai/autoscale-state,
# tpu.ai/autoscale.managed, tpu.ai/preemptible, tpu.ai/migrate-request and
# tpu.ai/migration-*; the Event reasons; the metric families. Renamed: a
# node is picked by ``nodeinfo.is_gpu_node``, pools are keyed on the GPU
# model (:func:`map_pool_name`) and so are the nodes the autoscaler
# registers, ``<pool>-a<seq>`` (:func:`map_registered_name`); the resync
# period is $GPU_OPERATOR_RESYNC_S. Two differences of the autoscaler:
# - a node's size is its ``nvidia.com/gpu`` capacity, where the reference
#   reads ``google.com/tpu`` (tpu_operator/autoscale/controller.py:
#   _node_chips); :func:`map_node` moves the capacity;
# - a node that reports no capacity counts for
#   :data:`AUTOSCALE_DEFAULT_PER_NODE` ``["port"]`` GPUs, one 8-GPU host,
#   where the reference counts 4 chips, one v5e host
#   (AutoscaleReconciler's ``chips_per_node``); the twins give the port's
#   reconciler the reference's default.
# And one addition: a node registered for a pool keyed on feature
# discovery's GPU model (no GKE accelerator label, as the card's node) also
# carries ``feature.node.kubernetes.io/pci-10de.present``, so that it is a
# GPU node; a TPU pool's template, its accelerator label, marks a TPU node
# by itself (tests/test_torch_autoscale.py pins it).

#: the per-node accelerator count of a node without capacity
AUTOSCALE_DEFAULT_PER_NODE = {"reference": 4, "port": 8}


def map_registered_name(name: str) -> str:
    """A node name of the reference's cluster as the port's: a node the
    autoscaler registered (``<pool>-a<seq>``) is named after the port's
    pool; any other name stays."""
    head, sep, seq = name.rpartition("-a")
    if sep and seq.isdigit():
        try:
            return f"{map_pool_name(head)}-a{seq}"
        except KeyError:
            pass
    return name


# -- the client chain ------------------------------------------------------------
#
# Four faults of the reference's the port does not copy. Its write batcher's
# flush patches below the read cache and never hands the result back
# (tpu_operator/client/batch.py:_apply_one), so until the watch delivers the
# write a sweep reads its node from before it, re-derives a health transition
# that already landed (the deferred write's decline comes only at the flush)
# and announces it a second time: NodeHealthDegraded, NodeHealthQuarantined
# or NodeHealthRecovered twice, as a loaded run or a lagging watch shows. The
# port's batcher gives each flushed object to the cache (``CachedClient.
# absorb``); tests/test_torch_crash_soak.py holds the port to one
# announcement with its Node watch 150 ms late. And while another
# controller's window is open, a flushed write waits in the batcher (up to
# its 2 s deadline): the reference's migration controller then reads its
# source at ``restoring`` again and finalizes the episode a second time,
# counting ``tpu_operator_migrations_total`` twice (the card's phase 16 saw
# it). The port's controller remembers the seq of the state row it wrote
# last and requeues on an older cached row
# (``migrate/controller.py:OWN_WRITE_LAG_S``; tests/test_torch_migrate.py::
# test_a_state_row_still_in_the_batcher_is_not_advanced_twice). And its
# informer takes a write's response applied after the object's DELETED event
# (a write-through racing the watch) as the object again, and keeps a deleted
# GPUDriver, say, for good; the port's informer keeps the rv of each delete
# and of its last relist and drops a write no newer
# (tests/test_torch_cached_client.py::
# test_a_write_applied_after_its_object_s_delete_does_not_bring_it_back).
# And a relist whose LIST was answered before a write but applied after the
# write's response swaps the older listed object back in, until the watch
# delivers the write: a sweep reads a DaemonSet's old template after its own
# update. The port's relist keeps an object the cache holds newer than the
# list (tests/test_torch_cached_client.py::
# test_a_relist_answered_before_a_write_keeps_the_write).


def map_crd(crd: dict) -> dict:
    """A reference CRD as the port generates it, descriptions aside: the
    driver kind and its names, ``driverVersion`` and the port's driver
    defaults through the string rules. Descriptions are prose, rewritten for GPUs; :func:`strip_descriptions`
    drops them from both sides."""
    out = _map_value(copy.deepcopy(crd))
    names = out["spec"]["names"]
    for key in ("plural", "singular", "listKind"):
        names[key] = names[key].replace("tpudriver", "gpudriver")
    if names.get("shortNames") == ["tpudrv"]:
        names["shortNames"] = ["gpudrv"]
    out["metadata"]["name"] = out["metadata"]["name"].replace("tpudrivers", "gpudrivers")
    for version in out["spec"]["versions"]:
        for column in version.get("additionalPrinterColumns") or []:
            if column["jsonPath"] == ".spec.libtpuVersion":
                column["jsonPath"] = ".spec.driverVersion"
        props = version["schema"]["openAPIV3Schema"]["properties"]

        def rename_keys(node):
            if isinstance(node, dict):
                return {{"libtpuVersion": "driverVersion",
                         "libtpuInstallDir": "driverInstallDir"}.get(k, k): rename_keys(v)
                        for k, v in node.items()}
            if isinstance(node, list):
                return [rename_keys(v) for v in node]
            return node

        props["spec"] = rename_keys(props["spec"])
        spec_props = props["spec"].get("properties") or {}
        devglobs = (spec_props.get("hostPaths") or {}).get("properties", {}).get("devGlobs")
        if devglobs and "default" in devglobs:
            devglobs["default"] = list(consts.GPU_DEV_GLOBS)
    return out


def map_sample(obj: dict) -> dict:
    """A reference ``tpuop-cfg sample`` CR as the port's ``gpuop-cfg``
    prints it: the mapped CR, with the samples' driver version and
    instance name."""
    if obj["kind"] == "TPUDriver":
        out = map_driver(obj)
        out["metadata"]["name"] = SAMPLE_INSTANCES[obj["metadata"]["name"]]
        spec = out["spec"]
    else:
        out = copy.deepcopy(obj)
        out["spec"] = map_spec(obj["spec"])
        out["spec"] = _map_value(out["spec"])
        spec = out["spec"]["driver"]
    spec["driverVersion"] = SAMPLE_DRIVER_VERSIONS[spec["driverVersion"]]
    return out


def map_status_text(text: str) -> str:
    """``tpuop-cfg status`` output as ``gpuop-cfg status`` prints it for the
    mapped cluster: the driver kind, the GPU count column, and each
    instance's pools by GPU model."""
    import ast

    lines = []
    for line in text.splitlines():
        line = line.replace("TPUDriver/", "GPUDriver/").replace(
            "NODE            CHIPS     ", "NODE            GPUS      ")
        head, sep, pools = line.partition(" pools=")
        if sep:
            mapped = {map_pool_name(k): v for k, v in ast.literal_eval(pools).items()}
            line = f"{head}{sep}{mapped}"
        lines.append(line)
    return "\n".join(lines) + ("\n" if text.endswith("\n") else "")


def strip_descriptions(value):
    if isinstance(value, dict):
        return {k: strip_descriptions(v) for k, v in value.items() if k != "description"}
    if isinstance(value, list):
        return [strip_descriptions(v) for v in value]
    return value


def map_patch(patch: dict) -> dict:
    """A reference Node label/annotation patch as the port writes it."""
    return {_map_string(k): v for k, v in patch.items()}


def map_rendezvous_pod(pod: dict) -> dict:
    """A reference multi-host validation pod as the port's: the JAX
    coordinator env becomes torch.distributed's (worker 0's pod DNS name as
    MASTER_ADDR, torch's default port, WORLD_SIZE, RANK), the hostname list
    goes (NCCL needs none), and the limit names the GPU resource."""
    out = map_object(pod)
    container = out["spec"]["containers"][0]
    env = {e["name"]: e for e in container["env"]}
    address = env.pop("GPU_COORDINATOR_ADDRESS")["value"]
    pod, service, rest = address.rsplit(":", 1)[0].split(".", 2)  # rest: <namespace>.svc
    host = f"{_map_string(pod)}.{_map_string(service)}.{rest}"
    timeout = env.pop("GPU_INIT_TIMEOUT")
    world, rank = env.pop("GPU_NUM_PROCESSES"), env.pop("GPU_WORKER_ID")
    env.pop("GPU_WORKER_HOSTNAMES")
    node_name = env.pop("NODE_NAME")
    container["env"] = [{"name": "MASTER_ADDR", "value": host},
                        {"name": "MASTER_PORT", "value": str(consts.MASTER_PORT)},
                        timeout,
                        {"name": "WORLD_SIZE", "value": world["value"]},
                        {"name": "RANK", "value": rank["value"]},
                        node_name]
    assert not env, env
    return out



# -- the fleet simulator and the traffic mix --------------------------------------
#
# The simulator's fleet is GPU nodes: ``node-NNN`` where the reference seeds
# ``tpu-NNN`` (herd joiners keep ``herd-NNNN``; the upgrade's job pods are
# ``gpu-consumer-<node>`` for ``job-<node>``; :func:`map_sim_name`), names
# that sort as the reference's do, since the chaos injectors draw their
# victims from sorted names, each with
# ``testing.kubelet.GPUS_PER_NODE`` (8) of ``nvidia.com/gpu`` where the
# reference's have 4 chips, labelled with feature discovery's chip type
# (``nvidia-h100-80gb``) and node feature discovery's NVIDIA PCI label where
# the reference's carry GKE's TPU accelerator and a slice topology
# (:func:`map_sim_labels`). Their pool is the chip type
# (:func:`map_pool_name`). Deliberate differences, none of which changes a
# decision on the committed cases (tests/test_torch_simulator.py holds the
# oracles, the settle tick, the injections, the Event counts and the
# terminal nodes equal):
# - a healthy node serves the card's measured frontier times its GPUs, and
#   the nominal per-GPU rate is that curve's best at 200 ms over 8, where the
#   reference's nodes serve a synthetic 3-point curve topping out at 4 x
#   250 tokens/s; the demand is in the same units, so every decision reads a
#   ratio the two share; ``capacity_basis`` says ``gpu-constant`` where the
#   reference's says ``chip-constant``;
# - the demand's traffic mix plays over one node's GPUs as two halves,
#   the reference's two 4-chip slices, so its shape is the reference's;
# - the fleet simulator's kubelet always makes the DaemonSets' pods, where
#   the reference's engine passes ``create_pods=False`` outside the upgrade;
#   the autoscale and migrate operations render no DaemonSet, so it makes
#   none there (:data:`KUBELET_SIM_CREATE_PODS`);
# - the migrate agents re-map over an 8-GPU NVLink board's links where the
#   reference's take an accelerator and a chip count, and the training job
#   names no partition (the reference's ``2x2``);
# - the upgrade's images are the simulated registry's ``gpu-validator``;
# - the read barrier's informer watermark moves with what the watch
#   delivered, never with a write-through (the reference's moves with both;
#   the port's batcher hands its flushed writes to the cache, which would
#   mark a kind caught up past events the watch still owes).
#
# The traffic mix (serving/traffic.py) is the reference's arithmetic: equal
# dicts for equal inputs. Its one difference is the fallback layout with no
# handoff: one group of one GPU (:data:`TRAFFIC_FALLBACK_SLICES`), where the
# reference's is one 4-chip 2x2 slice.

#: ``KubeletSimulator``'s ``create_pods`` default. The reference's makes no
#: pods unless asked (tpu_operator/testing/kubelet.py:KubeletSimulator.__init__);
#: the port's makes them unless asked not to, since every port test and
#: smoke phase that runs it reads the pods. Its other modes are the
#: reference's (tests/test_torch_kubelet_sim.py holds them tick by tick).
KUBELET_SIM_CREATE_PODS = {"reference": False, "port": True}

#: the slices ``scenario_from_handoff(None)`` reports: reference, port
TRAFFIC_FALLBACK_SLICES = {"reference": [{"capacity": 4, "blocked": False}],
                           "port": [{"capacity": 1, "blocked": False}]}


def map_sim_name(name: str) -> str:
    """A reference simulator node's or pod's name as the port's."""
    if re.fullmatch(r"tpu-\d{3}", name):
        return "node-" + name[4:]
    pod = re.fullmatch(r"(.+)-(tpu-\d{3}|herd-\d{4})", name)
    if pod:  # a job's or a DaemonSet's pod on a fleet node
        owner = "gpu-consumer" if pod.group(1) == "job" else _map_string(pod.group(1))
        return f"{owner}-{map_sim_name(pod.group(2))}"
    return map_registered_name(name)


def map_sim_labels(labels: dict) -> dict:
    """A reference simulator node's labels as the port's node carries them:
    the chip type and the PCI label for the TPU accelerator, no topology,
    the presence and deploy labels renamed, the autoscaled pool's name."""
    out = {}
    for key, value in labels.items():
        if key == "cloud.google.com/gke-tpu-accelerator":
            out[consts.TPU_CHIP_TYPE_LABEL] = ACCELERATORS[value]
            out[consts.NFD_NVIDIA_PCI_LABEL] = "true"
        elif key == "cloud.google.com/gke-tpu-topology":
            continue
        elif key == consts.AUTOSCALE_MANAGED_LABEL:
            out[key] = map_pool_name(value)
        else:
            out[_map_string(key)] = value
    return dict(sorted(out.items()))


def map_sim_terminal(terminal: dict) -> dict:
    """A reference simulator report's terminal node state as the port's."""
    return {map_sim_name(name): {"labels": map_sim_labels(state["labels"]),
                                 "unschedulable": state["unschedulable"]}
            for name, state in terminal.items()}


def map_sim_injection(record: dict) -> dict:
    """A reference injection record (tick, kind, victims) as the port's."""
    return {"tick": record["tick"], "kind": record["kind"], "params": record["params"],
            "victims": sorted(map_sim_name(v) for v in record.get("victims", [])),
            "zones": record.get("zones", [])}


# -- the install channels and the support bundle ------------------------------------
#
# The chart is deployments/gpu-operator (NVIDIA's own path), the static
# install deploy/gpu-operator.yaml, the OLM bundle bundle-gpu/manifests/: the
# reference's objects with the port's names (``tpu-operator`` objects are
# ``gpu-operator``, the per-pool driver kind and its resource ``GPUDriver``,
# ``gpudrivers``; the chart key ``tpuDriver`` is ``gpuDriver``). The release
# namespace stays ``tpu-operator``. Every file stays in the YAML subset
# (no flow mappings, no block scalars: the CSV's alm-examples is one
# double-quoted JSON line). Differences:
# - the ClusterRole grants what the port's operator requests
#   (tests/test_torch_chart.py drives it): the reference's rules lack
#   :data:`RBAC_NOT_IN_REFERENCE`, which its own operator needs too (its
#   autoscaler creates and deletes nodes, tpu_operator/autoscale/
#   controller.py:482, :543; its informer cache lists and watches the
#   namespace PSA labels);
# - the Deployment's args carry ``--log-level`` beside ``--leader-elect``
#   (so they never render empty), and its labels are
#   ``app.kubernetes.io/{name,version}`` with no ``managed-by: Helm``, so
#   that the static install is the chart's render byte for byte;
# - the chart renders no Namespace (helm install --create-namespace makes
#   it; helmlite's ``render_all(create_namespace=True)`` adds it);
# - ``gpu-must-gather`` lists nodes by ``nodeinfo.is_gpu_node`` (the
#   reference: its presence label), its summary columns are the GPU labels
#   (presence, model, count) where the reference's are the TPU's (presence,
#   chip type, topology), it reads ``nvidia.com/gpu`` capacity, adds
#   ``cluster/clusterinfo.txt``, collects the port's ``DEBUG_ROUTES`` (the
#   reference's, :data:`DEBUG_ROUTES_LEFT_OUT` being empty) and writes YAML with
#   ``yamlsubset.dump`` (JSON where a string is outside the subset).

#: (apiGroup, resource, verb) the port's operator needs that the reference's
#: ClusterRole does not grant: the autoscaler registers and removes nodes,
#: and the informer cache reads the namespace ``spec.psa`` labels
RBAC_NOT_IN_REFERENCE = {("", "nodes", "create"), ("", "nodes", "delete"),
                         ("", "namespaces", "list"), ("", "namespaces", "watch")}

#: the chart's renames, before :data:`STRING_RULES`
CHART_RULES = [
    (r"^tpudrivers(?=$|[/.])", "gpudrivers"),
    (r"^tpuDriver$", "gpuDriver"),
]


def map_chart_object(obj):
    """A reference chart's rendered object (or any part of one) with the
    port's names."""
    def walk(value):
        if isinstance(value, dict):
            return {walk(k): walk(v) for k, v in value.items()}
        if isinstance(value, list):
            return [walk(v) for v in value]
        if isinstance(value, str):
            for pattern, repl in CHART_RULES:
                value = re.sub(pattern, repl, value)
            return _map_string(value)
        return value

    return walk(copy.deepcopy(obj))


def map_chart_values(values: dict) -> dict:
    """Reference chart values as the port's chart takes them: the
    ``tpuDriver`` key renamed, its node selector over the GPU labels."""
    out = {}
    for key, value in values.items():
        if key == "tpuDriver":
            value = dict(value)
            if "nodeSelector" in value:
                value["nodeSelector"] = map_labels(value["nodeSelector"])
            key = "gpuDriver"
        out[key] = copy.deepcopy(value)
    return out


# -- the static checker (gpuop-lint) ----------------------------------------------

#: what each linter lints, reads and is called: the package tree (the
#: whole-program graph's and ``--changed``'s), its manifests, the key
#: registry module, the console script, the baseline file and how it is
#: regenerated, and the runbook whose tables it reads (the port's metric
#: families and keys keep the reference's names, but the port's runbook is
#: its own, docs/gpu/operations.md)
LINT_NAMES = {
    "reference": {"tree": "tpu_operator", "manifests": "tpu_operator/manifests",
                  "consts": "tpu_operator.consts", "tool": "opalint",
                  "baseline": ".opalint-baseline.json",
                  "regenerate": "make lint-baseline", "docs": "docs/operations.md"},
    "port": {"tree": "tpu_operator_torch", "manifests": "tpu_operator_torch/manifests",
             "consts": "tpu_operator_torch.consts", "tool": "gpuop-lint",
             "baseline": ".gpuop-lint-baseline.json",
             "regenerate": "gpuop-lint --write-baseline", "docs": "docs/gpu/operations.md"},
}

#: the two rules whose idiom the port maps; every other rule is the
#: reference's, word for word, over the mapped names. ``api-bypass``: the
#: port's client speaks ``http.client``, so a raw
#: ``http.client.HTTPConnection``/``HTTPSConnection`` (or the bare name
#: imported from ``http.client``) built outside ``client/`` is the bypass
#: the reference's ``requests.<verb>()`` is (still flagged too), and
#: ``RestClient(...)`` stays allowed in ``client/`` and the composition
#: roots (``cmd/``, ``simulator/``); a ``urlopen`` scrape stays unflagged.
#: ``metrics-discipline``: the port has no ``prometheus_client``; its
#: families are the classes of ``controllers/metrics.py`` and
#: ``validator/metrics.py`` (imported, absolute or relative, or defined
#: there), held to the same "documented" and "bounded cardinality" checks
LINT_IDIOM_RULES = ("api-bypass", "metrics-discipline")

#: "registered" for the port's own families. The reference requires
#: ``registry=`` so no metric lands on the process-global registry, shared
#: by every component and test of a process. The port has no registry
#: object: a family is exposed by the owner that keeps it (``add(...)`` in
#: ``OperatorMetrics``, ``NodeMetrics.families()``, ``TelemetryMetrics``'s
#: scrape), each owner one per component. The same failure mode is a family
#: built outside any owner (module level, a free function): so a port family
#: is registered when it is constructed inside a class that defines
#: ``scrape()``, and flagged otherwise
LINT_REGISTERED_MEANS = "constructed inside a class that defines scrape()"

#: the reference's committed baseline is not empty: it grandfathers the two
#: step-down handlers of ``LeaderElector._loop`` (``on_started``'s and
#: ``on_stopped``'s broad excepts, breaker-swallow). The port's baseline is
#: empty; the same two sites carry in-place suppressions with their reason
LINT_REFERENCE_BASELINED = {("breaker-swallow", "tpu_operator/controllers/leader.py", 2)}


def map_lint_text(text: str) -> str:
    """A reference fixture's path or source as the port's: the package's
    name (``tpu_operator`` -> ``tpu_operator_torch``; ``tpu.ai/`` keys
    and every other name stay)."""
    return re.sub(r"\btpu_operator\b", "tpu_operator_torch", text)


def unmap_lint_text(text: str) -> str:
    """A port linter's path, message or output in the reference's names:
    the package, the tool, its baseline file, how it is regenerated and
    the runbook it reads."""
    port, ref = LINT_NAMES["port"], LINT_NAMES["reference"]
    for key in ("docs", "regenerate", "baseline", "tool"):
        text = text.replace(port[key], ref[key])
    return text.replace("tpu_operator_torch", "tpu_operator")


# -- the test and release lanes outside the package ---------------------------------
#
# The port's lanes sit beside the reference's and run the port only. Their
# files: tests/scripts/torch/ and tests/cases/torch/ (the shell e2e, one
# level below the reference's, whose orchestrator runs ``ls *.sh`` in
# tests/cases), tests/torch_envtest_driver.py with tests/e2e-envtest-gpu.sh,
# docs/gpu/operations.md (the runbook ``gpuop-lint`` reads), the images
# docker/gpu-{operator,validator}.Dockerfile with multi-arch-gpu.mk,
# tests/e2e-kind-gpu.sh, .github/workflows/ci-gpu.yaml and the real-hardware
# lane tests/ci-run-e2e-gpu.sh, tests/gpu-ci.yaml,
# tests/scripts/torch/verify-real-cluster.sh. Their names:
# - nodes ``gpu-node-<i>`` (the reference's ``tpu-node-<i>``), the operand
#   DaemonSets :data:`LANE_DAEMONSETS`' values, a per-pool driver
#   ``gpu-driver-<instance>-<pool>``, the sample GPUDriver ``default``;
# - the install reads the port's JSON samples (no ``yaml2json``), and the
#   port's harness always makes pods (no ``--create-pods``);
# - the env-only upgrade rolls ``GPU_HOST_DRIVER_PATHS`` (the port's driver
#   container reads it) where the reference's rolls ``LIBTPU_INIT_ARGS``;
# - the envtest skip record defaults to tests/e2e-envtest-gpu-SKIPPED.json,
#   which is not committed; the reference's script writes its committed
#   tests/e2e-envtest-SKIPPED.json;
# - the kind lane's stub node plants ``libcuda.so.1``/``libnvidia-ml.so.1``
#   where :data:`tpu_operator_torch.validator.driver.HOST_DRIVER_PATHS`
#   looks, and ``/dev/nvidia*`` (the reference's: ``libtpu.so``,
#   ``/dev/accel*``); its status check is ``gpuop-cfg status``;
# - the images are ``gpu-operator`` (amd64, arm64) and ``gpu-validator``
#   (amd64 only: a CUDA payload); the reference's ``tpu-operator`` and
#   ``tpu-validator``.
# - the operator's alerts name ``gpuop-cfg`` and docs/gpu/operations.md
#   where the reference's name ``tpuop-cfg`` and docs/operations.md; the
#   alert names and expressions are the reference's.
# - every alert's text (the operator's and the node status and telemetry
#   exporters') speaks of GPUs, their driver and their validation, never of
#   TPU hardware (libtpu, ICI, MXU, a TPU chip or board).

#: the runbook each package's tooling and alerts name
RUNBOOKS = {name: names["docs"] for name, names in LINT_NAMES.items()}

#: the alerts' summaries and descriptions: the port's tool and runbook, and
#: GPU words where the port's nodes differ; alert names, expressions, label
#: keys and metric families stay the reference's
ALERT_TEXT_RULES = [
    (r"tpuop-cfg", "gpuop-cfg"),
    (r"docs/operations\.md", RUNBOOKS["port"]),
    (r"\bTPU (operator|nodes?|fleet)\b", r"GPU \1"),
    (r"the node's physical chip grid cannot realize",
     "the node's GPUs and their NVLink/PCIe links cannot realize"),
    (r"a node's chip grid", "a node's GPUs"),
    (r"the rolling libtpu upgrade", "the rolling GPU driver upgrade"),
    (r"have chips quarantined", "have GPUs quarantined"),
    (r"\bchip-health remediation", "health remediation"),
    (r"\bchip (failures|demand)", r"GPU \1"),
    (r"\bthe chips back", "the GPUs back"),
    (r"around unhealthy chips", "around unhealthy GPUs"),
    # the node status and telemetry exporters' alerts: the node's driver,
    # its validation and its GPUs
    (r"libtpu driver validation", "GPU driver validation"),
    (r"libtpu install or device nodes", "the CUDA driver install or its device nodes"),
    (r"ICI workload validation", "GPU workload validation"),
    (r"\(MXU matmul \+ ICI collectives\)", "(GEMM + NCCL collectives)"),
    (r"by the ICI workload sweep", "by the workload sweep"),
    (r"every chip is flagged", "every GPU is flagged"),
    (r"a (specific|previously-seen) TPU chip", r"a \1 GPU"),
    (r"^Chip ", "GPU "),
    (r"TPU HBM above", "GPU memory above"),
    (r" HBM utilization", " memory utilization"),
    (r"TPU board temperature", "GPU temperature"),
]


def map_alert_text(text: str) -> str:
    for pattern, repl in ALERT_TEXT_RULES:
        text = re.sub(pattern, repl, text)
    return text


#: the reference's shell case -> the port's, where the name differs
SHELL_CASES = {"tpudriver.sh": "gpudriver.sh"}

#: the reference's operand DaemonSets (what its verify step waits for) ->
#: the port's
LANE_DAEMONSETS = {
    "libtpu-driver": "gpu-driver",
    "tpu-operator-validator": "gpu-operator-validator",
    "tpu-device-plugin": "gpu-device-plugin",
    "tpu-feature-discovery": "gpu-feature-discovery",
    "tpu-telemetry-exporter": "gpu-telemetry-exporter",
    "tpu-node-status-exporter": "gpu-node-status-exporter",
}

def test_the_lane_daemonsets_are_the_mapped_names():
    assert {k: _map_string(k) for k in LANE_DAEMONSETS} == LANE_DAEMONSETS


# -- the shipped samples (config/samples -> config/gpu/samples) -------------------

#: each reference sample -> the port's, in ``config/gpu/samples/``
CONFIG_SAMPLES = {"v1_clusterpolicy.yaml": "v1_clusterpolicy.yaml",
                  "v1_clusterpolicy_baremetal.yaml": "v1_clusterpolicy_baremetal.yaml",
                  "v1alpha1_tpudriver.yaml": "v1alpha1_gpudriver.yaml"}
#: the samples' registry: the reference's project registry -> the chart's
#: (``deployments/gpu-operator/values.yaml``)
SAMPLE_REGISTRY = {"gcr.io/my-project": "registry.example.com/gpu-operator"}
#: the reference ships a device-plugin image beside its validator; the port's
#: one validator image runs every operand (``-c device-plugin`` among them)
SAMPLE_IMAGES = {"tpu-validator": "gpu-validator", "tpu-device-plugin": "gpu-validator"}
#: the bare-metal sample's host directories: the reference's TPU paths -> a
#: GPU node's
SAMPLE_HOST_PATHS = {"/var/lib/tpu/validations": "/var/lib/gpu/validations",
                     "/opt/tpu/libtpu": "/opt/nvidia/driver/lib64"}
#: the bare-metal sample's device globs: the TPU's accel nodes -> the GPUs'
#: numbered nodes (``consts.GPU_DEV_GLOBS``; ``/dev/nvidia*`` would also
#: match the control nodes, ``nvidiactl`` and ``nvidia-uvm``)
SAMPLE_DEV_GLOBS = {("/dev/accel*",): list(consts.GPU_DEV_GLOBS)}
#: keys the reference's samples set that the port's leave out: a pinned
#: driver version would be recorded as installed whatever NVML reports, so
#: the port's samples let the installer record NVML's (``driver.driverVersion``
#: and a GPUDriver's ``driverVersion`` default to it)
SAMPLE_LEFT_OUT = ("driverVersion",)
#: the GPUDriver sample: the reference's instance selects one accelerator's
#: nodes; the port's, ``default``, selects every GPU node and the operator
#: keys its pools on the GPU model (``state/nodepool.py:get_node_pools``),
#: the instance the smoke's phase 13 and the shell e2e's case hand over
SAMPLE_GPUDRIVER = {"name": "default", "nodeSelector": {}}


def _map_sample_images(section: dict, ref: dict) -> None:
    if "repository" in ref:
        section["repository"] = SAMPLE_REGISTRY[ref["repository"]]
    if "image" in ref:
        section["image"] = SAMPLE_IMAGES[ref["image"]]
    for key in SAMPLE_LEFT_OUT:
        section.pop(key, None)


def map_config_sample(obj: dict) -> dict:
    """A reference sample (``config/samples/*.yaml``) as the port's in
    ``config/gpu/samples/``: the CR mapped as the operator tests map one,
    the samples' registry and image, the bare-metal host paths and device
    globs, no pinned driver version, and the GPUDriver instance over every
    GPU node."""
    if obj["kind"] == "TPUDriver":
        out = map_driver(obj)
        out["metadata"]["name"] = SAMPLE_GPUDRIVER["name"]
        out["spec"]["nodeSelector"] = dict(SAMPLE_GPUDRIVER["nodeSelector"])
        _map_sample_images(out["spec"], obj["spec"])
        return out
    out = copy.deepcopy(obj)
    out["spec"] = map_spec(obj["spec"])
    for key, section in out["spec"].items():
        if isinstance(section, dict):
            _map_sample_images(section, obj["spec"][key])
    host = out["spec"].get("hostPaths") or {}
    for key in ("validationStatusDir", "driverInstallDir"):
        if key in host:
            host[key] = SAMPLE_HOST_PATHS[host[key]]
    if "devGlobs" in host:
        host["devGlobs"] = SAMPLE_DEV_GLOBS[tuple(host["devGlobs"])]
    return out


# -- the mapping's own tests ----------------------------------------------------

def _renders(spec):
    from test_golden_states import SPEC

    from tpu_operator.api.clusterpolicy import ClusterPolicy as RefPolicy
    from tpu_operator.state.operands import cluster_policy_states as ref_states
    from tpu_operator_torch.api.clusterpolicy import ClusterPolicy
    from tpu_operator_torch.state.operands import cluster_policy_states

    spec = copy.deepcopy(spec or SPEC)
    obj = {"apiVersion": "tpu.ai/v1", "kind": "ClusterPolicy", "metadata": {"name": "cp"}}
    out = []
    for factory, policy in ((ref_states, RefPolicy.from_obj(dict(obj, spec=spec))),
                            (cluster_policy_states,
                             ClusterPolicy.from_obj(dict(obj, spec=map_spec(spec))))):
        objs = []
        for state in factory(client=None):
            if state.name == "pre-requisites":
                objs += state.renderer.render_objects({"namespace": "tpu-operator"})
            elif hasattr(state, "render_data"):
                objs += state.render_objects(policy, "tpu-operator")
        out.append(objs)
    return out


def test_the_mapping_changes_nothing_the_port_renders():
    _, port = _renders(None)
    assert [map_object(o) for o in port] == port
    assert map_spec(map_spec({"driver": {"libtpuVersion": "1"}})) == \
        {"driver": {"driverVersion": "1"}}


#: the TPU words a mapped render keeps: the operator's namespace, the
#: protocol keys the node agents share, and the status and handoff host
#: paths (as paths and as flags)
KEPT = {consts.DEFAULT_NAMESPACE, consts.TEMPLATE_HASH_LABEL, consts.TRACE_ID_ANNOTATION,
        consts.VALIDATION_STATUS_DIR, f"--status-dir={consts.VALIDATION_STATUS_DIR}",
        consts.DEFAULT_HANDOFF_DIR, f"--handoff-dir={consts.DEFAULT_HANDOFF_DIR}"}


def test_the_mapping_leaves_no_tpu_name_in_a_render():
    """After mapping, a reference render names the GPU resource, the GPU
    validator and GPU env only. The TPU words left are the :data:`KEPT`
    values, the deploy labels (which keep the operator's ``tpu.ai/``
    group), the images the test spec names, and the alert rules, whose
    names, texts and expressions over the ``tpu_*`` metric families the
    port keeps as the reference wrote them."""
    from test_golden_states import SPEC

    ref, _ = _renders(None)
    kept = KEPT | {f"{c['repository']}/{c['image']}:{c['version']}"
                   for c in SPEC.values() if isinstance(c, dict) and "image" in c}
    leftovers = set()

    def walk(value):
        if isinstance(value, dict):
            for k, v in value.items():
                walk(k)
                walk(v)
        elif isinstance(value, list):
            for v in value:
                walk(v)
        elif (isinstance(value, str) and re.search(r"(^|[^a-z])tpu", value.lower())
              and value not in kept and not value.startswith(consts.DEPLOY_LABEL_PREFIX)):
            leftovers.add(value)

    for obj in ref:
        mapped = {k: v for k, v in map_object(obj).items() if k != "data"}
        if obj["kind"] == "PrometheusRule":
            mapped["spec"] = {k: v for k, v in mapped["spec"].items() if k != "groups"}
        walk(mapped)
    assert not leftovers, sorted(leftovers)[:10]


# -- the race sanitizer's hook sites -------------------------------------------------
#
# Every lock of the operator is built through ``utils.locks.make_lock`` /
# ``make_rlock`` under its static lock-graph label, and every shared structure
# the reference registers with ``register_shared`` the port registers under the
# same name. Renamed: the device plugin's class (``GPUDevicePlugin``).

#: the reference's hook-site class names as the port's
HOOK_CLASS_RENAMES = {"TPUDevicePlugin": "GPUDevicePlugin"}
#: (relpath, label) of the port's factory-built locks the reference does not
#: have: the ``http.client`` watch connection (the reference's rides
#: ``requests``), the port's own Prometheus families, the process kubelet
PORT_ONLY_LOCKS = {
    ("tpu_operator_torch/client/rest.py", "_RestWatch._conn_lock"),
    ("tpu_operator_torch/controllers/metrics.py", "_Child._lock"),
    ("tpu_operator_torch/controllers/metrics.py", "_Family._lock"),
    ("tpu_operator_torch/testing/kubelet.py", "ProcessKubelet._events_lock"),
    ("tpu_operator_torch/testing/kubelet.py", "ProcessKubelet._spawn_lock"),
    ("tpu_operator_torch/testing/kubelet.py", "ProcessKubelet._lock"),
}
#: (relpath, label) of the locks the port builds raw on purpose, and why:
#: node-side locks, which never run in the operator's process, and the work
#: queue's Condition, for which neither package has a factory (the
#: reference's, tpu_operator/controllers/runtime.py, is raw too)
RAW_LOCKS = {
    ("tpu_operator_torch/kernels/_build.py", "_build._lock"):
        "node side: the kernels' nvcc build in the validator's process",
    ("tpu_operator_torch/validator/metrics.py", "Gauge._lock"):
        "node side: the node-status exporter's Python families",
    ("tpu_operator_torch/validator/metrics.py", "Counter._lock"):
        "node side: the node-status exporter's Python families",
    ("tpu_operator_torch/controllers/runtime.py", "RateLimitingQueue._cond"):
        "a Condition: no factory in either package, raw in the reference too",
}
HOOK_FACTORIES = ("make_lock", "make_rlock", "register_shared")
RAW_FACTORIES = ("Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore")


def _label_text(node) -> str:
    """A hook's label argument as written; an f-string's fields as ``{}``."""
    if isinstance(node, ast.Constant):
        return node.value
    return "".join(v.value if isinstance(v, ast.Constant) else "{}" for v in node.values)


def hook_sites(root: str, package: str) -> list:
    """Every lock built and structure registered in ``package`` outside the
    sanitizer and the factory: ``(call, label, relpath, class, target)`` where
    ``call`` is a hook (:data:`HOOK_FACTORIES`) or a raw ``threading``
    factory (label None), ``class`` the enclosing class (None at module
    level) and ``target`` the attribute or name the value is assigned to."""
    sites = []
    for path in sorted(Path(root, package).rglob("*.py")):
        relpath = path.relative_to(root).as_posix()
        if relpath.startswith((f"{package}/sanitizer/", f"{package}/analysis/")) or \
                relpath == f"{package}/utils/locks.py":
            continue
        tree = ast.parse(path.read_text(encoding="utf-8"))

        def visit(node, cls, target):
            if isinstance(node, ast.ClassDef):
                cls = node.name
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                name = (tgt.attr if isinstance(tgt, ast.Attribute)
                        else tgt.id if isinstance(tgt, ast.Name) else None)
                for child in ast.iter_child_nodes(node):
                    visit(child, cls, name)
                return
            if isinstance(node, ast.Call):
                func = node.func.attr if isinstance(node.func, ast.Attribute) else getattr(
                    node.func, "id", "")
                if func in HOOK_FACTORIES and node.args:
                    sites.append((func, _label_text(node.args[0]), relpath, cls, target))
                elif func in RAW_FACTORIES and isinstance(node.func, ast.Attribute) and \
                        getattr(node.func.value, "id", "") == "threading":
                    sites.append((func, None, relpath, cls, target))
            for child in ast.iter_child_nodes(node):
                visit(child, cls, target)

        visit(tree, None, None)
    return sites


def map_hook_site(site: tuple) -> tuple:
    """A reference hook site's ``(call, label, relpath)`` in the port's names."""
    call, label, relpath = site[:3]
    head, _, tail = label.partition(".")
    return call, f"{HOOK_CLASS_RENAMES.get(head, head)}.{tail}", map_lint_text(relpath)


def test_every_reference_hook_site_has_its_counterpart_in_the_port():
    """Each ``make_lock``, ``make_rlock`` and ``register_shared`` of the
    reference is in the port, in the mirrored module under the mapped label,
    as many times (a structure swapped wholesale is registered again); the
    port adds only :data:`PORT_ONLY_LOCKS`."""
    import collections

    repo = Path(__file__).resolve().parents[1]
    ref = collections.Counter(map_hook_site(s) for s in hook_sites(repo, "tpu_operator")
                              if s[1] is not None)
    port = collections.Counter(s[:3] for s in hook_sites(repo, "tpu_operator_torch")
                               if s[1] is not None)
    extra = collections.Counter((call, label, relpath) for call, label, relpath in port
                                if (relpath, label) in PORT_ONLY_LOCKS)
    assert len(ref) >= 20 and sum(ref.values()) >= 25
    assert port - extra == ref
    assert {(relpath, label) for _, label, relpath in extra} == PORT_ONLY_LOCKS


def test_every_port_lock_label_is_its_static_label():
    """A lock's name is what the port's ``LockNode.label()`` gives for its
    attribute (``ClassName._attr``; ``module._name`` at module level, which
    the static graph does not model), so the cross-check lines the dynamic
    edges up with the static ones."""
    from tpu_operator_torch.analysis import graph, runner
    from tpu_operator_torch.analysis.core import LintConfig

    repo = str(Path(__file__).resolve().parents[1])
    project = runner._build_project(repo, runner._AstCache(repo), LintConfig())
    checked = 0
    for call, label, relpath, cls, target in hook_sites(repo, "tpu_operator_torch"):
        if call not in ("make_lock", "make_rlock"):
            continue
        modname = graph.module_name(relpath)
        if cls is None:
            assert label == f"{modname.rsplit('.', 1)[-1]}.{target}", (relpath, label)
        else:
            info = project.classes[f"{modname}:{cls}"]
            assert target in info.lock_attrs, (relpath, cls, target)
            assert graph.LockNode(cid=info.cid, attr=target).label() == label, (relpath, label)
        checked += 1
    assert checked == 21


def test_no_lock_of_the_operator_is_built_raw():
    """Every lock the port's static lock graph sees, and every module-level
    lock, is built through the factory, but for :data:`RAW_LOCKS`."""
    from tpu_operator_torch.analysis import graph, runner
    from tpu_operator_torch.analysis.core import LintConfig

    repo = str(Path(__file__).resolve().parents[1])
    project = runner._build_project(repo, runner._AstCache(repo), LintConfig())
    raw = {}
    sites = hook_sites(repo, "tpu_operator_torch")
    for call, _, relpath, cls, target in sites:
        if call not in RAW_FACTORIES:
            continue
        modname = graph.module_name(relpath)
        owner = modname.rsplit(".", 1)[-1] if cls is None else cls
        if cls is not None:
            assert target in project.classes[f"{modname}:{cls}"].lock_attrs, (relpath, target)
        raw[(relpath, f"{owner}.{target}")] = call
    assert set(raw) == set(RAW_LOCKS)
    # the sites are every class lock the graph sees, but the sanitizer's own
    # (raw on purpose: the sanitizer does not sanitize itself)
    seen = {(c.cid, lock) for c in project.classes.values() for lock in c.lock_attrs
            if not c.modname.startswith("tpu_operator_torch.sanitizer")}
    built = {(f"{graph.module_name(relpath)}:{cls}", target)
             for call, _, relpath, cls, target in sites if cls and call != "register_shared"}
    assert seen == built and len(seen) == 23
