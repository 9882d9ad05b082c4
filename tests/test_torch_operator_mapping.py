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
``/debug`` routes the port does not serve. The tests at the end hold the mapping itself: it changes nothing the
port already renders, and it leaves no TPU name behind in what it maps.
"""

import copy
import json
import re

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
# Three faults of the reference the port does not copy, each pinned by its
# own test in tests/test_torch_upgrade.py:
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
#   (``_episode_for``, ``_set_state``): :func:`map_upgrade_node_annotations`.

#: a container restarted more than this many times is crash-looping
UPGRADE_CRASH_LOOP_RESTARTS = consts.UPGRADE_CRASH_LOOP_RESTARTS

#: the port's additions to the upgrade's keys
UPGRADE_PORT_KEYS = {consts.UPGRADE_CORDONED_ANNOTATION, consts.UPGRADE_EPISODE_ANNOTATION}

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


#: the reference's /debug routes the port's health server does not answer:
#: /debug/capacity is the fleet capacity observatory's (ROADMAP Queue 1,
#: item 7), /debug/opsan the reference's race sanitizer's, which the port
#: does not have (tpu_operator/controllers/manager.py:DEBUG_ROUTES)
DEBUG_ROUTES_LEFT_OUT = {"/debug/capacity", "/debug/opsan"}


def map_crd(crd: dict) -> dict:
    """A reference CRD as the port generates it, descriptions aside: the
    driver kind and its names, ``driverVersion`` and the port's driver
    defaults through the string rules, and the autoscale and migrate
    sub-specs free-form objects until their controllers are ported.
    Descriptions are prose, rewritten for GPUs; :func:`strip_descriptions`
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
        for free_form in ("autoscale", "migrate"):
            if free_form in spec_props:
                spec_props[free_form] = {"type": "object",
                                         "x-kubernetes-preserve-unknown-fields": True}
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
