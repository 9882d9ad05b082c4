"""The port's in-memory kubelet without pods (tpu_operator_torch/testing/
kubelet.py:KubeletSimulator, ``create_pods=False``): the per-DaemonSet
image-pull model, its pre-pull credit and generation reset, the barrier
gates read from the rendered init containers, the whole-DaemonSet int
rollout, and the validator's pods run through ``validation_exec``.

The reference's six cases on the port, then the two simulators side by
side: the same nodes, pre-pull stamps, DaemonSets (names mapped through
tests/test_torch_operator_mapping.py) and barriers, tick by tick, must give
equal DaemonSet status and equal GPU registration. Ticks are driven by
hand: no threads.

The twin of tests/test_kubelet_sim.py.
"""

import inspect

import pytest

from test_torch_operator_mapping import KUBELET_SIM_CREATE_PODS, _map_string, map_node, map_object
from tpu_operator import consts as ref_consts
from tpu_operator.client.fake import FakeClient as RefFakeClient
from tpu_operator.testing.kubelet import KubeletSimulator as RefSimulator
from tpu_operator_torch import consts, yamlsubset
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.testing.kubelet import KubeletSimulator

NS = consts.DEFAULT_NAMESPACE


@pytest.fixture
def client():
    return FakeClient()


def mk_node(name, prepull_at=None, present_label=consts.GPU_PRESENT_LABEL):
    node = {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": {present_label: "true"}, "annotations": {}},
            "status": {}}
    if prepull_at is not None:
        node["metadata"]["annotations"][consts.IMAGE_PREPULL_ANNOTATION] = f"{prepull_at:.3f}"
    return node


def mk_ds(name, generation=1, inits=None, component=None,
          present_label=consts.GPU_PRESENT_LABEL):
    labels = {"app": name}
    if component:
        labels["app.kubernetes.io/component"] = component
    return {"apiVersion": "apps/v1", "kind": "DaemonSet",
            "metadata": {"name": name, "namespace": NS, "generation": generation},
            "spec": {"selector": {"matchLabels": {"app": name}},
                     "template": {"metadata": {"labels": labels},
                                  "spec": {"nodeSelector": {present_label: "true"},
                                           "initContainers": inits or [],
                                           "containers": [{"name": name, "image": "img:1"}]}}}}


def available(client, name):
    ds = client.get("apps/v1", "DaemonSet", name, NS)
    return (ds.get("status") or {}).get("numberAvailable", 0)


def sim(client, **kw):
    return KubeletSimulator(client, create_pods=False, **kw)


# -- the reference's six cases --------------------------------------------------------

def test_per_ds_rollout_stagger(client):
    """Each DaemonSet pulls on its own clock: a slow image does not hold up
    a fast one."""
    client.create(mk_node("n0"))
    client.create(mk_ds("slow-ds"))
    client.create(mk_ds("fast-ds"))
    s = sim(client, rollout_ticks={"slow-ds": 3, "*": 1})
    s.tick()  # the clocks start
    assert available(client, "slow-ds") == 0
    assert available(client, "fast-ds") == 0
    s.tick()
    assert available(client, "fast-ds") == 1  # 1 tick pulled
    assert available(client, "slow-ds") == 0
    s.tick()
    s.tick()
    assert available(client, "slow-ds") == 1  # 3 ticks pulled


def test_prepull_credit_starts_the_clock_early(client):
    """A node with the pre-pull stamp pulls from the tick the stamp was first
    seen, not from the DaemonSet's first match."""
    client.create(mk_node("warm", prepull_at=1000.0))
    client.create(mk_node("cold"))
    s = sim(client, rollout_ticks={"*": 3})
    s.tick()  # tick 1: warm's stamp seen; no DaemonSet yet
    client.create(mk_ds("plugin-ds"))
    s.tick()  # tick 2: the clocks start, warm's at 1, cold's at 2
    s.tick()
    s.tick()  # tick 4: warm has pulled 3 ticks, cold 2
    assert available(client, "plugin-ds") == 1
    s.tick()  # tick 5: cold too
    assert available(client, "plugin-ds") == 2


def test_generation_bump_resets_pull_clock_without_credit(client):
    """A template change is a new image: a fresh pull from the bump, and the
    pre-pull stamp (older than the new image) earns nothing."""
    client.create(mk_node("warm", prepull_at=1000.0))
    client.create(mk_ds("plugin-ds"))
    s = sim(client, rollout_ticks={"*": 2})
    for _ in range(3):
        s.tick()
    assert available(client, "plugin-ds") == 1
    ds = client.get("apps/v1", "DaemonSet", "plugin-ds", NS)
    ds["spec"]["template"]["spec"]["containers"][0]["image"] = "img:2"
    ds = client.update(ds)
    assert ds["metadata"]["generation"] == 2
    s.tick()  # the pull restarts
    assert available(client, "plugin-ds") == 0
    s.tick()
    s.tick()
    assert available(client, "plugin-ds") == 1


def test_barrier_check_gates_pod_readiness(client):
    """A pulled pod whose rendered inits wait on a barrier is available only
    once the barrier is written."""
    passed = set()
    client.create(mk_node("n0"))
    client.create(mk_ds("gated-ds", inits=[{
        "name": "driver-validation-wait",
        "args": ["-c", "wait", "--for=driver", "--status-dir=/x"]}]))
    s = sim(client, rollout_ticks={"*": 1}, barrier_check=lambda b: b in passed)
    for _ in range(4):
        s.tick()
    assert available(client, "gated-ds") == 0  # pulled, but gated
    passed.add("driver")
    s.tick()
    assert available(client, "gated-ds") == 1


def test_gating_barriers_extraction():
    """Explicit waits and the validation stages gate; a prewarm or the
    serving probe does not."""
    ds = mk_ds("v", inits=[
        {"name": "w1", "args": ["-c", "wait", "--for=driver", "--status-dir=/x"]},
        {"name": "w2", "args": ["-c", "wait", "--for", "workload"]},
        {"name": "plugin-validation",
         "args": ["-c", "plugin", "--resource=nvidia.com/gpu", "--prewarm"]},
        {"name": "extra", "args": ["-c", "serving"]},
        {"name": "prewarm", "args": ["-c", "prewarm"]},
    ])
    assert KubeletSimulator._gating_barriers(ds) == ["driver", "workload", "plugin"]


def test_legacy_int_rollout_unchanged(client):
    """An int rollout_ticks holds the whole DaemonSet per (name, generation),
    then flips every node at once; the pre-pull stamp earns nothing."""
    for i in range(3):
        client.create(mk_node(f"n{i}", prepull_at=1000.0))
    client.create(mk_ds("bulk-ds"))
    s = sim(client, rollout_ticks=2)
    s.tick()
    assert available(client, "bulk-ds") == 0
    s.tick()
    assert available(client, "bulk-ds") == 0  # seen once before this tick: 1 < 2
    s.tick()
    assert available(client, "bulk-ds") == 3


# -- the port's own cases ----------------------------------------------------------------

def test_create_pods_default_is_recorded_in_the_mapping():
    """The port's simulator makes pods by default, the reference's does not:
    the one difference in the constructor, written in the mapping."""
    defaults = {side: inspect.signature(cls).parameters["create_pods"].default
                for side, cls in (("reference", RefSimulator), ("port", KubeletSimulator))}
    assert defaults == KUBELET_SIM_CREATE_PODS
    ref = set(inspect.signature(RefSimulator).parameters)
    port = set(inspect.signature(KubeletSimulator).parameters)
    assert {"rollout_ticks", "barrier_check", "validation_exec", "create_pods"} <= ref & port


def test_create_pods_wins_over_rollout_ticks(client):
    client.create(mk_node("n0"))
    client.create(mk_ds("ds", inits=[{"name": "w", "args": ["-c", "wait", "--for=driver"]}]))
    s = KubeletSimulator(client, rollout_ticks={"*": 5}, barrier_check=lambda b: False)
    s.tick()  # the pod is made
    s.tick()  # and counted, with no pull and no gate
    assert available(client, "ds") == 1
    assert [p["metadata"]["name"] for p in client.list("v1", "Pod", NS)] == ["ds-n0"]


def test_without_pods_the_plugin_registers_only_ready_nodes(client):
    """Pod-less, the device plugin's DaemonSet gives GPUs only to the nodes
    whose pod is pulled and past its gates; the transitions say when."""
    client.create(mk_node("warm", prepull_at=1000.0))
    client.create(mk_ds("gpu-device-plugin", component="gpu-device-plugin"))
    s = sim(client, rollout_ticks={"*": 2}, gpus_per_node=1)
    s.tick()
    client.create(mk_node("cold"))
    for _ in range(2):
        s.tick()

    def gpus(name):
        return (client.get("v1", "Node", name).get("status") or {}).get(
            "capacity", {}).get(consts.GPU_RESOURCE_NAME)

    assert (gpus("warm"), gpus("cold")) == ("1", None)
    s.tick()
    assert (gpus("warm"), gpus("cold")) == ("1", "1")
    assert [(t, name, n) for t, _, name, n in s.transitions] == [
        (1, "gpu-device-plugin", 0), (3, "gpu-device-plugin", 1), (4, "gpu-device-plugin", 2)]
    assert client.list("v1", "Pod", NS) == []


def _validation_pod(name, node="n0"):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": NS,
                         "labels": {"app": "gpu-workload-validation"}},
            "spec": {"nodeName": node, "containers": [{"name": "c", "image": "img:1"}]},
            "status": {"phase": "Pending"}}


def test_validation_exec_sets_each_pod_s_phase(client):
    """rc 0 gives ``Succeeded``, anything else ``Failed``, a raise
    ``Failed``; a pod on a node outside ``node_filter`` is left alone."""
    client.create(mk_node("n0"))
    client.create(mk_node("other"))
    for name in ("ok", "bad", "boom"):
        client.create(_validation_pod(name))
    client.create(_validation_pod("elsewhere", node="other"))
    ran = []

    def runtime(pod):
        name = pod["metadata"]["name"]
        ran.append(name)
        if name == "boom":
            raise RuntimeError("the container crashed")
        return {"ok": 0, "bad": 1}[name]

    s = sim(client, validation_exec=runtime,
            node_filter=lambda n: n["metadata"]["name"] == "n0")
    s.tick()
    s.tick()  # terminal pods are not run again

    def phase(name):
        return client.get("v1", "Pod", name, NS)["status"]["phase"]

    assert {n: phase(n) for n in ("ok", "bad", "boom", "elsewhere")} == {
        "ok": "Succeeded", "bad": "Failed", "boom": "Failed", "elsewhere": "Pending"}
    assert sorted(ran) == ["bad", "boom", "ok"]


# -- the gates of the port's real manifests ------------------------------------------

#: every rendered DaemonSet of the default ClusterPolicy -> its gates
PORT_GATES = {"gpu-driver": [], "gpu-operator-validator": ["driver", "plugin", "workload"],
              "gpu-device-plugin": ["driver"], "gpu-feature-discovery": [],
              "gpu-telemetry-exporter": [], "gpu-node-status-exporter": [],
              "gpu-slice-partitioner": ["driver"], "gpu-serving-validator": ["workload"]}
IMAGES = ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "DEVICE_PLUGIN_IMAGE", "FEATURE_DISCOVERY_IMAGE",
          "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE")


def _daemonsets(states, policy):
    return [o for s in states(client=None)
            if hasattr(s, "render_data") and s.name != "pre-requisites"
            for o in s.render_objects(policy, NS) if o["kind"] == "DaemonSet"]


def test_the_gates_of_the_port_s_rendered_daemonsets(monkeypatch):
    """The default ClusterPolicy's DaemonSets, rendered by the port and read
    back through its YAML subset, gate as the reference's mapped ones do:
    the validator on its three stages, the plugin and the partitioner on the
    driver's wait, the serving probe on the workload's (its ``-c serving``
    init gates nothing)."""
    from tpu_operator.api.clusterpolicy import ClusterPolicy as RefPolicy
    from tpu_operator.api.clusterpolicy import new_cluster_policy as ref_new_policy
    from tpu_operator.state.operands import cluster_policy_states as ref_states
    from tpu_operator_torch.api.clusterpolicy import ClusterPolicy, new_cluster_policy
    from tpu_operator_torch.state.operands import cluster_policy_states

    for env in IMAGES:
        monkeypatch.setenv(env, "registry.example.com/img:1")
    port = _daemonsets(cluster_policy_states, ClusterPolicy.from_obj(new_cluster_policy()))
    assert {ds["metadata"]["name"]: KubeletSimulator._gating_barriers(ds)
            for ds in port} == PORT_GATES
    ref = _daemonsets(ref_states, RefPolicy.from_obj(ref_new_policy()))
    assert {map_object(ds)["metadata"]["name"]: RefSimulator._gating_barriers(ds)
            for ds in ref} == PORT_GATES


@pytest.mark.parametrize("args,gates", [
    ("[-c, wait, --for=driver, --status-dir=/run/gpu/validations]", ["driver"]),
    ("[-c, wait, --for, workload]", ["workload"]),
    ("[-c, driver, --install-dir=/usr/lib/x86_64-linux-gnu]", ["driver"]),
    ("[-c, plugin, --resource=nvidia.com/gpu, --prewarm]", ["plugin"]),
    ("[-c, workload, --resource=nvidia.com/gpu]", ["workload"]),
    ("[-c, serving]", []),
    ("[-c, sleep]", []),
])
def test_the_gates_of_a_yaml_subset_flow_list(args, gates):
    """The manifests write each init's args as a one-line flow list."""
    ds = yamlsubset.parse(
        "apiVersion: apps/v1\nkind: DaemonSet\nmetadata:\n  name: v\nspec:\n  template:\n"
        f"    spec:\n      initContainers:\n        - name: i\n          args: {args}\n")
    assert KubeletSimulator._gating_barriers(ds) == gates


# -- tick by tick beside the reference -------------------------------------------------

REF_DAEMONSETS = [
    mk_ds("tpu-operator-validator", component="tpu-operator-validator",
          present_label=ref_consts.TPU_PRESENT_LABEL, inits=[
              {"name": "driver-validation", "args": ["-c", "driver"]},
              {"name": "plugin-validation", "args": ["-c", "plugin", "--prewarm"]},
              {"name": "workload-validation", "args": ["-c", "workload"]}]),
    mk_ds("tpu-device-plugin", component="tpu-device-plugin",
          present_label=ref_consts.TPU_PRESENT_LABEL, inits=[
              {"name": "driver-validation-wait", "args": ["-c", "wait", "--for=driver"]}]),
    mk_ds("tpu-feature-discovery", component="tpu-feature-discovery",
          present_label=ref_consts.TPU_PRESENT_LABEL),
]
#: tick -> the barriers written by then
BARRIERS_AT = {3: "driver", 6: "plugin", 9: "workload"}


def _mapped(value):
    """A reference object's strings (keys and values) as the port's; the
    namespace is kept."""
    if isinstance(value, dict):
        return {_mapped(k): v if k == "namespace" else _mapped(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_mapped(v) for v in value]
    return _map_string(value) if isinstance(value, str) else value


def _twin_run(rollout_ticks):
    """Both simulators over the same cluster story, one tick at a time: the
    DaemonSets' status and each node's GPUs after every tick, the port's
    side mapped to the reference's names."""
    ref_client, port_client = RefFakeClient(), FakeClient()
    passed: set = set()
    ref = RefSimulator(ref_client, rollout_ticks=rollout_ticks, chips_per_node=4,
                       barrier_check=passed.__contains__)
    port = KubeletSimulator(
        port_client, create_pods=False, gpus_per_node=4, barrier_check=passed.__contains__,
        rollout_ticks=({_map_string(k): v for k, v in rollout_ticks.items()}
                       if isinstance(rollout_ticks, dict) else rollout_ticks))

    def create(obj):
        ref_client.create(obj)
        port_client.create(_mapped(obj))

    def ref_node(name, prepull_at=None):
        return mk_node(name, prepull_at, present_label=ref_consts.TPU_PRESENT_LABEL)

    create(ref_node("warm", prepull_at=1000.0))
    create(ref_node("cold"))
    create(dict(ref_node("elsewhere"), metadata={"name": "elsewhere", "labels": {}}))
    for ds in REF_DAEMONSETS[1:]:
        create(ds)
    trail = []
    for tick in range(1, 16):
        if tick in BARRIERS_AT:
            passed.add(BARRIERS_AT[tick])
        if tick == 2:
            create(REF_DAEMONSETS[0])
            create(ref_node("late"))
        if tick == 4:  # the labeller stamps a node after its pods were scheduled
            for c, node in ((ref_client, "cold"), (port_client, "cold")):
                live = c.get("v1", "Node", node)
                live["metadata"]["annotations"][consts.IMAGE_PREPULL_ANNOTATION] = "1001.000"
                c.update(live)
        if tick == 8:  # a template change on both sides: generation 2
            for c, name in ((ref_client, "tpu-feature-discovery"),
                            (port_client, "gpu-feature-discovery")):
                live = c.get("apps/v1", "DaemonSet", name, NS)
                live["spec"]["template"]["spec"]["containers"][0]["image"] = "img:2"
                c.update(live)
        ref.tick()
        port.tick()
        for side, c in (("ref", ref_client), ("port", port_client)):
            ds = {_map_string(d["metadata"]["name"]): d.get("status")
                  for d in c.list("apps/v1", "DaemonSet", NS)}
            nodes = {n["metadata"]["name"]: (map_node(n) if side == "ref" else n).get(
                "status", {}).get("capacity") for n in c.list("v1", "Node")}
            trail.append((tick, side, ds, nodes))
    return trail


@pytest.mark.parametrize("rollout_ticks", [{"tpu-operator-validator": 4,
                                            "tpu-device-plugin": 3, "*": 2}, 3],
                         ids=["per-node-pulls", "whole-daemonset"])
def test_tick_by_tick_beside_the_reference(rollout_ticks):
    trail = _twin_run(rollout_ticks)
    ref = [(t, ds, nodes) for t, side, ds, nodes in trail if side == "ref"]
    port = [(t, ds, nodes) for t, side, ds, nodes in trail if side == "port"]
    for want, got in zip(ref, port):
        assert got == want, f"tick {want[0]}"
    assert len(port) == len(ref) == 15
    # the story reaches everything it means to: GPUs on the matching nodes,
    # every DaemonSet available on all three, the second generation rolled
    last = ref[-1]
    assert last[2] == {"warm": {consts.GPU_RESOURCE_NAME: "4"},
                       "cold": {consts.GPU_RESOURCE_NAME: "4"},
                       "late": {consts.GPU_RESOURCE_NAME: "4"}, "elsewhere": None}
    assert {name: (s["numberAvailable"], s["observedGeneration"])
            for name, s in last[1].items()} == {
        "gpu-operator-validator": (3, 1), "gpu-device-plugin": (3, 1),
        "gpu-feature-discovery": (3, 2)}
    # and the clocks differ between the nodes on the way (pulls overlap)
    if isinstance(rollout_ticks, dict):
        counts = {t: ds["gpu-device-plugin"]["numberAvailable"] for t, ds, _ in ref}
        assert any(0 < n < 3 for n in counts.values()), counts

