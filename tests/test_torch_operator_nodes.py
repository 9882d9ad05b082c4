"""GPU node detection, labelling and pooling against the reference's on
the mapped cluster (tests/test_torch_operator_mapping.py).

A seeded mixed cluster (numpy) of nodes carrying any of the reference's
TPU signals, kill switches, stack labels and stale labels, with or without
the operator's device-plugin pods, goes through the reference's
``label_tpu_nodes``; the same cluster, mapped, through the port's
``label_gpu_nodes``. The resulting labels, the adoption Events and the
counts must be the mapped reference's. Then what only the port has:
NVIDIA's feature-discovery signal, GKE's ``nvidia-`` accelerator values,
and the serving deploy label the reference's labeller never sets.
"""

import copy

import numpy as np
import pytest

from test_torch_operator_mapping import ACCELERATORS, map_node, map_object, map_spec
from tpu_operator.api.clusterpolicy import ClusterPolicy as RefPolicy
from tpu_operator.client import FakeClient as RefFake
from tpu_operator.nodeinfo import label_tpu_nodes
from tpu_operator.nodeinfo.node_info import NodeAttributes as RefAttributes
from tpu_operator.state.nodepool import get_node_pools as ref_pools
from tpu_operator_torch import consts
from tpu_operator_torch.api.clusterpolicy import ClusterPolicy
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.nodeinfo import NodeAttributes, is_gpu_node, label_gpu_nodes
from tpu_operator_torch.state.nodepool import get_node_pools, shard_by_pools

NS = "tpu-operator"
OPERANDS = ("driver", "device-plugin", "feature-discovery", "telemetry",
            "node-status-exporter", "operator-validator", "slice-partitioner")


def _policies(spec):
    ref = RefPolicy.from_obj({"apiVersion": "tpu.ai/v1", "kind": "ClusterPolicy",
                              "metadata": {"name": "cp", "uid": "u1"}, "spec": spec})
    port = ClusterPolicy.from_obj({"apiVersion": "tpu.ai/v1", "kind": "ClusterPolicy",
                                   "metadata": {"name": "cp", "uid": "u1"},
                                   "spec": map_spec(spec)})
    return ref, port


def _cluster(seed: int, n: int = 24):
    """Nodes with a random mix of the reference's signals and labels, and
    the operator's device-plugin pods on some of them."""
    rng = np.random.default_rng(seed)
    nodes, pods = [], []
    accelerators = sorted(ACCELERATORS)
    for i in range(n):
        labels, status = {"kubernetes.io/hostname": f"n{i}"}, {}
        if rng.random() < 0.4:
            labels["cloud.google.com/gke-tpu-accelerator"] = accelerators[rng.integers(4)]
            labels["cloud.google.com/gke-tpu-topology"] = "2x4"
        if rng.random() < 0.3:
            labels["tpu.ai/tpu.present"] = "true" if rng.random() < 0.8 else "false"
        if rng.random() < 0.35:
            status["capacity"] = {"google.com/tpu": str(int(rng.choice([0, 4, 8])))}
        for operand in OPERANDS:
            roll = rng.random()
            if roll < 0.1:
                labels[consts.DEPLOY_LABEL_PREFIX.replace("gpu", "tpu") + operand] = "false"
            elif roll < 0.2:
                labels[consts.DEPLOY_LABEL_PREFIX.replace("gpu", "tpu") + operand] = "true"
        if rng.random() < 0.15:
            labels[consts.PLUGIN_STACK_LABEL] = "host"
        if rng.random() < 0.1:
            labels[consts.DRIVER_STACK_LABEL] = "host"
        nodes.append({"apiVersion": "v1", "kind": "Node",
                      "metadata": {"name": f"n{i:02d}", "labels": labels}, "status": status})
        if rng.random() < 0.2:
            pods.append({"apiVersion": "v1", "kind": "Pod",
                         "metadata": {"name": f"plugin-n{i:02d}", "namespace": NS,
                                      "labels": {"app.kubernetes.io/component":
                                                 "tpu-device-plugin"}},
                         "spec": {"nodeName": f"n{i:02d}"},
                         "status": {"phase": "Running" if rng.random() < 0.8 else "Succeeded"}})
    return nodes, pods


SPECS = {
    "defaults": {},
    "plugin explicitly on": {"devicePlugin": {"enabled": True}},
    "plugin off, driver from the platform": {"devicePlugin": {"enabled": False},
                                             "driver": {"enabled": False}},
    "partitioner on, telemetry off": {"slicePartitioner": {"enabled": True},
                                      "telemetry": {"enabled": False}},
}


def _fakes(nodes, pods):
    ref = RefFake(objects=copy.deepcopy(nodes + pods))
    port = FakeClient(objects=[map_node(n) for n in nodes] + [map_object(p) for p in pods])
    return ref, port


def _labels(client):
    return {n["metadata"]["name"]: n["metadata"].get("labels", {})
            for n in client.list("v1", "Node")}


def _events(client):
    return sorted((e["reason"], e["involvedObject"]["name"])
                  for e in client.list("v1", "Event", None))


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("spec", list(SPECS))
def test_labelling_matches_reference_after_mapping(seed, spec):
    nodes, pods = _cluster(seed)
    ref, port = _fakes(nodes, pods)
    ref_policy, port_policy = _policies(SPECS[spec])
    want = label_tpu_nodes(ref, ref_policy, NS)
    got = label_gpu_nodes(port, port_policy, NS)
    assert (got.gpu_nodes, got.labeled, got.cleaned) == \
        (want.tpu_nodes, want.labeled, want.cleaned)
    mapped = {name: map_node({"metadata": {"labels": labels}})["metadata"]["labels"]
              for name, labels in _labels(ref).items()}
    assert _labels(port) == mapped
    assert [n["metadata"]["labels"] for n in got.nodes] == \
        [mapped[n["metadata"]["name"]] for n in want.nodes]
    assert _events(port) == _events(ref)
    # the image pre-pull stamp rides the first labelling patch of each node
    for node in port.list("v1", "Node"):
        stamped = consts.IMAGE_PREPULL_ANNOTATION in (node["metadata"].get("annotations") or {})
        assert stamped == is_gpu_node(node)


@pytest.mark.parametrize("seed", [4, 5])
def test_relabel_after_a_spec_change_and_a_lost_signal(seed):
    """Disabling an operand strips its deploy label; a node that lost
    every signal is cleaned; a second pass changes nothing, in both."""
    nodes, pods = _cluster(seed)
    ref, port = _fakes(nodes, pods)
    ref_policy, port_policy = _policies({})
    label_tpu_nodes(ref, ref_policy, NS)
    label_gpu_nodes(port, port_policy, NS)
    ref_policy, port_policy = _policies({"telemetry": {"enabled": False},
                                         "featureDiscovery": {"enabled": False}})
    victim = next(n["metadata"]["name"] for n in ref.list("v1", "Node")
                  if n["metadata"]["labels"].get("tpu.ai/tpu.present") == "true")
    strip = {"metadata": {"labels": {"cloud.google.com/gke-tpu-accelerator": None,
                                     "tpu.ai/tpu.present": "false"}},
             "status": {"capacity": {"google.com/tpu": None}}}
    ref.patch("v1", "Node", victim, strip)
    port.patch("v1", "Node", victim, {
        "metadata": {"labels": {consts.GKE_ACCELERATOR_LABEL: None,
                                consts.GPU_PRESENT_LABEL: "false"}},
        "status": {"capacity": {consts.GPU_RESOURCE_NAME: None}}})
    for _ in range(2):
        want = label_tpu_nodes(ref, ref_policy, NS)
        got = label_gpu_nodes(port, port_policy, NS)
        assert (got.gpu_nodes, got.labeled, got.cleaned) == \
            (want.tpu_nodes, want.labeled, want.cleaned)
        assert _labels(port) == {
            name: map_node({"metadata": {"labels": labels}})["metadata"]["labels"]
            for name, labels in _labels(ref).items()}
    assert not any(k.startswith(consts.DEPLOY_LABEL_PREFIX)
                   for k in port.get("v1", "Node", victim)["metadata"]["labels"])


@pytest.mark.parametrize("labels,capacity,want", [
    ({consts.NFD_NVIDIA_PCI_LABEL: "true"}, None, True),
    ({consts.NFD_NVIDIA_PCI_LABEL: "false"}, None, False),
    ({consts.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb"}, None, True),
    ({consts.GKE_ACCELERATOR_LABEL: "nvidia-tesla-t4"}, None, True),
    ({"cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"}, None, False),
    ({consts.GPU_PRESENT_LABEL: "true"}, None, True),
    ({consts.GPU_PRESENT_LABEL: "false"}, None, False),
    ({}, "8", True),
    ({}, "0", False),
    ({}, "garbage", False),
    ({"tpu.ai/tpu.present": "true"}, None, False),
])
def test_a_gpu_node_is_detected_by_any_one_signal(labels, capacity, want):
    node = {"metadata": {"name": "n", "labels": labels},
            "status": {"capacity": {consts.GPU_RESOURCE_NAME: capacity}} if capacity else {}}
    assert is_gpu_node(node) is want


def test_the_nfd_signal_alone_labels_and_its_loss_cleans():
    """NVIDIA's own signal, which the reference has no counterpart for."""
    port = FakeClient(objects=[{"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "n1", "labels": {consts.NFD_NVIDIA_PCI_LABEL: "true"}}}])
    _, policy = _policies({})
    assert label_gpu_nodes(port, policy, NS).gpu_nodes == 1
    labels = port.get("v1", "Node", "n1")["metadata"]["labels"]
    assert labels[consts.GPU_PRESENT_LABEL] == "true"
    assert labels[consts.deploy_label("operator-validator")] == "true"
    port.patch("v1", "Node", "n1", {"metadata": {"labels": {
        consts.NFD_NVIDIA_PCI_LABEL: None, consts.GPU_PRESENT_LABEL: "false"}}})
    result = label_gpu_nodes(port, policy, NS)
    assert (result.gpu_nodes, result.cleaned) == (0, 1)
    assert port.get("v1", "Node", "n1")["metadata"]["labels"] == {}


def test_adoption_of_a_node_advertising_the_resource_and_of_gke_plugins():
    """A node that advertises nvidia.com/gpu before the operator labelled
    it (GKE's device plugin) is adopted, unless the pod advertising it is
    the operator's own; an explicit enable un-adopts, as the reference."""
    nodes = [{"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": {
        "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"}},
        "status": {"capacity": {"google.com/tpu": "8"}}} for name in ("gke", "ours")]
    pods = [{"apiVersion": "v1", "kind": "Pod", "metadata": {
        "name": "plugin", "namespace": NS,
        "labels": {"app.kubernetes.io/component": "tpu-device-plugin"}},
        "spec": {"nodeName": "ours"}, "status": {"phase": "Running"}}]
    ref, port = _fakes(nodes, pods)
    for spec in ({}, {"devicePlugin": {"enabled": True}}):
        ref_policy, port_policy = _policies(spec)
        label_tpu_nodes(ref, ref_policy, NS)
        label_gpu_nodes(port, port_policy, NS)
        labels = _labels(port)
        assert labels == {name: map_node({"metadata": {"labels": ls}})["metadata"]["labels"]
                          for name, ls in _labels(ref).items()}
        adopted = labels["gke"].get(consts.PLUGIN_STACK_LABEL) == "host"
        assert adopted is (spec == {})
        assert consts.PLUGIN_STACK_LABEL not in labels["ours"]
    assert ("HostPluginAdopted", "gke") in _events(port)


def test_the_serving_deploy_label_follows_spec_serving():
    """Deliberate difference: the reference's operand table leaves serving
    out, so its labeller never sets the label the serving DaemonSet selects
    on (and strips one an admin set); the port labels it when enabled."""
    node = {"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "n1", "labels": {"tpu.ai/tpu.present": "true"}}}
    ref, port = _fakes([node], [])
    ref_policy, port_policy = _policies({"serving": {"enabled": True}})
    label_tpu_nodes(ref, ref_policy, NS)
    label_gpu_nodes(port, port_policy, NS)
    assert "tpu.ai/tpu.deploy.serving" not in _labels(ref)["n1"]
    assert _labels(port)["n1"][consts.deploy_label("serving")] == "true"
    _, port_policy = _policies({"serving": {"enabled": False}})
    label_gpu_nodes(port, port_policy, NS)
    assert consts.deploy_label("serving") not in _labels(port)["n1"]


@pytest.mark.parametrize("seed", [6, 7])
def test_pools_and_attributes_match_reference_after_mapping(seed):
    """Pools by GKE accelerator, else the chip type; a GPU node has no
    topology, so pools the reference splits only by topology merge."""
    rng = np.random.default_rng(seed)
    accelerators = sorted(ACCELERATORS)
    nodes = []
    for i in range(20):
        labels = {}
        roll = rng.random()
        if roll < 0.6:
            labels["cloud.google.com/gke-tpu-accelerator"] = accelerators[rng.integers(4)]
        elif roll < 0.85:
            labels[consts.TPU_CHIP_TYPE_LABEL] = accelerators[rng.integers(4)]
        nodes.append({"metadata": {"name": f"n{i:02d}", "labels": labels},
                      "status": {"capacity": {"google.com/tpu": str(4 * int(rng.integers(3)))}}})
    want = ref_pools(nodes)
    got = get_node_pools([map_node(n) for n in nodes])
    assert sorted(tuple(p.node_names) for p in got) == \
        sorted(tuple(p.node_names) for p in want)
    by_members = {tuple(p.node_names): p for p in want}
    for pool in got:
        ref = by_members[tuple(pool.node_names)]
        assert pool.accelerator == ACCELERATORS.get(ref.accelerator, ref.accelerator)
        assert pool.topology == ""
        assert pool.node_selector == map_node(
            {"metadata": {"labels": ref.node_selector}})["metadata"]["labels"]
    shards = shard_by_pools([map_node(n) for n in nodes], got)
    assert sorted(n["metadata"]["name"] for s in shards for n in s) == \
        sorted(n["metadata"]["name"] for n in nodes)
    for node in nodes:
        ref, port = RefAttributes.from_node(node), NodeAttributes.from_node(map_node(node))
        assert port.accelerator == ACCELERATORS.get(ref.accelerator, ref.accelerator)
        assert (port.name, port.chip_count, port.topology) == (ref.name, ref.chip_count, "")
