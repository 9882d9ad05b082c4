"""The twin of tests/test_events.py: the reference's seven cases on the
port's Events (``tpu_operator_torch/events.py``) and reconcilers, on the
port's fake, with the port's names (a GPU node; a ``GPUDriver``; the
presence label ``consts.GPU_PRESENT_LABEL``). Beside them, the same
emissions through both packages must store the same Events, names, counts
and fields but for the timestamps and uids (the reporting component's name
through tests/test_torch_operator_mapping.py).
"""

import pytest

from test_torch_operator_mapping import _map_string
from tpu_operator import events as ref_events
from tpu_operator.client import FakeClient as RefFake
from tpu_operator_torch import consts, events
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.api.gpudriver import GPU_DRIVER_API_VERSION, GPU_DRIVER_KIND
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.controllers.gpudriver_controller import GPUDriverReconciler
from tpu_operator_torch.controllers.runtime import Request
from tpu_operator_torch.testing.kubelet import KubeletSimulator

NS = "tpu-operator"


def _gpu_driver(name, spec):
    return {"apiVersion": GPU_DRIVER_API_VERSION, "kind": GPU_DRIVER_KIND,
            "metadata": {"name": name}, "spec": spec}


@pytest.fixture
def client():
    return FakeClient()


def test_record_event(client):
    cp = client.create(new_cluster_policy())
    ev = events.record(client, NS, cp, events.WARNING, "TestReason", "something happened")
    assert ev is not None
    stored = client.list("v1", "Event", NS)
    assert len(stored) == 1
    assert stored[0]["reason"] == "TestReason"
    assert stored[0]["involvedObject"]["kind"] == "ClusterPolicy"
    assert stored[0]["involvedObject"]["uid"] == cp["metadata"]["uid"]


def test_ready_transition_emits_single_event(client, monkeypatch):
    for env in ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE", "DEVICE_PLUGIN_IMAGE"):
        monkeypatch.setenv(env, "img:1")
    from tpu_operator_torch.controllers.clusterpolicy_controller import ClusterPolicyReconciler

    client.create(new_cluster_policy())
    client.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "gpu-1", "labels": {consts.NFD_NVIDIA_PCI_LABEL: "true"}}, "status": {}})
    r = ClusterPolicyReconciler(client)
    r.reconcile(Request("cluster-policy"))  # notReady: no event
    # the port's simulator makes the pods in one tick and counts them in the
    # next, as the reference's does with create_pods=True
    KubeletSimulator(client).tick()
    KubeletSimulator(client).tick()
    r.reconcile(Request("cluster-policy"))  # -> ready: one event
    r.reconcile(Request("cluster-policy"))  # still ready: no new event
    assert len([e for e in client.list("v1", "Event", NS) if e["reason"] == "Ready"]) == 1


def _conflicting(client, monkeypatch):
    monkeypatch.setenv("DRIVER_IMAGE", "img:1")
    client.create(new_cluster_policy())
    client.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "n1", "labels": {consts.GPU_PRESENT_LABEL: "true"}}, "status": {}})
    client.create(_gpu_driver("one", {"image": "img"}))
    client.create(_gpu_driver("two", {"image": "img"}))
    return GPUDriverReconciler(client)


def test_conflict_emits_warning_event(client, monkeypatch):
    _conflicting(client, monkeypatch).reconcile(Request("one"))
    warnings = [e for e in client.list("v1", "Event", NS) if e["type"] == "Warning"]
    assert warnings and warnings[0]["reason"] == "ConflictingNodeSelector"


def test_long_object_name_keeps_unique_suffix(client):
    long_name = "gke-prod-cluster-h100-pool-1-1a2b3c4d-" + "x" * 30
    node = client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": long_name},
                          "status": {}})
    ev1 = events.record(client, NS, node, events.WARNING, "DriverUpgradeFailed", "boom")
    ev2 = events.record(client, NS, node, events.WARNING, "DriverUpgradeFailed", "boom again")
    assert ev1 is not None and ev2 is not None
    assert ev1["metadata"]["name"] != ev2["metadata"]["name"]
    assert len(ev1["metadata"]["name"]) <= 63
    assert len(client.list("v1", "Event", NS)) == 2


def test_identical_events_aggregate_count(client):
    node = client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n1"},
                          "status": {}})
    first = events.record(client, NS, node, events.WARNING, "DriverUpgradeFailed", "pod stuck")
    for _ in range(3):
        bumped = events.record(client, NS, node, events.WARNING, "DriverUpgradeFailed",
                               "pod stuck")
        assert bumped["metadata"]["name"] == first["metadata"]["name"]
    stored = client.list("v1", "Event", NS)
    assert len(stored) == 1
    assert stored[0]["count"] == 4
    assert stored[0]["firstTimestamp"] <= stored[0]["lastTimestamp"]
    # any field differing breaks the aggregation key: a distinct Event
    events.record(client, NS, node, events.WARNING, "DriverUpgradeFailed", "different message")
    events.record(client, NS, node, events.NORMAL, "DriverUpgradeFailed", "pod stuck")
    other = client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n2"},
                           "status": {}})
    events.record(client, NS, other, events.WARNING, "DriverUpgradeFailed", "pod stuck")
    assert len(client.list("v1", "Event", NS)) == 4


def test_record_never_raises():
    class ExplodingClient:
        def create(self, obj):
            raise ConnectionError("api server unreachable")

    assert events.record(ExplodingClient(), "ns", {"metadata": {"name": "x"}},
                         events.NORMAL, "R", "m") is None


def test_persistent_conflict_emits_one_event_across_sweeps(client, monkeypatch):
    r = _conflicting(client, monkeypatch)
    for _ in range(5):  # requeues and resyncs
        r.reconcile(Request("one"))
    assert len([e for e in client.list("v1", "Event", NS)
                if e["reason"] == "ConflictingNodeSelector"]) == 1


def _shape(event):
    keep = ("type", "reason", "message", "count", "reportingComponent")
    source = {k: _map_string(v) for k, v in (event.get("source") or {}).items()}
    return (event["metadata"]["name"].rsplit(".", 1)[0],
            dict({k: event.get(k) for k in keep}, source=source),
            {k: v for k, v in event["involvedObject"].items() if k not in ("uid",)})


def test_both_packages_store_the_same_events():
    """Names (but for the unique suffix), counts, types, reasons, messages
    and the involved object's reference agree for one sequence of emissions."""
    stores = {}
    for name, fake, mod in (("port", FakeClient, events), ("reference", RefFake, ref_events)):
        c = fake()
        nodes = [c.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": n},
                           "status": {}}) for n in ("n1", "n2", "x" * 70)]
        for i in range(12):
            node = nodes[i % 3]
            mod.record(c, NS, node, (mod.WARNING, mod.NORMAL)[i % 2],
                       ("DriverUpgradeFailed", "Ready")[i % 4 // 2], f"m{i % 5}")
        stores[name] = sorted((_shape(e) for e in c.list("v1", "Event", NS)), key=repr)
    assert stores["port"] == stores["reference"]
