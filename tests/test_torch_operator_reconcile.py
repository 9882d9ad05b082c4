"""The ClusterPolicy reconciler against the reference's, on the fakes.

The reference's reconciler runs on a TPU cluster and the port's on the
mapped GPU cluster (tests/test_torch_operator_mapping.py), through the same
sequence of DaemonSet status, Node and Pod changes. After every sweep the
objects in each cluster, the status ``state`` and the conditions must be
the mapped reference's. The reference's health sweep waits for its slice
in the port, so the CR turns it off (``spec.health.enabled: false``).

The twin of tests/test_clusterpolicy_controller.py.
"""

import copy

import numpy as np
import pytest

from test_golden_states import SPEC
from test_torch_operator_mapping import map_node, map_object, map_spec
from tpu_operator.client import FakeClient as RefFake
from tpu_operator.client import WriteBatcher as RefBatcher
from tpu_operator.controllers.clusterpolicy_controller import \
    ClusterPolicyReconciler as RefReconciler
from tpu_operator.controllers.runtime import Request as RefRequest
from tpu_operator_torch import consts
from tpu_operator_torch.client import FakeClient, WriteBatcher
from tpu_operator_torch.controllers.clusterpolicy_controller import ClusterPolicyReconciler
from tpu_operator_torch.controllers.runtime import Request
from tpu_operator_torch.state.skel import StateSkel

NS = "tpu-operator"
#: serving stays off: the reference's labeller never sets the serving
#: deploy label, the port's does (tests/test_torch_operator_nodes.py pins
#: that difference); the serving rollup reads node labels either way
BASE = dict(copy.deepcopy(SPEC), health={"enabled": False},
            serving=dict(SPEC["serving"], enabled=False))


def _policy(spec):
    return {"apiVersion": "tpu.ai/v1", "kind": "ClusterPolicy",
            "metadata": {"name": "cluster-policy", "uid": "cp-uid"}, "spec": spec}


def _nodes(seed, n=5):
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n):
        labels = {}
        if rng.random() < 0.7:
            labels["cloud.google.com/gke-tpu-accelerator"] = "tpu-v5-lite-podslice"
        if rng.random() < 0.2:
            labels["tpu.ai/tpu.deploy.telemetry"] = "false"
        nodes.append({"apiVersion": "v1", "kind": "Node",
                      "metadata": {"name": f"node-{i}", "labels": labels}, "status": {}})
    return nodes


def _normal(obj):
    """Server-managed fields out; the spec hash recomputed from the rest
    (it hashes the rendered object, whose names the mapping changed)."""
    obj = copy.deepcopy(obj)
    meta = obj["metadata"]
    for key in ("uid", "resourceVersion", "creationTimestamp", "generation"):
        meta.pop(key, None)
    annotations = meta.get("annotations") or {}
    if consts.SPEC_HASH_ANNOTATION in annotations:
        desired = copy.deepcopy(obj)
        desired.pop("status", None)
        annotations[consts.SPEC_HASH_ANNOTATION] = StateSkel._desired_fingerprint(desired)
    if obj.get("kind") == "Event":
        return {"reason": obj["reason"], "type": obj["type"], "message": obj["message"],
                "involved": obj["involvedObject"]["name"], "count": obj.get("count")}
    for cond in (obj.get("status") or {}).get("conditions") or []:
        cond.pop("lastTransitionTime", None)
    return obj


KINDS = [("apps/v1", "DaemonSet"), ("v1", "Service"), ("v1", "ServiceAccount"),
         ("v1", "ConfigMap"), ("rbac.authorization.k8s.io/v1", "ClusterRole"),
         ("rbac.authorization.k8s.io/v1", "ClusterRoleBinding"),
         ("rbac.authorization.k8s.io/v1", "Role"), ("rbac.authorization.k8s.io/v1", "RoleBinding"),
         ("scheduling.k8s.io/v1", "PriorityClass"), ("monitoring.coreos.com/v1", "ServiceMonitor"),
         ("monitoring.coreos.com/v1", "PrometheusRule"), ("v1", "Pod"), ("v1", "Event")]


class Twin:
    def __init__(self, nodes, spec=BASE, batched=False):
        self.ref = RefFake(objects=copy.deepcopy(nodes) + [_policy(copy.deepcopy(spec))])
        self.port = FakeClient(objects=[map_node(n) for n in nodes] + [_policy(map_spec(spec))])
        # the operators' own chains put the write coalescer in front
        ref_client = RefBatcher(self.ref) if batched else self.ref
        port_client = WriteBatcher(self.port) if batched else self.port
        self.ref_r = RefReconciler(ref_client, namespace=NS)
        self.port_r = ClusterPolicyReconciler(port_client, namespace=NS)
        self.states = []

    def reconcile(self):
        want = self.ref_r.reconcile(RefRequest("cluster-policy"))
        got = self.port_r.reconcile(Request("cluster-policy"))
        assert got.requeue_after == want.requeue_after
        self.compare()
        state = self.port.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")["status"]["state"]
        self.states.append(state)
        return state

    def objects(self, client, mapped=False):
        out = {}
        for api_version, kind in KINDS:
            for obj in client.list(api_version, kind, None):
                if kind == "Event":
                    obj = {**obj, "metadata": {**obj["metadata"], "name": obj["reason"]}}
                obj = map_object(obj) if mapped else obj
                out[(kind, obj["metadata"]["name"])] = _normal(obj)
        return out

    def compare(self):
        assert self.objects(self.port) == self.objects(self.ref, mapped=True)
        ref_cp = self.ref.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        port_cp = self.port.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        assert _normal(port_cp)["status"] == _normal(ref_cp)["status"]
        ref_nodes = {n["metadata"]["name"]: map_node(n)["metadata"].get("labels")
                     for n in self.ref.list("v1", "Node")}
        assert {n["metadata"]["name"]: n["metadata"].get("labels")
                for n in self.port.list("v1", "Node")} == ref_nodes

    def kubelet(self, available=True, only=None):
        """Both DaemonSet controllers' status: every DS scheduled on the
        nodes its selector matches, available or not."""
        for client in (self.ref, self.port):
            nodes = client.list("v1", "Node")
            for ds in client.list("apps/v1", "DaemonSet", NS):
                if only and not ds["metadata"]["name"].endswith(only):
                    continue
                selector = ds["spec"]["template"]["spec"].get("nodeSelector") or {}
                n = sum(1 for node in nodes
                        if all(node["metadata"].get("labels", {}).get(k) == v
                               for k, v in selector.items()))
                ds["status"] = {"desiredNumberScheduled": n, "updatedNumberScheduled": n,
                                "numberAvailable": n if available else 0,
                                "observedGeneration": ds["metadata"]["generation"]}
                client.update_status(ds)


@pytest.mark.parametrize("batched", [False, True], ids=["direct", "batched"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_to_ready_matches_reference(seed, batched):
    twin = Twin(_nodes(seed), batched=batched)
    assert twin.reconcile() == "notReady"
    assert twin.reconcile() == "notReady"  # level-driven: nothing new
    twin.kubelet(available=False)
    assert twin.reconcile() == "notReady"
    twin.kubelet()
    assert twin.reconcile() == "ready"
    assert twin.reconcile() == "ready"
    # a node joins: DaemonSets desire one more pod, not yet available
    node = {"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "late", "labels": {"cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"}}}
    twin.ref.create(copy.deepcopy(node))
    twin.port.create(map_node(node))
    twin.reconcile()
    twin.kubelet(available=False, only="validator")
    assert twin.reconcile() == "notReady"
    twin.kubelet()
    assert twin.reconcile() == "ready"
    assert twin.states == ["notReady", "notReady", "notReady", "ready", "ready", "ready",
                           "notReady", "ready"]


def test_slice_partition_failures_surface_on_the_cr():
    twin = Twin(_nodes(3))
    twin.reconcile()
    twin.kubelet()
    assert twin.reconcile() == "ready"
    failed = {"metadata": {"labels": {consts.TPU_SLICE_STATE_LABEL: "failed"}}}
    for name in ("node-1", "node-3"):
        twin.ref.patch("v1", "Node", name, copy.deepcopy(failed))
        twin.port.patch("v1", "Node", name, copy.deepcopy(failed))
    twin.reconcile()
    cp = twin.port.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
    cond = {c["type"]: c for c in cp["status"]["conditions"]}["SlicePartitionFailed"]
    assert cond["status"] == "True" and "node-1, node-3" in cond["message"]
    assert twin.port_r.metrics.slice_partition_failed_nodes._own().read() == 2
    for name in ("node-1", "node-3"):
        fixed = {"metadata": {"labels": {consts.TPU_SLICE_STATE_LABEL: "success"}}}
        twin.ref.patch("v1", "Node", name, copy.deepcopy(fixed))
        twin.port.patch("v1", "Node", name, copy.deepcopy(fixed))
    twin.reconcile()
    cp = twin.port.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
    assert {c["type"]: c for c in cp["status"]["conditions"]}[
        "SlicePartitionFailed"]["status"] == "False"


@pytest.mark.parametrize("seed", [4, 5])
def test_the_serving_rollup_from_node_labels(seed):
    rng = np.random.default_rng(seed)
    twin = Twin(_nodes(seed))
    twin.reconcile()
    verdicts = {}
    for i in range(5):
        verdict = str(rng.choice(["passed", "failed", "corrupt", "none"]))
        if verdict == "none":
            continue
        verdicts[f"node-{i}"] = verdict
        patch = {"metadata": {"labels": {consts.SERVING_SLO_LABEL: verdict},
                              "annotations": {consts.SERVING_SLO_ANNOTATION:
                                              f"p99_ms={rng.integers(1, 90)},"
                                              f"tokens_per_s={rng.integers(100, 9000)},"
                                              f"attainment=1.0"}}}
        twin.ref.patch("v1", "Node", f"node-{i}", copy.deepcopy(patch))
        twin.port.patch("v1", "Node", f"node-{i}", copy.deepcopy(patch))
    twin.kubelet()
    twin.reconcile()
    cp = twin.port.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
    conds = {c["type"]: c for c in cp["status"]["conditions"]}
    failing = sorted(n for n, v in verdicts.items() if v != "passed")
    if failing:
        assert conds["ServingValidated"]["status"] == "False"
        assert ", ".join(failing) in conds["ServingValidated"]["message"]
    elif verdicts:
        assert conds["ServingValidated"]["status"] == "True"
    scrape = twin.port_r.metrics.scrape().decode()
    assert f"tpu_operator_serving_slo_failing_nodes {float(len(failing))!r}" in scrape
    for name in verdicts:
        assert f'tpu_operator_serving_decode_p99_seconds{{node="{name}"}}' in scrape


def test_a_disabled_operand_is_deleted():
    twin = Twin(_nodes(6))
    twin.reconcile()
    twin.kubelet()
    assert twin.reconcile() == "ready"
    for client, spec in ((twin.ref, BASE), (twin.port, map_spec(BASE))):
        spec = copy.deepcopy(spec)
        spec["telemetry"]["enabled"] = False
        spec["nodeStatusExporter"]["enabled"] = False
        client.patch("tpu.ai/v1", "ClusterPolicy", "cluster-policy", {"spec": spec})
    assert twin.reconcile() == "ready"
    names = {ds["metadata"]["name"] for ds in twin.port.list("apps/v1", "DaemonSet", NS)}
    assert "gpu-telemetry-exporter" not in names and "gpu-node-status-exporter" not in names
    assert not twin.port.list("v1", "Service", NS,
                              label_selector={consts.STATE_LABEL: "state-telemetry"})
    for node in twin.port.list("v1", "Node"):  # a kill switch stays
        assert node["metadata"].get("labels", {}).get(
            consts.deploy_label("telemetry")) in (None, "false")


def test_a_failing_operand_state_errors_the_cr_once():
    """A state that raises marks the CR notReady with ReconcileFailed and
    one Warning Event per distinct failure, as the reference."""
    twin = Twin(_nodes(7))
    twin.reconcile()
    twin.kubelet()
    assert twin.reconcile() == "ready"
    for r in (twin.ref_r, twin.port_r):
        state = next(s for s in r.state_manager.states if s.name == "state-telemetry")
        state.sync = lambda catalog: (_ for _ in ()).throw(RuntimeError("render exploded"))
    for _ in range(3):
        assert twin.reconcile() == "notReady"
    cp = twin.port.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
    error = {c["type"]: c for c in cp["status"]["conditions"]}["Error"]
    assert error["reason"] == "ReconcileFailed" and "render exploded" in error["message"]
    warnings = [e for e in twin.port.list("v1", "Event", NS) if e["type"] == "Warning"]
    assert len(warnings) == 1 and warnings[0].get("count", 1) == 1


def _samples(text):
    """{sample: value} and the TYPE lines of a Prometheus text scrape, the
    ``_created`` stamps (a wall clock) left out."""
    samples, types = {}, set()
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            types.add(line)
        elif line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            if "_created" not in key:
                samples[key] = float(value)
    return samples, types


#: the reference's metric families the port leaves out, as their ``# TYPE``
#: lines name them: none, the race sanitizer's included
FAMILIES_LEFT_OUT: tuple = ()
#: the race sanitizer's families, which every scrape carries, switch on or off
OPSAN_FAMILIES = ("tpu_operator_opsan_races_total", "tpu_operator_opsan_races_created",
                  "tpu_operator_opsan_tracked_accesses_total",
                  "tpu_operator_opsan_tracked_accesses_created")


def test_the_metrics_text_is_prometheus_clients_for_the_same_values():
    """The port writes its families as prometheus_client writes the
    reference's: the same names, types, labels, buckets and values."""
    from tpu_operator.controllers.metrics import OperatorMetrics as RefMetrics
    from tpu_operator_torch.controllers.metrics import OperatorMetrics

    ref, port = RefMetrics(), OperatorMetrics()
    for m, nodes in ((ref, ref.tpu_nodes_total), (port, port.gpu_nodes_total)):
        m.reconciliation_total.inc(3)
        m.reconciliation_status.set(1)
        nodes.set(5)
        m.serving_decode_p99.labels(node="n1").set(0.0123)
        m.serving_throughput.labels(node="n2").set(123456789.0)
        m.workqueue_adds.labels(name="clusterpolicy").inc()
        for value in (0.0005, 0.05, 2.0, 100.0):
            m.reconcile_duration.labels(name="clusterpolicy").observe(value)
        m.write_batch_size.observe(3)
        m.rest_requests.labels(method="GET", code="200").inc(2)
    want, want_types = _samples(ref.scrape().decode())
    got, got_types = _samples(port.scrape().decode())
    # every family of the reference, the race sanitizer's included
    assert got_types == want_types
    assert not FAMILIES_LEFT_OUT
    assert all(any(t.endswith(f" {name} counter") or t.endswith(f" {name} gauge")
                   for t in got_types) for name in OPSAN_FAMILIES)
    assert got == {k: v for k, v in want.items() if k in got}
    assert len(got) >= 20
