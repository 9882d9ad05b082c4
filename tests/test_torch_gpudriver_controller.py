"""The GPUDriver controller against the reference's TPUDriver controller,
twin for twin with tests/test_tpudriver_controller.py.

Each test builds a TPU cluster on the reference's fake and the same cluster
with GPUs on the port's (tests/test_torch_operator_mapping.py), runs both
reconcilers through the same steps, and requires the port's objects,
statuses, conditions, Events and requeues to be the mapped reference's.
Pools are keyed on the GPU model in the port (on the accelerator and the
slice topology in the reference), so each twin gives every accelerator one
topology and its pools map one to one through ``ACCELERATORS``.
"""

import copy

import pytest

from test_torch_operator_mapping import (
    add_driver_own_settings,
    map_driver,
    map_driver_object,
    map_driver_status,
    map_labels,
    map_node,
    map_object,
    map_pool_name,
)
from tpu_operator import consts as ref_consts
from tpu_operator.api.clusterpolicy import ClusterPolicy as RefPolicy
from tpu_operator.api.clusterpolicy import new_cluster_policy as ref_new_policy
from tpu_operator.api.tpudriver import TPUDriver, new_tpu_driver
from tpu_operator.client import FakeClient as RefFake
from tpu_operator.client.errors import InvalidError as RefInvalid
from tpu_operator.controllers.runtime import Request as RefRequest
from tpu_operator.controllers.tpudriver_controller import TPUDriverReconciler
from tpu_operator.controllers.tpudriver_controller import \
    find_selector_conflicts as ref_conflicts
from tpu_operator.state.driver import StateDriver as RefStateDriver
from tpu_operator.state.manager import INFO_CLUSTER_POLICY as REF_INFO_CP
from tpu_operator.state.manager import INFO_NAMESPACE as REF_INFO_NS
from tpu_operator.state.manager import InfoCatalog as RefCatalog
from tpu_operator.state.nodepool import get_node_pools as ref_pools
from tpu_operator.testing.kubelet import KubeletSimulator
from tpu_operator_torch import consts
from tpu_operator_torch.api.clusterpolicy import ClusterPolicy, new_cluster_policy
from tpu_operator_torch.api.gpudriver import GPUDriver
from tpu_operator_torch.client import FakeClient, InvalidError
from tpu_operator_torch.conditions import ERROR, get_condition
from tpu_operator_torch.controllers.gpudriver_controller import (
    INSTANCE_LABEL,
    GPUDriverReconciler,
    find_selector_conflicts,
    pool_app_name,
)
from tpu_operator_torch.controllers.runtime import Request
from tpu_operator_torch.state.driver import StateDriver
from tpu_operator_torch.state.manager import INFO_CLUSTER_POLICY, INFO_NAMESPACE, InfoCatalog
from tpu_operator_torch.state.nodepool import get_node_pools
from tpu_operator_torch.state.skel import StateSkel

NS = "tpu-operator"
IMAGE = "registry.example.com/validator:0.1.0"
V5E, V6E, V4 = "tpu-v5-lite-podslice", "tpu-v6e-slice", "tpu-v4-podslice"
#: a label the tests' explicit selectors match on (the reference's tests
#: select one accelerator, whose pools differ by topology)
GROUP = "example.com/driver-group"


@pytest.fixture(autouse=True)
def default_images(monkeypatch):
    for env in ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE", "DEVICE_PLUGIN_IMAGE"):
        monkeypatch.setenv(env, IMAGE)


def mk_node(name, accelerator=V5E, topology="2x4", extra=None):
    labels = {
        ref_consts.GKE_TPU_ACCELERATOR_LABEL: accelerator,
        ref_consts.GKE_TPU_TOPOLOGY_LABEL: topology,
        ref_consts.deploy_label("driver"): "true",
        ref_consts.TPU_PRESENT_LABEL: "true",
        GROUP: "a",
    }
    labels.update(extra or {})
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels}, "status": {}}


def _normal(obj):
    obj = copy.deepcopy(obj)
    meta = obj["metadata"]
    for key in ("uid", "resourceVersion", "creationTimestamp", "generation"):
        meta.pop(key, None)
    for ref in meta.get("ownerReferences") or []:
        ref.pop("uid", None)
        ref["kind"] = ref["kind"].replace("TPUDriver", "GPUDriver")
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


KINDS = [("apps/v1", "DaemonSet"), ("v1", "ServiceAccount"),
         ("rbac.authorization.k8s.io/v1", "ClusterRole"),
         ("rbac.authorization.k8s.io/v1", "ClusterRoleBinding"), ("v1", "Event")]


class Twin:
    """The reference's cluster and the mapped one, reconciled in step."""

    def __init__(self, policy=True):
        self.ref, self.port = RefFake(), FakeClient()
        self.instances = []
        if policy:
            for client, new in ((self.ref, ref_new_policy), (self.port, new_cluster_policy)):
                cp = new()
                cp["metadata"]["uid"] = "cp-uid"  # the join trace derives from it
                client.create(cp)
        self.fresh()

    def fresh(self):
        """New reconcilers with empty memory (a restarted operator)."""
        self.ref_r = TPUDriverReconciler(self.ref, namespace=NS)
        self.port_r = GPUDriverReconciler(self.port, namespace=NS)

    def node(self, node):
        self.ref.create(node)
        self.port.create(map_node(node))

    def update_node(self, name, **labels):
        for client, mapped in ((self.ref, labels), (self.port, map_labels(labels))):
            node = client.get("v1", "Node", name)
            node["metadata"]["labels"].update(mapped)
            for key in [k for k, v in mapped.items() if v is None]:
                del node["metadata"]["labels"][key]
            client.update(node)

    def delete_node(self, name):
        self.ref.delete("v1", "Node", name)
        self.port.delete("v1", "Node", name)

    def driver(self, name, spec):
        self.instances.append(name)
        obj = new_tpu_driver(name, spec)
        self.ref.create(obj)
        self.port.create(map_driver(obj))

    def delete_driver(self, name):
        self.ref.delete("tpu.ai/v1alpha1", "TPUDriver", name)
        self.port.delete("tpu.ai/v1alpha1", "GPUDriver", name)

    def reconcile(self, name):
        want = self.ref_r.reconcile(RefRequest(name))
        got = self.port_r.reconcile(Request(name))
        assert got.requeue_after == want.requeue_after
        self.compare()
        return got

    def tick(self):
        """The reference's kubelet simulator marks the DaemonSets of both
        clusters available (it only counts nodes a selector matches)."""
        KubeletSimulator(self.ref).tick()
        KubeletSimulator(self.port).tick()

    def objects(self, client, mapped=False):
        out = {}
        for api_version, kind in KINDS:
            for obj in client.list(api_version, kind, None):
                if kind == "Event":
                    obj = {**obj, "metadata": {**obj["metadata"],
                                               "name": obj["reason"] + obj["involvedObject"]["name"]}}
                if mapped:
                    for instance in self.instances:
                        obj = map_driver_object(obj, instance)
                    obj = map_object(obj)
                out[(kind, obj["metadata"]["name"])] = _normal(obj)
        return out

    def compare(self):
        assert self.objects(self.port) == self.objects(self.ref, mapped=True)
        for name in self.instances:
            try:
                ref = self.ref.get("tpu.ai/v1alpha1", "TPUDriver", name)
            except Exception:
                continue
            port = self.port.get("tpu.ai/v1alpha1", "GPUDriver", name)
            assert _normal(port).get("status") == map_driver_status(
                _normal(ref).get("status") or {}) or not ref.get("status")

    def ds_names(self):
        return sorted(d["metadata"]["name"] for d in self.port.list("apps/v1", "DaemonSet", NS))

    def status(self, name):
        return self.port.get("tpu.ai/v1alpha1", "GPUDriver", name).get("status") or {}


def setup_cluster(twin, n_a=2, n_b=1, b=V6E):
    for i in range(n_a):
        twin.node(mk_node(f"a-{i}"))
    for i in range(n_b):
        twin.node(mk_node(f"b-{i}", accelerator=b))


def test_node_pool_partitioning():
    nodes = [mk_node("a"), mk_node("b"), mk_node("c", accelerator=V6E, topology="2x2"),
             mk_node("d", accelerator=V4, topology="2x2x1")]
    want = ref_pools(nodes)
    got = get_node_pools([map_node(n) for n in nodes])
    assert [(p.name, p.size, p.node_names) for p in got] == sorted(
        [(map_pool_name(p.name), p.size, p.node_names) for p in want])
    by_name = {p.name: p for p in got}
    for p in want:
        assert by_name[map_pool_name(p.name)].node_selector == map_labels(p.node_selector)
    assert [p.name for p in got] == ["nvidia-h100-80gb", "nvidia-h200-141gb", "nvidia-l4"]


def test_selector_conflicts():
    nodes = [mk_node("a", extra={"pool": "x"}), mk_node("b")]
    refs = [TPUDriver.from_obj(new_tpu_driver("one")),
            TPUDriver.from_obj(new_tpu_driver("two", {"nodeSelector": {"pool": "x"}}))]
    ports = [GPUDriver.from_obj(map_driver(d.obj)) for d in refs]
    want = ref_conflicts(refs, nodes)
    assert want == {"a": ["one", "two"]}
    assert find_selector_conflicts(ports, [map_node(n) for n in nodes]) == want


def test_reconcile_fans_out_per_pool():
    twin = Twin()
    setup_cluster(twin)
    twin.driver("main", {"repository": "gcr.io/example", "image": "validator", "version": "9.9",
                         "libtpuVersion": "2025.2.0", "nodeSelector": {GROUP: "a"}})
    assert twin.reconcile("main").requeue_after == 5.0  # DaemonSets fresh, not ready
    assert twin.ds_names() == ["gpu-driver-main-nvidia-h100-80gb",
                               "gpu-driver-main-nvidia-h200-141gb"]
    ds = twin.port.get("apps/v1", "DaemonSet", "gpu-driver-main-nvidia-h100-80gb", NS)
    assert ds["metadata"]["labels"][INSTANCE_LABEL] == "main"
    assert ds["metadata"]["labels"][consts.NODE_POOL_LABEL] == "nvidia-h100-80gb"
    ctr = ds["spec"]["template"]["spec"]["containers"][0]
    assert ctr["image"] == "gcr.io/example/validator:9.9"
    assert "--driver-version=2025.2.0" in ctr["args"]
    sel = ds["spec"]["template"]["spec"]["nodeSelector"]
    assert sel[consts.GKE_ACCELERATOR_LABEL] == "nvidia-h100-80gb"
    assert sel[consts.deploy_label("driver")] == "true"
    twin.tick()
    assert twin.reconcile("main").requeue_after is None
    assert twin.status("main")["state"] == "ready"
    assert twin.status("main")["pools"] == {"nvidia-h100-80gb": 2, "nvidia-h200-141gb": 1}


def test_stale_pool_cleanup():
    twin = Twin()
    setup_cluster(twin, n_a=1, n_b=1)
    twin.driver("main", {"image": "img", "nodeSelector": {GROUP: "a"}})
    twin.reconcile("main")
    assert len(twin.ds_names()) == 2
    twin.delete_node("b-0")  # the second pool's node leaves the fleet
    twin.reconcile("main")
    assert twin.ds_names() == ["gpu-driver-main-nvidia-h100-80gb"]


def test_conflicting_instances_blocked():
    twin = Twin()
    setup_cluster(twin, n_a=1, n_b=0)
    twin.driver("one", {"image": "img"})
    twin.driver("two", {"image": "img"})
    for _ in range(2):  # a requeue repeats no Event
        for name in ("one", "two"):
            assert twin.reconcile(name).requeue_after == 5.0
    for name in ("one", "two"):
        assert twin.status(name)["state"] == "notReady"
        live = twin.port.get("tpu.ai/v1alpha1", "GPUDriver", name)
        assert get_condition(live, ERROR)["reason"] == "ConflictingNodeSelector"
    warnings = [e for e in twin.port.list("v1", "Event", NS) if e["type"] == "Warning"]
    assert sorted(e["involvedObject"]["name"] for e in warnings) == ["one", "two"]
    assert twin.ds_names() == []


def test_requires_cluster_policy():
    twin = Twin(policy=False)
    twin.driver("main", {"image": "img"})
    assert twin.reconcile("main").requeue_after == 5.0
    live = twin.port.get("tpu.ai/v1alpha1", "GPUDriver", "main")
    assert "ClusterPolicy" in get_condition(live, ERROR)["message"]


def test_invalid_spec_rejected_by_apiserver():
    twin = Twin()
    with pytest.raises(RefInvalid, match="driverType"):
        twin.ref.create(new_tpu_driver("bad", {"driverType": "gpu", "image": "img"}))
    with pytest.raises(InvalidError, match="driverType"):
        twin.port.create(map_driver(new_tpu_driver("bad", {"driverType": "gpu", "image": "img"})))
    assert twin.port.list("tpu.ai/v1alpha1", "GPUDriver") == []


def test_invalid_spec_no_requeue():
    """A CR stored before the schema tightened still meets the controller's
    own validation: an error condition, no requeue."""
    twin = Twin()
    twin.ref._crd_schemas.clear()
    twin.port._crd_schemas.clear()
    twin.driver("bad", {"driverType": "gpu", "image": "img"})
    assert twin.reconcile("bad").requeue_after is None
    live = twin.port.get("tpu.ai/v1alpha1", "GPUDriver", "bad")
    assert "driverType" in get_condition(live, ERROR)["message"]


def test_clusterpolicy_driver_state_defers_to_gpudriver():
    twin = Twin(policy=False)
    states = []
    for client, state_cls, catalog_cls, policy_cls, cp_key, ns_key, new in (
            (twin.ref, RefStateDriver, RefCatalog, RefPolicy, REF_INFO_CP, REF_INFO_NS,
             ref_new_policy),
            (twin.port, StateDriver, InfoCatalog, ClusterPolicy, INFO_CLUSTER_POLICY,
             INFO_NAMESPACE, new_cluster_policy)):
        catalog = catalog_cls()
        cp = new()
        cp["metadata"]["uid"] = "cp-uid"
        catalog[cp_key] = policy_cls.from_obj(client.create(cp))
        catalog[ns_key] = NS
        states.append((state_cls(client), catalog))
    for state, catalog in states:
        state.sync(catalog)
    assert twin.port.get("apps/v1", "DaemonSet", "gpu-driver", NS)
    twin.compare()
    twin.driver("main", {"image": "img"})
    results = [state.sync(catalog) for state, catalog in states]
    assert [r.status.value for r in results] == ["ignore", "ignore"]
    assert results[1].message == map_object({"m": results[0].message})["m"]
    assert twin.ds_names() == []
    twin.compare()


def test_deleted_instance_cascades_daemonsets():
    twin = Twin()
    setup_cluster(twin, n_a=1, n_b=0)
    twin.driver("main", {"image": "img", "nodeSelector": {GROUP: "a"}})
    twin.reconcile("main")
    assert len(twin.ds_names()) == 1
    twin.delete_driver("main")
    assert twin.ds_names() == []  # owner-reference garbage collection
    assert twin.reconcile("main").requeue_after is None


def test_crash_during_fanout_with_pool_change_resumes():
    """DaemonSets exist from an earlier process; a node's GPU model changes
    while the operator is down; a fresh reconciler creates the new pool's
    DaemonSet, deletes the empty pool's and reports the new pools, all from
    the cluster's state."""
    twin = Twin()
    setup_cluster(twin, n_a=2, n_b=1)
    twin.driver("main", {"image": "img", "nodeSelector": {GROUP: "a"}})
    twin.reconcile("main")
    assert len(twin.ds_names()) == 2
    # the crash; while down, the second pool's node is re-provisioned
    twin.update_node("b-0", **{ref_consts.GKE_TPU_ACCELERATOR_LABEL: V4})
    twin.fresh()
    twin.reconcile("main")
    assert twin.ds_names() == ["gpu-driver-main-nvidia-h100-80gb", "gpu-driver-main-nvidia-l4"]
    twin.tick()
    twin.reconcile("main")
    assert twin.status("main")["pools"] == {"nvidia-h100-80gb": 2, "nvidia-l4": 1}
    assert twin.status("main")["state"] == "ready"


def test_a_long_pool_name_is_cut_to_63_characters():
    name = pool_app_name("a-very-long-instance-name-for-a-fleet", "nvidia-h200-141gb-extra-long")
    assert len(name) == 63 and not name.endswith("-")


def test_an_event_on_one_instance_reconciles_every_instance():
    """The deliberate difference (ROADMAP Queue 3): a GPUDriver created
    with a selector that claims another instance's node re-reconciles that
    instance too, so both show the conflict at once; the reference maps the
    event to its own instance only (the other learns at its next resync)."""
    from tpu_operator.client.interface import WatchEvent as RefEvent
    from tpu_operator.controllers.tpudriver_controller import setup_tpudriver_controller
    from tpu_operator_torch.client.interface import WatchEvent
    from tpu_operator_torch.controllers.gpudriver_controller import setup_gpudriver_controller

    twin = Twin()
    twin.driver("one", {"image": "img"})
    twin.driver("two", {"image": "img"})
    ref = setup_tpudriver_controller(twin.ref, twin.ref_r)
    port = setup_gpudriver_controller(twin.port, twin.port_r)
    ref_map = next(s.mapper for s in ref.watch_specs if s.kind == "TPUDriver")
    port_map = next(s.mapper for s in port.watch_specs if s.kind == "GPUDriver")
    event = twin.ref.get("tpu.ai/v1alpha1", "TPUDriver", "two")
    assert [r.name for r in ref_map(RefEvent("ADDED", event))] == ["two"]
    got = port_map(WatchEvent("ADDED", map_driver(event)))
    assert [r.name for r in got] == ["two", "one"]
    # a deleted instance's event reaches the survivors
    twin.delete_driver("two")
    assert [r.name for r in port_map(WatchEvent("DELETED", map_driver(event)))] == ["two", "one"]


def test_a_gpudriver_s_own_settings_reach_its_daemonset():
    """A GPUDriver's own toleration, label, annotation, node affinity and
    priority class, none of which the ClusterPolicy has, reach its pool's
    DaemonSet; the reference renders the same DaemonSet without them (the
    difference :func:`add_driver_own_settings` states)."""
    own = {
        "labels": {"example.com/team": "ml"},
        "annotations": {"example.com/owner": "infra"},
        "tolerations": [{"key": "example.com/dedicated", "operator": "Equal",
                         "value": "gpu", "effect": "NoSchedule"}],
        "nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchExpressions": [{
                "key": "example.com/zone", "operator": "In", "values": ["a"]}]}]}},
        "priorityClassName": "gpu-critical",
    }
    twin = Twin()
    setup_cluster(twin, n_a=1, n_b=0)
    twin.driver("main", {"image": "img", "nodeSelector": {GROUP: "a"}, **own})
    twin.ref_r.reconcile(RefRequest("main"))
    twin.port_r.reconcile(Request("main"))
    name = "gpu-driver-main-nvidia-h100-80gb"
    port = _normal(twin.port.get("apps/v1", "DaemonSet", name, NS))
    (ref,) = twin.ref.list("apps/v1", "DaemonSet", NS)
    mapped = _normal(map_object(map_driver_object(ref, "main")))
    pod = port["spec"]["template"]["spec"]
    assert port["metadata"]["labels"]["example.com/team"] == "ml"
    assert port["spec"]["template"]["metadata"]["annotations"]["example.com/owner"] == "infra"
    assert own["tolerations"][0] in pod["tolerations"]
    assert pod["affinity"] == {"nodeAffinity": own["nodeAffinity"]}
    assert pod["priorityClassName"] == "gpu-critical"
    # the reference's DaemonSet has none of the five (its fault) ...
    ref_pod = mapped["spec"]["template"]["spec"]
    assert "example.com/team" not in mapped["metadata"]["labels"]
    assert own["tolerations"][0] not in ref_pod["tolerations"]
    assert "affinity" not in ref_pod and ref_pod["priorityClassName"] != "gpu-critical"
    # ... and is the port's in every other field
    want = add_driver_own_settings(mapped, own)
    want["metadata"]["annotations"][consts.SPEC_HASH_ANNOTATION] = \
        port["metadata"]["annotations"][consts.SPEC_HASH_ANNOTATION]
    assert port == want
