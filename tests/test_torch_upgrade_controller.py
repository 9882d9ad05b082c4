"""The port's upgrade reconciler (tpu_operator_torch/controllers/
upgrade_controller.py) against the reference's.

The reconciler's cases of tests/test_upgrade.py run as scripts on both
packages, as tests/test_torch_upgrade.py runs the machine's: after each
reconcile the nodes' states, annotations and cordons, the result's requeue
and the five ``tpu_operator_nodes_upgrades_*`` gauges are logged, and the
reference's log, mapped, must equal the port's. A TPUDriver of the
reference is a GPUDriver of the port. Then the twins of
tests/test_upgrade_fault_injection.py's resume cases (the operator killed
at each state of a one-node upgrade, and mid-way through a three-node one)
and of tests/test_upgrade_e2e.py (a rolling upgrade end to end, direct and
behind the informer cache), each run on both packages with each package's
in-memory kubelet; and the requeue on a PDB-blocked eviction's hint.

And the reference's chaos case (``test_chaos_pod_deletion_during_rolling_upgrade``,
slow as the reference's), each package's ``PodChaos`` deleting operand pods
during a roll; and its 50-node pool join (slow), on the port.
"""

import ast
import time
import types

import pytest

from test_torch_upgrade import MACHINE_CASES, NS, PORT, REF, World
from tpu_operator.api.clusterpolicy import new_cluster_policy as ref_new_policy
from tpu_operator.client.cache import CachedClient as RefCached
from tpu_operator.controllers import clusterpolicy_controller as ref_cp_controller
from tpu_operator.controllers import upgrade_controller as ref_controller
from tpu_operator.controllers.runtime import Request as RefRequest
from tpu_operator.testing.kubelet import KubeletSimulator as RefKubelet
from tpu_operator_torch import consts
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.client.cache import CachedClient
from tpu_operator_torch.controllers import clusterpolicy_controller as cp_controller
from tpu_operator_torch.controllers import upgrade_controller as controller
from tpu_operator_torch.controllers.runtime import Request
from tpu_operator_torch.testing.kubelet import KubeletSimulator
from tpu_operator_torch.utils import deep_get

GAUGES = ("pending", "in_progress", "done", "failed", "available")

REF_STACK = types.SimpleNamespace(
    new_policy=ref_new_policy, ctl=ref_controller, cp=ref_cp_controller, Request=RefRequest,
    Kubelet=RefKubelet, Cached=RefCached, driver_kind="TPUDriver")
PORT_STACK = types.SimpleNamespace(
    new_policy=new_cluster_policy, ctl=controller, cp=cp_controller, Request=Request,
    Kubelet=KubeletSimulator, Cached=CachedClient, driver_kind="GPUDriver")


@pytest.fixture(autouse=True)
def default_images(monkeypatch):
    for env in ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE", "DEVICE_PLUGIN_IMAGE"):
        monkeypatch.setenv(env, "registry.example/operand:0.1.0")


class Cluster(World):
    """A :class:`World` with the reconciler on top."""

    def __init__(self, side):
        super().__init__(side)
        self.k = PORT_STACK if side.port else REF_STACK

    def policy(self, **upgrade_policy):
        spec = {"driver": {"upgradePolicy": upgrade_policy}} if upgrade_policy else None
        self.client.create(self.k.new_policy(spec=spec))

    def driver_cr(self, name, selector, auto_upgrade):
        self.client.create({"apiVersion": "tpu.ai/v1alpha1", "kind": self.k.driver_kind,
                            "metadata": {"name": name},
                            "spec": {"nodeSelector": selector,
                                     "upgradePolicy": {"autoUpgrade": auto_upgrade}}})

    def reconciler(self, **kw):
        return self.k.ctl.UpgradeReconciler(self.client, journal=self.journal, **kw)

    def reconcile(self, r):
        result = r.reconcile(self.k.ctl.SINGLETON_REQUEST)
        self.observe()
        text = r.metrics.scrape().decode()
        self.log[-1]["requeue_after"] = result.requeue_after
        samples = dict(line.rsplit(" ", 1) for line in text.splitlines()
                       if line.startswith("tpu_operator_nodes_upgrades_"))
        self.log[-1]["gauges"] = {g: float(samples[f"tpu_operator_nodes_upgrades_{g}"])
                                  for g in GAUGES}
        return result

    def gauge(self, r, name):
        return self.log[-1]["gauges"][name]


# -- the reference's reconciler cases ----------------------------------------------

def case_upgrade_reconciler_disabled_clears_labels(w):
    w.setup()
    w.place("node-0", w.m.DRAIN_REQUIRED, unschedulable=True)
    w.policy()  # autoUpgrade defaults false
    result = w.reconcile(w.reconciler())
    assert result.requeue_after is None
    assert w.c.UPGRADE_STATE_LABEL not in w.node()["metadata"]["labels"]
    assert not w.cordoned()


def case_upgrade_reconciler_enabled_progresses_and_requeues(w):
    w.setup()
    w.policy(autoUpgrade=True)
    r = w.reconciler(requeue_after=60.0)
    assert w.reconcile(r).requeue_after == 60.0
    assert w.state() == w.m.UPGRADE_REQUIRED
    assert w.gauge(r, "pending") == 1.0


def case_tpudriver_upgrade_policy_governs_its_pool(w):
    w.setup(n_nodes=2)
    w.place("node-1", None, labels={"pool": "v5e"})
    w.policy()
    w.driver_cr("v5e", {"pool": "v5e"}, True)
    assert w.reconcile(w.reconciler(requeue_after=60.0)).requeue_after == 60.0
    assert w.state("node-1") == w.m.UPGRADE_REQUIRED and w.state("node-0") == w.m.UNKNOWN


def case_tpudriver_upgrade_policy_off_clears_its_pool(w):
    w.setup(n_nodes=2)
    w.place("node-1", w.m.UPGRADE_REQUIRED, labels={"pool": "frozen"})
    w.policy(autoUpgrade=True)
    w.driver_cr("frozen", {"pool": "frozen"}, False)
    w.reconcile(w.reconciler())
    assert w.state("node-0") == w.m.UPGRADE_REQUIRED and w.state("node-1") == w.m.UNKNOWN


def case_conflicted_tpudriver_does_not_capture_nodes(w):
    w.setup()
    w.policy(autoUpgrade=True)
    key, value = w.s.accelerator
    w.driver_cr("a", {key: value}, False)
    w.driver_cr("b", {key: value}, False)
    w.reconcile(w.reconciler())
    assert w.state() == w.m.UPGRADE_REQUIRED


def case_no_clusterpolicy_clears_all_nodes_even_tpudriver_pools(w):
    w.setup(n_nodes=2)
    w.place("node-1", w.m.CORDON_REQUIRED, unschedulable=True, labels={"pool": "v5e"})
    w.driver_cr("v5e", {"pool": "v5e"}, True)
    assert w.reconcile(w.reconciler()).requeue_after is None
    for name in ("node-0", "node-1"):
        assert w.state(name) == w.m.UNKNOWN and not w.cordoned(name), name


def case_frozen_pool_unhealthy_node_not_counted_available(w):
    w.setup(n_nodes=3)
    w.place("node-1", w.m.FAILED, labels={"pool": "frozen"})
    w.place("node-2", None, labels={"pool": "frozen"})
    w.policy(autoUpgrade=True)
    w.driver_cr("frozen", {"pool": "frozen"}, False)
    r = w.reconciler()
    for _ in range(2):
        w.reconcile(r)
        assert w.gauge(r, "available") == 1.0 and w.gauge(r, "failed") == 1.0
    assert w.state("node-1") == w.m.FAILED


def case_policy_deletion_zeroes_gauges(w):
    w.setup()
    w.policy(autoUpgrade=True)
    r = w.reconciler()
    w.reconcile(r)
    assert w.gauge(r, "pending") == 1.0
    w.client.delete("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
    w.reconcile(r)
    assert w.gauge(r, "pending") == 0.0 and w.gauge(r, "available") == 1.0
    assert w.state() == w.m.UNKNOWN


def case_frozen_pool_counts_as_available(w):
    w.setup(n_nodes=3)
    for name in ("node-1", "node-2"):
        w.place(name, None, labels={"pool": "frozen"})
    w.policy(autoUpgrade=True)
    w.driver_cr("frozen", {"pool": "frozen"}, False)
    r = w.reconciler()
    w.reconcile(r)
    assert w.gauge(r, "pending") == 1.0 and w.gauge(r, "available") == 2.0


RECONCILER_CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
                    if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(RECONCILER_CASES))
def test_reconciler_matches_reference(case):
    ref, port = Cluster(REF), Cluster(PORT)
    RECONCILER_CASES[case](ref)
    RECONCILER_CASES[case](port)
    assert port.record() == ref.record()


def test_every_reference_case_has_a_twin():
    with open(__file__.replace("test_torch_upgrade_controller.py", "test_upgrade.py")) as f:
        tree = ast.parse(f.read())
    ref_tests = {n.name[len("test_"):] for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert set(MACHINE_CASES) | set(RECONCILER_CASES) == ref_tests
    assert not set(MACHINE_CASES) & set(RECONCILER_CASES)


# -- the requeue on a PDB-blocked eviction's hint -----------------------------------

@pytest.mark.parametrize("retry_after,requeue", [(2.0, 2.0), (0.1, 0.5), (500.0, 120.0)],
                         ids=["the-hint", "at-least-half-a-second", "at-most-the-period"])
def test_a_blocked_eviction_requeues_on_its_hint(retry_after, requeue, monkeypatch):
    from tpu_operator_torch.client import fake

    monkeypatch.setattr(fake, "EVICTION_RETRY_AFTER_S", retry_after)
    w = Cluster(PORT)
    w.setup()
    pod = w.mk_pod("workload", "node-0", None, "user:1", gpus=1)
    pod["metadata"]["labels"]["app"] = "train"
    w.client.create(pod)
    w.client.create(w.mk_pdb("train-pdb", {"app": "train"}))
    w.policy(autoUpgrade=True, podDeletion={"timeoutSeconds": 10, "force": True})
    r = w.reconciler()
    assert w.reconcile(r).requeue_after == 120.0  # upgrade-required
    assert w.reconcile(r).requeue_after == requeue  # the eviction refused
    assert w.state() == w.m.POD_DELETION_REQUIRED
    assert w.gauge(r, "in_progress") == 1.0


# -- the operator killed at each state, then resumed ---------------------------------

OLD, NEW = "1.0", "2.0"
RESUMABLE_STATES = ("upgrade-required", "cordon-required", "wait-for-jobs-required",
                    "pod-deletion-required", "drain-required", "pod-restart-required",
                    "validation-required", "uncordon-required", "upgrade-done")


def wait_for(predicate, timeout=45.0, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {message}")


class Stack:
    """One package's operator (the ClusterPolicy and upgrade controllers)
    and in-memory kubelet over its fake, as the reference's resume tests
    run them."""

    def __init__(self, side, nodes=1, version=OLD, max_parallel=1, cached=False):
        self.s = side
        self.k = PORT_STACK if side.port else REF_STACK
        self.client = side.Fake()
        key, value = side.accelerator
        for i in range(nodes):
            self.client.create({"apiVersion": "v1", "kind": "Node",
                                "metadata": {"name": f"node-{i}", "labels": {key: value}},
                                "spec": {}, "status": {}})
        self.client.create(self.k.new_policy(spec={"driver": {
            "repository": "registry.example", "image": "driver", "version": version,
            "upgradePolicy": {"autoUpgrade": True, "maxParallelUpgrades": max_parallel}}}))
        self.ctl = self.k.Cached(self.client) if cached else self.client
        self.parts = None

    def start(self):
        cp = self.k.cp.setup_clusterpolicy_controller(
            self.ctl, self.k.cp.ClusterPolicyReconciler(self.ctl, requeue_after=0.1))
        up = self.k.ctl.setup_upgrade_controller(
            self.ctl, self.k.ctl.UpgradeReconciler(self.ctl, requeue_after=0.1))
        # the port's simulator always runs pods; the reference's on request
        kubelet = self.k.Kubelet(self.client, interval=0.03,
                                 **({} if self.s.port else {"create_pods": True})).start()
        cp.start(self.ctl)
        up.start(self.ctl)
        # a fake's watch replays nothing at its start, where a real
        # apiserver's replays every object: kick both, as that replay would
        cp.queue.add(self.k.Request(name="cluster-policy"))
        up.queue.add(self.k.ctl.SINGLETON_REQUEST)
        self.parts = (cp, up, kubelet)
        return self

    def stop(self):
        for part in self.parts or ():
            part.stop()
        self.parts = None

    def images(self):
        return {deep_get(p, "spec", "nodeName"): p["spec"]["containers"][0]["image"]
                for p in self.client.list("v1", "Pod", NS, label_selector={
                    "app.kubernetes.io/component": self.s.driver})}

    def ready(self):
        return deep_get(self.client.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy"),
                        "status", "state") == "ready"

    def settled(self, image):
        return (set(self.images().values()) == {image}
                and all(self.s.m.node_upgrade_state(n) in (self.s.m.UNKNOWN, self.s.m.DONE)
                        and not n["spec"].get("unschedulable")
                        for n in self.client.list("v1", "Node")))

    def bump(self, version):
        self.client.patch("tpu.ai/v1", "ClusterPolicy", "cluster-policy",
                          {"spec": {"driver": {"version": version}}})


def image(version):
    return f"registry.example/driver:{version}"


def killed_at(side, state):
    """The wreckage a crash right after recording ``state`` leaves, as each
    package's upgrade leaves it, then a fresh operator to the end."""
    s = Stack(side, version=NEW)
    cordoned = state not in ("upgrade-required", "upgrade-done")
    old_pod = state in ("upgrade-required", "cordon-required", "wait-for-jobs-required",
                        "pod-deletion-required", "drain-required")
    node = s.client.get("v1", "Node", "node-0")
    node["metadata"]["labels"][side.consts.UPGRADE_STATE_LABEL] = state
    anns = node["metadata"].setdefault("annotations", {})
    anns[side.consts.UPGRADE_STATE_SINCE_ANNOTATION] = time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    if cordoned:
        node["spec"]["unschedulable"] = True
        if side.port:
            anns[consts.UPGRADE_CORDONED_ANNOTATION] = "true"
    s.client.update(node)
    if old_pod or state == "upgrade-done":
        s.client.create({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "drv-node-0", "namespace": NS,
                         "labels": {"app.kubernetes.io/component": side.driver,
                                    "tpu.ai/kubelet-sim-ds": "x"}},
            "spec": {"nodeName": "node-0", "containers": [{
                "name": "c", "image": image(NEW if state == "upgrade-done" else OLD),
                "args": ["-c", "driver-daemon"]}]},
            "status": {"phase": "Running", "conditions": [{"type": "Ready", "status": "True"}]}})
    s.start()
    try:
        wait_for(lambda: s.settled(image(NEW)), message=f"{side.name} resumed from {state}")
    finally:
        s.stop()
    return s


@pytest.mark.parametrize("state", RESUMABLE_STATES)
def test_the_operator_killed_at_a_state_resumes_as_the_reference(state):
    for side in (REF, PORT):
        s = killed_at(side, state)
        assert s.images() == {"node-0": image(NEW)}, side.name


def test_the_operator_killed_mid_rolling_upgrade_resumes_as_the_reference():
    for side in (REF, PORT):
        s = Stack(side, nodes=3).start()
        try:
            wait_for(s.ready, message="initial install")
            s.bump(NEW)
            wait_for(lambda: any(side.m.node_upgrade_state(n) != side.m.UNKNOWN
                                 for n in s.client.list("v1", "Node")), message="upgrade started")
        finally:
            s.stop()  # the operator dies mid-flight
        s.start()  # a fresh operator
        try:
            wait_for(lambda: s.settled(image(NEW)), timeout=90,
                     message=f"{side.name}: the rollout finished by the new operator")
        finally:
            s.stop()


@pytest.mark.parametrize("cached", [False, True], ids=["direct", "cached"])
def test_a_rolling_upgrade_end_to_end_as_the_reference(cached):
    """A driver version bump rolls every node through cordon, pod restart,
    validation and uncordon; the driver DaemonSet is OnDelete, so the
    machine, not the DaemonSet controller, orders the rollout."""
    for side in (REF, PORT):
        s = Stack(side, nodes=2, cached=cached).start()
        try:
            wait_for(s.ready, message=f"{side.name}: initial install ready")
            assert set(s.images().values()) == {image(OLD)}
            ds = [d for d in s.client.list("apps/v1", "DaemonSet", NS)
                  if deep_get(d, "spec", "template", "metadata", "labels",
                              "app.kubernetes.io/component") == side.driver]
            assert [d["spec"]["updateStrategy"]["type"] for d in ds] == ["OnDelete"]
            s.bump(NEW)
            wait_for(lambda: s.settled(image(NEW)), timeout=60,
                     message=f"{side.name}: every driver pod on 2.0, nodes uncordoned")
            wait_for(s.ready, message=f"{side.name}: ready after the upgrade")
        finally:
            s.stop()
            s.ctl.stop()


@pytest.mark.slow
def test_chaos_pod_deletion_during_rolling_upgrade_as_the_reference():
    """The twin of tests/test_upgrade_fault_injection.py's chaos case: each
    package's ``PodChaos`` deletes operand pods at random (seed 1729) for 3 s
    of a three-node roll at two nodes at a time; every driver pod still ends
    on the new version, every node settled and uncordoned."""
    from tpu_operator.testing.chaos import PodChaos as RefPodChaos
    from tpu_operator_torch.testing.chaos import PodChaos

    for side in (REF, PORT):
        s = Stack(side, nodes=3, max_parallel=2).start()
        chaos = (PodChaos if side.port else RefPodChaos)(s.client, NS, interval_s=0.05,
                                                           seed=1729)
        try:
            wait_for(s.ready, timeout=90, message=f"{side.name}: initial install")
            s.bump(NEW)
            chaos.start()
            time.sleep(3.0)  # the deletions overlap the rollout
            chaos.stop()
            assert chaos.victim_count > 0, side.name
            wait_for(lambda: s.settled(image(NEW)), timeout=90,
                     message=f"{side.name}: every driver pod on 2.0, nodes settled")
        finally:
            chaos.stop()
            s.stop()


@pytest.mark.slow
def test_a_fifty_node_pool_joins():
    """The twin of tests/test_upgrade_fault_injection.py's
    ``test_scale_fifty_node_pool_join`` (slow as the reference's), on the
    port's stack: the ClusterPolicy and upgrade controllers and the
    in-memory kubelet over the port's fake; 50 GPU nodes join, every one
    advertises ``nvidia.com/gpu`` and the ClusterPolicy reaches ``ready``,
    each within the reference's 60 s wait (no wall-clock assert, as the
    reference's)."""
    client = PORT.Fake()
    client.create(new_cluster_policy(spec={"driver": {
        "repository": "registry.example", "image": "driver", "version": "1.0"}}))
    cp = cp_controller.setup_clusterpolicy_controller(
        client, cp_controller.ClusterPolicyReconciler(client, requeue_after=0.1))
    up = controller.setup_upgrade_controller(
        client, controller.UpgradeReconciler(client, requeue_after=0.1))
    kubelet = KubeletSimulator(client, interval=0.03).start()
    cp.start(client)
    up.start(client)
    cp.queue.add(Request(name="cluster-policy"))
    key, value = PORT.accelerator
    try:
        for i in range(50):
            client.create({"apiVersion": "v1", "kind": "Node",
                           "metadata": {"name": f"gpu-{i}", "labels": {key: value}},
                           "spec": {}, "status": {}})
        wait_for(lambda: sum(1 for n in client.list("v1", "Node")
                             if deep_get(n, "status", "capacity", consts.GPU_RESOURCE_NAME))
                 == 50, timeout=60, message="50 nodes advertising GPU capacity")
        wait_for(lambda: deep_get(client.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy"),
                                  "status", "state") == "ready",
                 timeout=60, message="ClusterPolicy ready at 50 nodes")
    finally:
        for part in (cp, up, kubelet):
            part.stop()


def test_the_operator_registers_the_upgrade_controller():
    """``gpu-operator`` runs the upgrade controller beside the ClusterPolicy
    and GPUDriver controllers: its queue and state in ``/debug/state``, the
    five gauges on ``/metrics``, its sweeps traced with their ``plan`` and
    ``process`` phases."""
    from tpu_operator_torch.controllers.manager import OperatorApp

    w = Cluster(PORT)
    w.setup()
    w.policy(autoUpgrade=True)
    app = OperatorApp(w.client, namespace=NS)
    app.start()
    try:
        wait_for(lambda: w.state() == w.m.POD_RESTART_REQUIRED, message="two sweeps")
        wait_for(lambda: app.recorder.traces(controller="upgrade", limit=1),
                 message="an upgrade trace")
        state = app.debug_state()
        upgrade = [c for c in state["controllers"] if c["controller"] == "upgrade"]
        assert len(upgrade) == 1 and upgrade[0]["worker_alive"]
        root = app.recorder.traces(controller="upgrade", limit=1)[0].to_dict()
        assert {c["name"] for c in root["children"] if c["kind"] == "phase"} \
            == {"plan", "process"}
        text = app.metrics.scrape().decode()
        for gauge in GAUGES:
            assert f"# TYPE tpu_operator_nodes_upgrades_{gauge} gauge" in text
        assert "tpu_operator_nodes_upgrades_in_progress 1.0" in text
        assert app.upgrade_reconciler.journal is app.journal
    finally:
        app.stop()


# -- a fault found on the card: sweeps reading their own stale writes ---------------

class LaggingNodes:
    """A client whose Node reads show the cluster as it was ``lag`` seconds
    ago, as an informer cache lags its apiserver; writes go through."""

    def __init__(self, inner, lag):
        import copy

        self.inner, self.lag, self._copy = inner, lag, copy.deepcopy
        self.history = []
        self._snap()
        inner.watch("v1", "Node", None, handler=lambda event: self._snap())

    def _snap(self):
        self.history.append((time.monotonic(), {
            n["metadata"]["name"]: n for n in self.inner.list("v1", "Node")}))

    def _view(self):
        now = time.monotonic()
        return next((snap for t, snap in reversed(self.history) if t <= now - self.lag),
                    self.history[0][1])

    def get(self, api_version, kind, name, namespace=None):
        if kind == "Node":
            return self._copy(self._view()[name])
        return self.inner.get(api_version, kind, name, namespace)

    def list(self, api_version, kind, namespace=None, label_selector=None,
             field_selector=None):
        if kind == "Node":
            return [self._copy(n) for n in self._view().values()]
        return self.inner.list(api_version, kind, namespace, label_selector, field_selector)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _back_to_back_sweeps(monkeypatch, wait_s):
    monkeypatch.setattr(controller, "OWN_WRITES_WAIT_S", wait_s)
    w = Cluster(PORT)
    w.setup()
    w.policy(autoUpgrade=True)
    labels = []
    w.client.watch("v1", "Node", None, handler=lambda e: labels.append(
        e.object["metadata"]["labels"].get(consts.UPGRADE_STATE_LABEL)))
    lagging = LaggingNodes(w.client, lag=0.3)
    r = controller.UpgradeReconciler(lagging, namespace=NS, journal=w.journal)
    for pause in (0.0, 0.4, 0.0, 0.0):  # the second sweep reads the first's write
        time.sleep(pause)
        r.reconcile(controller.SINGLETON_REQUEST)
    order = [None] + list(machine_states())
    steps = [order.index(label) for label in labels if label in order]
    return steps, w


def machine_states():
    from tpu_operator_torch.upgrade import machine as m

    return (m.UPGRADE_REQUIRED, m.CORDON_REQUIRED, m.WAIT_FOR_JOBS_REQUIRED,
            m.POD_DELETION_REQUIRED, m.DRAIN_REQUIRED, m.POD_RESTART_REQUIRED)


def test_a_sweep_waits_for_its_own_writes_before_the_next(monkeypatch):
    """Input: four sweeps over reads that lag the apiserver by 0.3 s (on
    the card, the informer cache behind the operator's own writes), the
    last two right after the second. Without the wait the third sweep reads
    the node as it was, at upgrade-required, and walks it back through
    cordon-required to pod-restart-required again; with it each sweep starts from the last
    one's writes and the label only moves forward. The reference's
    reconciler has no such wait (tpu_operator/controllers/
    upgrade_controller.py: UpgradeReconciler.reconcile)."""
    wait_s = controller.OWN_WRITES_WAIT_S
    steps, _ = _back_to_back_sweeps(monkeypatch, 0.0)
    assert any(b < a for a, b in zip(steps, steps[1:])), steps
    steps, w = _back_to_back_sweeps(monkeypatch, wait_s)
    assert steps == sorted(steps), steps
    assert w.state() == w.m.POD_RESTART_REQUIRED
