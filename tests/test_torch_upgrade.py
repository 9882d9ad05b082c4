"""The port's upgrade machine (tpu_operator_torch/upgrade/machine.py) against
the reference's, twin for twin with tests/test_upgrade.py.

Each of the reference's machine cases runs as one script on both packages:
the same nodes, pods and DaemonSet on each package's fake (its names and
resource through tests/test_torch_operator_mapping.py), the same fake
clock, one decision journal per side. After every sweep the nodes' upgrade
labels, annotations and cordons and the sweep's counts are logged; at the
end the Events (reason, type, message, count), the pods left and the
journal's decision kinds per episode. The reference's log, mapped, must
equal the port's. The scripts keep the reference's own assertions, which
hold on both sides. The reconciler's cases are in
tests/test_torch_upgrade_controller.py; together the two files hold every
case of tests/test_upgrade.py.

The three faults of the reference the port does not copy each have a test
at the end that shows the reference's behaviour and the port's on the
input that exposes it, as does a PDB-blocked eviction's requeue hint.
"""

import pathlib
import re
import types

import pytest

from test_torch_operator_mapping import (HEALTH_COMPONENTS, UPGRADE_CRASH_LOOP_RESTARTS,
                                         UPGRADE_PORT_KEYS, map_upgrade_node_annotations,
                                         map_upgrade_text, upgrade_cordon_record)
from tpu_operator import consts as ref_consts
from tpu_operator.api.common import UpgradePolicySpec as RefPolicySpec
from tpu_operator.client.errors import TooManyRequestsError as RefTooMany
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.provenance import DecisionJournal as RefJournal
from tpu_operator.upgrade import machine as ref_machine
from tpu_operator_torch import consts
from tpu_operator_torch.api.common import UpgradePolicySpec
from tpu_operator_torch.client.errors import TooManyRequestsError
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.provenance import DecisionJournal
from tpu_operator_torch.upgrade import machine

NS = "tpu-operator"

REF = types.SimpleNamespace(
    name="reference", consts=ref_consts, m=ref_machine, Policy=RefPolicySpec, Fake=RefFake,
    Journal=RefJournal, TooMany=RefTooMany, resource=ref_consts.TPU_RESOURCE_NAME,
    driver="tpu-driver", validator="tpu-operator-validator", ds_name="libtpu-driver",
    accelerator=(ref_consts.GKE_TPU_ACCELERATOR_LABEL, "tpu-v5-lite-podslice"),
    consumers=lambda sm, node: sm._tpu_consumer_pods(node), port=False)
PORT = types.SimpleNamespace(
    name="port", consts=consts, m=machine, Policy=UpgradePolicySpec, Fake=FakeClient,
    Journal=DecisionJournal, TooMany=TooManyRequestsError, resource=consts.GPU_RESOURCE_NAME,
    driver=HEALTH_COMPONENTS["tpu-driver"], validator=HEALTH_COMPONENTS["tpu-operator-validator"],
    ds_name="gpu-driver", accelerator=(consts.GKE_ACCELERATOR_LABEL, "nvidia-h100-80gb"),
    consumers=lambda sm, node: sm._gpu_consumer_pods(node), port=True)


@pytest.fixture(autouse=True)
def default_images(monkeypatch):
    """The reference's renders need images (its tests set them so too)."""
    for env in ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE", "DEVICE_PLUGIN_IMAGE"):
        monkeypatch.setenv(env, "registry.example/operand:0.1.0")


class Clock:
    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


class World:
    """One package's cluster, clock and journal, driven as the reference's
    tests drive theirs, with a log of what each sweep left behind."""

    def __init__(self, side):
        self.s = side
        self.c = side.consts
        self.m = side.m
        self.client = side.Fake()
        self.clock = Clock()
        self.journal = side.Journal(now=self.clock)
        self.log = []
        self._names = {}

    # -- the cluster --------------------------------------------------------------
    def mk_node(self, name):
        key, value = self.s.accelerator
        return {"apiVersion": "v1", "kind": "Node",
                "metadata": {"name": name, "labels": {
                    key: value, self.c.deploy_label("driver"): "true"}},
                "spec": {}, "status": {}}

    def mk_driver_ds(self, image="img:2", name=None):
        return {"apiVersion": "apps/v1", "kind": "DaemonSet",
                "metadata": {"name": name or self.s.ds_name, "namespace": NS},
                "spec": {"template": {
                    "metadata": {"labels": {"app.kubernetes.io/component": self.s.driver}},
                    "spec": {"nodeSelector": {self.c.deploy_label("driver"): "true"},
                             "containers": [{"name": "installer", "image": image,
                                             "args": ["-c", "driver-daemon"]}]}}}}

    def mk_pod(self, name, node, component=None, image="img:1", phase="Running",
               ready=True, gpus=None, ns=NS):
        """``component`` is "driver", "validator" or another component."""
        component = {"driver": self.s.driver, "validator": self.s.validator}.get(
            component, component)
        labels = {"app.kubernetes.io/component": component} if component else {}
        ctr = {"name": "c", "image": image,
               "args": ["-c", "driver-daemon"] if component == self.s.driver else []}
        if gpus:
            ctr["resources"] = {"limits": {self.s.resource: str(gpus)}}
        return {"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": name, "namespace": ns, "labels": labels},
                "spec": {"nodeName": node, "containers": [ctr]},
                "status": {"phase": phase, "conditions": [
                    {"type": "Ready", "status": "True" if ready else "False"}]}}

    def mk_pdb(self, name, selector, min_available=1):
        return {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                "metadata": {"name": name, "namespace": NS},
                "spec": {"selector": {"matchLabels": selector}, "minAvailable": min_available}}

    def setup(self, n_nodes=1, old_image="img:1", new_image="img:2"):
        self.client.create(self.mk_driver_ds(new_image))
        for i in range(n_nodes):
            self.client.create(self.mk_node(f"node-{i}"))
            self.client.create(self.mk_pod(f"drv-{i}", f"node-{i}", "driver", old_image))
            self.client.create(self.mk_pod(f"val-{i}", f"node-{i}", "validator", "v:1"))

    def roll_driver(self, **template_spec):
        ds = self.client.get("apps/v1", "DaemonSet", self.s.ds_name, NS)
        ds["spec"]["template"]["spec"]["containers"][0].update(template_spec)
        self.client.update(ds)

    def place(self, name, state, unschedulable=False, labels=None):
        """A node the reference's test leaves mid-upgrade, as each package's
        upgrade would have left it (the port's carries its cordon record)."""
        node = self.node(name)
        node["metadata"]["labels"].update(labels or {})
        if state:
            node["metadata"]["labels"][self.c.UPGRADE_STATE_LABEL] = state
        if unschedulable:
            node["spec"]["unschedulable"] = True
        if self.s.port:
            node["metadata"].setdefault("annotations", {}).update(
                upgrade_cordon_record(state, unschedulable))
        self.client.update(node)

    def node(self, name="node-0"):
        return self.client.get("v1", "Node", name)

    def nodes(self):
        return self.client.list("v1", "Node")

    def state(self, name="node-0"):
        return self.m.node_upgrade_state(self.node(name))

    def cordoned(self, name="node-0"):
        return bool(self.node(name)["spec"].get("unschedulable"))

    def pods(self, ns=NS):
        return [p["metadata"]["name"] for p in self.client.list("v1", "Pod", ns)]

    def events(self, reason):
        return [e for e in self.client.list("v1", "Event", NS) if e.get("reason") == reason]

    # -- sweeps -------------------------------------------------------------------
    def machine(self, **policy):
        spec = self.s.Policy.from_dict({"autoUpgrade": True, **policy})
        return self.m.UpgradeStateMachine(self.client, NS, spec, now=self.clock,
                                          journal=self.journal)

    def process(self, sm):
        counts = sm.process(self.nodes())
        self.observe(counts)
        return counts

    def sweep(self, **policy):
        return self.process(self.machine(**policy))

    # -- the log ------------------------------------------------------------------
    def _name(self, kind, value):
        """Episode ids and template fingerprints by order of appearance."""
        names = self._names.setdefault(kind, {})
        return names.setdefault(value, f"{kind}{len(names) + 1}")

    def observe(self, counts=None):
        entry = {"counts": counts.as_dict() if counts is not None else None, "nodes": {}}
        for node in self.nodes():
            anns = {}
            for key, value in sorted((node["metadata"].get("annotations") or {}).items()):
                if key in (self.c.PROVENANCE_EPISODE_ANNOTATION,
                           getattr(self.c, "UPGRADE_EPISODE_ANNOTATION", None)):
                    value = self._name("episode", value)
                elif key in (self.c.UPGRADE_FAILED_TEMPLATE_ANNOTATION,
                             self.c.UPGRADE_REVALIDATED_ANNOTATION):
                    value = self._name("template", value)
                elif key == self.c.UPGRADE_STATE_SINCE_ANNOTATION:
                    value = "<since>"
                anns[key] = value
            entry["nodes"][node["metadata"]["name"]] = {
                "state": self.m.node_upgrade_state(node), "annotations": anns,
                "unschedulable": bool((node.get("spec") or {}).get("unschedulable"))}
        self.log.append(entry)

    def episodes(self):
        return [[r.kind for r in self.journal.chain(ep["episode"])]
                for ep in sorted(self.journal.episodes(), key=lambda e: e["first_ts"])]

    def record(self):
        events = sorted((e["type"], e["reason"], e["message"], int(e.get("count") or 1))
                        for e in self.client.list("v1", "Event", None))
        pods = sorted((p["metadata"]["namespace"], p["metadata"]["name"])
                      for p in self.client.list("v1", "Pod", None))
        log = self.log
        if self.s.port:
            log = [dict(e, nodes={n: dict(v, annotations={k: a for k, a in v["annotations"].items()
                                                           if k not in UPGRADE_PORT_KEYS
                                                           or k == consts.UPGRADE_EPISODE_ANNOTATION})
                                  for n, v in e["nodes"].items()}) if isinstance(e, dict) else e
                   for e in log]
        else:
            events = [(t, r, map_upgrade_text(msg), n) for t, r, msg, n in events]
            log = [dict(e, nodes={n: dict(v, annotations=map_upgrade_node_annotations(
                v["annotations"])) for n, v in e["nodes"].items()}) if isinstance(e, dict) else e
                for e in log]
        return {"log": log, "events": sorted(events), "pods": pods, "episodes": self.episodes()}


# -- the reference's machine cases, as scripts over either package ---------------------

def case_full_upgrade_flow_single_node(w):
    m = w.m
    w.setup()
    w.client.create(w.mk_pod("workload", "node-0", None, "user:1", gpus=4))
    sm = w.machine(drain={"enable": True})
    counts = w.process(sm)
    assert counts.pending == 1 and w.state() == m.UPGRADE_REQUIRED
    counts = w.process(sm)
    assert w.state() == m.POD_RESTART_REQUIRED and w.cordoned()
    assert "workload" not in w.pods() and "drv-0" not in w.pods()
    assert counts.in_progress == 1
    w.client.create(w.mk_pod("drv-0-new", "node-0", "driver", "img:2"))
    w.process(sm)
    assert w.state() == m.VALIDATION_REQUIRED
    assert "val-0" not in w.pods(), "stale validator pod must be recycled"
    w.client.create(w.mk_pod("val-0-new", "node-0", "validator", "v:1"))
    counts = w.process(sm)
    assert w.state() == m.DONE and not w.cordoned() and counts.done == 1
    counts = w.process(sm)
    assert w.state() == m.UNKNOWN and counts.available == 1


def case_max_parallel_throttle(w):
    m = w.m
    w.setup(n_nodes=3)
    sm = w.machine(maxParallelUpgrades=1)
    w.process(sm)
    counts = w.process(sm)
    assert counts.in_progress == 1 and counts.pending == 2
    states = sorted(w.m.node_upgrade_state(n) for n in w.nodes())
    assert states.count(m.UPGRADE_REQUIRED) == 2 and states.count(m.POD_RESTART_REQUIRED) == 1


def case_validation_gate_blocks_uncordon(w):
    m = w.m
    w.setup()
    w.client.delete("v1", "Pod", "val-0", NS)
    sm = w.machine()
    w.process(sm)
    w.process(sm)
    w.client.create(w.mk_pod("drv-0-new", "node-0", "driver", "img:2"))
    w.process(sm)
    assert w.state() == m.VALIDATION_REQUIRED and w.cordoned()
    w.client.create(w.mk_pod("val-0", "node-0", "validator", "v:1"))
    w.process(sm)
    assert w.state() == m.DONE and not w.cordoned()


def drive_to_failed(w):
    sm = w.machine()
    w.process(sm)
    w.process(sm)
    w.client.create(w.mk_pod("drv-0-new", "node-0", "driver", "img:2", phase="Failed",
                             ready=False))
    counts = w.process(sm)
    assert counts.failed == 1 and w.state() == w.m.FAILED
    return sm


def case_failed_driver_pod_marks_failed(w):
    w.setup()
    drive_to_failed(w)


def case_failed_node_recovers_when_driver_pods_healthy(w):
    w.setup()
    sm = drive_to_failed(w)
    w.client.delete("v1", "Pod", "drv-0-new", NS)
    w.client.create(w.mk_pod("drv-0-fresh", "node-0", "driver", "img:2"))
    w.process(sm)
    w.client.create(w.mk_pod("val-0-new", "node-0", "validator", "v:1"))
    counts = w.process(sm)
    assert w.state() == w.m.DONE and not w.cordoned() and counts.done == 1


def case_failed_node_retries_on_new_rollout(w):
    w.setup()
    sm = drive_to_failed(w)
    w.roll_driver(image="img:3")
    counts = w.process(sm)
    assert w.state() in w.m.IN_PROGRESS_STATES
    assert counts.in_progress == 1 and counts.failed == 0


def case_skip_drain_label(w):
    w.setup()
    w.place("node-0", None, labels={w.c.UPGRADE_SKIP_DRAIN_LABEL: "true"})
    w.client.create(w.mk_pod("bystander", "node-0", None, "user:1"))
    sm = w.machine(drain={"enable": True})
    w.process(sm)
    w.process(sm)
    assert "bystander" in w.pods()


def case_wait_for_jobs_selector(w):
    m = w.m
    w.setup()
    job = w.mk_pod("job-pod", "node-0", None, "user:1")
    job["metadata"]["labels"]["job"] = "training"
    w.client.create(job)
    sm = w.machine(waitForCompletion={"podSelector": "job=training"})
    w.process(sm)
    w.process(sm)
    assert w.state() == m.WAIT_FOR_JOBS_REQUIRED
    job = w.client.get("v1", "Pod", "job-pod", NS)
    job["status"]["phase"] = "Succeeded"
    w.client.update_status(job)
    w.process(sm)
    assert w.state() == m.POD_RESTART_REQUIRED


def case_no_upgrade_needed_stays_clear(w):
    w.setup(old_image="img:2")
    counts = w.sweep()
    assert counts.available == 1 and w.state() == w.m.UNKNOWN


def blocked_workload(w):
    pod = w.mk_pod("workload", "node-0", None, "user:1", gpus=4)
    pod["metadata"]["labels"]["app"] = "train"
    w.client.create(pod)
    w.client.create(w.mk_pdb("train-pdb", {"app": "train"}))


def case_pdb_blocked_eviction_retries_then_fails_without_force(w):
    m = w.m
    w.setup()
    blocked_workload(w)
    sm = w.machine(podDeletion={"timeoutSeconds": 300, "force": False})
    w.process(sm)
    w.process(sm)
    assert w.state() == m.POD_DELETION_REQUIRED and "workload" in w.pods()
    w.clock.t += 100.0
    w.process(sm)
    assert w.state() == m.POD_DELETION_REQUIRED
    w.clock.t += 300.0
    w.process(sm)
    assert w.state() == m.FAILED and "workload" in w.pods()
    assert w.events("UpgradeDrainFailed")


def case_pdb_blocked_eviction_force_deletes_after_budget(w):
    m = w.m
    w.setup()
    blocked_workload(w)
    sm = w.machine(podDeletion={"timeoutSeconds": 60, "force": True})
    w.process(sm)
    w.process(sm)
    assert "workload" in w.pods()
    w.clock.t += 120.0
    w.process(sm)
    assert "workload" not in w.pods()
    assert w.state() not in (m.FAILED, m.POD_DELETION_REQUIRED)
    assert w.events("UpgradeDrainForced")


def case_empty_dir_pod_blocks_drain_even_with_force(w):
    w.setup()
    pod = w.mk_pod("scratch", "node-0", None, "user:1", gpus=4)
    pod["spec"]["volumes"] = [{"name": "tmp", "emptyDir": {}}]
    w.client.create(pod)
    sm = w.machine(podDeletion={"timeoutSeconds": 60, "force": True, "deleteEmptyDir": False})
    w.process(sm)
    w.process(sm)
    assert "scratch" in w.pods()
    w.clock.t += 120.0
    w.process(sm)
    assert w.state() == w.m.FAILED and "scratch" in w.pods()
    # with the permission it proceeds
    second = World(w.s)
    second.setup()
    second.client.create(pod)
    sm2 = second.machine(podDeletion={"deleteEmptyDir": True})
    second.process(sm2)
    second.process(sm2)
    assert "scratch" not in second.pods()
    w.log.append(second.record()["log"])


def stuck_job(w):
    job = w.mk_pod("job", "node-0", None, "user:1")
    job["metadata"]["labels"]["app"] = "train"
    w.client.create(job)


def case_stuck_job_escalates_after_wait_timeout(w):
    m = w.m
    w.setup()
    stuck_job(w)
    sm = w.machine(waitForCompletion={"podSelector": "app=train", "timeoutSeconds": 600})
    w.process(sm)
    w.process(sm)
    assert w.state() == m.WAIT_FOR_JOBS_REQUIRED
    w.clock.t += 300.0
    w.process(sm)
    assert w.state() == m.WAIT_FOR_JOBS_REQUIRED
    w.clock.t += 600.0
    w.process(sm)
    assert w.state() not in (m.WAIT_FOR_JOBS_REQUIRED, m.UNKNOWN)
    assert w.events("UpgradeWaitForJobsTimeout")


def case_stuck_job_waits_forever_with_zero_timeout(w):
    w.setup()
    stuck_job(w)
    sm = w.machine(waitForCompletion={"podSelector": "app=train"})
    w.process(sm)
    w.process(sm)
    w.clock.t += 10_000_000.0
    w.process(sm)
    assert w.state() == w.m.WAIT_FOR_JOBS_REQUIRED


def case_skip_drain_label_still_honored(w):
    w.setup()
    w.place("node-0", None, labels={w.c.UPGRADE_SKIP_DRAIN_LABEL: "true"})
    w.client.create(w.mk_pod("keep-me", "node-0", None, "user:1"))
    sm = w.machine(drain={"enable": True})
    w.process(sm)
    w.process(sm)
    assert "keep-me" in w.pods()


def case_drain_pod_selector_limits_targets(w):
    w.setup()
    a = w.mk_pod("match", "node-0", None, "user:1")
    a["metadata"]["labels"]["team"] = "ml"
    w.client.create(a)
    w.client.create(w.mk_pod("nomatch", "node-0", None, "user:1"))
    sm = w.machine(drain={"enable": True, "podSelector": "team=ml"})
    w.process(sm)
    w.process(sm)
    assert "match" not in w.pods() and "nomatch" in w.pods()


def case_drain_timeout_failed_is_sticky_until_template_changes(w):
    m = w.m
    w.setup()
    blocked_workload(w)
    sm = w.machine(podDeletion={"timeoutSeconds": 60, "force": False})
    w.process(sm)
    w.process(sm)
    w.clock.t += 120.0
    w.process(sm)
    assert w.state() == m.FAILED
    for _ in range(3):
        w.clock.t += 600.0
        w.process(sm)
        assert w.state() == m.FAILED
    w.roll_driver(image="img:3")
    w.process(sm)
    assert w.state() in (m.UPGRADE_REQUIRED,) + m.IN_PROGRESS_STATES


def case_pdb_ignores_unhealthy_pods(w):
    run = w.mk_pod("running", "node-0", None, "user:1")
    run["metadata"]["labels"]["app"] = "train"
    done = w.mk_pod("done", "node-0", None, "user:1", phase="Succeeded")
    done["metadata"]["labels"]["app"] = "train"
    w.client.create(run)
    w.client.create(done)
    w.client.create(w.mk_pdb("train-pdb", {"app": "train"}))
    with pytest.raises(w.s.TooMany):
        w.client.evict("running", NS)


def accept_without_deleting(w):
    """A real apiserver's accepted Eviction only stamps deletionTimestamp."""
    def evict(name, namespace=None):
        pod = w.client.get("v1", "Pod", name, namespace)
        pod["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    w.client.evict = evict


def case_stuck_terminating_force_deleted_after_budget(w):
    m = w.m
    w.setup()
    w.client.create(w.mk_pod("workload", "node-0", None, "user:1", gpus=4))
    accept_without_deleting(w)
    sm = w.machine(podDeletion={"timeoutSeconds": 60, "force": True})
    w.process(sm)
    w.process(sm)
    assert "workload" in w.pods() and w.state() == m.POD_DELETION_REQUIRED
    w.clock.t += 120.0
    w.process(sm)
    assert "workload" not in w.pods() and w.state() != m.FAILED


def case_stuck_terminating_fails_node_without_force(w):
    w.setup()
    w.client.create(w.mk_pod("workload", "node-0", None, "user:1", gpus=4))
    accept_without_deleting(w)
    sm = w.machine(podDeletion={"timeoutSeconds": 60, "force": False})
    w.process(sm)
    w.process(sm)
    w.clock.t += 120.0
    w.process(sm)
    assert w.state() == w.m.FAILED and "workload" in w.pods()
    assert any("terminating" in e.get("message", "") for e in w.events("UpgradeDrainFailed"))


def case_finalizer_held_pod_fails_past_double_budget(w):
    w.setup()
    w.client.create(w.mk_pod("workload", "node-0", None, "user:1", gpus=4))
    accept_without_deleting(w)
    original_delete = w.client.delete

    def delete(api_version, kind, name, namespace=None, **kw):
        if kind == "Pod" and name == "workload":
            return None  # a finalizer: the delete is accepted, the object stays
        return original_delete(api_version, kind, name, namespace, **kw)
    w.client.delete = delete
    sm = w.machine(podDeletion={"timeoutSeconds": 60, "force": True})
    w.process(sm)
    w.process(sm)
    w.clock.t += 90.0
    w.process(sm)
    assert "workload" in w.pods() and w.state() != w.m.FAILED
    w.clock.t += 60.0
    w.process(sm)
    assert w.state() == w.m.FAILED


def case_drain_covers_user_namespaces(w):
    w.setup()
    w.client.create(w.mk_pod("train-0", "node-0", None, "user:1", gpus=4, ns="ml-team"))
    sm = w.machine(podDeletion={"timeoutSeconds": 300, "force": False})
    w.process(sm)
    w.process(sm)
    assert "train-0" not in w.pods("ml-team")


def case_terminating_validator_never_certifies(w):
    m, c = w.m, w.c
    w.setup()
    sm = w.machine()
    w.process(sm)
    w.process(sm)
    w.client.create(w.mk_pod("drv-0-new", "node-0", "driver", "img:2"))
    original_delete = w.client.delete

    def graceful_delete(api_version, kind, name, namespace=None, **kw):
        if kind == "Pod" and name == "val-0":
            w.client.patch("v1", "Pod", name, {"metadata": {
                "deletionTimestamp": "2026-01-01T00:00:00Z"}}, namespace)
            return None
        return original_delete(api_version, kind, name, namespace, **kw)
    w.client.delete = graceful_delete
    w.process(sm)
    w.process(sm)
    assert w.state() == m.VALIDATION_REQUIRED
    w.client.delete = original_delete
    w.client.delete("v1", "Pod", "val-0", NS)
    w.client.create(w.mk_pod("val-0-new", "node-0", "validator", "v:1"))
    w.process(sm)
    assert w.state() == m.DONE
    w.process(sm)
    assert c.UPGRADE_REVALIDATED_ANNOTATION not in (w.node()["metadata"].get("annotations") or {})


def case_max_unavailable_counts_unhealthy_bystanders(w):
    w.setup(n_nodes=3)
    sick = w.node("node-2")
    sick["status"]["conditions"] = [{"type": "Ready", "status": "False"}]
    w.client.update_status(sick)
    sm = w.machine(maxParallelUpgrades=0, maxUnavailable="1")
    w.process(sm)
    w.process(sm)
    cordoned = [n["metadata"]["name"] for n in w.nodes() if n["spec"].get("unschedulable")]
    assert set(cordoned) <= {"node-2"}
    sick = w.node("node-2")
    sick["status"]["conditions"] = [{"type": "Ready", "status": "True"}]
    w.client.update_status(sick)
    w.process(sm)
    assert len([n for n in w.nodes() if n["spec"].get("unschedulable")]) == 1


def case_max_unavailable_percent_rounds_up(w):
    w.setup(n_nodes=3)
    sm = w.machine(maxParallelUpgrades=0, maxUnavailable="50%")
    w.process(sm)
    w.process(sm)
    assert len([n for n in w.nodes() if n["spec"].get("unschedulable")]) == 2


def run_to_drain(w, **policy):
    sm = w.machine(drain={"enable": True}, **policy)
    w.process(sm)
    w.process(sm)
    return sm


def case_user_pod_with_component_label_is_evicted(w):
    w.setup()
    pod = w.mk_pod("web-train", "node-0", None, "user:1", gpus=4, ns="ml-team")
    pod["metadata"]["labels"]["app.kubernetes.io/component"] = "web"
    w.client.create(pod)
    run_to_drain(w)
    assert "web-train" not in w.pods("ml-team")


def case_user_component_pod_drained_without_tpu(w):
    w.setup()
    pod = w.mk_pod("web-svc", "node-0", None, "user:1", ns="ml-team")
    pod["metadata"]["labels"]["app.kubernetes.io/component"] = "web"
    w.client.create(pod)
    run_to_drain(w)
    assert "web-svc" not in w.pods("ml-team")


def case_init_container_tpu_consumer_evicted(w):
    w.setup()
    pod = w.mk_pod("preflight", "node-0", None, "user:1", ns="ml-team")
    pod["spec"]["initContainers"] = [{"name": "warmup", "resources": {
        "limits": {w.s.resource: "4"}}}]
    w.client.create(pod)
    assert [p["metadata"]["name"] for p in w.s.consumers(w.machine(), "node-0")] == ["preflight"]
    run_to_drain(w)
    assert "preflight" not in w.pods("ml-team")


def case_tpu_requests_without_limits_counts(w):
    w.setup()
    pod = w.mk_pod("req-only", "node-0", None, "user:1", ns="ml-team")
    pod["spec"]["containers"][0]["resources"] = {"requests": {w.s.resource: "4"}}
    w.client.create(pod)
    assert [p["metadata"]["name"] for p in w.s.consumers(w.machine(), "node-0")] == ["req-only"]


def case_daemonset_owned_user_pod_exempt_from_drain(w):
    w.setup()
    pod = w.mk_pod("user-ds-pod", "node-0", None, "user:1", gpus=4, ns="ml-team")
    pod["metadata"]["ownerReferences"] = [
        {"kind": "DaemonSet", "name": "user-ds", "controller": True}]
    w.client.create(pod)
    run_to_drain(w)
    assert "user-ds-pod" in w.pods("ml-team")


def case_mirror_pod_exempt_from_drain(w):
    w.setup()
    pod = w.mk_pod("static-pod", "node-0", None, "user:1", ns="ml-team")
    pod["metadata"]["annotations"] = {"kubernetes.io/config.mirror": "abc123"}
    w.client.create(pod)
    run_to_drain(w)
    assert "static-pod" in w.pods("ml-team")


def case_completed_pod_does_not_block_pod_deletion(w):
    w.setup()
    w.client.create(w.mk_pod("done-job", "node-0", None, "user:1", gpus=4, phase="Succeeded",
                             ns="ml-team"))
    assert w.s.consumers(w.machine(), "node-0") == []


def case_operand_impersonation_outside_namespace_not_exempt(w):
    w.setup()
    w.client.create(w.mk_pod("fake-driver", "node-0", "driver", "user:1", gpus=4,
                             ns="ml-team"))
    assert [p["metadata"]["name"] for p in w.s.consumers(w.machine(), "node-0")] \
        == ["fake-driver"]


def case_operand_components_set_matches_manifests(w):
    root = pathlib.Path(w.m.__file__).parents[1] / "manifests"
    found = set()
    for ds_file in root.glob("*/0500_daemonset.yaml"):
        found.update(re.findall(r"app\.kubernetes\.io/component:\s*(\S+)", ds_file.read_text()))
    assert found == set(w.m.OPERAND_COMPONENTS)
    w.log.append(len(found))


def case_drain_exempt_covers_every_rendered_operand_pod(w):
    import importlib

    pkg = "tpu_operator_torch" if w.s.port else "tpu_operator"
    cp = importlib.import_module(f"{pkg}.api.clusterpolicy")
    operands = importlib.import_module(f"{pkg}.state.operands")
    policy = cp.ClusterPolicy.from_obj(cp.new_cluster_policy(spec={
        "slicePartitioner": {"enabled": True}, "serving": {"enabled": True}}))
    daemonsets = [obj for state in operands.cluster_policy_states(client=None)
                  if hasattr(state, "render_data") and state.name != "pre-requisites"
                  for obj in state.render_objects(policy, NS) if obj.get("kind") == "DaemonSet"]
    assert len(daemonsets) >= len(w.m.OPERAND_COMPONENTS) - 1
    for ds in daemonsets:
        pod = {"metadata": {
            "name": f"{ds['metadata']['name']}-abc12", "namespace": NS,
            "labels": dict(ds["spec"]["template"]["metadata"].get("labels") or {}),
            "ownerReferences": [{"kind": "DaemonSet", "controller": True,
                                 "name": ds["metadata"]["name"]}]}}
        assert w.c.drain_exempt(pod, NS), ds["metadata"]["name"]
        pod["metadata"].pop("ownerReferences")
        assert w.c.drain_exempt(pod, NS), ds["metadata"]["name"]
    assert not w.c.drain_exempt({"metadata": {
        "name": "train-0", "namespace": "default",
        "labels": {"app.kubernetes.io/component": "trainer"}}}, NS)
    w.log.append(len(daemonsets))


def case_env_only_template_change_triggers_upgrade(w):
    w.setup(old_image="img:2", new_image="img:2")
    w.sweep()
    assert w.state() == w.m.UNKNOWN
    w.roll_driver(env=[{"name": "GPU_DRIVER_ARGS", "value": "--foo=1"}])
    w.sweep()
    assert w.state() == w.m.UPGRADE_REQUIRED


def case_new_init_container_triggers_upgrade(w):
    w.setup(old_image="img:2", new_image="img:2")
    ds = w.client.get("apps/v1", "DaemonSet", w.s.ds_name, NS)
    ds["spec"]["template"]["spec"]["initContainers"] = [
        {"name": "precheck", "image": "img:2", "args": ["-c", "driver-probe"]}]
    w.client.update(ds)
    w.sweep()
    assert w.state() == w.m.UPGRADE_REQUIRED


def case_metadata_only_ds_change_does_not_trigger(w):
    w.setup(old_image="img:2", new_image="img:2")
    ds = w.client.get("apps/v1", "DaemonSet", w.s.ds_name, NS)
    before = w.m.UpgradeStateMachine._template_fingerprint(ds)
    ds["metadata"].setdefault("labels", {})["team"] = "infra"
    ds["metadata"].setdefault("annotations", {})["note"] = "rolled by hand"
    w.client.update(ds)
    after = w.client.get("apps/v1", "DaemonSet", w.s.ds_name, NS)
    assert after["metadata"]["generation"] == ds["metadata"].get("generation", 1)
    assert w.m.UpgradeStateMachine._template_fingerprint(after) == before
    w.sweep()
    assert w.state() == w.m.UNKNOWN


def case_template_hash_label_is_primary(w):
    outdated = w.m.UpgradeStateMachine._pod_outdated
    w.setup(old_image="img:2", new_image="img:2")
    ds = w.client.get("apps/v1", "DaemonSet", w.s.ds_name, NS)
    ds["spec"]["template"]["metadata"]["labels"][w.c.TEMPLATE_HASH_LABEL] = "tplhash-2"
    w.client.update(ds)
    ds = w.client.get("apps/v1", "DaemonSet", w.s.ds_name, NS)
    stale = w.mk_pod("drv-stale", "node-0", "driver", "img:2")
    stale["metadata"]["labels"][w.c.TEMPLATE_HASH_LABEL] = "tplhash-1"
    unstamped = w.mk_pod("drv-unstamped", "node-0", "driver", "img:2")
    mutated = w.mk_pod("drv-mutated", "node-0", "driver", "img:2")
    mutated["metadata"]["labels"][w.c.TEMPLATE_HASH_LABEL] = "tplhash-2"
    mutated["spec"]["containers"][0]["env"] = [{"name": "INJECTED_BY_WEBHOOK", "value": "1"}]
    verdicts = [outdated(stale, ds), outdated(unstamped, ds), outdated(mutated, ds)]
    assert verdicts == [True, True, False]
    w.log.append(verdicts)


def case_non_template_spec_change_does_not_trigger(w):
    w.setup(old_image="img:2", new_image="img:2")
    ds = w.client.get("apps/v1", "DaemonSet", w.s.ds_name, NS)
    fingerprint = (ref_template_fingerprint if not w.s.port else port_template_fingerprint)
    stamp = fingerprint(ds["spec"]["template"])
    ds["spec"]["template"]["metadata"]["labels"][w.c.TEMPLATE_HASH_LABEL] = stamp
    ds["spec"]["minReadySeconds"] = 30
    ds["spec"]["updateStrategy"] = {"type": "RollingUpdate",
                                    "rollingUpdate": {"maxUnavailable": 2}}
    w.client.update(ds)
    ds = w.client.get("apps/v1", "DaemonSet", w.s.ds_name, NS)
    pod = w.mk_pod("drv-current", "node-0", "driver", "img:2")
    pod["metadata"]["labels"][w.c.TEMPLATE_HASH_LABEL] = stamp
    assert not w.m.UpgradeStateMachine._pod_outdated(pod, ds)
    assert w.m.UpgradeStateMachine._template_fingerprint(ds) == stamp


def ref_template_fingerprint(template):
    from tpu_operator.utils.hash import template_fingerprint

    return template_fingerprint(template)


def port_template_fingerprint(template):
    from tpu_operator_torch.utils import template_fingerprint

    return template_fingerprint(template)


def case_template_fingerprint_tracks_whole_template(w):
    fingerprint = w.m.UpgradeStateMachine._template_fingerprint
    ds = w.mk_driver_ds("img:2")
    base = fingerprint(ds)
    ds["metadata"]["labels"] = {"team": "infra"}
    assert fingerprint(ds) == base
    ds["spec"]["template"]["spec"]["containers"][0]["env"] = [
        {"name": "GPU_DRIVER_ARGS", "value": "--foo=1"}]
    assert fingerprint(ds) != base


def case_pool_scoped_template_change_upgrades_only_that_pool(w):
    for pool in ("a", "b"):
        node = w.mk_node(f"node-{pool}")
        node["metadata"]["labels"]["pool"] = pool
        w.client.create(node)
        ds = w.mk_driver_ds("img:1", name=f"{w.s.ds_name}-{pool}")
        ds["spec"]["template"]["spec"]["nodeSelector"] = {"pool": pool}
        ds["spec"]["template"]["metadata"]["labels"][w.c.TEMPLATE_HASH_LABEL] = \
            f"hash-{pool}-current"
        w.client.create(ds)
        w.client.create(w.mk_pod(f"val-{pool}", f"node-{pool}", "validator", "v:1"))
    stale = w.mk_pod("drv-a", "node-a", "driver", "img:1")
    stale["metadata"]["labels"][w.c.TEMPLATE_HASH_LABEL] = "hash-a-old"
    w.client.create(stale)
    current = w.mk_pod("drv-b", "node-b", "driver", "img:1")
    current["metadata"]["labels"][w.c.TEMPLATE_HASH_LABEL] = "hash-b-current"
    w.client.create(current)
    w.sweep()
    assert w.state("node-a") == w.m.UPGRADE_REQUIRED and w.state("node-b") == w.m.UNKNOWN


MACHINE_CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
                 if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(MACHINE_CASES))
def test_machine_matches_reference(case):
    ref, port = World(REF), World(PORT)
    MACHINE_CASES[case](ref)
    MACHINE_CASES[case](port)
    assert port.record() == ref.record()


# -- the operand set against the port's renders ---------------------------------------

def test_the_operand_set_is_the_port_s_manifests_and_rendered_daemonsets():
    """Every component the port's manifests stamp is exempt, each rendered
    DaemonSet's pod is, and no TPU component is left in the set."""
    w = World(PORT)
    case_operand_components_set_matches_manifests(w)
    case_drain_exempt_covers_every_rendered_operand_pod(w)
    assert w.log == [8, 8]
    assert not any("tpu" in c for c in consts.OPERAND_COMPONENTS)
    assert machine.OPERAND_COMPONENTS is consts.OPERAND_COMPONENTS


# -- a PDB-blocked eviction's requeue hint ------------------------------------------

def test_a_pdb_blocked_eviction_gives_the_requeue_hint(monkeypatch):
    """The fake's budget refusal carries its Retry-After, and the machine
    keeps the smallest hint of the sweep for the controller's requeue; the
    reference's fake sends none."""
    hints = {}
    for side in (REF, PORT):
        w = World(side)
        w.setup()
        blocked_workload(w)
        sm = w.machine(podDeletion={"timeoutSeconds": 60, "force": True})
        w.process(sm)
        w.process(sm)
        assert w.state() == w.m.POD_DELETION_REQUIRED
        hints[side.name] = sm.retry_after_hint
    assert hints == {"reference": None, "port": 2.0}
    from tpu_operator_torch.client import fake

    w = World(PORT)
    monkeypatch.setattr(fake, "EVICTION_RETRY_AFTER_S", 0.25)
    w.setup()
    blocked_workload(w)
    sm = w.machine(podDeletion={"timeoutSeconds": 60, "force": True})
    w.process(sm)
    w.process(sm)
    assert sm.retry_after_hint == 0.25


# -- fault 1: the upgrade lifts only its own cordon ----------------------------------

def _admin_cordoned_upgrade(w):
    w.setup()
    w.place("node-0", None, unschedulable=True)  # the admin's cordon
    sm = w.machine()
    w.process(sm)
    w.process(sm)
    w.client.create(w.mk_pod("drv-0-new", "node-0", "driver", "img:2"))
    w.process(sm)
    w.client.create(w.mk_pod("val-0-new", "node-0", "validator", "v:1"))
    w.process(sm)
    assert w.state() == w.m.DONE
    w.process(sm)
    assert w.state() == w.m.UNKNOWN


def test_an_admin_s_cordon_survives_the_upgrade():
    """Input: a node an admin cordoned before a new driver template. The
    reference's upgrade runs to its end and uncordons it; the port's keeps
    the cordon, and its record goes with the node's exit."""
    ref, port = World(REF), World(PORT)
    _admin_cordoned_upgrade(ref)
    _admin_cordoned_upgrade(port)
    assert not ref.cordoned()
    assert port.cordoned()
    anns = port.node()["metadata"].get("annotations") or {}
    assert not any(k in anns for k in UPGRADE_PORT_KEYS)
    # the same states either way
    assert ([{n: v["state"] for n, v in e["nodes"].items()} for e in port.log]
            == [{n: v["state"] for n, v in e["nodes"].items()} for e in ref.log])


def _frozen_after_upgrade_required(w):
    w.setup()
    w.place("node-0", None, unschedulable=True)
    w.sweep()
    assert w.state() == w.m.UPGRADE_REQUIRED
    counts = w.m.UpgradeStateMachine(w.client, NS, w.s.Policy.from_dict({}), now=w.clock,
                                     journal=w.journal).clear_all(w.nodes(), preserve_failed=True)
    assert counts.available == 1 and w.state() == w.m.UNKNOWN


def test_a_frozen_pool_keeps_an_admin_s_cordon():
    """Input: an admin-cordoned node at upgrade-required whose pool is then
    frozen (``autoUpgrade: false``). The reference's clear_all uncordons it;
    the port's leaves the cordon it did not set."""
    ref, port = World(REF), World(PORT)
    _frozen_after_upgrade_required(ref)
    _frozen_after_upgrade_required(port)
    assert not ref.cordoned() and port.cordoned()


def test_a_retry_out_of_failed_keeps_the_first_record():
    """A node schedulable when its upgrade began fails, then is retried on
    a new template while cordoned: the record written at the first cordon
    stands, so the retry's end uncordons it."""
    w = World(PORT)
    w.setup()
    sm = drive_to_failed(w)
    assert w.cordoned()
    assert w.node()["metadata"]["annotations"][consts.UPGRADE_CORDONED_ANNOTATION] == "true"
    w.roll_driver(image="img:3")
    w.client.delete("v1", "Pod", "drv-0-new", NS)
    w.process(sm)
    assert w.node()["metadata"]["annotations"][consts.UPGRADE_CORDONED_ANNOTATION] == "true"
    w.client.create(w.mk_pod("drv-0-3", "node-0", "driver", "img:3"))
    w.process(sm)
    w.client.create(w.mk_pod("val-0-3", "node-0", "validator", "v:1"))
    w.process(sm)
    assert w.state() == machine.DONE and not w.cordoned()
    assert consts.UPGRADE_CORDONED_ANNOTATION not in w.node()["metadata"]["annotations"]


# -- fault 2: a crash-looping new driver fails the upgrade ----------------------------

def crash_looping_pod(w, name, component, reason="CrashLoopBackOff", restarts=12):
    pod = w.mk_pod(name, "node-0", component, "img:2", ready=False)
    pod["status"]["initContainerStatuses"] = [{
        "name": "init", "restartCount": restarts, "ready": False,
        "state": {"waiting": {"reason": reason}}}]
    return pod


def _crash_looping_driver(w, sweeps=50):
    sm = w.machine()
    w.process(sm)
    w.process(sm)
    w.client.create(crash_looping_pod(w, "drv-0-new", "driver"))
    for _ in range(sweeps):
        w.clock.t += 600.0
        counts = w.process(sm)
    return counts


def test_a_crash_looping_driver_fails_the_upgrade():
    """Input: a new-template driver pod, Running, not Ready, an init
    container waiting in CrashLoopBackOff after 12 restarts. After 50
    sweeps over 500 minutes the reference's node still waits at
    pod-restart-required, cordoned, with no Event; the port's failed at the
    first sweep that saw it, through the machine's failure path."""
    ref, port = World(REF), World(PORT)
    for w in (ref, port):
        w.setup()
    want = _crash_looping_driver(ref)
    assert ref.state() == ref_machine.POD_RESTART_REQUIRED and ref.cordoned()
    assert (want.in_progress, want.failed) == (1, 0)
    assert not ref.events("DriverUpgradeFailed")
    got = _crash_looping_driver(port)
    assert port.state() == machine.FAILED and port.cordoned()
    assert (got.in_progress, got.failed) == (0, 1)
    assert [e["count"] for e in port.events("DriverUpgradeFailed")] == [1]
    assert port.log[2]["nodes"]["node-0"]["state"] == machine.FAILED
    assert port.episodes() == [["upgrade", "upgrade-failed"]]
    anns = port.node()["metadata"]["annotations"]
    assert anns[consts.UPGRADE_FAILED_TEMPLATE_ANNOTATION]


@pytest.mark.parametrize("status,looping", [
    ({"state": {"waiting": {"reason": "CrashLoopBackOff"}}, "restartCount": 1}, True),
    ({"state": {"running": {}}, "restartCount": UPGRADE_CRASH_LOOP_RESTARTS + 1}, True),
    ({"state": {"running": {}}, "restartCount": UPGRADE_CRASH_LOOP_RESTARTS}, False),
    ({"state": {"waiting": {"reason": "ContainerCreating"}}, "restartCount": 0}, False),
], ids=["back-off", "restarts-past", "restarts-at", "creating"])
def test_what_counts_as_crash_looping(status, looping):
    for key in ("initContainerStatuses", "containerStatuses"):
        pod = {"status": {"phase": "Running", key: [dict(status, name="c")]}}
        assert machine.crash_looping(pod) is looping
    assert machine.crash_looping({"status": {"phase": "Failed"}})


def test_a_crash_looping_validator_fails_the_upgrade_and_a_new_template_retries():
    """The recycled validator crash-loops against the new driver: the node
    fails through the same path; a new template retries it."""
    w = World(PORT)
    w.setup()
    sm = w.machine()
    w.process(sm)
    w.process(sm)
    w.client.create(w.mk_pod("drv-0-new", "node-0", "driver", "img:2"))
    w.process(sm)
    assert w.state() == machine.VALIDATION_REQUIRED and "val-0" not in w.pods()
    w.client.create(crash_looping_pod(w, "val-0-new", "validator"))
    counts = w.process(sm)
    assert w.state() == machine.FAILED and counts.failed == 1
    assert "validator pod" in w.events("DriverUpgradeFailed")[0]["message"]
    w.roll_driver(image="img:3")
    w.process(sm)
    assert w.state() in machine.IN_PROGRESS_STATES


def test_a_pod_restarting_in_place_is_no_recovery():
    """Between its crashes a crash-looping pod is briefly Ready: the node
    stays upgrade-failed until the pod is replaced (restart count 0)."""
    w = World(PORT)
    w.setup()
    sm = w.machine()
    w.process(sm)
    w.process(sm)
    looping = crash_looping_pod(w, "drv-0-new", "driver", restarts=1)
    w.client.create(looping)
    w.process(sm)
    assert w.state() == machine.FAILED
    live = w.client.get("v1", "Pod", "drv-0-new", NS)
    live["status"] = {"phase": "Running", "conditions": [{"type": "Ready", "status": "True"}],
                      "initContainerStatuses": [{"name": "init", "restartCount": 2,
                                                 "state": {"terminated": {"exitCode": 0}}}]}
    w.client.update_status(live)
    w.process(sm)
    assert w.state() == machine.FAILED
    w.client.delete("v1", "Pod", "drv-0-new", NS)
    w.client.create(w.mk_pod("drv-0-fresh", "node-0", "driver", "img:2"))
    w.process(sm)
    assert w.state() == machine.VALIDATION_REQUIRED


# -- fault 3: the upgrade keeps its own episode ---------------------------------------

def _quarantined_node_upgrade(w):
    """A node the health machine quarantined and cordoned, with a live
    health episode, through a driver upgrade to its end."""
    w.setup()
    w.place("node-0", None, unschedulable=True, labels={w.c.HEALTH_STATE_LABEL: "quarantined"})
    node = w.node()
    node["metadata"].setdefault("annotations", {})[
        w.c.PROVENANCE_EPISODE_ANNOTATION] = "ep-967a9a74"
    w.client.update(node)
    w.journal.record_decision("health", "drain-plan", "ep-967a9a74",
                              trigger={"type": "verdict"}, node="node-0")
    _run_to_done(w)


def _run_to_done(w):
    sm = w.machine()
    w.process(sm)
    w.process(sm)
    w.client.create(w.mk_pod("drv-0-new", "node-0", "driver", "img:2"))
    w.process(sm)
    w.client.create(w.mk_pod("val-0-new", "node-0", "validator", "v:1"))
    w.process(sm)
    w.process(sm)
    assert w.state() == w.m.UNKNOWN


def test_a_health_quarantined_node_keeps_its_cordon_and_its_episode():
    """Input: a node quarantined with health episode ep-967a9a74 holding a
    drain-plan record, then a driver template rolls and the upgrade runs to
    its end. The reference records its upgrade in the health episode,
    closes it as done and wipes the node's episode id, and uncordons the
    quarantined node; the port's upgrade has its own episode, leaves the
    health episode open under its id, and keeps the health machine's cordon."""
    ref, port = World(REF), World(PORT)
    _quarantined_node_upgrade(ref)
    _quarantined_node_upgrade(port)
    chain = [r.kind for r in ref.journal.chain("ep-967a9a74")]
    assert chain == ["drain-plan", "upgrade", "upgrade-done"]
    assert ref.journal.episode_complete("ep-967a9a74")
    assert ref_consts.PROVENANCE_EPISODE_ANNOTATION not in (
        ref.node()["metadata"].get("annotations") or {})
    assert not ref.cordoned()

    assert [r.kind for r in port.journal.chain("ep-967a9a74")] == ["drain-plan"]
    assert not port.journal.episode_complete("ep-967a9a74")
    assert port.episodes() == [["drain-plan"], ["upgrade", "upgrade-done"]]
    anns = port.node()["metadata"]["annotations"]
    assert anns[consts.PROVENANCE_EPISODE_ANNOTATION] == "ep-967a9a74"
    assert consts.UPGRADE_EPISODE_ANNOTATION not in anns
    assert port.node()["metadata"]["labels"][consts.HEALTH_STATE_LABEL] == "quarantined"
    assert port.cordoned()


def test_the_upgrade_s_episode_is_stamped_and_dropped_with_the_node_s_exit():
    w = World(PORT)
    sm_log = []
    w.setup()
    sm = w.machine()
    w.process(sm)
    w.process(sm)
    anns = w.node()["metadata"]["annotations"]
    sm_log.append(anns[consts.UPGRADE_EPISODE_ANNOTATION])
    assert consts.PROVENANCE_EPISODE_ANNOTATION not in anns
    w.client.create(w.mk_pod("drv-0-new", "node-0", "driver", "img:2"))
    w.process(sm)
    w.client.create(w.mk_pod("val-0-new", "node-0", "validator", "v:1"))
    w.process(sm)
    w.process(sm)
    assert consts.UPGRADE_EPISODE_ANNOTATION not in (w.node()["metadata"].get("annotations")
                                                     or {})
    assert [r.episode for r in w.journal.records()] == sm_log * 2
