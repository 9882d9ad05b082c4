"""``chip_smoke.py`` phase 14 rehearsed on the CPU, and the drain-ack path
the card's phase leaves out.

The first test runs the smoke's own ``health_phase`` on a one-node cluster
of the port's MiniApiServer, a ``gpu-operator`` process and the process
kubelet, which runs the driver installer (from a fake bundle), the
validator's init chain with its spawned workload pod (``--device=cpu``)
and feature discovery, whose passes publish the node's verdict. The fault
is a workload pod that cannot write its status dir. Both episodes run as
on the card and fail where the smoke would.

The second test is the port's counterpart of the reference's
tests/test_health_soak.py: an in-process operator, and on the node side
in-process stand-ins for what would need the card (the barrier file) with
the port's own feature-discovery and slice-partitioner passes over fake
NVML. The workload acks the published drain plan (``maybe_ack_plan``), so
the gate releases before its deadline with no miss counted, the
partitioner re-tiles around the failed GPU under the health episode, and
recovery restores the layout; a second episode with the same verdict gets
its own id and all its records.
"""

import json
import os
import sys
import time
import types

from tpu_operator_torch import consts
from tpu_operator_torch.client import RestClient
from tpu_operator_torch.client.cache import CachedClient
from tpu_operator_torch.controllers.manager import OperatorApp
from tpu_operator_torch.health import drain
from tpu_operator_torch.partitioner.partitioner import read_handoff, sync_once
from tpu_operator_torch.testing import fake_nvml
from tpu_operator_torch.testing.apiserver import MiniApiServer
from tpu_operator_torch.testing.kubelet import INIT, RUN, ProcessKubelet
from tpu_operator_torch.validator.feature_discovery import sync_node_labels
from tpu_operator_torch.validator.status import StatusFiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "tpu_operator_torch", "manifests", "samples", "v1_clusterpolicy.json")
NS = "tpu-operator"
#: every wait's own limit
WAIT_S = 120


def _wait(predicate, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _policy(tmp_path, health):
    cp = json.load(open(SAMPLE))
    dev = tmp_path / "dev"
    dev.mkdir(exist_ok=True)
    (dev / "nvidia0").touch()
    cp["spec"]["hostPaths"] = {"validationStatusDir": str(tmp_path / "status"),
                               "partitionHandoffDir": str(tmp_path / "handoff"),
                               "driverInstallDir": str(tmp_path / "driver"),
                               "devGlobs": [str(dev / "nvidia0")]}
    cp["spec"]["health"] = health
    return cp


def test_phase_14_on_the_cpu(tmp_path):
    import chip_smoke

    bundle = tmp_path / "bundle"
    bundle.mkdir()
    for name in consts.DRIVER_LIB_FILES:
        (bundle / name).write_bytes(b"\x7fELF" + bytes(60))
    srv = MiniApiServer(watch_idle_timeout_s=1.0)
    base = srv.start()
    srv.backend.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "gpu-node", "labels": {consts.NFD_NVIDIA_PCI_LABEL: "true",
                                       consts.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb"}}})
    operator_env = {k: v for k, v in os.environ.items()
                    if k != "PYTHONPATH" and not k.startswith("GPU_")}
    env = {k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ}
    env.update(PYTHONPATH=REPO, KUBE_API_URL=base)
    driver_env = {consts.DRIVER_SRC_ENV: str(bundle), consts.DRIVER_VERSION_ENV: "580.0"}
    kubelet = ProcessKubelet(
        srv.backend, "gpu-node", NS, str(tmp_path / "logs"), env,
        {"gpu-validator": [sys.executable, "-m", "tpu_operator_torch.cmd.validator",
                           "--device=cpu", "--matrix-dim=64"]},
        modes={"gpu-driver": RUN, "gpu-operator-validator": RUN, "gpu-device-plugin": INIT,
               "gpu-feature-discovery": RUN},
        image_env={"gpu-driver": driver_env}, capacity_app="gpu-device-plugin",
        path_map={"/var/cache/gpu-kernels": str(tmp_path / "kernel-cache")}).start()
    try:
        srv.backend.create(_policy(tmp_path, {"enabled": False}))
        numbers = chip_smoke.health_phase(types.SimpleNamespace(
            srv=srv, base=base, kubelet=kubelet, namespace=NS, node_name="gpu-node",
            repo=REPO, work=str(tmp_path), card="cpu", operator_env=operator_env,
            driver_env=driver_env, fault_env={"STATUS_DIR": os.devnull + "/status"}))
    finally:
        kubelet.stop()
        srv.stop()
    a, b = numbers["episode_a"], numbers["episode_b"]
    assert a["degraded_s"] <= a["quarantined_s"] <= a["plan_s"] < a["remediating_s"]
    assert a["remediating_s"] - a["plan_s"] >= 5.0  # the drain window, unacked
    assert a["recovered_s"] < a["remediating_s"] + 30.0  # before a second attempt
    # the machine's 30 s waits, from the since stamps it wrote (whole
    # seconds): attempt 1 to attempt 2, attempt 2 to failed
    assert all(wait >= 30.0 for wait in b["remediation_waits_s"])
    assert b["remediating_s"] < b["attempt_2_s"] < b["failed_s"]
    assert [n for _, n in numbers["records"]["episodes"]] == [4, 5]
    assert numbers["records"]["audit"]["ok"]
    assert numbers["metrics"]["remediation_attempts_total"] == 3


# -- the drain-ack path, in process ------------------------------------------------

PARTITIONS = {"partitions": {"singles": [{"chips": 1, "count": "all"}]}}


def _barrier(passed, failed=None):
    payload = {"component": "workload", "passed": passed, "n_devices": 4,
               "local_chips": [0, 1, 2, 3], "platform": "cpu"}
    if failed is not None:
        payload["failed_local_chips"] = list(failed)
    return payload


class Node:
    """The node's side in process: its barrier file, and one agent pass of
    feature discovery and the slice partitioner (fake NVML, 4 GPUs)."""

    def __init__(self, tmp_path, client, name, journal):
        self.client, self.name, self.journal = client, name, journal
        self.status = StatusFiles(str(tmp_path / "status"))
        self.handoff = str(tmp_path / "handoff")
        self.config = str(tmp_path / "partitions.json")
        with open(self.config, "w") as f:
            json.dump(PARTITIONS, f)
        gpus = fake_nvml.random_gpus(4, 3)
        self.nvml = fake_nvml.FakeNvml(gpus)
        self.status.write("workload", _barrier(True))

    def agent_pass(self, drain_deadline_s=60):
        sync_node_labels(self.client, self.name, device="cpu", status_dir=self.status.directory)
        return sync_once(self.client, self.name, self.config, self.handoff,
                         status_dir=self.status.directory, drain_deadline_s=drain_deadline_s,
                         nvml_lib=self.nvml, journal=self.journal)

    def get(self):
        return self.client.get("v1", "Node", self.name)

    def state(self):
        return (self.get()["metadata"].get("labels") or {}).get(consts.HEALTH_STATE_LABEL, "")

    def annotations(self):
        return self.get()["metadata"].get("annotations") or {}


def test_a_drain_ack_releases_the_gate_before_the_deadline(tmp_path, monkeypatch):
    # the node's four GPU device nodes, which feature discovery counts
    dev = tmp_path / "gpus"
    dev.mkdir()
    for i in range(4):
        (dev / f"nvidia{i}").touch()
    monkeypatch.setenv(consts.GPU_DEV_GLOBS_ENV, str(dev / "nvidia[0-9]*"))
    srv = MiniApiServer(watch_idle_timeout_s=1.0)
    base = srv.start()
    raw = RestClient(base)
    raw.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "gpu-node", "labels": {consts.NFD_NVIDIA_PCI_LABEL: "true",
                                       consts.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb",
                                       consts.TPU_CHIP_COUNT_LABEL: "4"}}})
    # every DaemonSet simulated: available at once, its pod a Pod object
    kubelet = ProcessKubelet(srv.backend, "gpu-node", NS, str(tmp_path / "logs"), {}, {}).start()
    client = CachedClient(RestClient(base))
    app = OperatorApp(client, health_port=0)
    node = Node(tmp_path, raw, "gpu-node", app.journal)
    try:
        raw.create(_policy(tmp_path, {"enabled": True, "drainDeadlineS": 60,
                                      "remediationWaitS": 30, "cordonOnQuarantine": True}))
        app.start()
        _wait(lambda: (raw.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy").get("status")
                       or {}).get("state") == "ready", "ready")
        raw.patch("v1", "Node", "gpu-node", {"metadata": {"labels": {
            consts.TPU_SLICE_CONFIG_LABEL: "singles"}}})
        assert node.agent_pass() == "success"
        original = read_handoff(node.handoff)["groups"]
        assert len(original) == 4

        for episode in (1, 2):
            # an episode's id holds the second its node entered the state
            # it was minted in: start the second one in a later second
            time.sleep(1.0 - time.time() % 1.0)
            # GPU 2 fails: the partitioner holds the layout while the plan
            # is negotiated
            node.status.write("workload", _barrier(False, failed=[2]))
            assert node.agent_pass() == "pending"
            _wait(lambda: drain.node_plan(node.get()) is not None, "the plan published")
            plan = drain.node_plan(node.get())
            assert plan.reason == drain.REASON_RETILE and plan.blocked == [2]
            assert plan.fingerprint == drain.plan_fingerprint("singles", [2])
            assert node.state() == "quarantined" and node.get()["spec"]["unschedulable"]
            assert node.agent_pass() == "pending"  # no ack yet: still held
            # the workload acks: checkpoint, barrier stamp; feature discovery
            # mirrors it and the partitioner re-tiles on it
            assert drain.maybe_ack_plan(raw, "gpu-node", node.status, step=7)
            assert node.agent_pass() == "retiled"
            assert read_handoff(node.handoff)["blocked"] == [2]
            assert drain.node_acked_plan(node.get()) == plan.fingerprint
            _wait(lambda: node.state() == "remediating", "the ack releasing remediation")
            assert time.time() < plan.deadline  # before the deadline
            # revalidation passes: the episode ends and the layout returns
            node.status.write("workload", _barrier(True, failed=None) | {
                "drain_ack": drain.read_drain_ack(node.status)})
            node.agent_pass()
            _wait(lambda: node.state() == "", "healthy again")
            drain.maybe_ack_plan(raw, "gpu-node", node.status)  # drops the stale stamp
            assert drain.read_drain_ack(node.status) is None
            assert node.agent_pass() == "success"
            assert read_handoff(node.handoff)["groups"] == original
            anns = node.annotations()
            for key in (consts.RETILE_PLAN_ANNOTATION, consts.DRAIN_ACK_ANNOTATION,
                        consts.PROVENANCE_EPISODE_ANNOTATION):
                assert key not in anns, key
            assert not node.get()["spec"].get("unschedulable")

        text = app.metrics.scrape().decode()
        assert "tpu_operator_drain_deadline_missed_total 0.0" in text
        assert "tpu_operator_remediation_attempts_total 2.0" in text
        events = {}
        for e in raw.list("v1", "Event", NS):
            if e["involvedObject"]["name"] == "gpu-node":
                events[e["reason"]] = events.get(e["reason"], 0) + int(e.get("count") or 1)
        assert events.get("RetilePlanned") == 2 and "RetileDeadlineExpired" not in events
        # two episodes, each with the partitioner's re-tile chained in
        chains = [[f"{r.subsystem}/{r.kind}" for r in app.journal.chain(e["episode"])]
                  for e in sorted(app.journal.episodes(), key=lambda e: e["first_ts"])
                  if e["kind"] == "drain-plan"]
        # (the re-tile and the remediation race: the ack releases both; so do
        # the recovery and the layout's restore: the passing barrier releases
        # both)
        assert len(chains) == 2
        for chain in chains:
            assert len(chain) == 5 and chain[0] == "health/drain-plan"
            assert sorted(chain[1:3]) == ["health/remediate", "partitioner/re-tile"]
            assert sorted(chain[3:]) == ["health/health-recover", "partitioner/partition-apply"]
        assert app.journal.replayed_total == 0
    finally:
        app.stop()
        client.stop()
        kubelet.stop()
        srv.stop()
