"""Multi-node validation: the rendezvous pods and the state walk against
the reference's, then the pods' env driving two real ranks.

For slices of 1, 2 and 4 nodes the port's pods carry MASTER_ADDR (worker
0's pod DNS name), MASTER_PORT, WORLD_SIZE and RANK where the reference's
carry the JAX coordinator env, with RANKs 0..n-1 in the reference's worker
order (tests/test_torch_operator_mapping.py:map_rendezvous_pod). The walk is
the same: launch, all Succeeded then stamp and teardown, any Failed then
teardown, changed membership then restart, and the scheduling budget.
"""

import calendar
import copy
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from test_torch_operator_mapping import map_node, map_rendezvous_pod, map_spec
from tpu_operator.api.clusterpolicy import ClusterPolicy as RefPolicy
from tpu_operator.client import FakeClient as RefFake
from tpu_operator.state.manager import InfoCatalog as RefCatalog
from tpu_operator.state.multihost import MultihostValidationState as RefState
from tpu_operator_torch import consts
from tpu_operator_torch.api.clusterpolicy import ClusterPolicy
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.state.manager import (INFO_CLUSTER_POLICY, INFO_NAMESPACE, INFO_NODES,
                                              InfoCatalog)
from tpu_operator_torch.state.multihost import APP_LABEL, MultihostValidationState
from tpu_operator_torch.validator import main as vmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "tpu-operator"
SPEC = {"validator": {"repository": "gcr.io/x", "image": "validator", "version": "1"},
        "driver": {"libtpuVersion": "1.2.3"}}
JOIN_TIMEOUT_S = 120


def _slice(seed: int, n: int, slice_id: str = "s1"):
    rng = np.random.default_rng(seed)
    names = [f"node-{int(x):03d}" for x in rng.choice(1000, size=n, replace=False)]
    return [{"apiVersion": "v1", "kind": "Node",
             "metadata": {"name": name, "labels": {"tpu.ai/slice.id": slice_id,
                                                   "tpu.ai/tpu.present": "true"}},
             "status": {"capacity": {"google.com/tpu": str(int(rng.choice([4, 8])))}}}
            for name in names]


class Twin:
    """The reference's state and the port's on the mapped cluster, driven
    through the same sweeps."""

    def __init__(self, nodes, spec=SPEC, budget=300.0, now=None):
        self.now = [1_000_000.0] if now is None else now
        self.ref = RefFake(objects=copy.deepcopy(nodes))
        self.port = FakeClient(objects=[map_node(n) for n in nodes])
        obj = {"apiVersion": "tpu.ai/v1", "kind": "ClusterPolicy",
               "metadata": {"name": "cp", "uid": "u1"}}
        self.ref_policy = RefPolicy.from_obj(dict(obj, spec=copy.deepcopy(spec)))
        self.port_policy = ClusterPolicy.from_obj(dict(obj, spec=map_spec(spec)))
        self.ref_state = RefState(self.ref, scheduling_budget_s=budget, now=lambda: self.now[0])
        self.port_state = MultihostValidationState(self.port, scheduling_budget_s=budget,
                                                   now=lambda: self.now[0])

    def sync(self):
        ref_cat = RefCatalog({"cluster-policy": self.ref_policy, "namespace": NS,
                              "nodes": self.ref.list("v1", "Node")})
        port_cat = InfoCatalog({INFO_CLUSTER_POLICY: self.port_policy, INFO_NAMESPACE: NS,
                                INFO_NODES: self.port.list("v1", "Node")})
        want, got = self.ref_state.sync(ref_cat), self.port_state.sync(port_cat)
        assert (got.status.value, got.message) == (want.status.value, want.message)
        assert self.pods() == [map_rendezvous_pod(p) for p in self.ref_pods()]
        assert self.stamps() == self.ref_stamps()
        return got.status.value

    def ref_pods(self):
        return [_strip(p) for p in self.ref.list("v1", "Pod", NS)
                if p["metadata"]["labels"].get("app") == "tpu-multihost-validation"]

    def pods(self):
        return [_strip(p) for p in self.port.list("v1", "Pod", NS)
                if p["metadata"]["labels"].get("app") == APP_LABEL]

    def ref_stamps(self):
        return {n["metadata"]["name"]: (n["metadata"].get("annotations") or {}).get(
            consts.MULTIHOST_VALIDATED_ANNOTATION) for n in self.ref.list("v1", "Node")}

    def stamps(self):
        return {n["metadata"]["name"]: (n["metadata"].get("annotations") or {}).get(
            consts.MULTIHOST_VALIDATED_ANNOTATION) for n in self.port.list("v1", "Node")}

    def set_phases(self, phases):
        for client, pods in ((self.ref, self.ref_pods()), (self.port, self.pods())):
            for pod, phase in zip(sorted(pods, key=_worker), phases):
                live = client.get("v1", "Pod", pod["metadata"]["name"], NS)
                live["status"] = {"phase": phase}
                client.update_status(live)


def _worker(pod):
    return int(pod["metadata"]["labels"][consts.MULTIHOST_WORKER_ID_LABEL])


def _strip(obj):
    """Server-managed fields and the owner's uid-derived trace id out."""
    obj = copy.deepcopy(obj)
    for key in ("uid", "resourceVersion", "creationTimestamp", "generation"):
        obj["metadata"].pop(key, None)
    for ref in obj["metadata"].get("ownerReferences", []):
        ref.pop("uid", None)
    obj["metadata"].get("annotations", {}).pop(consts.SPEC_HASH_ANNOTATION, None)
    obj.pop("status", None)
    return obj


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_rendezvous_pods_match_reference_after_mapping(n, seed):
    twin = Twin(_slice(seed, n))
    status = twin.sync()
    pods = twin.pods()
    if n == 1:  # one node is no multi-node slice: nothing to launch
        assert status == "ready" and pods == []
        return
    assert status == "notReady" and len(pods) == n
    names = sorted(node["metadata"]["name"] for node in twin.port.list("v1", "Node"))
    master = f"{APP_LABEL.replace('multihost-validation', 'mh-validation')}-s1-0"
    for pod in pods:
        env = {e["name"]: e.get("value") for e in pod["spec"]["containers"][0]["env"]}
        rank = int(env["RANK"])
        assert pod["spec"]["nodeName"] == names[rank]  # ranks follow name order
        assert env["WORLD_SIZE"] == str(n) and env["MASTER_PORT"] == "29500"
        assert env["MASTER_ADDR"] == f"{master}.gpu-mh-validation-s1.{NS}.svc"
        limits = pod["spec"]["containers"][0]["resources"]["limits"]
        node = twin.port.get("v1", "Node", pod["spec"]["nodeName"])
        assert limits == {consts.GPU_RESOURCE_NAME:
                          node["status"]["capacity"][consts.GPU_RESOURCE_NAME]}
    assert sorted(int(_worker(p)) for p in pods) == list(range(n))


def test_all_succeeded_stamps_and_tears_down():
    twin = Twin(_slice(2, 4))
    assert twin.sync() == "notReady"
    twin.set_phases(["Running"] * 4)
    assert twin.sync() == "notReady"
    twin.set_phases(["Succeeded"] * 4)
    assert twin.sync() == "ready"
    assert twin.pods() == [] and all(twin.stamps().values())
    assert twin.sync() == "ready"  # stamped: nothing relaunched


def test_any_failed_tears_down_for_a_clean_retry():
    twin = Twin(_slice(3, 2))
    twin.sync()
    twin.set_phases(["Succeeded", "Failed"])
    assert twin.sync() == "notReady"
    assert twin.pods() == [] and not any(twin.stamps().values())
    assert twin.sync() == "notReady" and len(twin.pods()) == 2  # relaunched


def test_changed_membership_restarts_validation():
    nodes = _slice(4, 2)
    twin = Twin(nodes)
    twin.sync()
    extra = _slice(5, 1)[0]
    twin.ref.create(copy.deepcopy(extra))
    twin.port.create(map_node(extra))
    assert twin.sync() == "notReady" and twin.pods() == []  # stale hash: teardown
    assert twin.sync() == "notReady" and len(twin.pods()) == 3


def test_a_stamp_survives_only_its_driver_version():
    twin = Twin(_slice(6, 2))
    twin.sync()
    twin.set_phases(["Succeeded", "Succeeded"])
    assert twin.sync() == "ready"
    spec = copy.deepcopy(SPEC)
    spec["driver"]["libtpuVersion"] = "9.9.9"
    obj = {"apiVersion": "tpu.ai/v1", "kind": "ClusterPolicy", "metadata": {"name": "cp"}}
    twin.ref_policy = RefPolicy.from_obj(dict(obj, spec=copy.deepcopy(spec)))
    twin.port_policy = ClusterPolicy.from_obj(dict(obj, spec=map_spec(spec)))
    assert twin.sync() == "notReady" and len(twin.pods()) == 2


def test_the_scheduling_budget_tears_down_pods_stuck_pending():
    twin = Twin(_slice(7, 2), budget=60.0)
    twin.sync()
    created = max(calendar.timegm(time.strptime(p["metadata"]["creationTimestamp"],
                                                "%Y-%m-%dT%H:%M:%SZ"))
                  for client in (twin.ref, twin.port) for p in client.list("v1", "Pod", NS))
    twin.set_phases(["Running", "Pending"])
    twin.now[0] = created + 30.0
    assert twin.sync() == "notReady" and len(twin.pods()) == 2  # inside the budget
    twin.now[0] = created + 62.0
    assert twin.sync() == "notReady" and twin.pods() == []
    reasons = [e["reason"] for e in twin.port.list("v1", "Event", NS)]
    assert reasons == [e["reason"] for e in twin.ref.list("v1", "Event", NS)]
    assert reasons == ["MultihostSchedulingTimeout"]


def test_two_ranks_from_the_pods_env_pass_over_gloo(tmp_path, monkeypatch):
    """The env the port's pods carry is what workload-multihost reads: the
    parser turns it into the rendezvous; two CPU ranks given that env (the
    store as a file:// URL, as no fixed port may be used here) pass."""
    twin = Twin(_slice(8, 2))
    twin.sync()
    pods = sorted(twin.pods(), key=_worker)
    for pod in pods:
        env = {e["name"]: e["value"] for e in pod["spec"]["containers"][0]["env"]
               if "value" in e}
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        args = vmain.build_parser().parse_args(pod["spec"]["containers"][0]["args"])
        assert args.coordinator == f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        assert (args.num_processes, args.process_id) == (2, int(env["RANK"]))
        assert args.init_timeout == 600.0
    store = "file://" + str(tmp_path / "store")
    procs = []
    for pod in pods:
        container = pod["spec"]["containers"][0]
        env = {e["name"]: e["value"] for e in container["env"] if "value" in e}
        env.update(NODE_NAME=pod["spec"]["nodeName"], PYTHONPATH=REPO, GPU_INIT_TIMEOUT="60")
        for key in ("MASTER_ADDR", "MASTER_PORT"):
            env.pop(key)
        argv = [sys.executable, "-m", "tpu_operator_torch.cmd.validator", *container["args"],
                f"--coordinator={store}", "--device=cpu", "--matrix-dim=64",
                f"--status-dir={tmp_path / env['RANK']}"]
        procs.append(subprocess.Popen(argv, env=dict(os.environ, **env), text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for p in procs:
        out, err = p.communicate(timeout=JOIN_TIMEOUT_S)
        assert p.returncode == 0, err[-2000:]
        assert '"passed": true' in out
    for rank in ("0", "1"):
        assert (tmp_path / rank / "workload-ready").exists()
