"""The twin of tests/test_soak.py: the seeded churn soak and its HA variant
on the port's stack (the port's ``MiniApiServer``, ``RestClient``,
``CachedClient``, ``OperatorApp``, ``KubeletSimulator`` and
``LeaderElector``).

Nodes join and leave, operands are disabled and enabled, operand
DaemonSets are deleted under the operator, the driver version flips, the
slice-partition labels churn and the apiserver dies and comes back on the
same endpoint, all drawn from a seeded RNG (``SOAK_SEED``, 20260730; the
HA soak draws from seed + 1) with the reference's action mix, soak length
(``SOAK_SECONDS``, 12 s) and waits. When the churn stops, every surviving
GPU node must advertise its GPUs, the ClusterPolicy must be ``ready`` with
``SlicePartitionFailed`` cleared, and the core DaemonSets available on
every node.

The HA soak runs two replicas with 3 s leases and a supervisor that
replaces a replica whose elector reported leadership lost. Beyond the
reference, each port replica writes through the operator's fence
(``FencedClient``, bound to its elector), and a probe under the fence
records every mutating request a replica dispatches while the Lease names
another holder: a stale write that lands is a fault, so the list must end
empty.
"""

import os
import random
import socket
import threading
import time

import pytest

import test_soak as ref_soak
from test_torch_operator_mapping import LANE_DAEMONSETS, map_labels
from tpu_operator_torch import consts
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.client import ApiError, NotFoundError, RestClient
from tpu_operator_torch.client.cache import CachedClient
from tpu_operator_torch.client.fenced import FencedClient
from tpu_operator_torch.client.interface import Client
from tpu_operator_torch.controllers.leader import LEASE_NAME, LeaderElector
from tpu_operator_torch.controllers.manager import OperatorApp
from tpu_operator_torch.partitioner.partitioner import DEFAULT_PARTITIONS
from tpu_operator_torch.testing.apiserver import MiniApiServer
from tpu_operator_torch.testing.kubelet import GPUS_PER_NODE, KubeletSimulator
from tpu_operator_torch.utils import deep_get

NS = consts.DEFAULT_NAMESPACE
GPU_LABELS = {consts.NFD_NVIDIA_PCI_LABEL: "true",
              **map_labels({"cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
                            "cloud.google.com/gke-tpu-topology": "2x4"})}
#: a partition of the port's table where the reference's names its 2x2 split
SPLIT = sorted(DEFAULT_PARTITIONS)[-1]
CP = ("tpu.ai/v1", "ClusterPolicy", "cluster-policy")

SOAK_SECONDS = float(os.environ.get("SOAK_SECONDS", "12"))
SEED = int(os.environ.get("SOAK_SEED", "20260730"))
#: an apiserver error or a transport failure: every transport failure of the
#: port's client is an OSError, as the reference's ``requests.RequestException`` is
TRANSPORT_ERRORS = (ApiError, OSError)
#: the reference's action mixes, by method name: the single-operator soak's
#: and the HA soak's (which adds the leader's crash)
SINGLE_MIX = ["add_node"] * 3 + ["remove_node"] * 2 + ["flip_operand"] * 3 + \
    ["delete_random_ds"] * 2 + ["bump_driver"] * 2 + ["restart_apiserver"] + \
    ["churn_slice_state"] * 2
HA_MIX = ["add_node"] * 3 + ["remove_node"] + ["flip_operand"] * 3 + \
    ["delete_random_ds"] * 2 + ["bump_driver"] + ["restart_apiserver"] + \
    ["churn_slice_state"] * 2 + ["kill_leader"]


@pytest.fixture(autouse=True)
def default_images(monkeypatch):
    for env in ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE", "DEVICE_PLUGIN_IMAGE"):
        monkeypatch.setenv(env, "registry.example.com/x:0.1.0")


def wait_for(predicate, timeout=60.0, interval=0.05, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if predicate():
                return
        except TRANSPORT_ERRORS:
            pass  # the apiserver mid-restart; anything else is a predicate bug
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


def test_the_soaks_keep_the_reference_s_seed_length_and_action_mix():
    assert (SEED, SOAK_SECONDS) == (ref_soak.SEED, ref_soak.SOAK_SECONDS)
    kit = {name for name in vars(ref_soak.ChaosKit) if not name.startswith("_")}
    assert set(SINGLE_MIX) | {"restore_operands", "restore_slices", "assert_converged"} == kit
    assert {name for name in vars(ChaosKit) if not name.startswith("_")} == kit
    assert set(HA_MIX) - set(SINGLE_MIX) == {"kill_leader"}


class ChaosKit:
    """The reference's churn actions on the port's names."""

    def __init__(self, client, rng, srv_holder, port):
        self.client = client
        self.rng = rng
        self.srv_holder = srv_holder
        self.port = port
        self.live_nodes = []
        self.ids = iter(range(10_000))

    def add_node(self):
        name = f"gpu-{next(self.ids)}"
        self.client.create({"apiVersion": "v1", "kind": "Node",
                            "metadata": {"name": name, "labels": dict(GPU_LABELS)},
                            "status": {}})
        self.live_nodes.append(name)

    def remove_node(self):
        if len(self.live_nodes) <= 1:
            return
        name = self.live_nodes.pop(self.rng.randrange(len(self.live_nodes)))
        self.client.delete("v1", "Node", name)

    def flip_operand(self):
        operand = self.rng.choice(["telemetry", "featureDiscovery", "nodeStatusExporter"])
        self.client.patch(*CP, {"spec": {operand: {"enabled": self.rng.random() < 0.5}}})

    def delete_random_ds(self):
        dses = self.client.list("apps/v1", "DaemonSet", NS)
        if dses:
            victim = self.rng.choice(dses)["metadata"]["name"]
            self.client.delete("apps/v1", "DaemonSet", victim, NS)

    def bump_driver(self):
        self.client.patch(*CP, {"spec": {"driver": {
            "repository": "registry.example.com", "image": "x",
            "version": f"0.1.{self.rng.randrange(10)}"}}})

    def restart_apiserver(self):
        old = self.srv_holder["srv"]
        backend = old.backend
        old.stop()
        time.sleep(0.3)
        fresh = MiniApiServer(backend=backend)
        fresh.start(self.port)
        self.srv_holder["srv"] = fresh

    def churn_slice_state(self):
        if not self.live_nodes:
            return
        name = self.rng.choice(self.live_nodes)
        roll = self.rng.random()
        if roll < 0.4:
            labels = {consts.TPU_SLICE_CONFIG_LABEL: SPLIT, consts.TPU_SLICE_STATE_LABEL: "failed"}
        elif roll < 0.7:
            labels = {consts.TPU_SLICE_CONFIG_LABEL: SPLIT,
                      consts.TPU_SLICE_STATE_LABEL: "success"}
        else:
            labels = {consts.TPU_SLICE_CONFIG_LABEL: None, consts.TPU_SLICE_STATE_LABEL: None}
        try:
            self.client.patch("v1", "Node", name, {"metadata": {"labels": labels}})
        except ApiError:
            pass  # the node deleted mid-choice

    def restore_slices(self, wait_for):
        for name in list(self.live_nodes):
            wait_for(lambda n=name: self.client.patch(
                "v1", "Node", n, {"metadata": {"labels": {
                    consts.TPU_SLICE_CONFIG_LABEL: None,
                    consts.TPU_SLICE_STATE_LABEL: None}}}) is not None,
                timeout=10, message=f"clear slice labels on {name}")

    def restore_operands(self, wait_for):
        for operand in ("telemetry", "featureDiscovery", "nodeStatusExporter"):
            wait_for(lambda op=operand: self.client.patch(
                *CP, {"spec": {op: {"enabled": True}}}) is not None,
                timeout=10, message=f"re-enable {operand}")

    def assert_converged(self, wait_for):
        def all_nodes_schedulable():
            return all(deep_get(self.client.get("v1", "Node", n), "status", "capacity",
                                consts.GPU_RESOURCE_NAME) == str(GPUS_PER_NODE)
                       for n in self.live_nodes)
        wait_for(all_nodes_schedulable, message="all surviving nodes schedulable")
        wait_for(lambda: deep_get(self.client.get(*CP), "status", "state") == "ready",
                 message="ready after chaos")

        def slice_condition_settled():
            policy = self.client.get(*CP)
            for cond in deep_get(policy, "status", "conditions", default=[]) or []:
                if cond.get("type") == "SlicePartitionFailed":
                    return cond.get("status") != "True"
            return True
        wait_for(slice_condition_settled, message="SlicePartitionFailed cleared after restore")


class StaleWriteProbe(Client):
    """Under a replica's fence: before each mutating request it dispatches
    (Leases aside, which the elector writes on its own client), read the
    Lease from the apiserver's store in process and record the request when
    the Lease names another holder. The fence admits a write only inside
    its hold window, which ends before any peer may take the Lease, so a
    recorded request is a stale write the fence let through."""

    def __init__(self, inner, backend, identity, stale):
        self.inner = inner
        self.scheme = getattr(inner, "scheme", None)
        self.backend = backend
        self.identity = identity
        self.stale = stale

    def _check(self, verb, kind, name):
        if kind == "Lease":
            return
        try:
            lease = self.backend.get("coordination.k8s.io/v1", "Lease", LEASE_NAME, NS)
        except NotFoundError:
            holder = None
        else:
            holder = deep_get(lease, "spec", "holderIdentity")
        if holder != self.identity:
            self.stale.append((self.identity, holder, verb, kind, name, time.monotonic()))

    def get(self, api_version, kind, name, namespace=None):
        return self.inner.get(api_version, kind, name, namespace)

    def list(self, api_version, kind, namespace=None, label_selector=None, field_selector=None):
        return self.inner.list(api_version, kind, namespace, label_selector=label_selector,
                               field_selector=field_selector)

    def create(self, obj):
        self._check("create", obj.get("kind"), deep_get(obj, "metadata", "name"))
        return self.inner.create(obj)

    def update(self, obj):
        self._check("update", obj.get("kind"), deep_get(obj, "metadata", "name"))
        return self.inner.update(obj)

    def update_status(self, obj):
        self._check("update_status", obj.get("kind"), deep_get(obj, "metadata", "name"))
        return self.inner.update_status(obj)

    def patch(self, api_version, kind, name, patch, namespace=None):
        self._check("patch", kind, name)
        return self.inner.patch(api_version, kind, name, patch, namespace)

    def delete(self, api_version, kind, name, namespace=None):
        self._check("delete", kind, name)
        return self.inner.delete(api_version, kind, name, namespace)

    def evict(self, name, namespace=None):
        self._check("evict", "Pod", name)
        return self.inner.evict(name, namespace)

    def watch(self, *args, **kwargs):
        return self.inner.watch(*args, **kwargs)

    def server_version(self):
        return self.inner.server_version()

    def stop(self):
        self.inner.stop()


def test_chaos_soak_with_ha_replicas_converges():
    rng = random.Random(SEED + 1)
    srv_holder = {}
    srv = MiniApiServer()
    base = srv.start()
    srv_holder["srv"] = srv
    port = int(base.rsplit(":", 1)[1])
    chaos = RestClient(base_url=base)
    kubelet = KubeletSimulator(chaos, interval=0.05).start()
    kit = ChaosKit(chaos, rng, srv_holder, port)

    replicas = {}
    clients = []
    fences = []
    stale = []
    spawn_seq = iter(range(10_000))

    def spawn(slot):
        identity = f"{slot}-{next(spawn_seq)}"
        fence = FencedClient(StaleWriteProbe(RestClient(base_url=base), srv.backend,
                                             identity, stale))
        op_client = CachedClient(fence)
        lease_client = RestClient(base_url=base)
        clients.extend([op_client, lease_client])
        app = OperatorApp(op_client)
        elector = LeaderElector(lease_client, NS, identity=identity, lease_duration=3.0,
                                renew_period=0.75, retry_period=0.4)
        fence.bind(elector)
        fences.append(fence)
        dead = {"flag": False}

        def on_lost(a=app, e=elector, d=dead):
            # a lost leader exits in production; this one must never take
            # the lease again, so its elector stops from its own callback
            d["flag"] = True
            e._stop.set()
            a.stop()

        elector.run(on_started=app.start, on_stopped=on_lost)
        replicas[slot] = {"app": app, "elector": elector, "dead": dead}

    def kill_leader():
        for replica in replicas.values():
            if replica["elector"].is_leader.is_set():
                # a hard crash: no lease release; expiry hands over
                replica["elector"]._stop.set()
                replica["app"].stop()
                replica["dead"]["flag"] = True
                return

    actions = {"kill_leader": kill_leader}
    actions = [actions.get(name) or getattr(kit, name) for name in HA_MIX]

    try:
        kit.add_node()
        chaos.create(new_cluster_policy())
        spawn("a")
        spawn("b")
        wait_for(lambda: deep_get(chaos.get(*CP), "status", "state") == "ready",
                 message="initial install ready")

        deadline = time.monotonic() + SOAK_SECONDS
        while time.monotonic() < deadline:
            try:
                rng.choice(actions)()
            except TRANSPORT_ERRORS:
                pass
            # the supervisor: a dead replica is replaced, as a kubelet restarts its pod
            for slot, replica in list(replicas.items()):
                if replica["dead"]["flag"]:
                    spawn(slot)
            time.sleep(rng.uniform(0.05, 0.25))

        kit.restore_operands(wait_for)
        kit.restore_slices(wait_for)
        kit.assert_converged(wait_for)
        assert stale == [], f"stale writes landed past the fence: {stale[:5]}"
        assert sum(f.dispatched_total for f in fences) > 0
    finally:
        for replica in replicas.values():
            replica["elector"]._stop.set()
            replica["app"].stop()
        for op_client in clients:
            op_client.stop()
        kubelet.stop()
        chaos.stop()
        srv_holder["srv"].stop()


def test_chaos_soak_converges():
    rng = random.Random(SEED)
    backend_holder = {}
    srv = MiniApiServer()
    base = srv.start()
    backend_holder["srv"] = srv
    port = int(base.rsplit(":", 1)[1])
    chaos = RestClient(base_url=base)
    op_client = CachedClient(RestClient(base_url=base))
    kubelet = KubeletSimulator(chaos, interval=0.05).start()
    app = OperatorApp(op_client)
    kit = ChaosKit(chaos, rng, backend_holder, port)
    live_nodes = kit.live_nodes
    actions = [getattr(kit, name) for name in SINGLE_MIX]

    try:
        kit.add_node()
        kit.add_node()
        chaos.create(new_cluster_policy())
        app.start()
        wait_for(lambda: deep_get(chaos.get(*CP), "status", "state") == "ready",
                 message="initial install ready")

        deadline = time.monotonic() + SOAK_SECONDS
        steps = 0
        while time.monotonic() < deadline:
            action = rng.choice(actions)
            try:
                action()
            except TRANSPORT_ERRORS:
                # the churn racing itself, or a kept-alive socket dying
                # across an apiserver restart
                pass
            steps += 1
            time.sleep(rng.uniform(0.02, 0.2))
        assert steps > 20, "soak too short to mean anything"

        kit.restore_operands(wait_for)
        kit.restore_slices(wait_for)
        kit.assert_converged(wait_for)

        def core_ds_healthy():
            for ref_name in ("libtpu-driver", "tpu-device-plugin", "tpu-telemetry-exporter"):
                try:
                    ds = chaos.get("apps/v1", "DaemonSet", LANE_DAEMONSETS[ref_name], NS)
                except NotFoundError:
                    return False
                if (ds.get("status") or {}).get("numberAvailable", 0) != len(live_nodes):
                    return False
            return True
        wait_for(core_ds_healthy, message="core DaemonSets healthy on all nodes")
    finally:
        app.stop()
        op_client.stop()
        kubelet.stop()
        chaos.stop()
        backend_holder["srv"].stop()


def _cut_short_server():
    """A server that answers one request with fewer body bytes than its
    Content-Length, then hangs up, as an apiserver stopping mid-answer does."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)

    def serve():
        conn, _ = listener.accept()
        with conn:
            conn.recv(65536)
            conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                         b"Content-Length: 100\r\n\r\n{\"kind\": \"No")
        listener.close()

    threading.Thread(target=serve, daemon=True).start()
    return f"http://127.0.0.1:{listener.getsockname()[1]}"


@pytest.mark.parametrize("package", ["port", "reference"])
def test_an_answer_cut_short_is_a_transport_failure(package):
    """An apiserver that stops mid-answer: the client raises an OSError, as
    for a reset, so every caller that rides out transport failures rides
    this one out too. The port's ``http.client`` raised ``IncompleteRead``,
    no OSError, which killed the kubelet simulator's thread in the HA soak;
    the reference's ``requests`` raises ``ChunkedEncodingError``, an OSError."""
    from tpu_operator.client.rest import RestClient as RefRestClient

    client = (RestClient if package == "port" else RefRestClient)(base_url=_cut_short_server())
    with pytest.raises(OSError):
        client.get("v1", "Node", "gpu-0")
