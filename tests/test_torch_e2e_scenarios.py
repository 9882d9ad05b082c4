"""The twin of tests/test_e2e_scenarios.py: the reference's seven end-to-end
scenarios over the real wire, each run ``direct`` and ``cached``, on the
port's own stack: the port's ``RestClient`` (and ``CachedClient``) against
``tpu_operator_torch.testing.apiserver.MiniApiServer`` over HTTP, the
port's ``OperatorApp``, and the port's in-memory ``KubeletSimulator``
standing in for the node agents.

Each scenario keeps the reference's steps, assertions and waits (45 s per
``wait_for``, a 0.05 s poll, a 0.03 s kubelet tick, the 6 s / 1.5 s / 0.5 s
leases of the failover); names go through
tests/test_torch_operator_mapping.py: the nodes carry NFD's NVIDIA PCI
label and GKE's accelerator label where the reference's carry GKE's TPU
labels, the operands are ``gpu-*`` DaemonSets, the per-pool driver is a
``GPUDriver`` whose pools are keyed on the GPU model, and a node advertises
``nvidia.com/gpu`` (the simulator's GPUs per node, where the reference's
gives 4 TPU chips).
"""

import time

import pytest

from test_torch_operator_mapping import LANE_DAEMONSETS, map_labels
from tpu_operator_torch import consts
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.client import NotFoundError, RestClient
from tpu_operator_torch.client.cache import CachedClient
from tpu_operator_torch.controllers.leader import LeaderElector
from tpu_operator_torch.controllers.manager import OperatorApp
from tpu_operator_torch.state.multihost import APP_LABEL as MULTIHOST_APP
from tpu_operator_torch.testing.apiserver import MiniApiServer
from tpu_operator_torch.testing.kubelet import GPUS_PER_NODE, KubeletSimulator
from tpu_operator_torch.utils import deep_get

NS = consts.DEFAULT_NAMESPACE
#: the reference's node labels (GKE's v5e accelerator, topology 2x4) as a
#: GPU node's: NFD's PCI label and the mapped GKE accelerator
REF_TPU_LABELS = {"cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
                  "cloud.google.com/gke-tpu-topology": "2x4"}
GPU_LABELS = {consts.NFD_NVIDIA_PCI_LABEL: "true", **map_labels(REF_TPU_LABELS)}
GPUS = str(GPUS_PER_NODE)
DRIVER, PLUGIN, TELEMETRY = (LANE_DAEMONSETS[n] for n in
                             ("libtpu-driver", "tpu-device-plugin", "tpu-telemetry-exporter"))
CP = ("tpu.ai/v1", "ClusterPolicy", "cluster-policy")


@pytest.fixture(autouse=True)
def default_images(monkeypatch):
    for env in ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE"):
        monkeypatch.setenv(env, "registry.example.com/gpu-validator:0.1.0")
    monkeypatch.setenv("DEVICE_PLUGIN_IMAGE", "registry.example.com/device-plugin:0.1.0")


@pytest.fixture(params=["direct", "cached"])
def cluster(request):
    """Every scenario runs twice: the operator reads straight from the
    apiserver, and through the informer cache (the production default)."""
    srv = MiniApiServer()
    base = srv.start()
    client = RestClient(base_url=base)
    kubelet = KubeletSimulator(client, interval=0.03).start()
    op_clients = []

    def make_op_client():
        op = RestClient(base_url=base)
        if request.param == "cached":
            op = CachedClient(op)
        op_clients.append(op)
        return op

    app = OperatorApp(make_op_client())
    state = {"srv": srv, "base": base, "client": client, "kubelet": kubelet,
             "app": app, "make_op_client": make_op_client}
    yield state
    state["app"].stop()
    for op in op_clients:  # the restart's clients too: no informer outlives its server
        op.stop()
    kubelet.stop()
    client.stop()
    state["srv"].stop()  # the outage swaps in a new server


def wait_for(predicate, timeout=45.0, interval=0.05, message="condition", explain=None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}"
                         + (f"\n{explain()}" if explain is not None else ""))


def policy_state(client):
    try:
        return deep_get(client.get(*CP), "status", "state")
    except NotFoundError:
        return None


def multihost_trail(client):
    """What a slice that never reached ready shows: the policy's status, each
    node's capacity and multihost stamp, the rendezvous pods, the DaemonSets."""
    lines = [f"policy status: {deep_get(client.get(*CP), 'status')}"]
    for node in client.list("v1", "Node"):
        lines.append(f"node {node['metadata']['name']}: capacity "
                     f"{deep_get(node, 'status', 'capacity')} stamp "
                     f"{deep_get(node, 'metadata', 'annotations', consts.MULTIHOST_VALIDATED_ANNOTATION)}")
    for pod in client.list("v1", "Pod", NS, label_selector={"app": MULTIHOST_APP}):
        lines.append(f"pod {pod['metadata']['name']}: {deep_get(pod, 'status', 'phase')} "
                     f"created {deep_get(pod, 'metadata', 'creationTimestamp')}")
    for ds in client.list("apps/v1", "DaemonSet", NS):
        lines.append(f"daemonset {ds['metadata']['name']}: {ds.get('status')}")
    return "\n".join(lines)


def gpu_node(name, labels=None):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": dict(labels or GPU_LABELS)}, "status": {}}


def ds_gone(client, name):
    try:
        client.get("apps/v1", "DaemonSet", name, NS)
        return False
    except NotFoundError:
        return True


def ds_available(client, name, n):
    try:
        ds = client.get("apps/v1", "DaemonSet", name, NS)
    except NotFoundError:
        return False
    return (ds.get("status") or {}).get("numberAvailable", 0) == n


def test_install_verify_update_restart_uninstall(cluster):
    client, app = cluster["client"], cluster["app"]

    for i in range(2):
        client.create(gpu_node(f"gpu-{i}"))
    client.create(new_cluster_policy())
    app.start()
    wait_for(lambda: policy_state(client) == "ready", message="install ready")

    for name in LANE_DAEMONSETS.values():
        ds = client.get("apps/v1", "DaemonSet", name, NS)
        assert ds["status"]["numberAvailable"] == 2, name

    # merge-patch: the operator writes the CR's status concurrently
    client.patch(*CP, {"spec": {"driver": {"repository": "registry.example.com",
                                           "image": "gpu-validator", "version": "0.2.0"}}})

    def driver_updated():
        ds = client.get("apps/v1", "DaemonSet", DRIVER, NS)
        image = ds["spec"]["template"]["spec"]["containers"][0]["image"]
        return image == "registry.example.com/gpu-validator:0.2.0"
    wait_for(driver_updated, message="driver image rollout")
    wait_for(lambda: policy_state(client) == "ready", message="ready after update")

    # a stateless restart resumes from the cluster's state
    app.stop()
    client.create(gpu_node("gpu-late"))
    cluster["app"] = app2 = OperatorApp(cluster["make_op_client"]())
    app2.start()
    wait_for(lambda: deep_get(client.get("v1", "Node", "gpu-late"), "status",
                              "capacity", consts.GPU_RESOURCE_NAME) == GPUS,
             message="late node schedulable after restart")
    wait_for(lambda: policy_state(client) == "ready", message="ready after restart")

    client.patch(*CP, {"spec": {"telemetry": {"enabled": False}}})
    wait_for(lambda: ds_gone(client, TELEMETRY), message="telemetry DS deleted")
    wait_for(lambda: consts.deploy_label("telemetry") not in
             (client.get("v1", "Node", "gpu-0")["metadata"].get("labels") or {}),
             message="telemetry deploy label removed")

    client.patch(*CP, {"spec": {"telemetry": {"enabled": True}}})
    wait_for(lambda: not ds_gone(client, TELEMETRY), message="telemetry DS recreated")

    # uninstall: the owner references collect every operand
    client.delete(*CP)
    wait_for(lambda: client.list("apps/v1", "DaemonSet", NS) == [],
             message="operand GC on uninstall")


def test_manual_operand_deletion_self_heals(cluster):
    client, app = cluster["client"], cluster["app"]
    client.create(gpu_node("gpu-0"))
    client.create(new_cluster_policy())
    app.start()
    wait_for(lambda: policy_state(client) == "ready", message="install ready")
    client.delete("apps/v1", "DaemonSet", PLUGIN, NS)
    wait_for(lambda: ds_available(client, PLUGIN, 1), message="device-plugin DS self-healed")
    wait_for(lambda: policy_state(client) == "ready", message="ready again")


def test_apiserver_outage_recovery(cluster):
    """The apiserver dies and comes back on the same endpoint, and the
    cluster changes while it is down (a node joins; an operand DaemonSet
    is deleted): watches reconnect, stale resume points relist, and the
    operator converges without a restart."""
    client, app = cluster["client"], cluster["app"]
    client.create(gpu_node("gpu-0"))
    client.create(new_cluster_policy())
    app.start()
    wait_for(lambda: policy_state(client) == "ready", message="install ready")

    port = int(cluster["base"].rsplit(":", 1)[1])
    backend = cluster["srv"].backend
    cluster["srv"].stop()
    time.sleep(0.5)  # the watches and the kubelet meet the dead endpoint
    backend.create(gpu_node("gpu-joined-in-outage"))
    backend.delete("apps/v1", "DaemonSet", PLUGIN, NS)

    srv2 = MiniApiServer(backend=backend)
    srv2.start(port)
    cluster["srv"] = srv2

    wait_for(lambda: deep_get(client.get("v1", "Node", "gpu-joined-in-outage"), "status",
                              "capacity", consts.GPU_RESOURCE_NAME) == GPUS,
             message="outage-joined node schedulable")
    wait_for(lambda: ds_available(client, PLUGIN, 2),
             message="DS deleted during outage recreated")
    wait_for(lambda: policy_state(client) == "ready", message="ready after outage")


def test_leader_failover_e2e(cluster):
    """Two replicas under Lease election; the leader crashes without
    releasing its lease, and the standby takes over after expiry and
    reconciles what changed in between."""
    client = cluster["client"]
    client.create(gpu_node("gpu-0"))
    client.create(new_cluster_policy())
    electors_clients = []

    def replica(ident):
        app = OperatorApp(cluster["make_op_client"]())
        lease_client = RestClient(base_url=cluster["base"])
        electors_clients.append(lease_client)
        elector = LeaderElector(lease_client, NS, identity=ident, lease_duration=6.0,
                                renew_period=1.5, retry_period=0.5)
        elector.run(on_started=app.start, on_stopped=app.stop)
        return app, elector

    app_a, elector_a = replica("replica-a")
    app_b, elector_b = replica("replica-b")
    try:
        wait_for(lambda: policy_state(client) == "ready", message="leader installed")
        leaders = [e for e in (elector_a, elector_b) if e.is_leader.is_set()]
        assert len(leaders) == 1, "exactly one replica must hold the lease"
        crashed = app_a if leaders[0] is elector_a else app_b
        survivor = elector_b if leaders[0] is elector_a else elector_a

        # a hard crash: the renewals stop, the lease is not released
        leaders[0]._stop.set()
        crashed.stop()
        client.patch(*CP, {"spec": {"telemetry": {"enabled": False}}})

        wait_for(survivor.is_leader.is_set, message="standby takes over")
        wait_for(lambda: ds_gone(client, TELEMETRY),
                 message="standby reconciled interregnum change")
        wait_for(lambda: policy_state(client) == "ready", message="ready under new leader")
    finally:
        elector_a.release()
        elector_b.release()
        app_a.stop()
        app_b.stop()
        for c in electors_clients:
            c.stop()


def test_multihost_slice_validation_e2e(cluster):
    """A four-node slice converges: operands up, rendezvous pods, every
    node stamped, ready."""
    client, app = cluster["client"], cluster["app"]
    for i in range(4):
        labels = dict(GPU_LABELS)
        labels[consts.TPU_SLICE_ID_LABEL] = "h100-32"
        client.create(gpu_node(f"vm-{i}", labels))
    client.create(new_cluster_policy())
    app.start()
    wait_for(lambda: policy_state(client) == "ready", message="slice validated + ready",
             explain=lambda: multihost_trail(client))
    for i in range(4):
        node = client.get("v1", "Node", f"vm-{i}")
        assert deep_get(node, "metadata", "annotations",
                        consts.MULTIHOST_VALIDATED_ANNOTATION), \
            f"vm-{i} not stamped\n{multihost_trail(client)}"
    assert client.list("v1", "Pod", NS, label_selector={"app": MULTIHOST_APP}) == []


def test_gpudriver_e2e_over_wire(cluster):
    """The per-pool driver CR over the wire. The reference's three nodes are
    one accelerator in two topologies (two pools); the port keys pools on
    the GPU model, so its three nodes are two H100 nodes and an H200 node,
    and the CR selects NFD's PCI label (every GPU node)."""
    client, app = cluster["client"], cluster["app"]
    for i, accelerator in enumerate(["tpu-v5-lite-podslice", "tpu-v5-lite-podslice",
                                     "tpu-v6e-slice"]):
        labels = {consts.NFD_NVIDIA_PCI_LABEL: "true",
                  **map_labels({"cloud.google.com/gke-tpu-accelerator": accelerator})}
        client.create(gpu_node(f"gpu-{i}", labels))
    client.create(new_cluster_policy())
    app.start()
    wait_for(lambda: policy_state(client) == "ready", message="base install")

    client.create({"apiVersion": "tpu.ai/v1alpha1", "kind": "GPUDriver",
                   "metadata": {"name": "main"},
                   "spec": {"repository": "registry.example.com", "image": "gpu-validator",
                            "version": "1.0",
                            "nodeSelector": {consts.NFD_NVIDIA_PCI_LABEL: "true"}}})

    def gpudriver_ready():
        try:
            live = client.get("tpu.ai/v1alpha1", "GPUDriver", "main")
        except NotFoundError:
            return False
        return deep_get(live, "status", "state") == "ready"
    wait_for(gpudriver_ready, message="GPUDriver ready")
    live = client.get("tpu.ai/v1alpha1", "GPUDriver", "main")
    assert live["status"]["pools"] == {"nvidia-h100-80gb": 2, "nvidia-h200-141gb": 1}
    # the ClusterPolicy's own driver DaemonSet is handed over and deleted in
    # its controller's next sweep
    wait_for(lambda: ds_gone(client, DRIVER), message="base driver DS handover cleanup")
    client.patch("tpu.ai/v1alpha1", "GPUDriver", live["metadata"]["name"],
                 {"spec": {"version": "2.0"}})

    def rolled():
        ds = client.get("apps/v1", "DaemonSet", "gpu-driver-main-nvidia-h100-80gb", NS)
        return ds["spec"]["template"]["spec"]["containers"][0]["image"].endswith(":2.0")
    wait_for(rolled, message="per-pool DS image roll")


def test_out_of_band_drift_healed_over_wire(cluster):
    """Drift written out of band to a rendered Service is healed within a
    resync sweep, though the stored hash still matches the operator's last
    write."""
    client, app = cluster["client"], cluster["app"]
    client.create(gpu_node("gpu-0"))
    client.create(new_cluster_policy())
    app.start()
    wait_for(lambda: policy_state(client) == "ready", message="install ready")

    svc = client.get("v1", "Service", TELEMETRY, NS)
    original_port = svc["spec"]["ports"][0]["port"]
    # asserted from the write's response: a re-read races the heal
    drifted = client.patch("v1", "Service", TELEMETRY,
                           {"spec": {"ports": [{"name": "metrics", "port": 19999,
                                                "targetPort": 19999}]}}, NS)
    assert drifted["spec"]["ports"][0]["port"] == 19999

    def healed():
        live = client.get("v1", "Service", TELEMETRY, NS)
        return live["spec"]["ports"][0]["port"] == original_port
    wait_for(healed, message="drifted Service port healed")


@pytest.mark.parametrize("package", ["port", "reference"])
def test_a_stopped_apiserver_cuts_its_kept_alive_connections(package):
    """A stopped apiserver answers nothing more, on a connection kept
    alive from before as on a new one. The reference's ``MiniApiServer``
    (tpu_operator/testing/apiserver.py) stops accepting but goes on serving
    the connections it holds, so its outage scenario never cut a kept-alive
    client off; the port's cuts every live connection and watch stream."""
    import http.client

    from tpu_operator.testing import MiniApiServer as RefServer

    srv = (MiniApiServer if package == "port" else RefServer)()
    port = int(srv.start().rsplit(":", 1)[1])
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request("GET", "/api/v1/nodes")
        first = conn.getresponse()
        first.read()
        assert first.status == 200
        srv.stop()
        try:
            conn.request("GET", "/api/v1/nodes")
            answered = conn.getresponse().status
        except (OSError, http.client.HTTPException):
            answered = None
        assert answered == (None if package == "port" else 200)
    finally:
        conn.close()
        srv.stop()
