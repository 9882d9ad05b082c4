"""The twin of tests/test_scale_envelope.py: 300 nodes join through the
informer-backed stack, then 30 rounds of label churn on single nodes, on
the port's stack and on the reference's, one after the other.

The bounds are the reference's: every node advertises its accelerators and
the ClusterPolicy is ``ready`` within 120 s; the whole churn (30 edits and
the sweeps they trigger) costs fewer counted apiserver calls than one relist
of the pool (``N_NODES``); the node informer holds all 300 nodes, and the
informer stores hold under 32 MiB of JSON. The port's nodes are GPU nodes
(NFD's PCI label and GKE's mapped accelerator label). The two packages'
call deltas and store bytes are printed side by side; they are CPU
figures of this harness, not the card's.

The reference marks this file ``slow``; the twin does not: a package's
run takes about ten seconds on the CPU, so it runs in tier-1 and guards
the port.
"""

import json
import threading
import time
import types

import pytest

import tpu_operator.api.clusterpolicy as ref_api
import tpu_operator.client as ref_client
import tpu_operator.client.cache as ref_cache
import tpu_operator.controllers.clusterpolicy_controller as ref_cp
import tpu_operator.controllers.runtime as ref_runtime
import tpu_operator.testing.kubelet as ref_kubelet
from test_torch_operator_mapping import map_labels
from tpu_operator import consts as ref_consts
from tpu_operator_torch import consts
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.client.cache import CachedClient
from tpu_operator_torch.controllers import clusterpolicy_controller as port_cp
from tpu_operator_torch.controllers.runtime import Request
from tpu_operator_torch.testing.kubelet import KubeletSimulator
from tpu_operator_torch.utils import deep_get

N_NODES = 300
ROUNDS = 30
STORE_LIMIT = 32 * 1024 * 1024
REF_TPU_LABELS = {ref_consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice"}

REF = types.SimpleNamespace(
    name="reference", Fake=ref_client.FakeClient, Cached=ref_cache.CachedClient,
    setup=ref_cp.setup_clusterpolicy_controller, Reconciler=ref_cp.ClusterPolicyReconciler,
    Request=ref_runtime.Request,
    kubelet=lambda raw: ref_kubelet.KubeletSimulator(raw, interval=0.03, create_pods=True),
    new_cp=ref_api.new_cluster_policy, labels=REF_TPU_LABELS,
    resource=ref_consts.TPU_RESOURCE_NAME, repository="gcr.io/tpu", image="tpu-validator",
    node="tpu")
PORT = types.SimpleNamespace(
    name="port", Fake=FakeClient, Cached=CachedClient,
    setup=port_cp.setup_clusterpolicy_controller, Reconciler=port_cp.ClusterPolicyReconciler,
    Request=Request, kubelet=lambda raw: KubeletSimulator(raw, interval=0.03),
    new_cp=new_cluster_policy,
    labels={consts.NFD_NVIDIA_PCI_LABEL: "true", **map_labels(REF_TPU_LABELS)},
    resource=consts.GPU_RESOURCE_NAME, repository="registry.example.com",
    image="gpu-validator", node="gpu")


@pytest.fixture(autouse=True)
def default_images(monkeypatch):
    for env in ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE"):
        monkeypatch.setenv(env, "registry.example.com/gpu-validator:0.1.0")
    monkeypatch.setenv("DEVICE_PLUGIN_IMAGE", "registry.example.com/device-plugin:0.1.0")


class CountingClient:
    """Counts apiserver round trips (an HTTP request's stand-in in the
    in-process harness). Watches are streams, not counted."""

    COUNTED = ("get", "list", "create", "update", "patch", "delete", "update_status", "evict")

    def __init__(self, inner):
        self._inner = inner
        self._lock = threading.Lock()
        self.calls = 0

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in self.COUNTED:
            def counted(*args, **kwargs):
                with self._lock:
                    self.calls += 1
                return attr(*args, **kwargs)
            return counted
        return attr


def wait_for(predicate, timeout, message):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {message}")


def join_and_churn(pkg) -> dict:
    """The reference's scenario on ``pkg``; its figures."""
    backend = pkg.Fake()
    counting = CountingClient(backend)
    cached = pkg.Cached(counting)
    backend.create(pkg.new_cp(spec={"driver": {"repository": pkg.repository,
                                               "image": pkg.image, "version": "1.0"}}))
    cp = pkg.setup(cached, pkg.Reconciler(cached, requeue_after=0.1))
    # the kubelet's traffic stays out of the operator's request count
    kubelet = pkg.kubelet(backend).start()
    cp.start(cached)
    cp.queue.add(pkg.Request(name="cluster-policy"))
    t0 = time.monotonic()
    try:
        for i in range(N_NODES):
            backend.create({"apiVersion": "v1", "kind": "Node",
                            "metadata": {"name": f"{pkg.node}-{i}", "labels": dict(pkg.labels)},
                            "spec": {}, "status": {}})
        wait_for(lambda: sum(1 for n in backend.list("v1", "Node")
                             if deep_get(n, "status", "capacity", pkg.resource)) == N_NODES,
                 timeout=120, message=f"{N_NODES} nodes advertising their accelerators")

        def ready():
            policy = backend.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
            return deep_get(policy, "status", "state") == "ready"

        wait_for(ready, 120, f"ClusterPolicy ready at {N_NODES} nodes")
        join_s = time.monotonic() - t0
        wait_for(ready, 30, "steady state")
        time.sleep(0.5)  # in-flight sweeps drain before the snapshot
        before = counting.calls
        for i in range(ROUNDS):
            backend.patch("v1", "Node", f"{pkg.node}-{i}",
                          {"metadata": {"labels": {"churn": f"gen-{i}"}}})
            time.sleep(0.05)
        wait_for(ready, 30, "ready after churn")
        time.sleep(1.0)  # every triggered sweep finishes
        delta = counting.calls - before

        node_informers = [s for s in cached.stats() if s["kind"] == "Node"]
        store_bytes = 0
        for informer in list(cached._informers.values()):
            with informer._lock:  # the kubelet's and the controller's threads still write
                objs = list(informer._store.values())
            store_bytes += sum(len(json.dumps(obj)) for obj in objs)
    finally:
        cp.stop()
        kubelet.stop()
        cached.stop()
    return {"join_s": round(join_s, 3), "churn_calls": delta,
            "node_objects": node_informers[0]["objects"] if node_informers else None,
            "store_bytes": store_bytes}


def test_scale_300_node_join_and_churn_soak_on_both_packages():
    figures = {pkg.name: join_and_churn(pkg) for pkg in (PORT, REF)}
    print(f"\n{N_NODES} nodes, {ROUNDS} churn rounds (CPU, this harness):")
    for key in ("join_s", "churn_calls", "node_objects", "store_bytes"):
        print(f"  {key:13s} port {figures['port'][key]!s:>10}  "
              f"reference {figures['reference'][key]!s:>10}")
    for name, fig in figures.items():
        assert fig["churn_calls"] < N_NODES, (
            f"{name}: the churn cost {fig['churn_calls']} apiserver calls, more than one "
            f"relist of {N_NODES} nodes: steady state is not O(events)")
        assert fig["node_objects"] == N_NODES, name
        assert fig["store_bytes"] < STORE_LIMIT, (
            f"{name}: the informer stores hold {fig['store_bytes']} bytes for {N_NODES} nodes")
