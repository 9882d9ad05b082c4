"""The twin of tests/test_chaos_convergence.py: install and a full rolling
driver upgrade converge under 30% API faults, on the port's stack and on
the reference's, one after the other, with the same seed.

The stack is the reference's: ``RetryingClient(ChaosClient(FakeClient))``
(error rate 0.3, Retry-After 0.02 s, ``CHAOS_SEED`` 1729; 12 attempts,
0.02-0.25 s back-off, 30 s deadline; a token bucket of qps 0, burst 1; a
breaker at 10 failures, 0.3 s cool-down) under the ClusterPolicy, per-pool
driver and upgrade controllers at a 0.1 s requeue, with the kubelet
simulator on the fake. Both packages must end with no reconcile error,
``tpu_operator_api_retries_total`` counted and the breaker gauge exported.
The port's runs use its names (tests/test_torch_operator_mapping.py): GPU
nodes, a ``GPUDriver``, the ``gpu-driver`` pods.

The injected faults are compared draw for draw: each run counts the calls
its chaos layer saw, and the other package's policy, fresh on the same
seed, given as many calls, must inject the same faults of the same kinds.

The reference marks this file ``slow``; the twin does not: each case takes
seconds on the CPU, so it runs in tier-1 and guards the port.
"""

import os
import time
import types

import pytest

import tpu_operator.api.tpudriver as ref_tpudriver
import tpu_operator.client as ref_client
import tpu_operator.client.chaos as ref_chaos
import tpu_operator.client.resilience as ref_resilience
import tpu_operator.controllers.clusterpolicy_controller as ref_cp
import tpu_operator.controllers.metrics as ref_metrics
import tpu_operator.controllers.runtime as ref_runtime
import tpu_operator.controllers.tpudriver_controller as ref_td
import tpu_operator.controllers.upgrade_controller as ref_up
import tpu_operator.testing.kubelet as ref_kubelet
import tpu_operator.upgrade as ref_upgrade
import tpu_operator.upgrade.machine as ref_machine
from test_torch_operator_mapping import map_labels
from tpu_operator import consts as ref_consts
from tpu_operator.api.clusterpolicy import new_cluster_policy as ref_new_cp
from tpu_operator_torch import consts
from tpu_operator_torch import upgrade as port_upgrade
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.api.gpudriver import GPU_DRIVER_API_VERSION, GPU_DRIVER_KIND
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.client import chaos as port_chaos
from tpu_operator_torch.client import resilience as port_resilience
from tpu_operator_torch.controllers import clusterpolicy_controller as port_cp
from tpu_operator_torch.controllers import gpudriver_controller as port_gd
from tpu_operator_torch.controllers import metrics as port_metrics
from tpu_operator_torch.controllers import upgrade_controller as port_up
from tpu_operator_torch.controllers.runtime import Request
from tpu_operator_torch.testing import kubelet as port_kubelet
from tpu_operator_torch.upgrade import machine as port_machine
from tpu_operator_torch.utils import deep_get

NS = "tpu-operator"
SEED = int(os.environ.get("CHAOS_SEED", "1729"))
REF_TPU_LABELS = {ref_consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
                  ref_consts.GKE_TPU_TOPOLOGY_LABEL: "2x4"}
GPU_LABELS = {consts.NFD_NVIDIA_PCI_LABEL: "true", **map_labels(REF_TPU_LABELS)}


def _new_gpu_driver(name, spec):
    return {"apiVersion": GPU_DRIVER_API_VERSION, "kind": GPU_DRIVER_KIND,
            "metadata": {"name": name}, "spec": spec}


REF = types.SimpleNamespace(
    name="reference", Fake=ref_client.FakeClient, chaos=ref_chaos, resilience=ref_resilience,
    Metrics=ref_metrics.OperatorMetrics, Request=ref_runtime.Request,
    cp=(ref_cp.setup_clusterpolicy_controller, ref_cp.ClusterPolicyReconciler),
    driver=(ref_td.setup_tpudriver_controller, ref_td.TPUDriverReconciler),
    up=(ref_up.setup_upgrade_controller, ref_up.UpgradeReconciler),
    kubelet=lambda raw: ref_kubelet.KubeletSimulator(raw, interval=0.03, create_pods=True),
    labels=REF_TPU_LABELS, resource=ref_consts.TPU_RESOURCE_NAME, new_cp=ref_new_cp,
    new_driver=ref_tpudriver.new_tpu_driver, driver_kind=("tpu.ai/v1alpha1", "TPUDriver"),
    repository="gcr.io/tpu", image="tpu-validator", pool_image="libtpu",
    driver_component="tpu-driver", node_state=ref_upgrade.node_upgrade_state,
    settled=(ref_machine.UNKNOWN, ref_machine.DONE), node="tpu")
PORT = types.SimpleNamespace(
    name="port", Fake=FakeClient, chaos=port_chaos, resilience=port_resilience,
    Metrics=port_metrics.OperatorMetrics, Request=Request,
    cp=(port_cp.setup_clusterpolicy_controller, port_cp.ClusterPolicyReconciler),
    driver=(port_gd.setup_gpudriver_controller, port_gd.GPUDriverReconciler),
    up=(port_up.setup_upgrade_controller, port_up.UpgradeReconciler),
    kubelet=lambda raw: port_kubelet.KubeletSimulator(raw, interval=0.03),
    labels=GPU_LABELS, resource=consts.GPU_RESOURCE_NAME, new_cp=new_cluster_policy,
    new_driver=_new_gpu_driver, driver_kind=(GPU_DRIVER_API_VERSION, GPU_DRIVER_KIND),
    repository="registry.example.com", image="gpu-validator", pool_image="gpu-driver",
    driver_component="gpu-driver", node_state=port_upgrade.node_upgrade_state,
    settled=(port_machine.UNKNOWN, port_machine.DONE), node="gpu")
PACKAGES = {"reference": REF, "port": PORT}


@pytest.fixture(autouse=True)
def default_images(monkeypatch):
    for env in ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE"):
        monkeypatch.setenv(env, "registry.example.com/gpu-validator:0.1.0")
    monkeypatch.setenv("DEVICE_PLUGIN_IMAGE", "registry.example.com/device-plugin:0.1.0")


def wait_for(predicate, timeout=60.0, interval=0.05, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


def _policy(pkg, error_rate=0.3):
    return pkg.chaos.ChaosPolicy(error_rate=error_rate, retry_after_s=0.02, seed=SEED)


def chaotic_stack(pkg, raw, error_rate=0.3):
    """The reference's production wrapper order, the chaos layer standing in
    for a flaky wire; every chaos draw is counted."""
    r = pkg.resilience
    chaos = _policy(pkg, error_rate)
    calls = [0]
    draw = chaos.maybe_fail

    def counted(verb):
        calls[0] += 1
        return draw(verb)

    chaos.maybe_fail = counted
    client = r.RetryingClient(
        pkg.chaos.ChaosClient(raw, chaos),
        policy=r.RetryPolicy(max_attempts=12, base_backoff_s=0.02, max_backoff_s=0.25,
                             deadline_s=30.0),
        limiter=r.TokenBucket(qps=0, burst=1),
        breaker=r.CircuitBreaker(threshold=10, cooldown_s=0.3))
    return client, chaos, calls


def start_controllers(pkg, client, metrics):
    setup, reconciler = pkg.cp
    cp = setup(client, reconciler(client, metrics=metrics, requeue_after=0.1))
    setup, reconciler = pkg.driver
    td = setup(client, reconciler(client, requeue_after=0.1))
    setup, reconciler = pkg.up
    up = setup(client, reconciler(client, metrics=metrics, requeue_after=0.1))
    controllers = (cp, td, up)
    for c in controllers:
        c.instrument(metrics)
        c.start(client)
    cp.queue.add(pkg.Request(name="cluster-policy"))
    return controllers


def assert_zero_unhandled_errors(metrics, chaos):
    scrape = metrics.scrape().decode()
    assert chaos.injected_total() > 0, "chaos never fired: the run proves nothing"
    assert "tpu_operator_reconcile_errors_total{" not in scrape
    assert "tpu_operator_reconciliation_failed_total 0.0" in scrape
    assert "tpu_operator_api_retries_total{" in scrape
    assert "tpu_operator_api_breaker_state" in scrape


def node(pkg, name, extra=None):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": {**pkg.labels, **(extra or {})}},
            "spec": {}, "status": {}}


def cp_ready(pkg, raw):
    return deep_get(raw.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy"),
                    "status", "state") == "ready"


def install(pkg):
    raw = pkg.Fake()
    client, chaos, calls = chaotic_stack(pkg, raw)
    metrics = pkg.Metrics()
    metrics.wire_resilience(client)
    for i in range(4):
        raw.create(node(pkg, f"{pkg.node}-{i}"))
    raw.create(node(pkg, f"{pkg.node}-pool-0", {"pool": "a"}))
    raw.create(pkg.new_cp(spec={"driver": {"repository": pkg.repository,
                                           "image": pkg.image, "version": "1.0"}}))
    raw.create(pkg.new_driver("pool-a", {"image": pkg.pool_image,
                                         "repository": pkg.repository, "version": "1.0",
                                         "nodeSelector": {"pool": "a"}}))
    controllers = start_controllers(pkg, client, metrics)
    kubelet = pkg.kubelet(raw).start()
    try:
        wait_for(lambda: cp_ready(pkg, raw), timeout=90,
                 message="ClusterPolicy ready under chaos")
        wait_for(lambda: deep_get(raw.get(*pkg.driver_kind, "pool-a"), "status",
                                  "state") == "ready",
                 timeout=90, message="driver pool ready under chaos")
        wait_for(lambda: all(deep_get(n, "status", "capacity", pkg.resource)
                             for n in raw.list("v1", "Node")),
                 timeout=90, message="every node advertising its accelerators")
    finally:
        for c in controllers:
            c.stop()
        kubelet.stop()
    assert_zero_unhandled_errors(metrics, chaos)
    return chaos, calls[0]


def rolling_upgrade(pkg):
    raw = pkg.Fake()
    client, chaos, calls = chaotic_stack(pkg, raw)
    metrics = pkg.Metrics()
    metrics.wire_resilience(client)
    for i in range(3):
        raw.create(node(pkg, f"{pkg.node}-{i}"))
    raw.create(pkg.new_cp(spec={"driver": {
        "repository": pkg.repository, "image": pkg.image, "version": "1.0",
        "upgradePolicy": {"autoUpgrade": True, "maxParallelUpgrades": 2}}}))
    controllers = start_controllers(pkg, client, metrics)
    kubelet = pkg.kubelet(raw).start()
    new_image = f"{pkg.repository}/{pkg.image}:2.0"
    try:
        wait_for(lambda: cp_ready(pkg, raw), timeout=90, message="initial install under chaos")
        live = raw.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        live["spec"]["driver"]["version"] = "2.0"
        raw.update(live)

        def rolled():
            images = {deep_get(p, "spec", "nodeName"): p["spec"]["containers"][0]["image"]
                      for p in raw.list("v1", "Pod", NS, label_selector={
                          "app.kubernetes.io/component": pkg.driver_component})}
            return len(images) == 3 and set(images.values()) == {new_image}

        wait_for(rolled, timeout=120, message="all driver pods rolled to 2.0 under chaos")
        wait_for(lambda: all(pkg.node_state(n) in pkg.settled
                             and not n["spec"].get("unschedulable")
                             for n in raw.list("v1", "Node")),
                 timeout=120, message="labels settled, nodes uncordoned")
    finally:
        for c in controllers:
            c.stop()
        kubelet.stop()
    assert_zero_unhandled_errors(metrics, chaos)
    return chaos, calls[0]


SCENARIOS = {"install": install, "rolling_upgrade": rolling_upgrade}


def _replay(pkg, calls):
    """A fresh policy of ``pkg`` on the same seed, given ``calls`` calls:
    the faults it injects, by kind."""
    policy = _policy(pkg)
    for _ in range(calls):
        try:
            policy.maybe_fail("GET")
        except Exception:  # every injected kind; only the counts matter here
            pass
    return dict(policy.injected)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_converges_under_30pct_chaos_on_both_packages(scenario):
    record = {}
    for name in ("port", "reference"):
        t0 = time.monotonic()
        chaos, calls = SCENARIOS[scenario](PACKAGES[name])
        record[name] = {"calls": calls, "injected": dict(chaos.injected),
                        "injected_total": chaos.injected_total(),
                        "s": round(time.monotonic() - t0, 3)}
    print(f"\n{scenario} under 30% chaos, seed {SEED}: {record}")
    # draw for draw: each run's faults are what the other package's policy
    # injects for as many calls on the same seed
    for name, other in (("port", "reference"), ("reference", "port")):
        assert _replay(PACKAGES[other], record[name]["calls"]) == record[name]["injected"]
    for name in ("port", "reference"):
        rate = record[name]["injected_total"] / record[name]["calls"]
        assert 0.2 < rate < 0.4, (name, rate)
