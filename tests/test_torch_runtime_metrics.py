"""The twin of tests/test_runtime_metrics.py: the reference's seven cases
against the port's work-queue, reconcile and REST-traffic families
(``tpu_operator_torch/controllers/metrics.py``), its ``/metrics``,
``/healthz`` and ``/debug/informers`` over HTTP, a standby replica's
probes and the informer's ``stats()`` rows.

The port writes its families under the reference's names (no renames:
tests/test_torch_operator_reconcile.py holds the whole scrape to
prometheus_client's); each sample here is read from the port's own text
scrape. The deterministic scenario, one request that fails once and is
retried, runs on both packages and the two scrapes' work-queue and
reconcile counts must be equal.

The port's ``Controller.wait_idle`` also waits out the request in flight;
the reference's returns while the request it last handed out is still
reconciling (a case below shows both).
"""

import json
import socket
import time
import types
import urllib.request

import pytest

import tpu_operator.client.fake as ref_fake
import tpu_operator.controllers.metrics as ref_metrics
import tpu_operator.controllers.runtime as ref_runtime
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.client import RestClient
from tpu_operator_torch.client.cache import CachedClient
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.controllers import metrics as port_metrics
from tpu_operator_torch.controllers import runtime as port_runtime
from tpu_operator_torch.controllers.manager import OperatorApp
from tpu_operator_torch.controllers.metrics import OperatorMetrics
from tpu_operator_torch.controllers.runtime import Controller, RateLimitingQueue, Request
from tpu_operator_torch.testing.apiserver import MiniApiServer

REF = types.SimpleNamespace(runtime=ref_runtime, Metrics=ref_metrics.OperatorMetrics,
                            Fake=ref_fake.FakeClient)
PORT = types.SimpleNamespace(runtime=port_runtime, Metrics=port_metrics.OperatorMetrics,
                             Fake=FakeClient)
#: the families the failing-once scenario writes, compared across packages
QUEUE_SAMPLES = ("tpu_operator_workqueue_adds_total", "tpu_operator_workqueue_retries_total",
                 "tpu_operator_reconcile_errors_total",
                 "tpu_operator_reconcile_duration_seconds_count",
                 "tpu_operator_workqueue_queue_duration_seconds_count",
                 "tpu_operator_workqueue_depth")


def _scrape(metrics) -> dict:
    out = {}
    for line in metrics.scrape().decode().splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def _sample(metrics, metric, **labels):
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return _scrape(metrics).get(f"{metric}{{{inner}}}" if inner else metric, 0.0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read()


@pytest.fixture
def images(monkeypatch):
    for env in ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE", "DEVICE_PLUGIN_IMAGE"):
        monkeypatch.setenv(env, "registry.example.com/x:0.1.0")


def _recon(pkg, fail_times=0, hold_s=0.0):
    class Recon(pkg.runtime.Reconciler):
        name = "test-recon"

        def __init__(self):
            self.fail_times = fail_times
            self.calls = 0

        def reconcile(self, request):
            self.calls += 1
            time.sleep(hold_s)
            if self.fail_times > 0:
                self.fail_times -= 1
                raise RuntimeError("boom")
            return pkg.runtime.Result()

    return Recon()


def _fail_once_and_retry(pkg):
    metrics = pkg.Metrics()
    recon = _recon(pkg, fail_times=1)
    controller = pkg.runtime.Controller(recon)
    controller.instrument(metrics)
    controller.start(pkg.Fake())
    try:
        controller.queue.add(pkg.runtime.Request(name="a"))
        deadline = time.monotonic() + 10
        while recon.calls < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert recon.calls >= 2
        assert controller.wait_idle()
        controller.queue.add(pkg.runtime.Request(name="later"), delay=60.0)
        return metrics
    finally:
        controller.stop()


def test_workqueue_and_reconcile_metrics():
    metrics = OperatorMetrics()
    recon = _recon(PORT, fail_times=1)
    controller = Controller(recon)
    controller.instrument(metrics)
    controller.start(FakeClient())
    try:
        controller.queue.add(Request(name="a"))
        deadline = time.monotonic() + 10
        while recon.calls < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert recon.calls >= 2  # failed once, retried, succeeded
        assert controller.wait_idle()  # the second reconcile observed too
        assert _sample(metrics, "tpu_operator_workqueue_adds_total", name="test-recon") >= 2.0
        assert _sample(metrics, "tpu_operator_workqueue_retries_total", name="test-recon") == 1.0
        assert _sample(metrics, "tpu_operator_reconcile_errors_total", name="test-recon") == 1.0
        assert _sample(metrics, "tpu_operator_reconcile_duration_seconds_count",
                       name="test-recon") >= 2.0
        assert _sample(metrics, "tpu_operator_workqueue_queue_duration_seconds_count",
                       name="test-recon") >= 2.0
        assert controller.wait_idle()
        assert _sample(metrics, "tpu_operator_workqueue_depth", name="test-recon") == 0.0
        # an item sleeping out a requeue delay is scheduling, not backlog
        controller.queue.add(Request(name="later"), delay=60.0)
        assert _sample(metrics, "tpu_operator_workqueue_depth", name="test-recon") == 0.0
    finally:
        controller.stop()


def test_both_packages_count_the_failing_once_scenario_alike():
    scrapes = {}
    for name, pkg in (("port", PORT), ("reference", REF)):
        text = _scrape(_fail_once_and_retry(pkg))
        scrapes[name] = {k: v for k, v in text.items()
                         if k.split("{")[0] in QUEUE_SAMPLES}
    assert scrapes["port"] == scrapes["reference"]
    assert scrapes["port"]['tpu_operator_workqueue_adds_total{name="test-recon"}'] == 3.0


def test_queue_duration_excludes_deliberate_delay():
    metrics = OperatorMetrics()
    recon = _recon(PORT)
    controller = Controller(recon)
    controller.instrument(metrics)
    controller.start(FakeClient())
    try:
        controller.queue.add(Request(name="a"), delay=2.0)
        deadline = time.monotonic() + 15
        while recon.calls < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert recon.calls == 1
        total = _sample(metrics, "tpu_operator_workqueue_queue_duration_seconds_sum",
                        name="test-recon")
        assert total < 1.0, f"delay leaked into queue duration: {total}"
    finally:
        controller.stop()


def test_rest_client_request_metrics_over_the_wire():
    srv = MiniApiServer()
    base = srv.start()
    client = RestClient(base_url=base)
    try:
        metrics = OperatorMetrics()
        client.on_response = metrics.observe_rest_response
        client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n1"},
                       "status": {}})
        client.get("v1", "Node", "n1")
        client.list("v1", "Node")
        try:
            client.get("v1", "Node", "missing")
        except Exception:  # the 404 is what is counted
            pass
        family = "tpu_operator_rest_client_requests_total"
        assert _sample(metrics, family, method="POST", code="201") == 1.0
        assert _sample(metrics, family, method="GET", code="200") >= 2.0
        assert _sample(metrics, family, method="GET", code="404") == 1.0
        handle = client.watch("v1", "Node", handler=lambda e: None)
        deadline = time.monotonic() + 5
        while (_sample(metrics, family, method="WATCH", code="200") < 1.0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        handle.stop()
        assert _sample(metrics, family, method="WATCH", code="200") >= 1.0
    finally:
        client.stop()
        srv.stop()


def test_health_server_serves_metrics_and_informer_debug(images):
    srv = MiniApiServer()
    base = srv.start()
    seed = RestClient(base_url=base)
    seed.create(new_cluster_policy())
    cached = CachedClient(RestClient(base_url=base))
    mport, hport = _free_port(), _free_port()
    app = OperatorApp(cached, metrics_port=mport, health_port=hport)
    app.start()
    try:
        deadline = time.monotonic() + 10
        scraped = b""
        while time.monotonic() < deadline:
            scraped = _get(f"http://127.0.0.1:{mport}/metrics")[1]
            if b"tpu_operator_workqueue_adds_total" in scraped:
                break
            time.sleep(0.1)
        assert b"tpu_operator_workqueue_adds_total" in scraped
        assert b"tpu_operator_rest_client_requests_total" in scraped
        assert json.loads(_get(f"http://127.0.0.1:{hport}/healthz")[1])["status"] == "ok"
        informers = json.loads(_get(f"http://127.0.0.1:{hport}/debug/informers")[1])
        assert any(row["kind"] == "ClusterPolicy" and row["synced"] for row in informers)
    finally:
        app.stop()
        cached.stop()
        seed.stop()
        srv.stop()


def test_standby_replica_serves_probes_without_reconciling(images):
    srv = MiniApiServer()
    base = srv.start()
    hport = _free_port()
    client = RestClient(base_url=base)
    app = OperatorApp(client, health_port=hport)
    app.start_servers()  # a standby: no controllers
    try:
        assert _get(f"http://127.0.0.1:{hport}/healthz")[0] == 200
        assert all(c._thread is None for c in app.manager.controllers)
        # idempotent across the leadership transition
        app.start_servers()
        app.start_controllers()
        assert all(c._thread is not None for c in app.manager.controllers)
    finally:
        app.stop()
        client.stop()
        srv.stop()


def test_cached_client_stats_shape():
    backend = FakeClient()
    backend.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n1"},
                    "status": {}})
    cached = CachedClient(backend)
    try:
        cached.get("v1", "Node", "n1")
        rows = cached.stats()
        assert len(rows) == 1
        row = rows[0]
        assert row["kind"] == "Node" and row["synced"] and row["objects"] == 1
        assert row["scope"] == "all-namespaces" and row["subscribers"] == 0
        assert row["degraded"] is False
    finally:
        cached.stop()


def test_due_requeue_visible_at_scrape_without_queue_mutation():
    metrics = OperatorMetrics()
    queue = RateLimitingQueue()
    queue.instrument(metrics, "idle-recon")
    queue.add(Request(name="r"), delay=0.05)
    assert _sample(metrics, "tpu_operator_workqueue_depth", name="idle-recon") == 0.0
    time.sleep(0.15)
    # no queue mutation since the add: the scrape alone sees it due
    assert _sample(metrics, "tpu_operator_workqueue_depth", name="idle-recon") == 1.0


@pytest.mark.parametrize("name", ["port", "reference"])
def test_wait_idle_and_the_request_in_flight(name):
    """One request whose reconcile takes 0.5 s: the port's ``wait_idle``
    returns after it finishes; the reference's returns as soon as the queue
    is empty, with the request still reconciling."""
    pkg = {"port": PORT, "reference": REF}[name]
    recon = _recon(pkg, hold_s=0.5)
    controller = pkg.runtime.Controller(recon)
    controller.start(pkg.Fake())
    try:
        controller.queue.add(pkg.runtime.Request(name="a"))
        deadline = time.monotonic() + 10
        while recon.calls < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert controller.wait_idle()
        still_reconciling = controller._inflight is not None
        assert still_reconciling is (name == "reference")
    finally:
        controller.stop()
