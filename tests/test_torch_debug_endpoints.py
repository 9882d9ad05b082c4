"""The port's ``/debug`` routes on the operator's health port
(tpu_operator_torch/controllers/manager.py), over HTTP against the port's
MiniApiServer: the route set is the reference's but for the two the
mapping names (``DEBUG_ROUTES_LEFT_OUT``), ``debug_endpoints=False``
(``--no-debug-endpoints``) serves none of them while the probes stay,
``/debug/timeline`` filters the journal as the reference's does, and
``/debug/queue``, ``/debug/state``, ``/debug/traces`` and
``/debug/join-traces`` have the reference's shapes after one sweep.
"""

import json
import os
import time
import urllib.error
import urllib.request

import pytest

from test_torch_operator_mapping import DEBUG_ROUTES_LEFT_OUT
from tpu_operator.controllers.manager import DEBUG_ROUTES as REF_ROUTES
from tpu_operator_torch import tracing
from tpu_operator_torch.client import RestClient
from tpu_operator_torch.controllers.manager import DEBUG_ROUTES, OperatorApp
from tpu_operator_torch.testing.apiserver import MiniApiServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "tpu_operator_torch", "manifests", "samples", "v1_clusterpolicy.json")


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def get(port, path):
    """(status, body): JSON where the route answers JSON, else text."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            body = r.read().decode()
            code = r.status
            kind = r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, None
    return code, (json.loads(body) if kind.startswith("application/json") else body)


@pytest.fixture
def cluster():
    srv = MiniApiServer(watch_idle_timeout_s=1.0)
    base = srv.start()
    apps = []

    def app(**kwargs):
        a = OperatorApp(RestClient(base), health_port=_free_port(), **kwargs)
        apps.append(a)
        return a

    yield srv, base, app
    for a in apps:
        a.stop()
    srv.stop()


def test_the_route_set_is_the_reference_s_minus_the_left_out():
    assert set(DEBUG_ROUTES) == set(REF_ROUTES) - DEBUG_ROUTES_LEFT_OUT
    assert DEBUG_ROUTES_LEFT_OUT <= set(REF_ROUTES)


def test_every_route_answers(cluster):
    _, _, make = cluster
    app = make()
    app.start_servers()
    for route in DEBUG_ROUTES:
        code, _ = get(app._health_port, route)
        assert code == 200, route
    code, body = get(app._health_port, "/debug/threads")
    assert "MainThread" in body


def test_no_debug_endpoints_serves_none(cluster):
    _, _, make = cluster
    app = make(debug_endpoints=False)
    app.start_servers()
    for route in DEBUG_ROUTES:
        assert get(app._health_port, route)[0] == 404, route
    # the probes are not debug surface
    assert get(app._health_port, "/healthz")[0] == 200


def test_debug_timeline_serves_the_journal_with_filters(cluster):
    _, _, make = cluster
    app = make()
    app.start_servers()
    port = app._health_port
    app.journal.record_decision(
        "health", "drain-plan", "ep-t1", {"type": "verdict"}, node="node-a",
        decision={"node": "node-a"},
        actuations=[{"verb": "plan", "kind": "Node", "name": "node-a"}])
    app.journal.record_decision(
        "health", "health-recover", "ep-t1", {"type": "verdict"}, node="node-a",
        outcome="recovered")
    app.journal.record_decision("health", "drain-plan", "ep-t2", {"type": "verdict"},
                                node="node-b")
    _, body = get(port, "/debug/timeline")
    assert body["count"] == 3 and {"stats", "episodes", "records"} <= set(body)
    assert body["records"][0]["episode"] == "ep-t2"  # newest first
    assert body["stats"]["open_episodes"] == 1
    _, by_node = get(port, "/debug/timeline?node=node-a")
    assert by_node["count"] == 2 and {r["episode"] for r in by_node["records"]} == {"ep-t1"}
    _, by_episode = get(port, "/debug/timeline?episode=ep-t2")
    assert by_episode["count"] == 1 and by_episode["records"][0]["node"] == "node-b"
    assert get(port, "/debug/timeline?limit=1")[1]["count"] == 1
    assert get(port, "/debug/timeline?limit=x")[1]["count"] == 3  # a bad limit: the default


def test_queue_state_traces_and_join_traces_after_a_sweep(cluster):
    srv, base, make = cluster
    seed = RestClient(base)
    seed.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "gpu-node", "labels": {"feature.node.kubernetes.io/pci-10de.present": "true"}}})
    with open(SAMPLE) as f:
        seed.create(json.load(f))
    app = make(trace_buffer_size=16)
    app.start()
    port = app._health_port
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        # the upgrade controller's sweeps are traced too: wait for the
        # ClusterPolicy's own
        if app.recorder.traces(controller="clusterpolicy", limit=1):
            break
        time.sleep(0.1)
    _, queues = get(port, "/debug/queue")
    assert {q["controller"] for q in queues} == {"clusterpolicy", "gpudriver", "upgrade"}
    for q in queues:
        assert {"depth_ready", "delayed", "pending", "backoff", "inflight",
                "worker_alive"} <= set(q)
    policy_queue = next(q for q in queues if q["controller"] == "clusterpolicy")
    assert {"node_health", "slice_states", "serving_failing"} <= set(policy_queue)
    _, state = get(port, "/debug/state")
    assert {"ready", "readiness", "informers", "controllers", "flight_recorder",
            "join_profiler", "journal"} <= set(state)
    assert state["flight_recorder"]["capacity"] == 16
    assert state["flight_recorder"]["error_capacity"] == 4
    _, traces = get(port, "/debug/traces?controller=clusterpolicy&limit=1")
    assert traces["count"] == 1
    root = traces["traces"][0]
    assert root["kind"] == "reconcile" and root["attributes"]["controller"] == "clusterpolicy"
    phases = {c["name"] for c in root["children"] if c["kind"] == "phase"}
    assert {"label-nodes", "sync-state"} <= phases
    _, one = get(port, f"/debug/traces?trace_id={root['trace_id']}")
    assert one["count"] == 1 and one["traces"][0]["trace_id"] == root["trace_id"]
    assert "dropped_spans_total" in traces["stats"]
    _, joins = get(port, "/debug/join-traces?node=gpu-node")
    assert {"stats", "reconcile_latency", "count", "traces"} <= set(joins)
    assert joins["count"] == 1 and joins["traces"][0]["node"] == "gpu-node"
    assert joins["traces"][0]["traceparent"] == tracing.join_traceparent(
        seed.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy"))
    text = app.metrics.scrape().decode()
    assert 'tpu_operator_reconcile_phase_seconds_count{controller="clusterpolicy",' \
           'phase="sync-state"}' in text
