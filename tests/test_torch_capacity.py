"""The port's measured serving frontier and capacity collector
(tpu_operator_torch/serving/frontier.py, tpu_operator_torch/capacity/)
against the reference's: the twins of the 22 tests of tests/test_capacity.py.

Every case runs on both packages with the same curves, nodes and clock and
returns what it computed; the reference's side is mapped into the port's
names through tests/test_torch_operator_mapping.py (a TPU node is the same
node with GPUs, its pool named after the GPU model) and the two must be
equal, and equal what the reference's test asserts.
"""

import json
import types

from test_torch_operator_mapping import (AUTOSCALE_DEFAULT_PER_NODE, map_node, map_pool_name,
                                         map_registered_name)
from tpu_operator import consts as ref_consts
from tpu_operator.api import clusterpolicy as ref_api
from tpu_operator.autoscale import controller as ref_autoscale
from tpu_operator.autoscale import engine as ref_engine
from tpu_operator.capacity import collector as ref_collector
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.controllers.runtime import Request as RefRequest
from tpu_operator.serving import frontier as ref_frontier
from tpu_operator_torch import consts
from tpu_operator_torch.api import clusterpolicy as api
from tpu_operator_torch.autoscale import controller as autoscale
from tpu_operator_torch.autoscale import engine
from tpu_operator_torch.capacity import collector
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.controllers.runtime import Request
from tpu_operator_torch.serving import frontier

NS = "tpu-operator"
REF_POOL = "v5-lite-podslice-4x4"
POOL = map_pool_name(REF_POOL)

REF = types.SimpleNamespace(port=False, c=ref_consts, fr=ref_frontier, col=ref_collector,
                            engine=ref_engine, api=ref_api, auto=ref_autoscale, Fake=RefFake,
                            Request=RefRequest, kw={})
PORT = types.SimpleNamespace(port=True, c=consts, fr=frontier, col=collector, engine=engine,
                             api=api, auto=autoscale, Fake=FakeClient, Request=Request,
                             kw={"chips_per_node": AUTOSCALE_DEFAULT_PER_NODE["reference"]})


def both(case):
    ref, port = case(REF), case(PORT)
    assert port == ref
    return port


def curve(s, top=1000.0, template=""):
    return s.fr.Frontier(points=[s.fr.FrontierPoint(1, 2.0, 0.4 * top, 32),
                                 s.fr.FrontierPoint(4, 8.0, 0.8 * top, 32),
                                 s.fr.FrontierPoint(8, 20.0, top, 32)],
                         measured_at=100.0, template=template)


def mk_node(s, name, fr=None, template_label=None):
    labels = {ref_consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
              ref_consts.GKE_TPU_TOPOLOGY_LABEL: "4x4"}
    if template_label:
        labels[ref_consts.TEMPLATE_HASH_LABEL] = template_label
    annotations = {}
    if fr is not None:
        annotations[ref_consts.SERVING_FRONTIER_ANNOTATION] = (
            fr if isinstance(fr, str) else s.fr.encode_annotation(fr))
    node = {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels, "annotations": annotations},
            "status": {"capacity": {ref_consts.TPU_RESOURCE_NAME: "4"}}}
    return map_node(node) if s.port else node


def pools(state):
    """A debug payload's pools, keyed by the port's pool names."""
    return {map_pool_name(k) if k == REF_POOL else k: v for k, v in state["pools"].items()}


# -- the schema: versions ---------------------------------------------------------------------

def test_versionless_payload_loads_as_v1_forever():
    def case(s):
        a = s.fr.from_dict({"points": [{"batch": 1, "p99_ms": 2.0, "tokens_per_s": 400.0,
                                        "samples": 32}]})
        b = s.fr.from_dict({"points": [{"batch": 1, "p99_ms": 2.0, "tokens_per_s": 400.0}]})
        return a.version, a.points[0].tokens_per_s, b.points[0].samples

    assert both(case) == (1, 400.0, 0)


def test_newer_version_fails_closed():
    def case(s):
        payload = curve(s).to_dict()
        out = []
        for version in (s.fr.FRONTIER_VERSION + 1, 0, "2"):
            payload["version"] = version
            out.append(s.fr.from_dict(payload))
        return out

    assert both(case) == [None, None, None]


def test_from_dict_rejects_garbage():
    def case(s):
        return [s.fr.from_dict(v) for v in (None, "not a dict", {}, {"points": "nope"},
                                            {"points": [{"batch": "x"}]})]

    assert both(case) == [None] * 5


def test_dict_round_trip():
    def case(s):
        fr = curve(s, template="abc123")
        return s.fr.from_dict(fr.to_dict()) == fr, fr.to_dict()

    equal, payload = both(case)
    assert equal


# -- the schema: the annotation codec ----------------------------------------------------------

def test_annotation_round_trip():
    def case(s):
        fr = curve(s, template="tpl-1")
        value = s.fr.encode_annotation(fr)
        back = s.fr.decode_annotation(value)
        return value, back.points == fr.points, back.template, back.measured_at, back.version

    value, same, template, at, version = both(case)
    assert same and template == "tpl-1" and at == 100.0 and version == 1


def test_annotation_truncation_drops_deep_points_first():
    def case(s):
        fr = s.fr.Frontier(points=[s.fr.FrontierPoint(b, float(b), 100.0 * b, 32)
                                   for b in (1, 2, 4, 8, 16, 32, 64)], measured_at=5.0)
        full = s.fr.encode_annotation(fr)
        back = s.fr.decode_annotation(s.fr.encode_annotation(fr, max_bytes=len(full) - 1))
        return [p.batch for p in back.points]

    batches = both(case)
    assert batches[0] == 1 and max(batches) < 64


def test_annotation_truncation_always_reparses():
    def case(s):
        fr = s.fr.Frontier(points=[s.fr.FrontierPoint(b, float(b), 123.456 * b, 32)
                                   for b in (1, 2, 4, 8, 16)], measured_at=99.0, template="tpl")
        out = []
        for budget in range(0, len(s.fr.encode_annotation(fr)) + 1, 7):
            back = s.fr.decode_annotation(s.fr.encode_annotation(fr, max_bytes=budget))
            out.append((back.version, [p.batch for p in back.points]))
        return out

    for version, batches in both(case):
        assert version == 1 and batches == sorted(batches)


def test_decode_annotation_rejects_garbage():
    def case(s):
        return [s.fr.decode_annotation(v) for v in (None, "", "v=2;p=1:2:3:4", "v=banana",
                                                    "v=1;p=1:2:3")]

    assert both(case) == [None] * 5


def test_best_tokens_and_depth_respect_ceiling():
    def case(s):
        fr = curve(s, top=1000.0)
        return [(fr.best_tokens_per_s(c), fr.best_depth(c)) for c in (200.0, 10.0, 0.1)]

    assert both(case) == [(1000.0, 8), (800.0, 4), (0.0, 0)]


def test_p99_bucket_labels():
    def case(s):
        return [s.fr.p99_bucket(v) for v in (3.0, 5.0, 99.0, 9999.0)]

    assert both(case) == ["le5", "le5", "le100", "inf"]


# -- the collector: aggregation ----------------------------------------------------------------

def mk_collector(s, client, **kw):
    return s.col.CapacityCollector(client, NS, now=lambda: 1100.0, **kw)


def test_collector_aggregates_pool_medians():
    def case(s):
        nodes = [mk_node(s, "a", curve(s, 1000.0)), mk_node(s, "b", curve(s, 1200.0)),
                 mk_node(s, "c", curve(s, 800.0)), mk_node(s, "d")]
        col = mk_collector(s, s.Fake())
        col.observe(nodes)
        state = col.debug_state()
        return pools(state), state["nodes"], col.tokens_per_node(), state["tokens_per_node_at_slo"]

    got, nodes, tpn, at_slo = both(case)
    pool = got[POOL]
    assert (pool["nodes"], pool["reporting"], pool["tokens_per_node_at_slo"]) == (4, 3, 1000.0)
    assert pool["curve"]["le25"] == 1000.0 and pool["curve"]["le10"] == 800.0
    assert tpn == at_slo == 1000.0 and nodes["a"]["age_s"] == 1000.0


def test_collector_no_curves_returns_zero():
    def case(s):
        col = mk_collector(s, s.Fake())
        col.observe([mk_node(s, "a"), mk_node(s, "b")])
        return col.tokens_per_node(), pools(col.debug_state())[POOL]["reporting"]

    assert both(case) == (0.0, 0)


# -- the collector: drift ----------------------------------------------------------------------

def drift_count(s, client):
    return sum(int(e.get("count") or 1) for e in client.list("v1", "Event", NS)
               if e.get("reason") == s.col.REASON_DRIFT)


def test_drift_fires_one_event_per_episode():
    def case(s):
        client = s.Fake()
        col = mk_collector(s, client)
        healthy = [mk_node(s, "a", curve(s, 1000.0)), mk_node(s, "b", curve(s, 1000.0))]
        degraded = healthy + [mk_node(s, "c", curve(s, 100.0))]
        log = []
        for nodes in (healthy + [mk_node(s, "c", curve(s, 1000.0))], degraded, degraded,
                      degraded, healthy + [mk_node(s, "c", curve(s, 1000.0))], degraded):
            col.observe(nodes)
            log.append((drift_count(s, client), col.drifting_nodes()))
        return log

    assert both(case) == [(0, []), (1, ["c"]), (1, ["c"]), (1, ["c"]), (1, []), (2, ["c"])]


def test_drift_episode_closes_when_frontier_vanishes():
    def case(s):
        client = s.Fake()
        col = mk_collector(s, client)
        healthy = [mk_node(s, "a", curve(s, 1000.0)), mk_node(s, "b", curve(s, 1000.0))]
        log = []
        for c in (curve(s, 100.0), None, curve(s, 100.0)):
            col.observe(healthy + [mk_node(s, "c", c)])
            log.append(drift_count(s, client))
        return log

    assert both(case) == [1, 1, 2]


def test_drift_needs_pool_quorum():
    def case(s):
        client = s.Fake()
        col = mk_collector(s, client)
        col.observe([mk_node(s, "a", curve(s, 100.0)), mk_node(s, "b")])
        return s.col.MIN_POOL_QUORUM, drift_count(s, client), col.drifting_nodes()

    quorum, count, drifting = both(case)
    assert quorum >= 2 and count == 0 and drifting == []


def test_drift_metric_counts_episodes():
    def case(s):
        col = mk_collector(s, s.Fake())
        healthy = [mk_node(s, "a", curve(s, 1000.0)), mk_node(s, "b", curve(s, 1000.0))]
        for _ in range(2):
            col.observe(healthy + [mk_node(s, "c", curve(s, 100.0))])
        child = col.metrics.serving_frontier_drift.labels(
            pool=POOL if s.port else REF_POOL)
        return child.read() if s.port else child._value.get()

    assert both(case) == 1


# -- the collector: template staleness ----------------------------------------------------------

def test_template_change_requests_reprobe():
    def case(s):
        client = s.Fake()
        node = mk_node(s, "a", curve(s, 1000.0, template="old"), template_label="new")
        client.create(node)
        col = mk_collector(s, client)
        col.observe([node])
        first = client.get("v1", "Node", "a")
        col.observe([first])
        second = client.get("v1", "Node", "a")
        return (col.stale_nodes(), first["metadata"]["annotations"][s.c.SERVING_REPROBE_ANNOTATION],
                second["metadata"]["annotations"][s.c.SERVING_REPROBE_ANNOTATION],
                first["metadata"]["resourceVersion"] == second["metadata"]["resourceVersion"])

    assert both(case) == (["a"], "new", "new", True)


def test_matching_template_is_not_stale():
    def case(s):
        client = s.Fake()
        node = mk_node(s, "a", curve(s, 1000.0, template="t1"), template_label="t1")
        client.create(node)
        col = mk_collector(s, client)
        col.observe([node])
        out = [col.stale_nodes(), s.c.SERVING_REPROBE_ANNOTATION in (
            client.get("v1", "Node", "a")["metadata"].get("annotations") or {})]
        node2 = mk_node(s, "b", curve(s, 1000.0), template_label="t2")
        client.create(node2)
        col.observe([node, node2])
        return out + [col.stale_nodes()]

    assert both(case) == [[], False, []]


# -- the autoscaler: the measured path and the constant fallback -------------------------------

def spec_of(s, **kw):
    return s.api.AutoscaleSpec.from_dict(dict({"enabled": True}, **kw))


def test_nodes_needed_measured_frontier_path():
    def case(s):
        spec = spec_of(s, headroomPct=20.0)
        return [s.engine.nodes_needed(spec, chips, 4, False, 3, demand_tokens_per_s=5000.0,
                                      frontier_tokens_per_node=1250.0) for chips in (0.0, 999.0)]

    assert both(case) == [5, 5]


def test_nodes_needed_falls_back_to_constant_without_frontier():
    def case(s):
        spec = spec_of(s, headroomPct=20.0)
        return [s.engine.nodes_needed(spec, 10.0, 4, False, 3),
                s.engine.nodes_needed(spec, 10.0, 4, False, 3, demand_tokens_per_s=5000.0,
                                      frontier_tokens_per_node=0.0),
                s.engine.nodes_needed(spec, 10.0, 4, False, 3, demand_tokens_per_s=0.0,
                                      frontier_tokens_per_node=1250.0)]

    assert both(case) == [3, 3, 3]


def test_nodes_needed_breach_floor_applies_to_measured_path():
    def case(s):
        return s.engine.nodes_needed(spec_of(s, headroomPct=0.0), 0.0, 4, True, 6,
                                     demand_tokens_per_s=1000.0, frontier_tokens_per_node=1250.0)

    assert both(case) == 7


class Clock:
    t = 1_000_000.0

    def __call__(self):
        return self.t


def test_reconciler_consumes_collector():
    """With curves on the fleet and a token forecast in the snapshot the
    reconciler's debug state shows the measured tokens per node; without
    them 0.0 (the constant path). The collector's pool curve and its
    metric carry the same number."""
    def case(s):
        client, clock = s.Fake(), Clock()
        client.create(s.api.new_cluster_policy(spec={
            "autoscale": {"enabled": True, "scaleDownDelayS": 0, "cooldownS": 0,
                          "minNodes": {"default": 1}, "maxNodes": {"default": 8}},
            "health": {"drainDeadlineS": 60}}))
        for i in range(2):
            client.create(mk_node(s, f"node-{i}"))
        capacity = s.col.CapacityCollector(client, NS, now=clock)
        rec = s.auto.AutoscaleReconciler(client, namespace=NS, now=clock, capacity=capacity,
                                         **s.kw)

        def snapshot(**extra):
            client.patch("tpu.ai/v1", "ClusterPolicy", "cluster-policy",
                         {"metadata": {"annotations": {
                             s.c.TRAFFIC_SNAPSHOT_ANNOTATION: json.dumps(dict({
                                 "ts": clock(), "queue_depth": 0, "backlog_chips": 8.0,
                                 "attainment": 1.0}, **extra))}}})

        snapshot()
        rec.reconcile(s.Request(name="cluster-policy"))
        before = rec.debug_state()["autoscale"]["frontier_tokens_per_node"]
        for name in ("node-0", "node-1"):
            client.patch("v1", "Node", name, {"metadata": {"annotations": {
                s.c.SERVING_FRONTIER_ANNOTATION: s.fr.encode_annotation(curve(s, 1250.0))}}})
        clock.t += 60.0
        snapshot(demand_tokens_per_s=2000.0)
        rec.reconcile(s.Request(name="cluster-policy"))
        debug = rec.debug_state()["autoscale"]
        pool = POOL if s.port else REF_POOL
        gauge = capacity.metrics.serving_frontier_tokens_per_s.labels(pool=pool, p99_bucket="le25")
        return (before, debug["frontier_tokens_per_node"], debug["token_demand_level"] > 0,
                pools(capacity.debug_state())[POOL]["tokens_per_node_at_slo"],
                gauge.read() if s.port else gauge._value.get(),
                sorted(map_registered_name(n["metadata"]["name"])
                       for n in client.list("v1", "Node")))

    before, after, demand, at_slo, gauge, nodes = both(case)
    assert before == 0.0 and after == at_slo == gauge == 1250.0 and demand
    assert nodes == ["node-0", "node-1", f"{POOL}-a0"]  # 2000 t/s * 1.2 / 1250 -> 2 nodes
