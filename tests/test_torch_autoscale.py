"""The port's fleet autoscaler (tpu_operator_torch/autoscale/) against the
reference's (tpu_operator/autoscale/): the twins of the 22 tests of
tests/test_autoscale.py.

The predictor, the decision engine and the snapshot parser are pure: each
case runs on both packages' functions and what it computed must be equal
(and equal what the reference's test asserts). The controller's cases run as
scripts on a :class:`World` of each package (its fake apiserver, its
reconciler, a shared fake clock); each returns what it observed, the
reference's side mapped into the port's names through
tests/test_torch_operator_mapping.py (a TPU node is the same node with
GPUs, pools and registered nodes named after the GPU model, plan
fingerprints over the mapped names), and the two must be equal. The
crash-point soak kills each operator before and after every mutating call
of a scale-down episode, on both packages.
"""

import json
import types

import pytest

from test_torch_operator_mapping import (AUTOSCALE_DEFAULT_PER_NODE, map_labels, map_node,
                                         map_pool_name, map_registered_name)
from tpu_operator import consts as ref_consts
from tpu_operator.api import clusterpolicy as ref_api
from tpu_operator.autoscale import controller as ref_controller
from tpu_operator.autoscale import engine as ref_engine
from tpu_operator.autoscale import predictor as ref_predictor
from tpu_operator.client import chaos as ref_chaos
from tpu_operator.client.errors import FencedError as RefFencedError
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.client.fenced import FencedClient as RefFenced
from tpu_operator.controllers.runtime import Request as RefRequest
from tpu_operator.health import HealthStateMachine as RefHealthMachine
from tpu_operator.health import drain as ref_drain
from tpu_operator.testing import NodeChaos as RefNodeChaos
from tpu_operator.testing.kubelet import KubeletSimulator as RefKubelet
from tpu_operator_torch import consts
from tpu_operator_torch.api import clusterpolicy as api
from tpu_operator_torch.autoscale import controller
from tpu_operator_torch.autoscale import engine
from tpu_operator_torch.autoscale import predictor
from tpu_operator_torch.client import chaos
from tpu_operator_torch.client.errors import FencedError
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.client.fenced import FencedClient
from tpu_operator_torch.controllers.runtime import Request
from tpu_operator_torch.health import HealthStateMachine
from tpu_operator_torch.health import drain
from tpu_operator_torch.testing.chaos import NodeChaos
from tpu_operator_torch.testing.kubelet import KubeletSimulator

NS = "tpu-operator"
#: the reference's pool (state.nodepool's name for its test nodes' labels)
REF_POOL = "v5-lite-podslice-2x2"
REF_LABELS = {ref_consts.TPU_PRESENT_LABEL: "true",
              ref_consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
              ref_consts.GKE_TPU_TOPOLOGY_LABEL: "2x2"}

REF = types.SimpleNamespace(
    port=False, c=ref_consts, api=ref_api, ctl=ref_controller, engine=ref_engine,
    predictor=ref_predictor, chaos=ref_chaos, Fake=RefFake, Fenced=RefFenced,
    FencedError=RefFencedError, Request=RefRequest, drain=ref_drain,
    HealthMachine=RefHealthMachine, NodeChaos=RefNodeChaos, Kubelet=RefKubelet,
    pool=REF_POOL, reconciler_kw={})
PORT = types.SimpleNamespace(
    port=True, c=consts, api=api, ctl=controller, engine=engine, predictor=predictor,
    chaos=chaos, Fake=FakeClient, Fenced=FencedClient, FencedError=FencedError,
    Request=Request, drain=drain, HealthMachine=HealthStateMachine, NodeChaos=NodeChaos,
    Kubelet=KubeletSimulator, pool=map_pool_name(REF_POOL),
    reconciler_kw={"chips_per_node": AUTOSCALE_DEFAULT_PER_NODE["reference"]})
SIDES = (REF, PORT)


def metric(family, **labels):
    """A counter's or gauge's value in either package's metrics."""
    if hasattr(family, "samples") and not labels:
        family = family.labels()  # the port's: its unlabelled child
    child = family.labels(**labels) if labels else family
    return child.read() if hasattr(child, "read") else child._value.get()


class Clock:
    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


# -- the pure pieces -----------------------------------------------------------------------

def both(case):
    """Run ``case(side)`` on both packages: the results must be equal."""
    ref, port = case(REF), case(PORT)
    assert port == ref
    return port


def test_predictor_empty_then_single_sample():
    def case(s):
        p = s.predictor.TrendPredictor()
        out = [p.forecast(60.0)]
        p.observe(10.0, 8.0)
        return out + [p.level, p.forecast(600.0)]

    assert both(case) == [0.0, 8.0, 8.0]


def test_predictor_forecast_leads_a_linear_ramp():
    def case(s):
        p = s.predictor.TrendPredictor(alpha=1.0)
        for i in range(10):
            p.observe(30.0 * i, 4.0 * i)
        return p.slope(), p.forecast(60.0)

    slope, forecast = both(case)
    assert slope == pytest.approx(4.0 / 30.0) and forecast == pytest.approx(44.0)


def test_predictor_ignores_out_of_order_samples():
    def case(s):
        p = s.predictor.TrendPredictor()
        p.observe(100.0, 5.0)
        p.observe(50.0, 500.0)
        return len(p.samples), p.level

    assert both(case) == (1, 5.0)


def test_predictor_window_prunes_stale_samples():
    def case(s):
        p = s.predictor.TrendPredictor(window_s=100.0)
        for t in (0.0, 50.0, 140.0):
            p.observe(t, 1.0)
        return [t for t, _ in p.samples]

    assert both(case) == [50.0, 140.0]


def test_predictor_forecast_floors_at_zero():
    def case(s):
        p = s.predictor.TrendPredictor(alpha=1.0)
        p.observe(0.0, 100.0)
        p.observe(10.0, 10.0)
        return p.forecast(600.0)

    assert both(case) == 0.0


def spec_of(s, **kw):
    return s.api.AutoscaleSpec.from_dict(dict({"enabled": True}, **kw))


def _decisions(ds):
    return [(d.pool, d.current, d.target, d.action, d.hold_reason) for d in ds]


def _states(states):
    return {pool: st.to_dict() for pool, st in sorted(states.items())}


def test_nodes_needed_headroom_and_breach_floor():
    def case(s):
        spec = spec_of(s, headroomPct=20.0)
        return [s.engine.nodes_needed(spec, 10.0, 4, False, 3),
                s.engine.nodes_needed(spec, 0.0, 4, False, 3),
                s.engine.nodes_needed(spec, 0.0, 4, True, 3)]

    assert both(case) == [3, 0, 4]


def test_spread_targets_waterfills_in_sorted_order():
    def case(s):
        spec = spec_of(s, minNodes={"default": 1}, maxNodes={"a": 2, "default": 4})
        return (s.engine.spread_targets(spec, {"b": 1, "a": 1}, 5),
                s.engine.spread_targets(spec, {"b": 1, "a": 1}, 99))

    assert both(case) == ({"a": 2, "b": 3}, {"a": 2, "b": 4})


def test_decide_scales_up_toward_target():
    def case(s):
        states = {}
        ds = s.engine.decide(spec_of(s, maxNodes={"default": 8}), {"p": 2}, 20.0, 4, False,
                             states, now=100.0)
        return _decisions(ds), _states(states)

    decisions, states = both(case)
    assert decisions == [("p", 2, 6, "up", None)] and states["p"]["target"] == 6


def test_decide_holds_in_cooldown():
    def case(s):
        states = {"p": s.engine.PoolState(target=2, cooldown_until=150.0)}
        return _decisions(s.engine.decide(spec_of(s, cooldownS=60), {"p": 2}, 20.0, 4, False,
                                          states, now=100.0))

    assert both(case) == [("p", 2, 6, None, "cooldown")]


def test_decide_revoked_preemptible_bypasses_cooldown():
    def case(s):
        out = []
        for spec in (spec_of(s, cooldownS=600, preemptiblePools=["p"]), spec_of(s, cooldownS=600)):
            states = {"p": s.engine.PoolState(target=3, cooldown_until=10_000.0)}
            out.append(_decisions(s.engine.decide(spec, {"p": 2}, 8.0, 4, False, states,
                                                  now=100.0)))
        return out

    up, held = both(case)
    assert up[0][3] == "up" and held[0][4] == "cooldown"


def test_decide_scale_down_needs_sustained_deficit():
    def case(s):
        spec = spec_of(s, scaleDownDelayS=300)
        out, states = [], {}
        for now in (100.0, 250.0, 401.0):
            out += _decisions(s.engine.decide(spec, {"p": 4}, 4.0, 4, False, states, now=now))
        states = {}
        for now, demand in ((100.0, 4.0), (200.0, 40.0), (401.0, 4.0)):
            out += _decisions(s.engine.decide(spec, {"p": 4}, demand, 4, False, states,
                                              now=now))
        return out

    got = both(case)
    assert [d[3] or d[4] for d in got] == ["scale-down-delay", "scale-down-delay", "down",
                                           "scale-down-delay", "up", "scale-down-delay"]


def test_decide_resize_in_flight_holds_everything():
    def case(s):
        states = {"p": s.engine.PoolState(target=2, resize={
            "node": "n-1", "fingerprint": "f", "direction": "down", "deadline": 0.0})}
        return _decisions(s.engine.decide(spec_of(s, scaleDownDelayS=0, cooldownS=0), {"p": 4},
                                          400.0, 4, False, states, now=100.0))

    assert both(case) == [("p", 4, 32, None, "resize-in-flight")]


@pytest.mark.parametrize("raw", [None, "{not json", '["list"]', '{"no_ts": 1}',
                                 '{"ts": 5, "backlog_chips": 2}', '{"ts": 1.5}'])
def test_parse_snapshot_rejects_corrupt_payloads(raw):
    assert controller.parse_snapshot(raw) == ref_controller.parse_snapshot(raw)


# -- the controller -------------------------------------------------------------------------

class World:
    """One package's cluster: a fake apiserver, the reconciler and a clock.
    Observations are in the port's names (the reference's mapped)."""

    def __init__(self, s, backend=None):
        self.s = s
        self.clock = Clock()
        self.client = backend if backend is not None else s.Fake()

    # -- setup ---------------------------------------------------------------------------
    def node(self, name, managed=False, preemptible=False, chips="4"):
        labels = dict(REF_LABELS)
        if managed:
            labels[ref_consts.AUTOSCALE_MANAGED_LABEL] = REF_POOL
        if preemptible:
            labels[ref_consts.PREEMPTIBLE_POOL_LABEL] = "true"
        node = {"apiVersion": "v1", "kind": "Node",
                "metadata": {"name": name, "labels": labels},
                "status": {"capacity": {ref_consts.TPU_RESOURCE_NAME: chips}}}
        if self.s.port:
            node = map_node(node)
            node["metadata"]["name"] = map_registered_name(name)
            if managed:
                node["metadata"]["labels"][consts.AUTOSCALE_MANAGED_LABEL] = self.s.pool
        return node

    def setup(self, n=2, autoscale=None, drain_deadline_s=60, preemptible=False,
              migrate=None):
        spec = {"enabled": True, "scaleDownDelayS": 0, "cooldownS": 0,
                "minNodes": {"default": 1}, "maxNodes": {"default": 8}}
        spec.update(autoscale or {})
        if "preemptiblePools" in spec:
            spec["preemptiblePools"] = [self.s.pool]
        cp = {"autoscale": spec, "health": {"drainDeadlineS": drain_deadline_s}}
        if migrate is not None:
            cp["migrate"] = migrate
        self.client.create(self.s.api.new_cluster_policy(spec=cp))
        for i in range(n):
            self.client.create(self.node(f"node-{i}", preemptible=preemptible))

    def pod(self, name, node):
        self.client.create({"apiVersion": "v1", "kind": "Pod",
                            "metadata": {"name": name, "namespace": "tenant-a"},
                            "spec": {"nodeName": node}, "status": {"phase": "Running"}})

    def snapshot(self, backlog_chips, attainment=1.0, queue_depth=0, ts=None, **extra):
        self.client.patch("tpu.ai/v1", "ClusterPolicy", "cluster-policy",
                          {"metadata": {"annotations": {
                              self.s.c.TRAFFIC_SNAPSHOT_ANNOTATION: json.dumps(dict({
                                  "ts": self.clock.t if ts is None else ts,
                                  "queue_depth": queue_depth,
                                  "backlog_chips": backlog_chips,
                                  "attainment": attainment}, **extra))}}})

    def reconciler(self, client=None, **kw):
        return self.s.ctl.AutoscaleReconciler(client or self.client, namespace=NS,
                                              now=self.clock,
                                              **dict(self.s.reconciler_kw, **kw))

    def sweep(self, rec):
        return rec.reconcile(self.s.Request(name="cluster-policy"))

    # -- observations ---------------------------------------------------------------------
    def name(self, name):
        return name if self.s.port else map_registered_name(name)

    def labels(self, labels):
        if self.s.port:
            return dict(labels)
        out = map_labels(labels)
        if consts.AUTOSCALE_MANAGED_LABEL in out:
            out[consts.AUTOSCALE_MANAGED_LABEL] = map_pool_name(out[consts.AUTOSCALE_MANAGED_LABEL])
        return out

    def fingerprint(self, fp, candidates):
        """A plan fingerprint as the port's over the mapped node names."""
        if self.s.port:
            return fp
        for name in candidates:
            if fp == ref_drain.plan_fingerprint(f"scale-down:{name}", []):
                return drain.plan_fingerprint(f"scale-down:{self.name(name)}", [])
        return fp

    def gpu_nodes(self):
        key = consts.GKE_ACCELERATOR_LABEL if self.s.port else ref_consts.GKE_TPU_ACCELERATOR_LABEL
        return sorted(self.name(n["metadata"]["name"]) for n in self.client.list("v1", "Node")
                      if key in (n["metadata"].get("labels") or {}))

    def node_labels(self, name):
        raw = self.client.get("v1", "Node", name)["metadata"]["labels"]
        return self.labels(raw)

    def states(self):
        policy = self.client.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        raw = (policy["metadata"].get("annotations") or {}).get(
            self.s.c.AUTOSCALE_STATE_ANNOTATION)
        states = json.loads(raw) if raw else {}
        names = [n["metadata"]["name"] for n in self.client.list("v1", "Node")]
        names += [f"node-{i}" for i in range(8)] + [f"{self.s.pool}-a{i}" for i in range(8)]
        out = {}
        for pool, st in states.items():
            st = dict(st)
            if st.get("template"):
                st["template"] = self.labels(st["template"])
            if st.get("resize"):
                rec = dict(st["resize"])
                rec["node"] = self.name(rec["node"])
                rec["fingerprint"] = self.fingerprint(rec["fingerprint"], names)
                st["resize"] = rec
            out[pool if self.s.port else map_pool_name(pool)] = st
        return out

    def planned(self):
        """The nodes carrying a drain plan, with the plan's reason."""
        out = []
        for n in self.client.list("v1", "Node"):
            plan = self.s.drain.node_plan(n)
            if plan is not None:
                out.append((self.name(n["metadata"]["name"]), plan.reason))
        return sorted(out)

    def events(self, reason):
        return len([e for e in self.client.list("v1", "Event", NS) if e.get("reason") == reason])

    def ack_open_plans(self, client=None, step=7):
        """The workload: ack every published plan through its own client."""
        client = client or self.client
        for n in client.list("v1", "Node"):
            plan = self.s.drain.node_plan(n)
            if plan is None or self.s.drain.node_acked_plan(n) == plan.fingerprint:
                continue
            client.patch("v1", "Node", n["metadata"]["name"], {"metadata": {"annotations": {
                self.s.c.DRAIN_ACK_ANNOTATION: json.dumps({"plan": plan.fingerprint,
                                                           "step": step})}}})


def twin(case, **kw):
    """Run a controller case on both packages; the observations must agree."""
    ref, port = case(World(REF, **kw)), case(World(PORT, **kw))
    assert port == ref
    return port


def test_scale_up_registers_nodes_with_pool_template():
    def case(w):
        w.setup(n=1, autoscale={"preemptiblePools": True})
        w.snapshot(20.0)
        rec = w.reconciler()
        w.sweep(rec)
        names = w.gpu_nodes()
        created = [n for n in names if n != "node-0"]
        return {"nodes": names,
                "labels": {n: w.node_labels(n if w.s.port else n.replace(PORT.pool, REF_POOL))
                           for n in created},
                "states": w.states(),
                "up": metric(rec.metrics.autoscale_resizes, pool=w.s.pool, direction="up"),
                "target": metric(rec.metrics.autoscale_target_nodes, pool=w.s.pool)}

    got = twin(case)
    assert got["nodes"][1:] == [f"{PORT.pool}-a{i}" for i in range(5)]
    for labels in got["labels"].values():
        assert labels[consts.GKE_ACCELERATOR_LABEL] == PORT.pool
        assert labels[consts.AUTOSCALE_MANAGED_LABEL] == PORT.pool
        assert labels[consts.PREEMPTIBLE_POOL_LABEL] == "true"
    assert got["states"][PORT.pool]["target"] == 6 and got["up"] == 5 and got["target"] == 6


def test_targets_clamp_to_max_nodes():
    def case(w):
        w.setup(n=1, autoscale={"maxNodes": {"default": 3}})
        w.snapshot(500.0)
        rec = w.reconciler()
        w.sweep(rec)
        return len(w.gpu_nodes()), w.events("AutoscaleSaturated")

    assert twin(case) == (3, 1)


def test_scale_down_is_a_planned_drain_never_a_bare_delete():
    def case(w):
        w.setup(n=3)
        w.snapshot(6.0)  # wants 2
        rec = w.reconciler()
        log = [w.sweep(rec).requeue_after is not None, len(w.gpu_nodes()), w.planned(),
               w.events(w.s.ctl.REASON_PLANNED), w.states()]
        w.clock.t += 5.0
        w.sweep(rec)
        log.append(len(w.gpu_nodes()))
        w.ack_open_plans()
        w.clock.t += 5.0
        w.sweep(rec)
        log += [w.gpu_nodes(), w.states(), w.events(w.s.ctl.REASON_PLANNED),
                w.events("AutoscaleDown"),
                metric(rec.metrics.autoscale_resizes, pool=w.s.pool, direction="down")]
        return log

    got = twin(case)
    assert got[0] is True and got[1] == 3 and got[2] == [("node-0", "scale-down")]
    assert got[3] == 1 and got[5] == 3 and len(got[6]) == 2
    assert got[7][PORT.pool].get("resize") is None and got[8:] == [1, 1, 1]


def test_scale_down_deadline_expiry_forces_removal():
    def case(w):
        w.setup(n=3, drain_deadline_s=30)
        w.snapshot(6.0)
        rec = w.reconciler()
        w.sweep(rec)
        before = len(w.gpu_nodes())
        w.clock.t += 31.0
        w.sweep(rec)
        return before, len(w.gpu_nodes()), metric(rec.metrics.drain_deadline_missed)

    assert twin(case) == (3, 2, 1)


def test_victim_is_the_emptiest_managed_node():
    def case(w):
        w.setup(n=2)
        w.client.create(w.node(f"{REF_POOL}-a0", managed=True))
        w.pod("w-0", "node-0")
        w.pod("w-1", "node-1")
        w.snapshot(6.0)
        w.sweep(w.reconciler())
        return w.planned()

    assert twin(case) == [(f"{PORT.pool}-a0", "scale-down")]


def test_scale_down_holds_when_every_node_is_busy():
    def case(w):
        w.setup(n=3)
        for i in range(3):
            w.pod(f"w-{i}", f"node-{i}")
        w.snapshot(6.0)
        w.sweep(w.reconciler())
        return len(w.gpu_nodes()), w.planned()

    assert twin(case) == (3, [])


class DeposedFence:
    """The elector's live view of a replica that lost leadership."""

    epoch = 3

    def current_epoch(self):
        return None


def test_fenced_write_propagates_for_runtime_requeue():
    def case(w):
        w.setup(n=1)
        w.snapshot(20.0)
        fenced = w.s.Fenced(w.client, fence=DeposedFence())
        rec = w.reconciler(client=fenced)
        with pytest.raises(w.s.FencedError):
            w.sweep(rec)
        return w.gpu_nodes(), w.states(), fenced.fenced_total, fenced.dispatched_total

    assert twin(case) == (["node-0"], {}, 1, 0)


def test_revoked_preemptible_capacity_is_jointly_replaced():
    """NodeChaos revokes a preemptible node (pods and Node gone, no plan);
    the health machine stays quiet and the autoscaler replaces the capacity
    on its next sweep, inside its cooldown."""
    def case(w):
        w.setup(n=2, preemptible=True,
                autoscale={"cooldownS": 600, "preemptiblePools": True})
        w.snapshot(8.0)  # wants 3
        rec = w.reconciler()
        w.sweep(rec)
        log = [len(w.gpu_nodes()), w.states()[PORT.pool]["cooldown_until"] > w.clock.t]
        node_chaos = w.s.NodeChaos(w.s.Kubelet(w.client, namespace=NS), seed=7)
        victim = node_chaos.revoke_one()
        log += [w.name(victim), [w.name(v) for v in node_chaos.revoked], len(w.gpu_nodes()),
                w.planned()]
        hsm = w.s.HealthMachine(w.client, NS, w.s.api.HealthSpec.from_dict(
            {"drainDeadlineS": 0}), now=w.clock)
        counts = hsm.process(w.client.list("v1", "Node"))
        log += [counts.quarantined, counts.remediating]
        w.clock.t += 1.0
        w.sweep(rec)
        names = w.gpu_nodes()
        replacements = [n for n in names if n.startswith(f"{PORT.pool}-a")]
        raw = replacements[0] if w.s.port else replacements[0].replace(PORT.pool, REF_POOL)
        log += [names, w.node_labels(raw)]
        return log

    got = twin(case)
    assert got[0] == 3 and got[1] is True and got[4] == 2 and got[5] == []
    assert got[6:8] == [0, 0] and len(got[8]) == 3
    assert got[9][consts.PREEMPTIBLE_POOL_LABEL] == "true"


# -- the crash-point soak: a kill mid-resize ---------------------------------------------------

class _NodeDeleteCounter:
    """Counts Node deletions across operator incarnations."""

    def __init__(self, inner):
        self.inner = inner
        self.scheme = getattr(inner, "scheme", None)
        self.node_deletes = []

    def delete(self, api_version, kind, name, namespace=None):
        if kind == "Node":
            self.node_deletes.append(name)
        return self.inner.delete(api_version, kind, name, namespace)

    def __getattr__(self, attr):
        return getattr(self.inner, attr)


def _scale_down_world(s):
    w = World(s, backend=_NodeDeleteCounter(s.Fake()))
    w.setup(n=3)
    w.snapshot(6.0)  # wants 2
    return w


def _drive_scale_down(w, arm=None, max_steps=30):
    """Sweeps and acks until the pool is at 2 with its resize retired; on
    the armed kill, a fresh operator over the same cluster. Returns the
    recording client's sites."""
    first = w.s.chaos.CrashPointClient(w.client, arm=arm)
    rec = w.reconciler(client=first)
    for _ in range(max_steps):
        w.clock.t += 5.0
        try:
            w.sweep(rec)
        except w.s.chaos.OperatorCrashed:
            rec = w.reconciler(client=w.s.chaos.CrashPointClient(w.client))
            continue
        w.ack_open_plans()
        st = w.states().get(PORT.pool, {})
        if len(w.gpu_nodes()) == 2 and st.get("resize") is None and st.get("target") == 2:
            if arm is not None:
                assert first.fired, f"armed site never fired: {arm}"
            return first.sites
    raise AssertionError(f"scale-down episode did not converge (arm={arm})")


def _map_site(site):
    return site.replace(REF_POOL, PORT.pool).replace("google.com/tpu", consts.GPU_RESOURCE_NAME)


def test_kill_mid_resize_converges_to_exactly_one_retile():
    """The operator dies just before and just after every mutating call of
    a scale-down episode, on both packages; each cold-restarted replay ends
    with one node removed, one RetilePlanned Event and the resize retired."""
    sites = {}
    for s in SIDES:
        w = _scale_down_world(s)
        sites[s.port] = _drive_scale_down(w)
        assert w.client.node_deletes == ["node-0"]
    assert sites[True] == [_map_site(x) for x in sites[False]]
    assert any("planned-retile" in x for x in sites[True])
    assert any(x.startswith("DELETE Node/") for x in sites[True]) and len(sites[True]) >= 4
    for ref_site, port_site in zip(sites[False], sites[True]):
        for mode in ("before", "after"):
            seen = []
            for s, site in ((REF, ref_site), (PORT, port_site)):
                w = _scale_down_world(s)
                _drive_scale_down(w, arm=(site, mode))
                seen.append((len(w.client.node_deletes), w.events(s.ctl.REASON_PLANNED),
                             w.states()[PORT.pool].get("resize"), len(w.gpu_nodes())))
            assert seen[1] == seen[0] == (1, 1, None, 2), (port_site, mode, seen)


# -- the port's differences, pinned (tests/test_torch_operator_mapping.py) -------------------

def test_a_node_without_capacity_counts_for_one_gpu_host():
    rec = controller.AutoscaleReconciler(FakeClient(), namespace=NS)
    assert rec.default_chips_per_node == AUTOSCALE_DEFAULT_PER_NODE["port"] == 8
    assert ref_controller.AutoscaleReconciler(RefFake(), namespace=NS).default_chips_per_node \
        == AUTOSCALE_DEFAULT_PER_NODE["reference"]
    node = {"metadata": {"name": "n"}, "status": {"capacity": {consts.GPU_RESOURCE_NAME: "2"}}}
    assert controller._node_chips(node, 8) == 2
    assert controller._node_chips({"metadata": {"name": "n"}}, 8) == 8


def test_a_pool_keyed_on_the_gpu_model_registers_gpu_nodes():
    """The card's node carries no GKE accelerator label, only feature
    discovery's GPU model and node feature discovery's NVIDIA PCI label: its
    pool's template is the model label, so a registered node also gets the
    PCI label. It is a GPU node, the next census counts it, and the pool
    grows to its bound and no further."""
    from tpu_operator_torch.nodeinfo import is_gpu_node

    w = World(PORT)
    w.client.create(api.new_cluster_policy(spec={"autoscale": {
        "enabled": True, "cooldownS": 0, "minNodes": {"default": 1},
        "maxNodes": {"default": 3}}}))
    w.client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "card", "labels": {
        consts.NFD_NVIDIA_PCI_LABEL: "true", consts.TPU_CHIP_TYPE_LABEL: "nvidia-h100-80gb"}},
        "status": {"capacity": {consts.GPU_RESOURCE_NAME: "1"}}})
    w.snapshot(20.0)
    rec = controller.AutoscaleReconciler(w.client, namespace=NS, now=w.clock)
    for _ in range(3):
        w.clock.t += 1.0
        w.sweep(rec)
    nodes = {n["metadata"]["name"]: n for n in w.client.list("v1", "Node")}
    assert sorted(nodes) == ["card", "nvidia-h100-80gb-a0", "nvidia-h100-80gb-a1"]
    for name in ("nvidia-h100-80gb-a0", "nvidia-h100-80gb-a1"):
        labels = nodes[name]["metadata"]["labels"]
        assert labels == {consts.TPU_CHIP_TYPE_LABEL: "nvidia-h100-80gb",
                          consts.NFD_NVIDIA_PCI_LABEL: "true",
                          consts.AUTOSCALE_MANAGED_LABEL: "nvidia-h100-80gb"}
        assert is_gpu_node(nodes[name])
    assert metric(rec.metrics.autoscale_resizes, pool="nvidia-h100-80gb", direction="up") == 2
