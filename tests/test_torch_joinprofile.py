"""The port's join profiler (tpu_operator_torch/joinprofile/{critical_path,
collector}.py) against the reference's, on the same inputs.

``attribute`` and ``record_intervals`` must give exactly the reference's
seconds, coverage and phases on the same intervals: the reference's
hand-built cases and seeded random ones. ``JoinProfiler`` runs on both
packages under one fake wall clock and must stitch the same hand-built
join (window, attribution, node spans, orphans) and give the same
reconcile-latency summary. A node is schedulable once it has the port's
``nvidia.com/gpu`` capacity where the reference's has ``google.com/tpu``.

The twin of tests/test_joinprofile.py.
"""

import types

import numpy as np
import pytest

from test_torch_operator_mapping import map_node
from tpu_operator import consts as ref_consts
from tpu_operator import tracing as ref_tracing
from tpu_operator.joinprofile import collector as ref_collector
from tpu_operator.joinprofile import critical_path as ref_cp
from tpu_operator.joinprofile.records import encode_annotation as ref_encode
from tpu_operator_torch import tracing
from tpu_operator_torch.controllers.metrics import OperatorMetrics
from tpu_operator_torch.joinprofile import collector, critical_path
from tpu_operator_torch.joinprofile.records import encode_annotation

NAMES = ["xla-compile", "ici-sweep", "operand.workload-local", "barrier-wait.workload",
         "operand.wait", "ds-rollout-wait", "serving.probe", "reconcile", "mystery-span",
         "image-prepull", "image-pull.validator", "operand.driver", "operand.plugin",
         "operand.perf", "state.driver", "label-nodes", "sync-state", "status-update",
         "health-sweep", "api.get", "operand.serving", "operand.feature-discovery",
         "operand.prewarm", "validate", "handshake", ""]


@pytest.mark.parametrize("kind", ["", "phase", "reconcile", "api", "state", "remote"])
def test_phase_of_matches_reference(kind):
    assert [critical_path.phase_of(n, kind) for n in NAMES] == \
        [ref_cp.phase_of(n, kind) for n in NAMES]
    assert critical_path.PHASES == ref_cp.PHASES


HAND_CASES = [
    ([("ds-rollout-wait", 0.0, 10.0), ("reconcile", 0.0, 10.0), ("validation-run", 2.0, 8.0),
      ("xla-compile", 3.0, 5.0), ("barrier-handshake", 7.0, 9.0)], (0.0, 10.0)),
    ([("validation-run", -5.0, 2.0), ("unknown-phase", 6.0, 7.0)], (0.0, 10.0)),
    ([], (0.0, 0.0)),
    ([("reconcile", 5.0, 4.0)], (0.0, 10.0)),
]


def _random_case(seed):
    rng = np.random.default_rng(seed)
    phases = list(ref_cp.PHASES) + ["not-a-phase"]
    n = int(rng.integers(1, 40))
    starts = rng.uniform(-5.0, 60.0, n)
    lengths = rng.exponential(6.0, n)
    intervals = [(phases[int(rng.integers(len(phases)))], float(a), float(a + d))
                 for a, d in zip(starts, lengths)]
    w0 = float(rng.uniform(-2.0, 5.0))
    return intervals, (w0, w0 + float(rng.uniform(0.0, 70.0)))


@pytest.mark.parametrize("case", [f"hand-{i}" for i in range(len(HAND_CASES))]
                         + [f"seed-{s}" for s in range(12)])
def test_attribute_gives_exactly_the_reference_s_seconds(case):
    kind, index = case.split("-")
    intervals, window = (HAND_CASES[int(index)] if kind == "hand"
                         else _random_case(int(index)))
    got = critical_path.attribute(intervals, window)
    assert got == ref_cp.attribute(intervals, window)
    assert sum(got["phases"].values()) <= got["window_s"] + 1e-3


def test_record_intervals_match_reference():
    rng = np.random.default_rng(7)
    records = [{"i": f"{i:016x}", "n": NAMES[i % len(NAMES)], "s": float(rng.uniform(0, 100)),
                "d": None if i % 5 == 0 else float(rng.uniform(0, 9))} for i in range(40)]
    assert critical_path.record_intervals(records) == ref_cp.record_intervals(records)


# -- the profiler ----------------------------------------------------------------

class WallClock:
    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def time(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = WallClock()
    for mod in (collector, ref_collector):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=c.time))
    return c


SIDES = {
    "ref": types.SimpleNamespace(mod=ref_collector, tracing=ref_tracing, encode=ref_encode,
                                 node=lambda n: n),
    "port": types.SimpleNamespace(mod=collector, tracing=tracing, encode=encode_annotation,
                                  node=map_node),
}


def _policy(uid="u-1"):
    return types.SimpleNamespace(obj={"metadata": {"name": "cluster-policy", "uid": uid}})


def _node(side, name, schedulable=False, spans=None, prepull=None):
    node = {"metadata": {"name": name, "annotations": {}}, "status": {}}
    if schedulable:
        node["status"]["capacity"] = {ref_consts.TPU_RESOURCE_NAME: "4"}
    if spans is not None:
        node["metadata"]["annotations"][ref_consts.TRACE_SPANS_ANNOTATION] = side.encode(spans)
    if prepull is not None:
        node["metadata"]["annotations"][ref_consts.IMAGE_PREPULL_ANNOTATION] = prepull
    return side.node(node)


def rec(i, s, d=1.0, n="ici-sweep", t="t" * 32, p=""):
    out = {"i": i, "n": n, "s": s, "d": d, "t": t}
    if p:
        out["p"] = p
    return out


def _hand_built_join(side, clock):
    profiler = side.mod.JoinProfiler()
    policy = _policy()
    trace_id, parent_id = side.tracing.parse_traceparent(side.tracing.join_traceparent(policy.obj))
    not_ready, ready = types.SimpleNamespace(ready=False), types.SimpleNamespace(ready=True)
    start = clock.t
    profiler.observe(policy, [_node(side, "n0", prepull=f"{start - 3.0:.3f}")], not_ready)
    clock.t += 4.0
    profiler.observe(policy, [_node(side, "n0")], not_ready)
    clock.t += 2.5
    profiler.observe(policy, [_node(side, "n0", schedulable=True)], ready)
    spans = [
        # the root starts before the first sweep saw the node and a child
        # ends after the join completed: the window covers both
        rec("a" * 16, start - 0.5, d=8.0, n="operand.workload-local", t=trace_id, p=parent_id),
        rec("b" * 16, start + 1.0, d=3.0, n="ici-sweep", t=trace_id, p="a" * 16),
        rec("c" * 16, start + 1.5, d=1.0, n="xla-compile", t=trace_id, p="b" * 16),
        rec("d" * 16, start + 4.5, d=1.5, n="barrier-wait.workload", t=trace_id, p="a" * 16),
        rec("e" * 16, start + 2.0, d=0.2, t="f" * 32, p=parent_id),        # foreign trace
        rec("f" * 16, start + 2.0, d=0.2, t=trace_id, p="9" * 16),         # broken chain
        rec("0" * 16, start + 6.0, d=None, n="operand.sleep", t=trace_id, p=parent_id),
    ]
    clock.t += 1.0
    profiler.observe(policy, [_node(side, "n0", schedulable=True, spans=spans)], ready)
    for d in (0.01, 0.02, 0.03, 1.0, 0.5):
        root = side.tracing.Span("reconcile", kind="reconcile",
                                 attributes={"controller": "clusterpolicy"})
        root.start_unix = start + d
        root.duration_s = d
        profiler.on_trace(root)
    profiler.on_trace(side.tracing.Span("reconcile"))  # unfinished: ignored
    return profiler


def test_the_profiler_stitches_the_reference_s_join(clock):
    t0 = clock.t
    ref = _hand_built_join(SIDES["ref"], clock)
    clock.t = t0
    port = _hand_built_join(SIDES["port"], clock)
    want, got = ref.join_trace("n0"), port.join_trace("n0")
    assert got == want
    assert sorted(got["orphan_spans"]) == ["e" * 16, "f" * 16]
    assert got["window"]["complete"] is True
    assert {"xla-compile", "validation-run", "barrier-handshake"} <= set(
        got["attribution"]["phases"])
    assert port.reconcile_latency() == ref.reconcile_latency()
    assert port.reconcile_latency()["count"] == 5
    assert port.stats() == ref.stats()
    assert port.join_traces(node="n0") == [got] and port.join_traces(node="absent") == []


def test_the_profiler_emits_join_phases_once_per_join(clock):
    metrics = OperatorMetrics()
    profiler = collector.JoinProfiler(metrics=metrics)
    policy = _policy()
    profiler.observe(policy, [_node(SIDES["port"], "n0")], types.SimpleNamespace(ready=False))
    clock.t += 3.0
    node = _node(SIDES["port"], "n0", schedulable=True)
    for _ in range(8):  # no mirrored spans: fed after the grace sweeps
        profiler.observe(policy, [node], types.SimpleNamespace(ready=True))
        clock.t += 1.0
    text = metrics.scrape().decode()
    counts = [line for line in text.splitlines()
              if line.startswith("tpu_operator_join_phase_seconds_count")]
    assert counts and all(line.endswith(" 1.0") for line in counts), counts
