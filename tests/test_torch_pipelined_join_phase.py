"""``chip_smoke.py`` phase 23 (``pipelined_join_phase``) rehearsed on the CPU,
and its join attribution held against the reference's join profiler.

The smoke's own phase: the port's operator in process over a 20 ms
MiniApiServer, the in-memory kubelet without pods (each DaemonSet's image
pulled on its own clock from the labeller's pre-pull stamp, each pod gated
on the barriers its rendered init containers wait on), and the validator's
chain in subprocesses (``--device=cpu`` over a fake device node and a fake
driver bundle) beside a concurrent ``wait --for workload``. The phase's own
checks run; the test asserts its numbers are there.

Then the tape the phase records (every reconcile root and every sweep's
view the operator's join profiler took; the DaemonSets' transitions reach
it as the sweeps' readiness) is played through the port's
``JoinProfiler`` and the reference's (tpu_operator/joinprofile/
collector.py) under one clock: the same phases, seconds and coverage,
within 1e-6 s.
"""

import os
import types

import pytest

from test_torch_opsan_phase import _node
from tpu_operator import consts as ref_consts
from tpu_operator import tracing as ref_tracing
from tpu_operator.joinprofile import collector as ref_collector
from tpu_operator_torch import consts, tracing
from tpu_operator_torch.joinprofile import collector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def phase23(tmp_path_factory):
    import chip_smoke

    tmp = tmp_path_factory.mktemp("pipelined")
    dev = tmp / "nvidia0"
    dev.touch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(consts.GPU_DEV_GLOBS_ENV, str(dev))
        return chip_smoke.pipelined_join_phase(types.SimpleNamespace(
            repo=REPO, work=str(tmp), card="cpu rehearsal", node=_node(tmp), device="cpu"))


def test_phase_23_on_the_cpu(phase23):
    import chip_smoke

    numbers = phase23
    assert numbers["chain_exit_codes"] == {"driver": 0, "plugin": 0, "workload": 0, "wait": 0}
    stamps = numbers["barrier_stamps_s"]
    assert stamps["driver"] <= stamps["plugin"] <= stamps["workload"] <= numbers["join_s"]
    assert numbers["coverage"] >= chip_smoke.PIPELINED_MIN_COVERAGE
    assert numbers["orphan_spans"] == 0 and numbers["complete"] is True
    assert numbers["phases"]["image-prepull"] > 0
    assert numbers["unattributed_s"] >= 0 and numbers["window_s"] > 0
    # the pulls by the rendered names: the validator's 10 ticks, the plugin's
    # 7, the rest 5; the plugin's pod waits for its pull and the driver barrier
    assert numbers["pull_ticks"] == {"gpu-operator-validator": 10, "gpu-device-plugin": 7,
                                     "*": 5}
    available = numbers["ds_available"]
    assert set(available) >= {"gpu-driver", "gpu-operator-validator", "gpu-device-plugin"}
    assert available["gpu-device-plugin"]["tick"] >= 1 + 7
    assert available["gpu-operator-validator"]["tick"] >= 1 + 10
    assert available["gpu-operator-validator"]["s"] >= stamps["workload"]
    # the serial sum of the pulls of the DaemonSets that rolled out (printed
    # beside join_s, not gated): the validator's, the plugin's, four others
    assert numbers["serial_pull_s"] == (10 + 7 + 4 * 5) * chip_smoke.PIPELINED_INTERVAL_S
    assert numbers["sweep"]["elapsed_s"] > 0 and numbers["sweep"]["compile_s"] >= 0
    assert numbers["sweep"]["platform"] == "cpu"
    assert numbers["phase_s"] <= chip_smoke.PIPELINED_BUDGET_S


class _Clock:
    t = 0.0

    def time(self):
        return self.t


def _replay(tape, mod, trace_mod, node_view, clock):
    profiler = mod.JoinProfiler()
    for event in tape:
        if event["kind"] == "trace":
            root = trace_mod.Span("reconcile", kind="reconcile", trace_id=event["trace_id"],
                                  attributes={"controller": event["controller"]})
            root.start_unix = event["start_unix"]
            root.duration_s = event["duration_s"]
            profiler.on_trace(root)
        else:
            clock.t = event["t"]
            profiler.observe(types.SimpleNamespace(obj={"metadata": event["policy"]}),
                             [node_view(n) for n in event["nodes"]],
                             types.SimpleNamespace(ready=event["ready"]))
    return profiler


def _as_reference(node):
    """The port's node view as the reference's: its GPUs as chips."""
    capacity = node["status"]["capacity"]
    return {"metadata": node["metadata"],
            "status": {"capacity": {ref_consts.TPU_RESOURCE_NAME: v
                                    for k, v in capacity.items()
                                    if k == consts.GPU_RESOURCE_NAME}}}


def test_the_phase_s_join_attributes_as_the_reference_s_profiler(phase23, monkeypatch):
    clock = _Clock()
    for mod in (collector, ref_collector):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=clock.time))
    tape = phase23["tape"]
    assert {e["kind"] for e in tape} == {"trace", "observe"}
    assert any(e["kind"] == "observe" and e["ready"] for e in tape)
    [node] = {n["metadata"]["name"] for e in tape if e["kind"] == "observe" for n in e["nodes"]}
    port = _replay(tape, collector, tracing, lambda n: n, clock).join_trace(node)
    ref = _replay(tape, ref_collector, ref_tracing, _as_reference, clock).join_trace(node)
    got, want = port["attribution"], ref["attribution"]
    assert set(got["phases"]) == set(want["phases"])
    for phase, seconds in want["phases"].items():
        assert abs(got["phases"][phase] - seconds) <= 1e-6, phase
    for key in ("coverage", "window_s", "attributed_s", "unattributed_s"):
        assert abs(got[key] - want[key]) <= 1e-6, key
    assert port["window"] == ref["window"]
    assert port["orphan_spans"] == ref["orphan_spans"] == []
    assert len(port["node_spans"]) == len(ref["node_spans"]) == phase23["node_spans"]
    # and the replay is the phase's own reading (the tape's sweep times are
    # taken as each observation begins: microseconds before the profiler's)
    assert set(got["phases"]) == set(phase23["phases"])
    assert abs(got["coverage"] - phase23["coverage"]) <= 1e-3
