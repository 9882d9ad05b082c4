"""Join-trace spans of the PyTorch port (tpu_operator_torch/tracing.py,
joinprofile/records.py and the spans in validator/main.py) against the JAX
package's: the same records, ids and times aside, that the operator's join
profiler decodes and charges to the same phases."""

import json
import os

import pytest

from tpu_operator import tracing as ref_tracing
from tpu_operator.client import FakeClient
from tpu_operator.joinprofile import critical_path
from tpu_operator.joinprofile import records as ref_records
from tpu_operator.validator import main as ref_main
from tpu_operator.validator import perf as ref_perf
from tpu_operator.validator import plugin as ref_plugin
from tpu_operator.validator import serving as ref_serving
from tpu_operator.validator import workload as ref_workload
from tpu_operator.validator.status import StatusFiles as RefStatusFiles
from tpu_operator_torch import tracing
from tpu_operator_torch.joinprofile import records
from tpu_operator_torch.validator import main as vmain
from tpu_operator_torch.validator import perf as port_perf
from tpu_operator_torch.validator import plugin as port_plugin
from tpu_operator_torch.validator import serving as port_serving
from tpu_operator_torch.validator import workload as port_workload

TRACE_ID = "0123456789abcdef0123456789abcdef"
PARENT = "fedcba9876543210"


@pytest.mark.parametrize("value", [
    f"{TRACE_ID}-{PARENT}", f" {TRACE_ID}-{PARENT}\n", None, "", "abc",
    f"{TRACE_ID}-{PARENT}-01", f"{TRACE_ID[:-1]}-{PARENT}", f"{TRACE_ID}-{PARENT}0",
    f"{TRACE_ID[:-1]}g-{PARENT}", 12,
])
def test_parse_traceparent_matches_reference(value):
    assert tracing.parse_traceparent(value) == ref_tracing.parse_traceparent(value)
    if ref_tracing.parse_traceparent(value):
        assert tracing.format_traceparent(*tracing.parse_traceparent(value)) == \
            ref_tracing.format_traceparent(*ref_tracing.parse_traceparent(value))


def _tree(mod):
    """The same span tree built with either package's tracing module."""
    captured = []
    with mod.remote_trace("operand.x", traceparent=f"{TRACE_ID}-{PARENT}",
                          sink=lambda root: captured.append(root), component="x") as root:
        with mod.span("outer", dim=4, blob={"dropped": True}) as sp:
            sp.set_attribute("passed", True)
            mod.record_span("xla-compile", 100.0, 0.5)
            with mod.span("inner", ratio=0.5, none=None):
                pass
        with pytest.raises(ValueError):
            with mod.span("fails"):
                raise ValueError("boom")
        root.set_attribute("exit_code", 3)
    return captured


def _shape(recs):
    """Records with each parent id replaced by the parent's name, start and
    duration dropped, in name order (the span log orders by start time,
    and a pre-measured span may start before its parent)."""
    names = {r["i"]: r["n"] for r in recs}
    return sorted(({"n": r["n"], "p": names.get(r["p"], r["p"]), "t": r["t"], "st": r["st"],
                    "a": r["a"], "open": r["d"] is None} for r in recs),
                  key=lambda r: (r["n"], r["p"]))


def test_span_records_match_reference():
    port, ref = _tree(tracing), _tree(ref_tracing)
    assert len(port) == len(ref) == 2  # the open root at entry, the tree at exit
    for p_root, r_root in zip(port, ref):
        p_recs, r_recs = records.span_to_records(p_root), ref_records.span_to_records(r_root)
        assert _shape(p_recs) == _shape(r_recs)
    final = records.span_to_records(port[1])
    assert [r["n"] for r in final] == ["operand.x", "outer", "xla-compile", "inner", "fails"]
    assert final[0]["p"] == PARENT and final[0]["a"]["exit_code"] == 3
    assert final[2]["s"] == 100.0 and final[2]["d"] == 0.5
    assert final[4]["st"] == "error"
    assert port[1].children[1].error == ref[1].children[1].error == "ValueError: boom"


def test_no_trace_is_a_counted_noop(tmp_path):
    before = tracing.dropped_spans_total()
    with tracing.span("orphan") as sp:
        sp.set_attribute("x", 1)
    assert tracing.record_span("orphan", 0.0, 1.0) is tracing.NOOP_SPAN
    assert tracing.dropped_spans_total() == before + 2
    log = records.SpanLog(str(tmp_path))
    with tracing.remote_trace("operand.x", traceparent="garbage", sink=log.sink()) as root:
        assert root is tracing.NOOP_SPAN
    assert not os.path.exists(log.path)


def test_failing_sink_never_fails_the_component():
    def sink(_root):
        raise OSError("read-only file system")

    with tracing.remote_trace("operand.x", traceparent=f"{TRACE_ID}-{PARENT}",
                              sink=sink) as root:
        tracing.flush_spans()
    assert root.status == "ok"


def _records(n, start=1000.0, name="s"):
    return [{"i": f"{k:016x}", "p": "", "t": TRACE_ID, "n": f"{name}{k}", "s": start + k,
             "d": 0.5, "st": "ok", "a": {"k": k}} for k in range(n)]


@pytest.mark.parametrize("n,max_records,max_bytes", [
    (0, 64, 16384), (3, 64, 16384), (100, 64, 16384), (40, 64, 1000), (5, 2, 16384),
    (5, 64, 10),
])
def test_annotation_codec_matches_reference(n, max_records, max_bytes):
    recs = _records(n) + [{"bad": 1}, "x"]
    encoded = records.encode_annotation(recs, max_records, max_bytes)
    assert encoded == ref_records.encode_annotation(recs, max_records, max_bytes)
    assert records.decode_annotation(encoded) == ref_records.decode_annotation(encoded)
    assert len(encoded.encode()) <= max_bytes


@pytest.mark.parametrize("value", [None, "", "{", "[1, 2]", '{"a": 1}',
                                   json.dumps(_records(2) + [{"i": 3}])])
def test_annotation_decode_matches_reference(value):
    assert records.decode_annotation(value) == ref_records.decode_annotation(value)


def test_span_log_matches_reference(tmp_path):
    port_log = records.SpanLog(str(tmp_path / "port"))
    ref_log = ref_records.SpanLog(str(tmp_path / "ref"))
    assert port_log.path.endswith("trace-spans.json") and records.MAX_LOG_RECORDS == 200
    first = _records(150)
    again = _records(150, start=2000.0, name="t")  # same ids: new wins
    more = [dict(r, i=f"{k + 500:016x}") for k, r in enumerate(_records(120, start=3000.0))]
    for batch in (first, again, more):
        assert port_log.append(batch) and ref_log.append(batch)
        assert port_log.read() == ref_log.read()
    assert len(port_log.read()) == 200
    for content in ("{torn", "[1, 2]", "\x00\xff", '{"a": 1}'):
        for log in (port_log, ref_log):
            with open(log.path, "w", errors="surrogateescape") as f:
                f.write(content)
        assert port_log.read() == ref_log.read() == []


class _Report:
    def __init__(self, passed=True, compile_s=0.25):
        self.passed = passed
        self.compile_s = compile_s

    def to_dict(self):
        return {"passed": self.passed, "n_devices": 1, "platform": "cpu",
                "elapsed_s": 0.5, "compile_s": self.compile_s, "details": {}}


def _stub_both(monkeypatch):
    """Stub every component's work in both packages alike."""
    warm = {"compile_s": 0.25, "cache_dir": "/cache", "n_devices": 1}
    for perf, plugin, serving, workload in ((ref_perf, ref_plugin, ref_serving, ref_workload),
                                            (port_perf, port_plugin, port_serving,
                                             port_workload)):
        monkeypatch.setattr(workload, "ici_health_check", lambda **kw: _Report())
        monkeypatch.setattr(workload, "run_multihost", lambda *a, **kw: _Report(False))
        monkeypatch.setattr(workload, "prewarm_compile_cache", lambda **kw: dict(warm))
        monkeypatch.setattr(workload, "spawn_workload_pod", lambda *a, **kw: True)
        monkeypatch.setattr(plugin, "validate", lambda *a, **kw: True)
        monkeypatch.setattr(perf, "run_perf", lambda **kw: _Report())
        monkeypatch.setattr(serving, "run_serving", lambda *a, **kw: 1)


COMPONENTS = {
    "driver": ["--no-require-devices"],
    "plugin": [],
    "plugin-prewarm": ["--prewarm"],
    "workload": [],
    "workload-local": ["--matrix-dim=64"],
    "workload-multihost": ["--coordinator=localhost:1"],
    "prewarm": [],
    "perf": [],
    "serving": [],
    "wait": ["--for=driver", "--timeout=0.1"],
}


@pytest.mark.parametrize("component", sorted(COMPONENTS))
def test_component_spans_match_reference(component, tmp_path, monkeypatch):
    _stub_both(monkeypatch)
    monkeypatch.setenv("NODE_NAME", "node-a")
    monkeypatch.setenv("VALIDATOR_IMAGE", "img")
    monkeypatch.setenv("TPU_TRACE_PARENT", f"{TRACE_ID}-{PARENT}")
    monkeypatch.setenv("GPU_TRACE_PARENT", f"{TRACE_ID}-{PARENT}")
    install = tmp_path / "lib"
    install.mkdir()
    (install / "libtpu.so").write_bytes(b"\x7fELF fake")
    (install / "libcuda.so.1").write_bytes(b"\x7fELF fake")
    name = component.split("-prewarm")[0]
    argv = ["-c", name, f"--install-dir={install}", "--resource=nvidia.com/gpu",
            *COMPONENTS[component]]
    logs = {}
    for side, run in (("ref", ref_main.run), ("port", vmain.run)):
        status_dir = str(tmp_path / side)
        RefStatusFiles(status_dir).write("driver")
        extra = ["--device=cpu"] if side == "port" else []
        rc = run(argv + [f"--status-dir={status_dir}"] + extra, client=FakeClient())
        logs[side] = (rc, ref_records.SpanLog(status_dir).read())
    (ref_rc, ref_recs), (port_rc, port_recs) = logs["ref"], logs["port"]
    assert port_rc == ref_rc
    assert port_recs and _shape(port_recs) == _shape(ref_recs)
    assert port_recs[0]["n"] == f"operand.{name}"
    # the operator's join profiler reads the port's annotation and charges
    # every span to the phase it charges the reference's span of that name
    decoded = ref_records.decode_annotation(records.encode_annotation(port_recs))
    assert decoded == port_recs
    assert sorted((r["n"], critical_path.phase_of(r["n"])) for r in decoded) == \
        sorted((r["n"], critical_path.phase_of(r["n"])) for r in ref_recs)
    assert sorted(p for p, _, _ in critical_path.record_intervals(decoded)) == \
        sorted(p for p, _, _ in critical_path.record_intervals(ref_recs))


def test_xla_compile_span_carries_the_sweeps_set_up(tmp_path, monkeypatch):
    """On the card the xla-compile child is the sweep's own set-up window
    (its compile_s), charged by the join profiler to xla-compile."""
    monkeypatch.setattr(port_workload, "ici_health_check",
                        lambda **kw: _Report(compile_s=1.5))
    monkeypatch.setenv("GPU_TRACE_PARENT", f"{TRACE_ID}-{PARENT}")
    vmain.run(["-c", "workload-local", "--device=cpu", f"--status-dir={tmp_path}"])
    recs = {r["n"]: r for r in records.SpanLog(str(tmp_path)).read()}
    assert recs["xla-compile"]["d"] == 1.5
    assert recs["xla-compile"]["p"] == recs["ici-sweep"]["i"]
    assert critical_path.phase_of("xla-compile") == "xla-compile"


# -- profiler ranges, marks and counters (the port's own) ----------------------

def _profiled(body):
    """``body()`` under ``torch.profiler`` with CPU activity: the user
    annotations it recorded, ``(name, start_ns, end_ns)`` in start order."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body()
    events = prof.profiler.kineto_results.events()
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.device_type() == torch.autograd.DeviceType.CPU
                   and e.is_user_annotation()), key=lambda r: r[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("traced", [True, False], ids=["in-a-trace", "no-trace"])
def test_spans_and_marks_are_profiler_ranges_of_the_same_name(traced):
    captured = []

    def body():
        with tracing.remote_trace("operand.x", f"{TRACE_ID}-{PARENT}" if traced else None,
                                  sink=captured.append):
            with tracing.span("perf.sweep"):
                with tracing.span("perf.gemm"):
                    with tracing.mark("perf.chain.probe"):
                        pass
                with tracing.mark("validator.report"):
                    pass

    ranges = _profiled(body)
    by_name = {name: (name, s, e) for name, s, e in ranges}
    assert [r[0] for r in ranges] == ["operand.x", "perf.sweep", "perf.gemm",
                                      "perf.chain.probe", "validator.report"]
    assert _inside(by_name["perf.sweep"], by_name["operand.x"])
    assert _inside(by_name["perf.gemm"], by_name["perf.sweep"])
    assert _inside(by_name["perf.chain.probe"], by_name["perf.gemm"])
    assert _inside(by_name["validator.report"], by_name["perf.sweep"])
    assert not _inside(by_name["validator.report"], by_name["perf.gemm"])
    # the marks never reach the span tree, traced or not
    names = [r["n"] for r in records.span_to_records(captured[-1])] if traced else []
    assert names == (["operand.x", "perf.sweep", "perf.gemm"] if traced else [])


def test_the_operators_traces_are_profiler_ranges_too():
    def body():
        with tracing.Tracer().trace("reconcile", controller="c"):
            with tracing.phase_span("label-nodes"):
                pass

    assert [r[0] for r in _profiled(body)] == ["reconcile", "label-nodes"]


def test_with_the_profiler_off_nothing_is_recorded():
    assert tracing.mark("perf.chain.probe") is tracing.mark("perf.operands")
    with tracing.mark("before"):
        pass
    assert [r[0] for r in _profiled(lambda: None)] == []


def test_tracing_loads_no_torch_and_marks_cost_nothing_without_it():
    import subprocess
    import sys

    script = (
        "import sys\n"
        "from tpu_operator_torch import tracing\n"
        "with tracing.mark('m'):\n"
        "    with tracing.span('s'):\n"
        "        tracing.count('c', 2)\n"
        "assert 'torch' not in sys.modules, 'tracing loaded torch'\n"
        "assert tracing.counters()['c'] == 2 and tracing.dropped_spans_total() == 1\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", script], cwd=repo, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr


def test_a_mark_never_enters_the_span_tree_or_the_dropped_count():
    captured = []
    before = tracing.dropped_spans_total()
    with tracing.mark("outside"):
        pass
    with tracing.remote_trace("operand.x", f"{TRACE_ID}-{PARENT}", sink=captured.append) as root:
        with tracing.mark("perf.operands"):
            with tracing.span("perf.hbm") as sp:
                with tracing.mark("perf.chain.sample"):
                    pass
    assert tracing.dropped_spans_total() == before
    assert [c.name for c in root.children] == ["perf.hbm"] and sp.children == []
    assert [r["n"] for r in records.span_to_records(captured[-1])] == ["operand.x", "perf.hbm"]


def test_counters_add_up_and_snapshot():
    before = tracing.counters()
    tracing.count("test.a")
    tracing.count("test.a", 2.5)
    tracing.count("test.b", 0)
    with tracing.span("orphan"):
        pass
    snap = tracing.counters()
    assert snap["test.a"] == before.get("test.a", 0) + 3.5
    assert snap["test.b"] == before.get("test.b", 0)
    assert snap[tracing.DROPPED_SPANS] == tracing.dropped_spans_total() == \
        before.get(tracing.DROPPED_SPANS, 0) + 1
    snap["test.a"] = -1.0  # a snapshot, not the registry
    assert tracing.counters()["test.a"] == before.get("test.a", 0) + 3.5


def test_counters_lose_no_update_across_threads():
    import sys
    import threading

    threads, per_thread = 16, 2000
    before = tracing.counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [tracing.count("test.threads")
                                                    for _ in range(per_thread)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert tracing.counters()["test.threads"] == before + threads * per_thread
