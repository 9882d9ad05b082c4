"""The port's flight recorder and reconcile tracer (tpu_operator_torch/
tracing.py: ``FlightRecorder``, ``Tracer``, ``ensure_trace``,
``install_log_correlation``; the runtime's root trace per reconcile)
against the reference's, twin for twin with tests/test_tracing.py.

Each case runs on both packages and returns what it observed (span names
and kinds, statuses, ring stats, phase-histogram counts, root attributes);
the port's must equal the reference's. The log-correlation case restores
the process's log record factory, which both packages would otherwise
wrap for the rest of the test process.
"""

import logging
import time
import types

import pytest

from tpu_operator import events as ref_events
from tpu_operator import tracing as ref_tracing
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.controllers import runtime as ref_runtime
from tpu_operator.controllers.metrics import OperatorMetrics as RefMetrics
from tpu_operator_torch import events, tracing
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.controllers import runtime
from tpu_operator_torch.controllers.metrics import OperatorMetrics

SIDES = {
    "ref": types.SimpleNamespace(tracing=ref_tracing, runtime=ref_runtime, Metrics=RefMetrics,
                                 Fake=RefFake, events=ref_events),
    "port": types.SimpleNamespace(tracing=tracing, runtime=runtime, Metrics=OperatorMetrics,
                                  Fake=FakeClient, events=events),
}


def phase_count(s, metrics, controller, phase):
    name = "tpu_operator_reconcile_phase_seconds_count"
    if s.Metrics is RefMetrics:
        return metrics.registry.get_sample_value(
            name, {"controller": controller, "phase": phase}) or 0.0
    want = f'{name}{{controller="{controller}",phase="{phase}"}} '
    return next((float(line.split()[-1]) for line in metrics.scrape().decode().splitlines()
                 if line.startswith(want)), 0.0)


def shape(span):
    return {"name": span.name, "kind": span.kind, "status": span.status,
            "attributes": {k: v for k, v in span.attributes.items()
                           if not k.endswith("_s")},
            "children": [shape(c) for c in span.children]}


def case_span_is_noop_outside_trace(s):
    t = s.tracing
    assert t.current_trace_id() is None
    with t.span("orphan") as sp:
        assert sp is t.NOOP_SPAN
        sp.set_attribute("k", "v")
        sp.mark_error("ignored")
    with t.api_span("GET", "/api/v1/nodes") as sp:
        assert sp is t.NOOP_SPAN
    return t.current_trace_id()


def case_trace_builds_span_tree_via_contextvars(s):
    t = s.tracing
    tracer = t.Tracer(t.FlightRecorder(8))
    with tracer.trace("reconcile", controller="c", request="ns/obj") as root:
        assert t.current_trace_id() == root.trace_id
        with t.phase_span("render", pool="p1") as render:
            assert render.parent_id == root.span_id
            with t.api_span("POST", "/apis/apps/v1/daemonsets") as api:
                assert api.parent_id == render.span_id and api.trace_id == root.trace_id
        assert t.current_span() is root
    [recorded] = tracer.recorder.traces()
    assert recorded is root
    d = root.to_dict()
    return [shape(root), sorted(d), d["children"][0]["children"][0]["attributes"]]


def case_exception_marks_trace_failed_and_reraises(s):
    t = s.tracing
    tracer = t.Tracer(t.FlightRecorder(8))
    with pytest.raises(RuntimeError):
        with tracer.trace("reconcile", controller="c", request="bad"):
            with pytest.raises(ValueError):
                with t.span("inner"):
                    raise ValueError("inner fails first")
            raise RuntimeError("then the reconcile body")
    [root] = tracer.recorder.traces()
    assert tracer.recorder.traces(errors_only=True) == [root]
    return [shape(root), root.error, root.children[0].error, root.has_error]


def case_child_error_pins_parent_as_error_trace(s):
    t = s.tracing
    tracer = t.Tracer(t.FlightRecorder(8))
    with tracer.trace("reconcile", controller="c") as root:
        with t.phase_span("status-update") as sp:
            sp.mark_error("409 conflict")
    assert tracer.recorder.traces(errors_only=True) == [root]
    return [root.status, root.has_error, shape(root)]


def case_ring_eviction_keeps_pinned_error_traces(s):
    t = s.tracing
    recorder = t.FlightRecorder(size=4, error_size=2)
    tracer = t.Tracer(recorder)
    with pytest.raises(RuntimeError):
        with tracer.trace("reconcile", controller="c", request="bad"):
            raise RuntimeError("boom")
    error_id = recorder.traces(errors_only=True)[0].trace_id
    for i in range(10):
        with tracer.trace("reconcile", controller="c", request=f"ok-{i}"):
            pass
    ids = [r.trace_id for r in recorder.traces(limit=None)]
    assert error_id in ids, "error trace evicted by healthy reconciles"
    assert recorder.traces(trace_id=error_id)[0].trace_id == error_id
    return [recorder.stats(), [r.attributes["request"] for r in recorder.traces()],
            recorder.traces(controller="c", limit=1)[0].attributes["request"],
            recorder.traces(controller="absent"), t.FlightRecorder(7).stats()]


def case_phase_spans_feed_latency_histogram(s):
    t = s.tracing
    metrics = s.Metrics()
    tracer = t.Tracer(t.FlightRecorder(8), metrics)
    with tracer.trace("reconcile", controller="ctl"):
        for phase in ("render", "render", "apply"):
            with t.phase_span(phase):
                pass
        with t.span("api.get", kind="api"):
            pass
    return [phase_count(s, metrics, "ctl", p) for p in ("render", "apply", "api.get")]


class _FailOnce:
    name = "flaky"

    def __init__(self, result):
        self.calls, self.result = 0, result

    def reconcile(self, request):
        self.calls += 1
        if self.calls == 1:
            raise RuntimeError("transient")
        return self.result()


def case_requeue_mints_new_trace_with_attempt_counter(s):
    t = s.tracing
    metrics = s.Metrics()
    recorder = t.FlightRecorder(16)
    tracer = t.Tracer(recorder, metrics)
    controller = s.runtime.Controller(_FailOnce(s.runtime.Result))
    controller.instrument(metrics, tracer)
    controller.start(s.Fake())
    try:
        controller.queue.add(s.runtime.Request(name="obj"))
        deadline = time.monotonic() + 10
        while len(recorder.traces(controller="flaky")) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        state = controller.debug_state()
    finally:
        controller.stop()
    retry, first = recorder.traces(controller="flaky")
    assert first.trace_id != retry.trace_id
    assert retry.attributes["since_add_s"] >= retry.attributes["queue_wait_s"]
    assert recorder.traces(controller="flaky", errors_only=True) == [first]
    return [shape(first), shape(retry), sorted(state),
            {k: state[k] for k in ("controller", "inflight", "depth_ready", "backoff")}]


def case_event_carries_trace_id_annotation(s):
    t, client = s.tracing, s.Fake()
    node = client.create({"apiVersion": "v1", "kind": "Node",
                          "metadata": {"name": "n1"}, "status": {}})
    tracer = t.Tracer(t.FlightRecorder(8))
    with tracer.trace("reconcile", controller="c") as root:
        event = s.events.record(client, "tpu-operator", node, s.events.WARNING, "Probe",
                                "failed")
    quiet = s.events.record(client, "tpu-operator", node, s.events.WARNING, "Probe",
                            "different message")
    return [event["metadata"]["annotations"][t.TRACE_ID_ANNOTATION] == root.trace_id,
            t.TRACE_ID_ANNOTATION in (quiet["metadata"].get("annotations") or {})]


def case_log_records_carry_trace_id(s):
    t = s.tracing
    factory = logging.getLogRecordFactory()
    captured = []

    class _Capture(logging.Handler):
        def emit(self, record):
            captured.append(record)

    logger = logging.getLogger("test_torch_flight_recorder.correlation")
    handler = _Capture()
    logger.addHandler(handler)
    try:
        t.install_log_correlation()
        t.install_log_correlation()  # idempotent
        tracer = t.Tracer(t.FlightRecorder(8))
        with tracer.trace("reconcile", controller="c") as root:
            logger.warning("inside")
        logger.warning("outside")
    finally:
        logger.removeHandler(handler)
        logging.setLogRecordFactory(factory)
        t._orig_record_factory = None
    return [captured[0].trace_id == root.trace_id, captured[1].trace_id]


def case_ensure_trace_opens_a_recorded_root_outside_a_trace(s):
    """Not in tests/test_tracing.py: the fallback root the reference's
    protocol Events rely on."""
    t = s.tracing
    saved = t.default_tracer()
    tracer = t.Tracer(t.FlightRecorder(8))
    t.set_default_tracer(tracer)
    try:
        with t.ensure_trace("migrate", controller="migrate", node="n1") as root:
            inner = t.current_span()
        with tracer.trace("reconcile", controller="c") as outer:
            with t.ensure_trace("migrate", controller="migrate") as adopted:
                same = adopted is outer
    finally:
        t.set_default_tracer(saved)
    return [inner is root, same, [shape(r) for r in tracer.recorder.traces()]]


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracing_matches_reference(case):
    assert CASES[case](SIDES["port"]) == CASES[case](SIDES["ref"])
