"""Spans for the validator's components and the operator, and the
operator's flight recorder (counterpart of tpu_operator/tracing.py).

OTel-style spans with no external dependency. The operator stamps a
traceparent into every operand pod (``$GPU_TRACE_PARENT``); the component's
entry point opens a root span continuing that trace (:func:`remote_trace`)
and its work opens child spans (:func:`span`), or attaches an interval it
measured itself (:func:`record_span`). The root's sink writes the subtree
to the node's span log (``joinprofile/records.py``), from which feature
discovery mirrors it to the node for the operator's join profiler.

In the operator, the runtime's worker opens one root span per reconcile
(:meth:`Tracer.trace`), reconcilers open phase spans and the clients API
spans. Finished traces land in a bounded :class:`FlightRecorder` (the last
N traces, error traces pinned in a quarter-sized ring of their own), behind
``/debug/traces``; phase spans feed
``tpu_operator_reconcile_phase_seconds``; :func:`install_log_correlation`
adds the active trace id to every log record.

Propagation rides :mod:`contextvars`: outside an active trace every call is
a free no-op, and the loss is counted (:func:`dropped_spans_total`).

While ``torch.profiler`` records, every span is also a ``record_function``
range of the same name, trace or no trace, so a device trace names the
host's work after the program's own spans; :func:`mark` adds such a range
alone, for steps too fine for the span log. The module never imports
torch: with torch not loaded no profiler can be on. Process-wide counters
(:func:`count`, :func:`counters`) add up whether or not a trace is active;
the dropped-span count is one of them.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import sys
import time
import uuid
from collections import deque
from typing import Dict, Iterator, List, Optional

from .consts import TRACE_ID_ANNOTATION, TRACE_PARENT_ENV  # noqa: F401  (re-exported)
from .utils.locks import make_lock, register_shared

#: the flight recorder's default capacity (``--trace-buffer-size``)
DEFAULT_BUFFER_SIZE = 256

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "tpu_operator_torch_current_span", default=None)

#: active remote-trace sink: ``(root, sink)`` set by :func:`remote_trace` so
#: long-running loops can checkpoint-publish via :func:`flush_spans`
_remote_sink: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "tpu_operator_torch_remote_sink", default=None)

#: process-wide counters, name -> total since the process started
_counters_lock = make_lock("tracing._counters_lock")
_counters: Dict[str, float] = {}

#: the counter of spans discarded because no trace was active on the
#: calling thread
DROPPED_SPANS = "tracing.dropped_spans"


def count(name: str, value: float = 1) -> None:
    """Add ``value`` to the process-wide counter ``name``."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + value


def counters() -> Dict[str, float]:
    """A snapshot of every counter, name -> total."""
    with _counters_lock:
        return dict(_counters)


def dropped_spans_total() -> int:
    with _counters_lock:
        return _counters.get(DROPPED_SPANS, 0)


#: torch's profiler check and ``record_function``, looked up once torch is
#: loaded
_profiler_hooks = None
_NO_RANGE = contextlib.nullcontext()


def mark(name: str):
    """A ``record_function`` range named ``name`` while ``torch.profiler``
    records, else a no-op: never a span, a span-log record or a dropped
    span. For steps inside a span that only a device trace needs named."""
    global _profiler_hooks
    hooks = _profiler_hooks
    if hooks is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return _NO_RANGE
        try:
            hooks = (torch._C._autograd._profiler_enabled,
                     torch.autograd.profiler.record_function)
        except AttributeError:  # torch is still being imported
            return _NO_RANGE
        _profiler_hooks = hooks
    enabled, record_function = hooks
    return record_function(name) if enabled() else _NO_RANGE


def _new_id(nbytes: int) -> str:
    return uuid.uuid4().hex[: nbytes * 2]


# Simplified traceparent: ``<trace_id:32 hex>-<span_id:16 hex>`` (the W3C
# format minus version and flags, which nothing here reads).

def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"{trace_id}-{span_id}"


def parse_traceparent(value: Optional[str]):
    """``(trace_id, span_id)``, or None for anything malformed: bad context
    from an older or foreign manifest degrades to untraced, never crashes
    an operand entry point."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 2:
        return None
    trace_id, span_id = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return trace_id, span_id


def stable_traceparent(seed: str) -> str:
    """Deterministic traceparent for a seed string (sha256-derived): the
    same policy always yields the same join trace id, so node-side spans
    from any sweep stitch into one join trace."""
    import hashlib

    h = hashlib.sha256(seed.encode()).hexdigest()
    return format_traceparent(h[:32], h[32:48])


def join_traceparent(policy_obj: dict) -> str:
    """The join traceparent the operator stamps into every operand pod of
    a ClusterPolicy (uid-keyed, name fallback where no uid was minted)."""
    meta = (policy_obj or {}).get("metadata", {}) or {}
    return stable_traceparent(f"join:{meta.get('uid') or meta.get('name', '')}")


class Span:
    """One timed operation in a tree under a root span; children in start
    order. A trace lives on the thread that opened it."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind",
                 "attributes", "status", "error", "start_unix", "_t0",
                 "duration_s", "children")

    def __init__(self, name: str, kind: str = "internal",
                 trace_id: Optional[str] = None,
                 parent: Optional["Span"] = None,
                 attributes: Optional[dict] = None):
        self.name = name
        self.kind = kind
        self.trace_id = trace_id or (parent.trace_id if parent else _new_id(16))
        self.span_id = _new_id(8)
        self.parent_id = parent.span_id if parent else None
        self.attributes: Dict[str, object] = dict(attributes or {})
        self.status = "unset"
        self.error: Optional[str] = None
        self.start_unix = time.time()
        self._t0 = time.perf_counter()
        self.duration_s: Optional[float] = None
        self.children: List[Span] = []

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def set_attributes(self, **attrs) -> None:
        self.attributes.update(attrs)

    def finish(self, error: Optional[BaseException] = None) -> None:
        if self.duration_s is not None:
            return  # idempotent: a double finish keeps the first timing
        self.duration_s = time.perf_counter() - self._t0
        if error is not None:
            self.status = "error"
            self.error = f"{type(error).__name__}: {error}"
        elif self.status == "unset":
            self.status = "ok"

    def mark_error(self, message: str) -> None:
        self.status = "error"
        self.error = message

    @property
    def has_error(self) -> bool:
        return self.status == "error" or any(c.has_error for c in self.children)

    def walk(self) -> Iterator["Span"]:
        yield self
        for child in self.children:
            yield from child.walk()

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_unix": self.start_unix,
            "duration_s": self.duration_s,
            "status": self.status,
            "error": self.error,
            "attributes": self.attributes,
            "children": [c.to_dict() for c in self.children],
        }


class _NoopSpan:
    """Returned outside a trace: every recording call is a cheap no-op, so
    component code never needs a guard."""

    __slots__ = ()
    trace_id = None
    span_id = None
    status = "unset"
    attributes: dict = {}

    def set_attribute(self, key, value):
        pass

    def set_attributes(self, **attrs):
        pass

    def mark_error(self, message):
        pass

    def finish(self, error=None):
        pass


NOOP_SPAN = _NoopSpan()


def current_span() -> Optional[Span]:
    """The active span on this thread, or None outside a trace."""
    return _current_span.get()


@contextlib.contextmanager
def span(name: str, kind: str = "internal", **attributes):
    """A child span of the active span; a counted no-op outside a trace."""
    with mark(name):
        parent = _current_span.get()
        if parent is None:
            count(DROPPED_SPANS)
            yield NOOP_SPAN
            return
        child = Span(name, kind=kind, parent=parent, attributes=attributes)
        parent.children.append(child)
        token = _current_span.set(child)
        try:
            yield child
        except BaseException as e:
            child.finish(error=e)
            raise
        else:
            child.finish()
        finally:
            _current_span.reset(token)


@contextlib.contextmanager
def ensure_trace(name: str, controller: str, **attributes):
    """The active span, or, outside a trace, a fallback root on the default
    tracer: Events recorded off the runtime's worker (a reconciler driven
    directly, a timer thread) still carry ``tpu.ai/trace-id``."""
    current = _current_span.get()
    if current is not None:
        yield current
        return
    with _default_tracer.trace(name, controller=controller, **attributes) as root:
        yield root


def phase_span(phase: str, **attributes):
    """A reconcile-phase child span (label-nodes, sync-state, status-update)."""
    return span(phase, kind="phase", phase=phase, **attributes)


def api_span(verb: str, path: str, **attributes):
    """An apiserver call child span."""
    return span(f"api.{verb.lower()}", kind="api", verb=verb, path=path, **attributes)


def current_trace_id() -> Optional[str]:
    """The active trace's id, or None outside a trace."""
    sp = _current_span.get()
    return sp.trace_id if sp is not None else None


def record_span(name: str, start_unix: float, duration_s: float,
                kind: str = "internal", **attributes):
    """Attach an interval measured elsewhere (a report's ``compile_s``) as
    a finished child of the active span; a counted no-op outside a trace."""
    parent = _current_span.get()
    if parent is None:
        count(DROPPED_SPANS)
        return NOOP_SPAN
    child = Span(name, kind=kind, parent=parent, attributes=attributes)
    child.start_unix = float(start_unix)
    child.duration_s = float(duration_s)
    child.status = "ok"
    parent.children.append(child)
    return child


@contextlib.contextmanager
def remote_trace(name: str, traceparent: Optional[str] = None,
                 sink=None, **attributes):
    """A ROOT span continuing a trace that another process (the operator)
    started, from a ``<trace_id>-<span_id>`` traceparent; a free no-op
    without parseable context.

    ``sink(root)`` is called with the open root at entry and again at exit
    (and by :func:`flush_spans` from inside loops), so components that never
    exit still publish their spans. A failing sink is logged and ignored:
    span publication never fails a validation."""
    with mark(name):
        parsed = parse_traceparent(traceparent)
        if parsed is None:
            yield NOOP_SPAN
            return
        trace_id, parent_span_id = parsed
        root = Span(name, kind="remote", trace_id=trace_id, attributes=attributes)
        root.parent_id = parent_span_id
        token = _current_span.set(root)
        sink_token = _remote_sink.set((root, sink))
        _flush(root, sink)
        try:
            yield root
        except BaseException as e:
            root.finish(error=e)
            raise
        else:
            root.finish()
        finally:
            _current_span.reset(token)
            _remote_sink.reset(sink_token)
            _flush(root, sink)


def _flush(root, sink) -> None:
    if sink is None:
        return
    try:
        sink(root)
    except Exception:  # best-effort: a read-only mount must not break operands
        logging.getLogger(__name__).debug("span sink failed", exc_info=True)


def flush_spans() -> None:
    """Publish the active remote trace through its sink now: the loop
    components (revalidation, serving re-probe, feature discovery) call
    this each pass, since a DaemonSet's main container never exits."""
    active = _remote_sink.get()
    if active is not None:
        _flush(*active)


class FlightRecorder:
    """Bounded rings of finished traces (root spans): the last ``size``
    whatever their outcome, and error traces also in a ring of their own
    (``error_size``, a quarter by default), so a run of healthy reconciles
    cannot evict the one failure being debugged."""

    def __init__(self, size: int = DEFAULT_BUFFER_SIZE,
                 error_size: Optional[int] = None):
        self.size = max(1, int(size))
        self.error_size = max(1, int(error_size if error_size is not None
                                     else self.size // 4 or 1))
        self._lock = make_lock("FlightRecorder._lock")
        self._traces: deque = register_shared(
            "FlightRecorder._traces", deque(maxlen=self.size))
        self._errors: deque = register_shared(
            "FlightRecorder._errors", deque(maxlen=self.error_size))
        self.recorded_total = 0
        self.error_total = 0

    def record(self, root: Span) -> None:
        with self._lock:
            self.recorded_total += 1
            self._traces.append(root)
            if root.has_error:
                self.error_total += 1
                self._errors.append(root)

    def traces(self, controller: Optional[str] = None,
               errors_only: bool = False,
               trace_id: Optional[str] = None,
               limit: Optional[int] = None) -> List[Span]:
        """Both rings merged, newest first, each trace once."""
        with self._lock:
            merged: Dict[str, Span] = {}
            for root in list(self._traces) + list(self._errors):
                merged[root.trace_id] = root
        out = sorted(merged.values(), key=lambda r: r.start_unix, reverse=True)
        if controller:
            out = [r for r in out if r.attributes.get("controller") == controller]
        if errors_only:
            out = [r for r in out if r.has_error]
        if trace_id:
            out = [r for r in out if r.trace_id == trace_id]
        if limit is not None:
            out = out[:max(0, int(limit))]
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.size,
                "error_capacity": self.error_size,
                "buffered": len(self._traces),
                "buffered_errors": len(self._errors),
                "recorded_total": self.recorded_total,
                "error_total": self.error_total,
            }


class Tracer:
    """Opens root spans and hands each finished one to the recorder, the
    phase histogram and ``on_finalize`` (the join profiler's feed). One per
    operator process, shared by every controller; a trace itself stays on
    the thread that opened it."""

    def __init__(self, recorder: Optional[FlightRecorder] = None, metrics=None):
        self.recorder = recorder or FlightRecorder()
        self.metrics = metrics
        #: called with every finished root span; must never raise into a
        #: reconcile (a failure is logged and dropped)
        self.on_finalize = None

    @contextlib.contextmanager
    def trace(self, name: str, controller: str, **attributes):
        """A ROOT span (a fresh trace); what the body raises is re-raised
        after the trace is marked failed."""
        root = Span(name, kind="reconcile",
                    attributes={"controller": controller, **attributes})
        token = _current_span.set(root)
        try:
            with mark(name):
                yield root
        except BaseException as e:
            root.finish(error=e)
            raise
        else:
            root.finish()
        finally:
            _current_span.reset(token)
            self._finalize(root)

    def _finalize(self, root: Span) -> None:
        self.recorder.record(root)
        if self.on_finalize is not None:
            try:
                self.on_finalize(root)
            except Exception:  # telemetry never breaks a reconcile
                logging.getLogger(__name__).debug("trace finalize hook failed",
                                                  exc_info=True)
        if self.metrics is None:
            return
        controller = str(root.attributes.get("controller", ""))
        for sp in root.walk():
            if sp.kind == "phase" and sp.duration_s is not None:
                self.metrics.reconcile_phase.labels(
                    controller=controller,
                    phase=str(sp.attributes.get("phase", sp.name)),
                ).observe(sp.duration_s)


#: the process's tracer for code with no wiring of its own; the operator
#: app replaces it with one bound to its metrics and sized recorder
_default_tracer = Tracer()


def default_tracer() -> Tracer:
    return _default_tracer


def set_default_tracer(tracer: Tracer) -> None:
    global _default_tracer
    _default_tracer = tracer


_orig_record_factory = None


def install_log_correlation() -> None:
    """Stamp ``record.trace_id`` (``-`` outside a trace) on every log
    record, so a format can hold ``%(trace_id)s``. Idempotent."""
    global _orig_record_factory
    if _orig_record_factory is not None:
        return
    _orig_record_factory = logging.getLogRecordFactory()

    def factory(*args, **kwargs):
        record = _orig_record_factory(*args, **kwargs)
        record.trace_id = current_trace_id() or "-"
        return record

    logging.setLogRecordFactory(factory)
