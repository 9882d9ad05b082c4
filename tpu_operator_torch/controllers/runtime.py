"""Minimal controller-runtime: workqueue + watches + single-flight workers
(copy of tpu_operator/controllers/runtime.py).

Each served request runs under one root trace of the operator's
:class:`~..tracing.Tracer` (attempt, queue wait and back-off on the root's
attributes); the queue and the controller describe themselves for
``/debug/queue`` (:meth:`Controller.debug_state`).

An open circuit breaker (:class:`~..client.errors.BreakerOpenError`) and
the write fence (:class:`~..client.errors.FencedError`) are not reconcile
errors: the request is requeued with no error count and no back-off growth.

The scheduling model copies what the reference actually relies on from
controller-runtime (SURVEY.md 5.2/5.3): one worker per controller
(MaxConcurrentReconciles=1), request dedup in the queue, exponential
per-item backoff 100ms-3s on error, and explicit requeue-after support
(clusterpolicy_controller.go:51-52,165,193).
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..client.errors import BreakerOpenError, FencedError
from ..client.interface import Client, WatchEvent

log = logging.getLogger(__name__)

BASE_BACKOFF = 0.1
MAX_BACKOFF = 3.0


@dataclasses.dataclass(frozen=True)
class Request:
    name: str
    namespace: str = ""


@dataclasses.dataclass
class Result:
    requeue_after: Optional[float] = None


class Reconciler:
    name = "reconciler"

    def reconcile(self, request: Request) -> Result:
        raise NotImplementedError


class RateLimitingQueue:
    """Deduplicating delay queue with per-item exponential backoff."""

    def __init__(self):
        self._cond = threading.Condition()
        self._heap: List[Tuple[float, int, Request]] = []
        self._due: Dict[Request, float] = {}  # pending requests -> earliest due time
        self._added: Dict[Request, float] = {}  # pending requests -> first add time
        self._failures: Dict[Request, int] = {}
        self._seq = 0
        self._shutdown = False
        self._metrics = None  # OperatorMetrics, set via instrument()
        self._name = ""
        # for the worker's root span (one consumer): the ready-but-unserved
        # wait of the request the last get() returned, and its whole
        # add-to-get latency, deliberate delay included
        self.last_wait = 0.0
        self.last_since_add = 0.0

    def instrument(self, metrics, name: str) -> None:
        """Attach workqueue metrics (controller-runtime's workqueue family).
        Depth is a scrape-time callback, not a mutation-time set: a delayed
        requeue that becomes due while the worker is busy elsewhere must
        show up as backlog at the next scrape even though no queue mutation
        happened — otherwise the workqueue backlog alert under-reports ready-but-unserved items in quiet clusters."""
        self._metrics = metrics
        self._name = name
        metrics.workqueue_depth.labels(name=name).set_function(self._due_depth)

    def _due_depth(self) -> int:
        """client-go semantics: depth counts only the ACTIVE queue. Items
        sleeping out a requeue_after/backoff delay are not backlog — a
        healthy idle operator with periodic resyncs must read depth 0, not
        one per controller forever (any depth>0 alert would never clear)."""
        now = time.monotonic()
        with self._cond:
            return sum(1 for d in self._due.values() if d <= now)

    def add(self, request: Request, delay: float = 0.0) -> None:
        """Enqueue; re-adding a pending request keeps the EARLIER due time
        (an immediate watch event must not wait out a pending slow requeue)."""
        due = time.monotonic() + delay
        with self._cond:
            if self._shutdown:
                return
            current = self._due.get(request)
            if current is not None and current <= due:
                return
            if request not in self._due:
                self._added[request] = time.monotonic()
                if self._metrics is not None:
                    self._metrics.workqueue_adds.labels(name=self._name).inc()
            self._due[request] = due
            self._seq += 1
            heapq.heappush(self._heap, (due, self._seq, request))
            self._cond.notify()

    def add_rate_limited(self, request: Request) -> None:
        failures = self._failures.get(request, 0)
        self._failures[request] = failures + 1
        if self._metrics is not None:
            self._metrics.workqueue_retries.labels(name=self._name).inc()
        self.add(request, min(BASE_BACKOFF * (2 ** failures), MAX_BACKOFF))

    def forget(self, request: Request) -> None:
        self._failures.pop(request, None)

    def failures_for(self, request: Request) -> int:
        with self._cond:
            return self._failures.get(request, 0)

    @staticmethod
    def _request_key(request: Request) -> str:
        return f"{request.namespace}/{request.name}" if request.namespace else request.name

    def debug_state(self) -> dict:
        """``/debug/queue``: each pending request's due time, split into
        the ready backlog and deliberate delays, and the back-off counts."""
        now = time.monotonic()
        with self._cond:
            pending = [
                {"request": self._request_key(r),
                 "due_in_s": round(max(0.0, d - now), 3),
                 "ready": d <= now}
                for r, d in sorted(self._due.items(), key=lambda item: item[1])
            ]
            return {
                "depth_ready": sum(1 for p in pending if p["ready"]),
                "delayed": sum(1 for p in pending if not p["ready"]),
                "pending": pending,
                "backoff": {self._request_key(r): n for r, n in sorted(
                    self._failures.items(), key=lambda i: self._request_key(i[0]))},
                "shutdown": self._shutdown,
            }

    def get(self, timeout: Optional[float] = None) -> Optional[Request]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._shutdown:
                    return None
                now = time.monotonic()
                while self._heap and self._heap[0][0] <= now:
                    due, _, request = heapq.heappop(self._heap)
                    if self._due.get(request) != due:
                        continue  # stale entry superseded by an earlier add
                    del self._due[request]
                    added = self._added.pop(request, due)
                    self.last_wait = max(0.0, now - due)
                    self.last_since_add = max(0.0, now - added)
                    if self._metrics is not None:
                        # queue latency = time spent READY but unserved (a
                        # deliberate 120 s requeue delay is scheduling, not
                        # queueing — timing it would peg the histogram at
                        # +Inf on a healthy system)
                        self._metrics.workqueue_queue_duration.labels(
                            name=self._name).observe(self.last_wait)
                    return request
                wait = self._heap[0][0] - now if self._heap else None
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait, remaining)
                self._cond.wait(wait)

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._due)


@dataclasses.dataclass
class _WatchSpec:
    api_version: str
    kind: str
    namespace: Optional[str]
    mapper: Callable[[WatchEvent], List[Request]]


class Controller:
    def __init__(self, reconciler: Reconciler):
        self.reconciler = reconciler
        self.queue = RateLimitingQueue()
        self._metrics = None  # OperatorMetrics, set via instrument()
        self._tracer = None  # tracing.Tracer, set via instrument()
        self._inflight: Optional[Request] = None
        self._inflight_since: float = 0.0
        self.watch_specs: List[_WatchSpec] = []
        self._handles: list = []
        self._thread: Optional[threading.Thread] = None
        self._resync_fn: Optional[Callable[[], List[Request]]] = None
        self._resync_period: float = 0.0
        self._resync_jitter: bool = True
        self._stop_event = threading.Event()

    def watches(self, api_version: str, kind: str,
                mapper: Callable[[WatchEvent], List[Request]],
                namespace: Optional[str] = None) -> "Controller":
        self.watch_specs.append(_WatchSpec(api_version, kind, namespace, mapper))
        return self

    def resyncs(self, fn: Callable[[], List[Request]],
                period: float = 30.0, jitter: bool = True) -> "Controller":
        """Informer-style periodic resync: a level-driven controller must
        converge even if a watch event is lost (stream reconnect gap, mapper
        error), so re-enqueue everything roughly every ``period`` seconds.

        With ``jitter`` (the default) each cycle waits a fresh
        ``uniform(period/2, period)`` — full jitter on the back half, so
        replicas started in lockstep (a rolling Deployment restart) never
        LIST in lockstep forever, the thundering herd a 5,000-node fleet
        amplifies into an apiserver spike per period."""
        self._resync_fn = fn
        self._resync_period = period
        self._resync_jitter = jitter
        return self

    def start(self, client: Client) -> None:
        # fresh Event per start: a stop() immediately followed by start()
        # must not let a prior resync thread (still blocked in wait()) miss
        # the set flag and keep running alongside the new one
        self._stop_event = threading.Event()
        stop_event = self._stop_event
        for spec in self.watch_specs:
            def handler(event: WatchEvent, _spec=spec) -> None:
                try:
                    for request in _spec.mapper(event):
                        self.queue.add(request)
                except BreakerOpenError as e:
                    # a mapper's cached read met an open breaker: degraded
                    # mode, not a mapper bug; the resync re-derives it
                    log.warning("%s: watch mapper skipped (apiserver "
                                "circuit open, retry in %.1fs); resync "
                                "will recover", self.reconciler.name,
                                e.retry_in or 0.0)
                except FencedError:
                    log.warning("%s: watch mapper skipped (not leader)",
                                self.reconciler.name)
                except Exception:
                    log.exception("%s: watch mapper failed", self.reconciler.name)
            self._handles.append(client.watch(spec.api_version, spec.kind, spec.namespace, handler))
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name=f"{self.reconciler.name}-worker")
        self._thread.start()
        if self._resync_fn is not None and self._resync_period > 0:
            threading.Thread(target=self._resync_loop, args=(stop_event,),
                             daemon=True,
                             name=f"{self.reconciler.name}-resync").start()

    def _resync_delay(self) -> float:
        if not self._resync_jitter:
            return self._resync_period
        return random.uniform(self._resync_period / 2.0, self._resync_period)

    def _resync_loop(self, stop_event: threading.Event) -> None:
        while not stop_event.wait(self._resync_delay()):
            try:
                for request in self._resync_fn():
                    self.queue.add(request)
            except BreakerOpenError as e:
                log.warning("%s: resync skipped (apiserver circuit open, "
                            "retry in %.1fs)", self.reconciler.name,
                            e.retry_in or 0.0)
            except FencedError:
                log.warning("%s: resync skipped (not leader)",
                            self.reconciler.name)
            except Exception:
                log.exception("%s: resync failed", self.reconciler.name)

    def instrument(self, metrics, tracer=None) -> None:
        """Attach workqueue + reconcile metrics (and, optionally, the
        reconcile tracer) for this controller."""
        self._metrics = metrics
        self._tracer = tracer
        self.queue.instrument(metrics, self.reconciler.name)

    def _trace_ctx(self, request: Request, attempt: int):
        """One root span per served request, a fresh trace every attempt
        (the attempt and back-off attributes tie a request's retries
        together in ``/debug/traces``)."""
        if self._tracer is None:
            return contextlib.nullcontext(None)
        return self._tracer.trace(
            "reconcile", controller=self.reconciler.name,
            request=self.queue._request_key(request),
            attempt=attempt,
            queue_wait_s=round(self.queue.last_wait, 6),
            since_add_s=round(self.queue.last_since_add, 6),
            backoff_failures=attempt - 1)

    def _worker(self) -> None:
        while True:
            request = self.queue.get()
            if request is None:
                return
            attempt = self.queue.failures_for(request) + 1
            self._inflight = request
            self._inflight_since = time.monotonic()
            started = time.monotonic()
            try:
                with self._trace_ctx(request, attempt) as root:
                    result = self.reconciler.reconcile(request)
                    if root is not None and result and result.requeue_after is not None:
                        root.set_attribute("requeue_after_s", result.requeue_after)
            except BreakerOpenError as e:
                # degraded mode: nothing this reconcile does can land now;
                # wait out the breaker's cooldown, with no error count and
                # no back-off growth on top of it
                delay = max(0.5, e.retry_in or 0.0)
                log.warning("%s: apiserver circuit open; requeueing %s in "
                            "%.1fs", self.reconciler.name, request, delay)
                self.queue.add(request, delay)
                continue
            except FencedError:
                # deposed mid-sweep: split-brain protection working, not an
                # error; the request waits in case leadership comes back
                log.warning("%s: write fenced (no longer leader); "
                            "requeueing %s", self.reconciler.name, request)
                self.queue.add(request, 1.0)
                continue
            except Exception:
                log.exception("%s: reconcile %s failed", self.reconciler.name, request)
                if self._metrics is not None:
                    self._metrics.reconcile_errors.labels(
                        name=self.reconciler.name).inc()
                self.queue.add_rate_limited(request)
                continue
            finally:
                self._inflight = None
                if self._metrics is not None:
                    self._metrics.reconcile_duration.labels(
                        name=self.reconciler.name).observe(time.monotonic() - started)
            self.queue.forget(request)
            if result and result.requeue_after is not None:
                self.queue.add(request, result.requeue_after)

    def debug_state(self) -> dict:
        """``/debug/queue``: the queue's state, the request being
        reconciled and for how long (a large ``inflight_for_s`` is a wedged
        reconcile), and the reconciler's own page where it has one."""
        inflight = self._inflight
        state = {
            "controller": self.reconciler.name,
            "inflight": (self.queue._request_key(inflight)
                         if inflight is not None else None),
            "inflight_for_s": (round(time.monotonic() - self._inflight_since, 3)
                               if inflight is not None else None),
            "worker_alive": self._thread.is_alive() if self._thread else False,
        }
        state.update(self.queue.debug_state())
        if hasattr(self.reconciler, "debug_state"):
            state.update(self.reconciler.debug_state())
        return state

    def stop(self) -> None:
        self._stop_event.set()
        for h in self._handles:
            h.stop()
        self.queue.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


class ControllerManager:
    def __init__(self, client: Client):
        self.client = client
        self.controllers: List[Controller] = []

    def add(self, controller: Controller) -> Controller:
        self.controllers.append(controller)
        return controller

    def start(self) -> None:
        for c in self.controllers:
            c.start(self.client)

    def stop(self) -> None:
        for c in self.controllers:
            c.stop()
