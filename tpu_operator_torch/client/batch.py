"""Write coalescer: one preconditioned PATCH per object per flush window
(copy of tpu_operator/client/batch.py).

A node-facing sweep (labeler, health machine, upgrade machine, multihost
stamping) computes several small JSON merge patches per node — a label here,
an annotation there — and each one alone is a round trip. At realistic
apiserver latencies the round trips dominate the sweep, and at fleet size
they are the difference between O(events) and O(nodes·sweeps)
steady-state traffic.

:class:`WriteBatcher` wraps the apiserver client (the port's chain is
``WriteBatcher → RestClient``; the reference's read cache, resilience and
fencing layers around it are not ported yet). While a reconcile sweep holds a *flush
window* open (:func:`batch_window`), deferred writes — registered through
:func:`~.preconditions.preconditioned_patch` or :func:`coalesced_patch` —
are queued per (apiVersion, kind, namespace, name) instead of dispatched.
At window exit (or on a small deadline, the safety net for a stalled
sweep) the queue flushes: per object, the pending build callbacks are
re-run in registration order against a fresh read and folded into ONE
merge patch, preconditioned on that read's resourceVersion, so N writes
per node become one PATCH per node per sweep with last-write-wins
semantics per key.

Contracts the batcher must not weaken:

* **Preconditions.** A flushed PATCH carries the resourceVersion of the
  read its builds ran against. A 409 on one object splits back to that
  object's own recompute-reapply loop (re-read, re-run *all* its builds,
  re-patch — the :mod:`~.preconditions` contract), leaving sibling
  objects' patches untouched.
* **Ordering.** Any other mutating verb (create/update/update_status/
  delete/evict) and any direct ``patch()`` call is a barrier: pending
  deferred writes flush first. A Normal Event recorded after a label
  patch therefore still lands after that patch, and a direct write can
  never overtake a deferred write to the same object.
* **Determinism.** Builds are folded in registration order, so the
  merged patch body has a stable shape.

Outside a window every verb passes straight through — node agents and
composition-root plumbing never see deferred semantics.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .errors import ConflictError
from .interface import Client, WatchHandle

log = logging.getLogger(__name__)

#: same bounded recompute-reapply budget as preconditions.DEFAULT_ATTEMPTS
#: (not imported: preconditions imports this module for window detection)
DEFAULT_ATTEMPTS = 6

#: default deadline flush: pending writes older than this are dispatched
#: even mid-window, bounding staleness when a sweep stalls on one pool
DEFAULT_MAX_DELAY_S = 2.0

#: concurrent per-object dispatches during a flush. Objects are
#: independent (each replays only its own builds), so a mass flush — the
#: first labeling sweep of a 5,000-node pool defers thousands of patches —
#: must not pay serial round-trip latency: at 2ms apiserver latency a
#: serial flush of 5,000 patches is a 10s sweep all by itself.
DEFAULT_FLUSH_WORKERS = 16

#: below this many due objects a flush dispatches inline — no point
#: spinning up a pool to issue three patches
_PARALLEL_FLUSH_THRESHOLD = 4


def _merge_obj(dst: dict, patch: dict) -> dict:
    """Apply JSON merge-patch semantics to a plain object: None deletes,
    dicts recurse, everything else replaces."""
    for key, value in patch.items():
        if value is None:
            dst.pop(key, None)
        elif isinstance(value, dict) and isinstance(dst.get(key), dict):
            _merge_obj(dst[key], value)
        elif isinstance(value, dict):
            fresh: dict = {}
            _merge_obj(fresh, value)
            dst[key] = fresh
        else:
            dst[key] = value
    return dst


def _merge_patch(dst: dict, patch: dict) -> dict:
    """Fold one merge-patch body into another, later writer wins per key.
    Unlike :func:`_merge_obj`, None is *kept* — in a patch body it is the
    delete marker and must reach the server."""
    for key, value in patch.items():
        if isinstance(value, dict) and isinstance(dst.get(key), dict):
            _merge_patch(dst[key], value)
        else:
            dst[key] = copy.deepcopy(value)
    return dst


class _Pending:
    """Deferred writes for one object: build callbacks in registration
    order. Each build is a pure function of the object it is handed
    (the preconditions contract) so the flush may re-run the whole list
    against a fresh read after a 409."""

    __slots__ = ("api_version", "kind", "name", "namespace", "builds",
                 "enqueued_at")

    def __init__(self, api_version: str, kind: str, name: str,
                 namespace: Optional[str]):
        self.api_version = api_version
        self.kind = kind
        self.name = name
        self.namespace = namespace
        self.builds: List[Callable[[dict], Optional[dict]]] = []
        self.enqueued_at = time.monotonic()


class WriteBatcher(Client):
    """See module docstring. Wrapper exposing ``.inner`` like every other
    layer so chain-walking wiring (metrics) works
    regardless of stacking order."""

    def __init__(self, inner: Client, max_delay_s: float = DEFAULT_MAX_DELAY_S,
                 attempts: int = DEFAULT_ATTEMPTS,
                 sleep: Callable[[float], None] = time.sleep,
                 flush_workers: int = DEFAULT_FLUSH_WORKERS):
        self.inner = inner
        self.scheme = getattr(inner, "scheme", None)
        self.max_delay_s = max_delay_s
        self._attempts = attempts
        self._sleep = sleep
        self._flush_workers = max(1, flush_workers)
        self._lock = threading.Lock()
        self._depth = 0  # open windows (ref-counted across controllers)
        self._pending: Dict[Tuple[str, str, str, str], _Pending] = (
            {})
        #: outermost read client, bound after chain assembly (a read cache
        #: above the batcher, when one is ported, makes flush re-reads hits)
        self._read: Optional[Client] = None
        self._flusher: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        #: metrics hooks (wired by controllers/metrics.wire_batching)
        self.on_batched: Optional[Callable[[], None]] = None
        self.on_flush: Optional[Callable[[int], None]] = None
        #: plain counters for tests / stats endpoints
        self.batched_writes_total = 0
        self.flushed_patches_total = 0

    # -- window management ---------------------------------------------------
    @property
    def window_active(self) -> bool:
        return self._depth > 0

    def begin(self) -> None:
        with self._lock:
            self._depth += 1

    def end(self) -> None:
        """Close one window; the last close flushes everything pending."""
        with self._lock:
            self._depth = max(0, self._depth - 1)
            should_flush = self._depth == 0
        if should_flush:
            self.flush()

    # -- deferral ------------------------------------------------------------
    def bind_read_client(self, read: Client) -> None:
        self._read = read

    def _read_obj(self, api_version: str, kind: str, name: str,
                  namespace: Optional[str], authoritative: bool = False) -> dict:
        """Base read for a deferred build. The first attempt reads through
        the informer cache (free); ``authoritative`` bypasses it — after a
        409 the cache has DEMONSTRABLY lagged the competing writer (e.g. a
        kubelet's status bump racing a label flush), and re-reading the
        same stale resourceVersion just burns the whole retry budget. At
        fleet scale that was the difference between one extra GET per
        conflict and ~0.8 s of doomed retries per node per flush."""
        reader = self._read if self._read is not None else self.inner
        if authoritative:
            reader = self.inner
        return reader.get(api_version, kind, name, namespace)

    def defer_patch(self, api_version: str, kind: str, name: str,
                    build: Callable[[dict], Optional[dict]],
                    namespace: Optional[str] = None) -> dict:
        """Queue ``build`` for the object and return an optimistic local
        projection of its effect (base read + merge applied), which the
        caller may mirror into its sweep snapshot. The write itself lands
        at flush, preconditioned on a fresh read; conflicts re-run the
        build there. NotFoundError on the base read propagates now, like a
        direct patch of a missing object would."""
        base = self._read_obj(api_version, kind, name, namespace)
        patch = build(base)
        if patch is None:
            return base
        projected = _merge_obj(copy.deepcopy(base), copy.deepcopy(patch))
        key = (api_version, kind, namespace or "", name)
        with self._lock:
            pending = self._pending.get(key)
            if pending is None:
                pending = _Pending(api_version, kind, name, namespace)
                self._pending[key] = pending
            pending.builds.append(build)
            self.batched_writes_total += 1
            hook = self.on_batched
        if hook is not None:
            hook()
        self._ensure_flusher()
        return projected

    # -- flushing ------------------------------------------------------------
    def flush(self, only_overdue: bool = False) -> None:
        """Dispatch pending writes: one preconditioned merge PATCH per
        object. Every object is attempted even when an earlier one fails;
        the first error is re-raised at the end."""
        now = time.monotonic()
        with self._lock:
            if only_overdue:
                due = {k: p for k, p in self._pending.items()
                       if now - p.enqueued_at >= self.max_delay_s}
                for k in due:
                    del self._pending[k]
            else:
                due, self._pending = self._pending, {}
        if not due:
            return
        def attempt(pending: _Pending) -> Optional[BaseException]:
            try:
                self._apply_one(pending)
                return None
            except BaseException as e:  # noqa: BLE001 — triaged below
                log.warning("batched write to %s/%s failed: %s",
                            pending.kind, pending.name, e)
                return e

        items = list(due.values())
        if len(items) < _PARALLEL_FLUSH_THRESHOLD or self._flush_workers == 1:
            errors = [attempt(p) for p in items]
        else:
            # objects are independent — each _apply_one replays only its
            # own builds — so dispatch concurrently and keep a mass flush
            # from paying serial round-trip latency
            from concurrent import futures
            with futures.ThreadPoolExecutor(
                    max_workers=min(self._flush_workers, len(items)),
                    thread_name_prefix="write-batcher-dispatch") as pool:
                errors = list(pool.map(attempt, items))
        first_exc = next((e for e in errors if e is not None), None)
        if first_exc is not None:
            raise first_exc

    def _apply_one(self, pending: _Pending) -> dict:
        """The preconditions recompute-reapply loop, per object: fresh
        read → run every build in order against a working copy → one merged
        patch at the read's resourceVersion → on 409, repeat."""
        last_conflict: Optional[ConflictError] = None
        for attempt in range(self._attempts):
            if attempt:
                # brief yield, then re-read AUTHORITATIVELY below: waiting
                # for the cache to observe the competing write is hopeless
                # under sustained contention (a kubelet sweep bumping every
                # node's status lags the watch by more than the backoff)
                self._sleep(min(0.25, 0.02 * (2 ** attempt)))
            base = self._read_obj(pending.api_version, pending.kind,
                                  pending.name, pending.namespace,
                                  authoritative=attempt > 0)
            working = copy.deepcopy(base)
            merged: dict = {}
            for build in pending.builds:
                part = build(working)
                if not part:
                    continue
                part = copy.deepcopy(part)
                meta = part.get("metadata")
                if isinstance(meta, dict):
                    meta.pop("resourceVersion", None)
                _merge_obj(working, copy.deepcopy(part))
                _merge_patch(merged, part)
            if not merged:
                return base
            rv = base.get("metadata", {}).get("resourceVersion")
            if rv is not None:
                merged.setdefault("metadata", {})["resourceVersion"] = rv
            try:
                out = self.inner.patch(pending.api_version, pending.kind,
                                       pending.name, merged,
                                       pending.namespace)
            except ConflictError as e:
                last_conflict = e
                log.debug("batched patch of %s/%s conflicted at rv %s "
                          "(attempt %d/%d); recomputing", pending.kind,
                          pending.name, rv, attempt + 1, self._attempts)
                continue
            with self._lock:
                self.flushed_patches_total += 1
                hook = self.on_flush
            if hook is not None:
                hook(len(pending.builds))
            return out
        raise last_conflict if last_conflict is not None else ConflictError(
            f"batched patch of {pending.kind}/{pending.name} never applied")

    def _ensure_flusher(self) -> None:
        """Deadline safety net: a daemon thread that flushes overdue
        entries mid-window. Exits when idle; restarted lazily."""
        if self.max_delay_s is None:
            return
        with self._lock:
            if self._flusher is not None and self._flusher.is_alive():
                return
            self._flusher = threading.Thread(
                target=self._flush_loop, name="write-batcher-flush",
                daemon=True)
            self._flusher.start()

    def _flush_loop(self) -> None:
        idle = 0
        interval = max(0.05, self.max_delay_s / 4.0)
        while not self._stopped.wait(interval):
            with self._lock:
                empty = not self._pending
            if empty:
                idle += 1
                if idle >= 8:
                    return  # lazily restarted on the next deferral
                continue
            idle = 0
            try:
                self.flush(only_overdue=True)
            except Exception:
                # the sweep's own flush (or the next one) re-raises for the
                # worker; the safety-net thread must survive to keep trying
                log.warning("deadline flush failed", exc_info=True)

    # -- barrier verbs (flush-first, then pass through) ----------------------
    def _barrier(self) -> None:
        self.flush()

    def patch(self, api_version, kind, name, patch, namespace=None) -> dict:
        # direct patches stay synchronous even inside a window (deferral is
        # explicit: preconditioned_patch / coalesced_patch) but must not
        # overtake deferred writes — flush first
        self._barrier()
        return self.inner.patch(api_version, kind, name, patch, namespace)

    def create(self, obj: dict) -> dict:
        self._barrier()
        return self.inner.create(obj)

    def update(self, obj: dict) -> dict:
        self._barrier()
        return self.inner.update(obj)

    def update_status(self, obj: dict) -> dict:
        self._barrier()
        return self.inner.update_status(obj)

    def delete(self, api_version, kind, name, namespace=None) -> None:
        self._barrier()
        return self.inner.delete(api_version, kind, name, namespace)

    def evict(self, name: str, namespace: Optional[str] = None) -> None:
        # a barrier: the cordon a drain's eviction follows lands first
        self._barrier()
        return self.inner.evict(name, namespace)

    # -- reads / plumbing (pass through) -------------------------------------
    def get(self, api_version, kind, name, namespace=None) -> dict:
        return self.inner.get(api_version, kind, name, namespace)

    def list(self, api_version, kind, namespace=None, label_selector=None,
             field_selector=None) -> List[dict]:
        return self.inner.list(api_version, kind, namespace,
                               label_selector, field_selector)

    def watch(self, api_version, kind, namespace=None, handler=None,
              relist_handler=None) -> WatchHandle:
        return self.inner.watch(api_version, kind, namespace, handler,
                                relist_handler=relist_handler)

    def server_version(self) -> str:
        return self.inner.server_version()

    def stop(self) -> None:
        self._stopped.set()
        try:
            self.flush()
        except Exception:
            log.warning("final flush on stop failed", exc_info=True)


def find_batcher(client: Optional[Client]) -> Optional[WriteBatcher]:
    """Walk the ``.inner`` chain for the batching layer."""
    current = client
    while current is not None:
        if isinstance(current, WriteBatcher):
            return current
        current = getattr(current, "inner", None)
    return None


@contextlib.contextmanager
def batch_window(client: Optional[Client]):
    """Open a flush window for the duration of a reconcile sweep. No-op
    when the chain has no batcher (unit tests, node agents). Flush errors
    surface to the caller — unless the sweep is already unwinding on its
    own exception, which must not be masked by a failed flush."""
    batcher = find_batcher(client)
    if batcher is None:
        yield None
        return
    batcher.begin()
    try:
        yield batcher
    except BaseException:
        try:
            batcher.end()
        except Exception:
            log.warning("batch flush failed during exception unwind",
                        exc_info=True)
        raise
    else:
        batcher.end()


def coalesced_patch(client: Client, api_version: str, kind: str, name: str,
                    body: dict, namespace: Optional[str] = None) -> dict:
    """A plain merge patch that coalesces when a flush window is open and
    degrades to a direct ``client.patch`` otherwise. The loop-borne
    per-node writes in sweeps route through here (opalint
    ``unbatched-sweep-write`` enforces it)."""
    batcher = find_batcher(client)
    if batcher is not None and batcher.window_active:
        frozen = copy.deepcopy(body)
        return batcher.defer_patch(
            api_version, kind, name,
            lambda _fresh: copy.deepcopy(frozen), namespace)
    return client.patch(api_version, kind, name, body, namespace)
