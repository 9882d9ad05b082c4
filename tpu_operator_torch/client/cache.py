"""Informer-backed read cache: controller-runtime's cached client (copy of
tpu_operator/client/cache.py).

NVIDIA's operator never GETs objects from the apiserver in its hot loop — every
``r.Client.Get/List`` inside a reconcile is served from shared informer
caches kept fresh by watches (controller-runtime manager cache, wired at
cmd/gpu-operator/main.go:111-117); only writes hit the wire. Without this,
a full DAG sweep costs one round-trip per owned object per reconcile —
at real apiserver latencies that dominates reconcile time and generates
the exact read-storm controller-runtime exists to prevent.

:class:`CachedClient` wraps any :class:`~.interface.Client`. The first read
of a (apiVersion, kind, scope) lazily starts an informer: a watch whose
``relist_handler`` delivers full LIST snapshots (initial sync and every
410 resync — the replace-boundary is what makes deletions-during-an-outage
safe; an ADDED-replay can never express that tombstone) and whose event
stream applies rv-monotonic upserts. Reads are then served locally;
writes pass through to the inner client and their responses are applied
back to the cache (write-through), shrinking the staleness window that
pure controller-runtime accepts.

Staleness contract (controller-runtime's): a cached read may lag the
server by one event delivery. Reconcilers already tolerate this — stale
``resourceVersion`` on a write surfaces as 409 Conflict and the runtime
requeues; a missed object surfaces as AlreadyExists on create.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .. import tracing
from .errors import NotFoundError
from .fake import match_field_selector, match_label_selector
from .interface import Client, WatchEvent, WatchHandle
from .scheme import Scheme, default_scheme
from ..utils.locks import make_lock, register_shared

log = logging.getLogger(__name__)

#: how long a read waits for an informer's initial LIST before falling back
#: to a direct read (a dead watch must degrade to slow, never to wrong)
SYNC_TIMEOUT_S = 30.0
#: deletes an informer remembers (the newest): a write racing a delete
#: lands within a round trip of it, so older ones need no guard
TOMBSTONES_KEPT = 4096


def _rv_int(obj: dict) -> int:
    try:
        return int(obj.get("metadata", {}).get("resourceVersion", 0))
    except (TypeError, ValueError):
        return -1  # non-numeric rv: treat as unknown → always apply


class _Subscription(WatchHandle):
    """A controller's watch served from a shared informer (controller-runtime
    shares one informer per kind between the cache and all event sources —
    a second server-side stream per controller would double watch load).
    ``namespace`` filters delivery when the subscription is narrower than
    the informer (a scoped watch served from the all-namespaces superset
    must not become a cluster-wide firehose)."""

    def __init__(self, informer: "_Informer",
                 handler: Callable[[WatchEvent], None],
                 namespace: Optional[str] = None):
        self._informer = informer
        self.handler = handler
        self.namespace = namespace
        # live events are buffered until the initial snapshot replay is done:
        # interleaving them could deliver a stale snapshot ADDED *after* the
        # live DELETED for the same object — an ordering no direct apiserver
        # watch can produce
        self.buffering = True
        self.buffer: List[WatchEvent] = []

    def wants(self, obj: dict) -> bool:
        if not self.namespace:
            return True
        return obj.get("metadata", {}).get("namespace", "") == self.namespace

    def stop(self) -> None:
        self._informer.unsubscribe(self)


class _Informer:
    """One kind+scope cache: store replaced wholesale on every relist,
    rv-monotonically upserted per event in between. Subscribers receive the
    live event stream plus synthetic ADDED replays on (re)sync — the same
    contract a direct watch gives them."""

    def __init__(self, inner: Client, api_version: str, kind: str,
                 namespace: Optional[str]):
        self.api_version = api_version
        self.kind = kind
        self.namespace = namespace
        self._store: Dict[Tuple[str, str], dict] = register_shared(
            f"Informer[{kind}]._store", {})
        #: the rv each deleted object's DELETED event carried, and the last
        #: relist's rv (below which an object absent from the list was
        #: deleted): a write made before the delete, whose response is
        #: applied after it (a write-through racing the watch), must not
        #: bring the object back
        self._gone: Dict[Tuple[str, str], int] = {}
        self._listed_rv = -1
        #: the newest rv the watch (an event or a relist) has delivered: the
        #: read barrier's watermark. Unlike the reference's, a write-through
        #: does not advance it: the write batcher hands its flushed writes to
        #: the cache, which would mark the kind caught up past events the
        #: watch still owes
        self.max_rv = -1
        self._lock = make_lock("_Informer._lock")
        self.synced = threading.Event()
        #: set after a full sync-timeout expired once: later reads stop
        #: paying the timeout and degrade to direct reads immediately
        self.sync_wait_failed = False
        self._subscribers: List[_Subscription] = []
        self._handle = inner.watch(api_version, kind, namespace,
                                   handler=self._on_event,
                                   relist_handler=self._on_relist)

    def has_subscribers(self) -> bool:
        with self._lock:
            return bool(self._subscribers)

    def stats(self) -> dict:
        with self._lock:
            return {
                "apiVersion": self.api_version, "kind": self.kind,
                "scope": self.namespace or "all-namespaces",
                "synced": self.synced.is_set(),
                "degraded": self.sync_wait_failed and not self.synced.is_set(),
                "objects": len(self._store),
                "subscribers": len(self._subscribers),
            }

    @staticmethod
    def _key(obj: dict) -> Tuple[str, str]:
        meta = obj.get("metadata", {})
        return (meta.get("namespace", ""), meta.get("name", ""))

    def subscribe(self, handler: Callable[[WatchEvent], None],
                  namespace: Optional[str] = None) -> _Subscription:
        sub = _Subscription(self, handler, namespace)
        with self._lock:
            snapshot = [copy.deepcopy(o) for o in self._store.values()
                        if sub.wants(o)]
            self._subscribers.append(sub)
        # initial replay, like an informer's list-then-watch: level-driven
        # consumers treat a duplicate ADDED as a no-op reconcile
        for obj in snapshot:
            self._deliver(sub, WatchEvent(type="ADDED", object=obj))
        # drain events that arrived during the replay (they postdate the
        # snapshot, so replay-then-buffer preserves true order), then go live
        while True:
            with self._lock:
                if not sub.buffer:
                    sub.buffering = False
                    break
                pending, sub.buffer = sub.buffer, []
            for event in pending:
                self._deliver(sub, event)
        return sub

    def unsubscribe(self, sub: _Subscription) -> None:
        with self._lock:
            if sub in self._subscribers:
                self._subscribers.remove(sub)

    @staticmethod
    def _deliver(sub: _Subscription, event: WatchEvent) -> None:
        try:
            sub.handler(event)
        except Exception:
            log.exception("informer subscriber failed")

    def _fanout(self, event_type: str, obj: dict) -> None:
        deliver_now = []
        with self._lock:
            for sub in self._subscribers:
                if not sub.wants(obj):
                    continue
                # per-subscriber copy: a mapper mutating its event must
                # poison neither the cache store nor sibling subscribers
                event = WatchEvent(type=event_type, object=copy.deepcopy(obj))
                if sub.buffering:
                    sub.buffer.append(event)
                else:
                    deliver_now.append((sub, event))
        for sub, event in deliver_now:
            self._deliver(sub, event)

    def _on_relist(self, items: List[dict], rv: str) -> None:
        listed_rv = _rv_int({"metadata": {"resourceVersion": rv}})
        with self._lock:
            old = self._store
            # wholesale swap: the relist is the new truth, but for a
            # write-through newer than the list (its write landed after the
            # list was answered): swapped out, the cache would read the
            # listed version until the watch, resumed at the list's rv,
            # delivers the write's event
            store = {self._key(o): o for o in items}
            for key, obj in old.items():
                if listed_rv >= 0 and _rv_int(obj) > max(listed_rv, _rv_int(store.get(key, {}))):
                    store[key] = obj
            # the replacement is a new shared structure: registered again,
            # two generations (the old map draining, the new one filling)
            # are tracked apart
            self._store = register_shared(f"Informer[{self.kind}]._store", store)
            self._gone = {}
            self._listed_rv = listed_rv
            self.max_rv = max(self.max_rv, self._listed_rv)
            vanished = [obj for key, obj in old.items()
                        if key not in self._store]
            added = [store[self._key(item)] for item in items]
        self.synced.set()
        # controller-runtime Replace semantics: subscribers get ADDED for the
        # surviving set AND tombstone DELETEDs for objects removed during the
        # missed-event window — without the tombstones, a deletion that fell
        # in a watch outage would only ever surface via periodic resync
        for obj in vanished:
            self._fanout("DELETED", obj)
        for obj in added:
            self._fanout("ADDED", obj)

    def _on_event(self, event: WatchEvent) -> None:
        self.apply(event.type, event.object)
        with self._lock:
            self.max_rv = max(self.max_rv, _rv_int(event.object))
        self._fanout(event.type, event.object)

    def caught_up(self, rv: int) -> bool:
        """True once the initial relist landed and the watch has delivered
        every event up to ``rv`` (the backend's newest event for this watch
        scope). ``rv <= 0`` means the scope never emitted an event."""
        if not self.synced.is_set():
            return False
        with self._lock:
            return rv <= 0 or self.max_rv >= rv

    def apply(self, event_type: str, obj: dict) -> None:
        key = self._key(obj)
        with self._lock:
            rv = _rv_int(obj)
            if event_type == "DELETED":
                self._store.pop(key, None)
                self._gone.pop(key, None)
                self._gone[key] = rv
                if len(self._gone) > TOMBSTONES_KEPT:
                    del self._gone[next(iter(self._gone))]
                return
            current = self._store.get(key)
            if current is None and 0 <= rv <= max(self._gone.get(key, -1),
                                                   self._listed_rv):
                return
            if current is None or rv < 0 or rv >= _rv_int(current):
                self._store[key] = obj
                self._gone.pop(key, None)

    def get(self, name: str, namespace: str) -> Optional[dict]:
        with self._lock:
            obj = self._store.get((namespace, name))
            return copy.deepcopy(obj) if obj is not None else None

    def list(self, namespace: Optional[str], label_selector: Optional[dict],
             field_selector: Optional[dict]) -> List[dict]:
        out = []
        with self._lock:
            for (ns, _), obj in sorted(self._store.items()):
                if namespace and ns != namespace:
                    continue
                if not match_label_selector(
                        obj.get("metadata", {}).get("labels"), label_selector):
                    continue
                if not match_field_selector(obj, field_selector):
                    continue
                out.append(copy.deepcopy(obj))
        return out

    def stop(self) -> None:
        self._handle.stop()


class CachedClient(Client):
    def __init__(self, inner: Client, scheme: Optional[Scheme] = None):
        self.inner = inner
        self.scheme = scheme or getattr(inner, "scheme", None) or default_scheme()
        self._informers: Dict[Tuple[str, str, Optional[str]], _Informer] = (
            register_shared("CachedClient._informers", {}))
        self._lock = make_lock("CachedClient._lock")

    # -- informer plumbing ---------------------------------------------------
    def _scope(self, api_version: str, kind: str, namespace: Optional[str],
               for_name: bool) -> Optional[str]:
        """Effective watch scope for a read. Named reads on namespaced kinds
        default to "default" exactly like the URL layout does."""
        if not self.scheme.is_namespaced(api_version, kind):
            return None
        if namespace is None and not for_name:
            return None  # all-namespaces list
        return namespace or "default"

    def _informer_for(self, api_version: str, kind: str,
                      scope: Optional[str], wait_sync: bool = True) -> _Informer:
        # LOCK ORDER INVARIANT: self._lock is never held while calling into
        # the inner client (watch/stop). FakeClient delivers watch events
        # inline under ITS lock, and a controller mapper handling such an
        # event may perform a cached read (wants self._lock) — holding
        # self._lock across inner.watch()/handle.stop() closes an AB-BA
        # deadlock cycle with that path.
        with self._lock:
            informer = (self._informers.get((api_version, kind, None))
                        or self._informers.get((api_version, kind, scope)))
        if informer is None:
            candidate = _Informer(self.inner, api_version, kind, scope)
            doomed: List[_Informer] = []
            with self._lock:
                informer = (self._informers.get((api_version, kind, None))
                            or self._informers.get((api_version, kind, scope)))
                if informer is None:
                    informer = candidate
                    self._informers[(api_version, kind, scope)] = candidate
                    if scope is None:
                        doomed = self._collect_superseded_locked(api_version, kind)
                else:
                    doomed = [candidate]  # lost the creation race
            for stale in doomed:
                stale.stop()
        if wait_sync and not informer.synced.is_set():
            breaker = getattr(self.inner, "breaker", None)
            if breaker is not None and breaker.is_open:
                # apiserver known-down (resilience layer's breaker open):
                # the sync LIST cannot land until it recovers, so don't
                # park the worker for the full timeout — fall through to
                # the direct-read path now, which short-circuits with
                # BreakerOpenError and the runtime requeues. Not recorded
                # as sync_wait_failed: the informer is healthy, the
                # server is not, and sync resumes the moment it returns.
                return informer
            # pay the full sync timeout once; a watch that cannot sync
            # (RBAC-denied LIST, unserved kind) must degrade to direct
            # reads per call, not wedge every read for 30 s forever
            timeout = 0.05 if informer.sync_wait_failed else SYNC_TIMEOUT_S
            if not informer.synced.wait(timeout) and not informer.sync_wait_failed:
                informer.sync_wait_failed = True
                log.warning("informer %s/%s scope=%s not synced after %ss; "
                            "degrading to direct reads until it recovers",
                            api_version, kind, scope, SYNC_TIMEOUT_S)
        return informer

    def _collect_superseded_locked(self, api_version: str,
                                   kind: str) -> List[_Informer]:
        """A new all-namespaces informer supersedes scoped ones for the kind:
        unregister any without subscribers (reads route to the superset from
        now on) so their server-side watch streams don't live until process
        exit — the watch multiplication shared informers exist to prevent.
        Scoped informers WITH subscribers stay: their subscriptions hold the
        stream. Returns the informers to stop OUTSIDE the lock."""
        doomed = []
        for key, informer in list(self._informers.items()):
            av, k, scope = key
            if av == api_version and k == kind and scope is not None \
                    and not informer.has_subscribers():
                del self._informers[key]
                doomed.append(informer)
        return doomed

    def _matching_informers(self, api_version: str, kind: str,
                            ns: str) -> List[_Informer]:
        """Informers that cover an object of this kind in this namespace:
        the all-namespaces superset plus the exact scope."""
        with self._lock:
            return [
                informer for (av, k, scope), informer in self._informers.items()
                if av == api_version and k == kind and scope in (None, ns or None)
            ]

    def _apply_write(self, obj: dict) -> dict:
        """Write-through: fold a write response into any matching informer."""
        ns = obj.get("metadata", {}).get("namespace", "")
        for informer in self._matching_informers(obj.get("apiVersion"),
                                                 obj.get("kind"), ns):
            informer.apply("MODIFIED", copy.deepcopy(obj))
        return obj

    def absorb(self, obj: dict) -> None:
        """Write-through of a write made below this layer (the write
        batcher's flush)."""
        self._apply_write(obj)

    def stop(self) -> None:
        with self._lock:
            informers = list(self._informers.values())
            self._informers.clear()
        for informer in informers:
            informer.stop()

    # -- reads (cache) -------------------------------------------------------
    def get(self, api_version, kind, name, namespace=None) -> dict:
        scope = self._scope(api_version, kind, namespace, for_name=True)
        informer = self._informer_for(api_version, kind, scope)
        if not informer.synced.is_set():
            # inner RestClient records its own wire span; tag the fallback
            with tracing.api_span("GET", f"{kind}/{name}", source="direct"):
                return self.inner.get(api_version, kind, name, namespace)
        with tracing.api_span("GET", f"{kind}/{name}", source="cache") as sp:
            obj = informer.get(name, scope or "")
            sp.set_attribute("code", 404 if obj is None else 200)
        if obj is None:
            # raised OUTSIDE the span so a cache miss reads code=404 but not
            # status=error — like the wire client, absence is an answer, not
            # a failure that should pin the trace into the error ring
            raise NotFoundError(f"{kind} {namespace or ''}/{name} not found (cache)")
        return obj

    def list(self, api_version, kind, namespace=None, label_selector=None,
             field_selector=None) -> List[dict]:
        scope = self._scope(api_version, kind, namespace, for_name=False)
        informer = self._informer_for(api_version, kind, scope)
        if not informer.synced.is_set():
            with tracing.api_span("LIST", kind, source="direct"):
                return self.inner.list(api_version, kind, namespace,
                                       label_selector, field_selector)
        # a scoped read served from the all-namespaces superset still filters
        want_ns = namespace if self.scheme.is_namespaced(api_version, kind) else None
        with tracing.api_span("LIST", kind, source="cache") as sp:
            out = informer.list(want_ns, label_selector, field_selector)
            sp.set_attributes(code=200, items=len(out))
            return out

    # -- writes (pass through + write-through) -------------------------------
    def create(self, obj: dict) -> dict:
        return self._apply_write(self.inner.create(obj))

    def update(self, obj: dict) -> dict:
        return self._apply_write(self.inner.update(obj))

    def patch(self, api_version, kind, name, patch, namespace=None) -> dict:
        return self._apply_write(self.inner.patch(api_version, kind, name, patch, namespace))

    def update_status(self, obj: dict) -> dict:
        return self._apply_write(self.inner.update_status(obj))

    def delete(self, api_version, kind, name, namespace=None) -> None:
        # No optimistic tombstone: a real apiserver delete of
        # an object with finalizers or a grace period only marks it
        # Terminating — removing it from the cache here would make cached
        # get()/list() report it gone while it still exists, until the next
        # watch MODIFIED event resurrected it. The watch DELETED event is
        # the one source of truth for removal.
        self.inner.delete(api_version, kind, name, namespace)

    def evict(self, name: str, namespace: Optional[str] = None) -> None:
        # no optimistic remove either: an eviction starts a graceful
        # termination, and the DELETED event comes when the pod is gone
        self.inner.evict(name, namespace)

    # -- watches (shared informers) ------------------------------------------
    def watch(self, api_version, kind, namespace=None, handler=None,
              relist_handler=None) -> WatchHandle:
        """Handler watches are served from the shared informer for the kind —
        one server-side stream feeds the cache and every controller (the
        controller-runtime shared-informer model). Raw handles (no handler)
        and external cache consumers (relist_handler) pass through."""
        if relist_handler is not None or handler is None:
            return self.inner.watch(api_version, kind, namespace, handler,
                                    relist_handler=relist_handler)
        scope = self._scope(api_version, kind, namespace, for_name=False)
        # the informer may be the all-namespaces superset: keep the
        # subscription filtered to what the caller actually asked for
        want_ns = namespace if self.scheme.is_namespaced(api_version, kind) else None
        while True:
            # no sync wait: a subscriber to an unsynced informer receives the
            # ADDED fanout when the initial relist lands, so blocking here
            # only stalls controller start — which, under --leader-elect,
            # runs inline in the lease renew loop where a 30 s wait per
            # unsyncable kind would forfeit leadership mid-start
            informer = self._informer_for(api_version, kind, scope,
                                          wait_sync=False)
            sub = informer.subscribe(handler, namespace=want_ns)
            with self._lock:
                if any(i is informer for i in self._informers.values()):
                    return sub
            # a concurrent superset creation retired this scoped informer
            # between resolve and subscribe; re-resolve onto the superset
            sub.stop()

    def wait_caught_up(self, rv_for: Callable[[str, str, Optional[str]], int],
                       timeout: float = 5.0) -> bool:
        """Deterministic read barrier for synchronous harnesses (the fleet
        simulator): block until every active informer's watch has delivered
        the newest event its scope has emitted. ``rv_for(api_version, kind,
        namespace)`` returns that scope's event high watermark
        (``FakeClient.last_event_rv``). False on timeout (a watch stream is
        wedged or lagging)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                informers = list(self._informers.values())
            lagging = [i for i in informers if not i.caught_up(
                int(rv_for(i.api_version, i.kind, i.namespace) or 0))]
            if not lagging:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.001)

    def server_version(self) -> str:
        return self.inner.server_version()

    # -- introspection -------------------------------------------------------
    def stats(self) -> List[dict]:
        """Cache state for the /debug/informers endpoint: one row per
        informer with scope, sync state, and cached object count."""
        with self._lock:
            informers = list(self._informers.values())
        return [informer.stats() for informer in informers]
