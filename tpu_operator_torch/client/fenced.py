"""Leader write fencing: the single-writer guarantee, enforced client-side
(copy of tpu_operator/client/fenced.py).

The operator's durable state — health labels, drain plans/acks, slice
handoffs, serving verdicts — lives in node labels and annotations, so a
stale writer silently corrupts the detect→drain→retile→recover loop.
``LeaderElector`` hands leadership *off* but nothing stops the deposed
replica's already-running reconcile workers from finishing their sweeps
with blind PATCHes. :class:`FencedClient` closes that gap: every mutating
call is stamped with the monotonic leader epoch (the
``tpu.ai/leader-epoch`` Lease annotation, bumped on each acquisition) and
checked against the elector's LIVE view immediately before dispatch. Once
the elector's indeterminate hold window expires — strictly before any peer
may legally take over — the view flips to "not leader" and every write is
hard-rejected with the non-transient :class:`~.errors.FencedError`.

Stacking: ``CachedClient → WriteBatcher → RetryingClient → FencedClient →
RestClient``.
Under the retry layer so a fenced rejection is never retried (it is not
transient) and never charged to the circuit breaker (the server was never
asked); above the raw REST client so nothing mutating can slip underneath.

Leases bypass the fence by design: the elector must always be able to
renew/release, and fencing the very object that defines leadership would
deadlock re-acquisition. Reads also pass through — a deposed replica keeps
its caches warm for fast failback, it just cannot write.

The fence is *advisory-fast, precondition-final*: a write that races past
the epoch check in the instant between dispatch and depose is still
harmless, because the state machines it feeds write through
``resourceVersion``-preconditioned patches (:mod:`.preconditions`) that
the newer leader's writes invalidate.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional

from .errors import FencedError
from .interface import Client, WatchHandle

log = logging.getLogger(__name__)


class FencedClient(Client):
    """Epoch-checking write gate. ``fence`` is any object with the
    elector's live-view protocol — ``current_epoch() -> Optional[int]``
    (None = not leader) — normally the :class:`LeaderElector` itself,
    bound late via :meth:`bind` because composition roots build the client
    chain before the elector exists. Unbound (single-replica deployments,
    ``--leader-elect`` off) the fence is a pass-through: single-writer
    holds by construction."""

    def __init__(self, inner: Client, fence=None,
                 on_fenced: Optional[Callable[[str], None]] = None):
        self.inner = inner
        self.scheme = getattr(inner, "scheme", None)
        self._fence = fence
        #: hook(verb) per rejection — feeds tpu_operator_fenced_writes_total
        self.on_fenced = on_fenced
        self._lock = threading.Lock()
        #: rejections since construction, by verb (split-brain soak + /debug)
        self.fenced_total = 0
        self.fenced_by_verb: dict = {}
        #: mutating calls actually dispatched to the inner client, and the
        #: epoch each was admitted under — the soak's "zero landed writes"
        #: evidence and the stamp a post-mortem correlates with the Lease
        self.dispatched_total = 0
        self.last_dispatched_epoch: Optional[int] = None

    def bind(self, fence) -> None:
        """Attach the elector's live view (composition roots create the
        elector after the client chain)."""
        self._fence = fence

    # -- the gate --------------------------------------------------------------
    @staticmethod
    def _is_lease(api_version: Optional[str] = None,
                  kind: Optional[str] = None, obj: Optional[dict] = None) -> bool:
        if obj is not None:
            api_version = obj.get("apiVersion", api_version)
            kind = obj.get("kind", kind)
        return kind == "Lease"

    def _admit(self, verb: str, api_version=None, kind=None,
               obj=None) -> Optional[int]:
        """Check the live view; returns the epoch the write is admitted
        under (None = unfenced deployment or Lease bypass), raises
        :class:`FencedError` when this replica is deposed."""
        fence = self._fence
        if fence is None or self._is_lease(api_version, kind, obj):
            return None
        epoch = fence.current_epoch()
        if epoch is None:
            with self._lock:
                self.fenced_total += 1
                self.fenced_by_verb[verb] = self.fenced_by_verb.get(verb, 0) + 1
            if self.on_fenced is not None:
                try:
                    self.on_fenced(verb)
                except Exception:
                    pass
            held = getattr(fence, "epoch", None)
            log.warning("fenced write rejected: %s %s/%s by deposed replica "
                        "(last held epoch %s)", verb, kind or "?",
                        _name_of(obj) if obj else "?", held)
            raise FencedError(
                f"write fenced: this replica is not the leader "
                f"(verb={verb}, last held epoch={held}); requeue until "
                f"leadership is re-acquired", epoch=held)
        with self._lock:
            self.dispatched_total += 1
            self.last_dispatched_epoch = epoch
        return epoch

    # -- reads (pass-through: deposed replicas may keep caches warm) -----------
    def get(self, api_version, kind, name, namespace=None) -> dict:
        return self.inner.get(api_version, kind, name, namespace)

    def list(self, api_version, kind, namespace=None, label_selector=None,
             field_selector=None) -> List[dict]:
        return self.inner.list(api_version, kind, namespace, label_selector,
                               field_selector)

    # -- writes (fenced) -------------------------------------------------------
    def create(self, obj: dict) -> dict:
        self._admit("POST", obj=obj)
        return self.inner.create(obj)

    def update(self, obj: dict) -> dict:
        self._admit("PUT", obj=obj)
        return self.inner.update(obj)

    def patch(self, api_version, kind, name, patch, namespace=None) -> dict:
        self._admit("PATCH", api_version, kind)
        return self.inner.patch(api_version, kind, name, patch, namespace)

    def delete(self, api_version, kind, name, namespace=None) -> None:
        self._admit("DELETE", api_version, kind)
        return self.inner.delete(api_version, kind, name, namespace)

    def update_status(self, obj: dict) -> dict:
        self._admit("PUT", obj=obj)
        return self.inner.update_status(obj)

    def evict(self, name: str, namespace: Optional[str] = None) -> None:
        self._admit("EVICT", "v1", "Pod")
        return self.inner.evict(name, namespace)

    # -- passthrough -----------------------------------------------------------
    def watch(self, api_version, kind, namespace=None, handler=None,
              relist_handler=None) -> WatchHandle:
        return self.inner.watch(api_version, kind, namespace, handler,
                                relist_handler=relist_handler)

    def server_version(self) -> str:
        return self.inner.server_version()

    def stop(self) -> None:
        self.inner.stop()


def _name_of(obj: Optional[dict]) -> str:
    return (obj or {}).get("metadata", {}).get("name", "?")


def find_fenced(client: Optional[Client]) -> Optional[FencedClient]:
    """Locate the FencedClient in a wrapper chain (CachedClient →
    RetryingClient → FencedClient → RestClient) so the app can wire the
    fenced-writes counter and bind the elector without caring about
    stacking order."""
    seen = set()
    while client is not None and id(client) not in seen:
        seen.add(id(client))
        if isinstance(client, FencedClient):
            return client
        client = getattr(client, "inner", None)
    return None
