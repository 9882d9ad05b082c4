"""The client interface every consumer in the operator programs against
(copy of tpu_operator/client/interface.py).

Mirrors the slice of controller-runtime's client.Client the reference actually
uses (Get/List/Create/Update/Patch/Delete + Status().Update + watches). All
objects are unstructured plain dicts -- the same decision as the reference's
new-style engine which applies []unstructured.Unstructured
(internal/state/state_skel.go:223-285).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    object: dict


class Client:
    """Abstract k8s API client. Implementations: FakeClient, RestClient,
    and the WriteBatcher wrapper, which exposes the wrapped client as
    ``.inner`` so cross-cutting wiring (metrics hooks) can walk the chain.

    Error contract: implementations raise the typed
    :mod:`~tpu_operator_torch.client.errors` hierarchy."""

    def stop(self) -> None:
        """Release background resources (informer watches, streams). No-op
        for stateless clients; callers can invoke unconditionally."""

    # -- reads ---------------------------------------------------------------
    def get(self, api_version: str, kind: str, name: str, namespace: Optional[str] = None) -> dict:
        raise NotImplementedError

    def list(
        self,
        api_version: str,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[dict] = None,
        field_selector: Optional[dict] = None,
    ) -> List[dict]:
        raise NotImplementedError

    # -- writes --------------------------------------------------------------
    def create(self, obj: dict) -> dict:
        raise NotImplementedError

    def update(self, obj: dict) -> dict:
        raise NotImplementedError

    def patch(self, api_version: str, kind: str, name: str, patch: dict, namespace: Optional[str] = None) -> dict:
        """JSON-merge-patch semantics."""
        raise NotImplementedError

    def delete(self, api_version: str, kind: str, name: str, namespace: Optional[str] = None) -> None:
        raise NotImplementedError

    def update_status(self, obj: dict) -> dict:
        """Update only the status subresource."""
        raise NotImplementedError

    def evict(self, name: str, namespace: Optional[str] = None) -> None:
        """Evict a pod through the Eviction subresource (policy/v1). Unlike
        :meth:`delete`, it honours PodDisruptionBudgets: a budget that
        allows no disruption answers 429 (``TooManyRequestsError``, its
        ``retry_after`` the server's ``Retry-After``). The upgrade's drain
        goes through it, as ``kubectl drain`` does."""
        raise NotImplementedError

    # -- watches -------------------------------------------------------------
    def watch(
        self,
        api_version: str,
        kind: str,
        namespace: Optional[str] = None,
        handler: Optional[Callable[[WatchEvent], None]] = None,
        relist_handler: Optional[Callable[[List[dict], str], None]] = None,
    ) -> "WatchHandle":
        """Subscribe to change events. Returns a handle with .stop().

        ``relist_handler(items, rv)``, when given, receives each full LIST
        snapshot (initial sync and every resync after a lost resume point)
        INSTEAD of per-item synthetic ADDED events — cache consumers need
        the replace-boundary to expire entries deleted during a
        missed-event window. Implementations must accept the kwarg; ones
        with gap-free streams may call it exactly once at registration."""
        raise NotImplementedError

    # -- discovery -----------------------------------------------------------
    def server_version(self) -> str:
        """The apiserver's version string."""
        raise NotImplementedError


class WatchHandle:
    def stop(self) -> None:
        raise NotImplementedError

    def events(self) -> Iterable[WatchEvent]:
        raise NotImplementedError
