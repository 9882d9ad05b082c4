"""In-memory fake Kubernetes API for tests (copy of
tpu_operator/client/fake.py). Like a real apiserver it validates the
operator's custom resources (ClusterPolicy, GPUDriver) against the CRDs the
spec dataclasses generate (``api/schema_gen.py``): a create with an unknown
field or a bad value is refused with :class:`~.errors.InvalidError` (422),
and an update is pruned to the schema, then validated.

The reference's entire unit-test strategy is built on controller-runtime's
fake client (SURVEY.md section 4.1; e.g. controllers/object_controls_test.go:241).
This fake replicates the parts that matter to an operator: identity + metadata
bookkeeping (uid/resourceVersion/creationTimestamp), optimistic-concurrency
conflicts, label/field selectors, watches, ownerReference garbage
collection (which real clusters do server-side), and the Eviction
subresource's PodDisruptionBudget check.
"""

from __future__ import annotations

import copy
import queue
import threading
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import deep_get, json_merge_patch, rfc3339_now
from .errors import (
    AlreadyExistsError,
    ApiError,
    ConflictError,
    InvalidError,
    NotFoundError,
    TooManyRequestsError,
)
from .interface import Client, WatchEvent, WatchHandle
from .scheme import Scheme, default_scheme

Key = Tuple[str, str, str, str]

#: the ``Retry-After`` a budget-blocked eviction answers with, in seconds,
#: which the upgrade machine requeues on
EVICTION_RETRY_AFTER_S = 2.0

_crd_schemas_cache: Optional[Dict[Tuple[str, str], dict]] = None


def _default_crd_schemas() -> Dict[Tuple[str, str], dict]:
    """(apiVersion, kind) -> served openAPIV3Schema of the operator's CRDs,
    compiled once per process (schema_gen walks the spec dataclasses)."""
    global _crd_schemas_cache
    if _crd_schemas_cache is None:
        from ..api import schema_gen
        schemas: Dict[Tuple[str, str], dict] = {}
        for crd in schema_gen.generate_crds().values():
            group = crd["spec"]["group"]
            kind = crd["spec"]["names"]["kind"]
            for v in crd["spec"]["versions"]:
                if v.get("served"):
                    schemas[(f"{group}/{v['name']}", kind)] = \
                        v["schema"]["openAPIV3Schema"]
        _crd_schemas_cache = schemas
    return _crd_schemas_cache

def match_label_selector(labels: Optional[dict], selector: Optional[dict]) -> bool:
    """Equality-based selector; a value of None means 'key exists'."""
    if not selector:
        return True
    labels = labels or {}
    for key, want in selector.items():
        if want is None:
            if key not in labels:
                return False
        elif labels.get(key) != want:
            return False
    return True


def match_field_selector(obj: dict, selector: Optional[dict]) -> bool:
    if not selector:
        return True
    for path, want in selector.items():
        if deep_get(obj, *path.split(".")) != want:
            return False
    return True


class _FakeWatch(WatchHandle):
    def __init__(self, owner: "FakeClient", key: Tuple[str, str, str],
                 handler: Optional[Callable[[WatchEvent], None]]):
        self._owner = owner
        self._key = key
        self._handler = handler
        self._queue: "queue.Queue[WatchEvent]" = queue.Queue()
        self._stopped = False

    def push(self, event: WatchEvent) -> None:
        if self._stopped:
            return
        if self._handler is not None:
            self._handler(event)
        else:
            self._queue.put(event)

    def stop(self) -> None:
        self._stopped = True
        self._owner._remove_watch(self)

    def events(self, idle_timeout: float = 0.5):
        """Yield events as they arrive; return after ``idle_timeout`` s of quiet."""
        while not self._stopped:
            try:
                yield self._queue.get(timeout=idle_timeout)
            except queue.Empty:
                return


class FakeClient(Client):
    def __init__(self, scheme: Optional[Scheme] = None, objects: Optional[List[dict]] = None):
        self.scheme = scheme or default_scheme()
        self._lock = threading.RLock()
        self._store: Dict[Key, dict] = {}
        self._rv = 0
        # last rv at which an event was emitted, per (apiVersion, kind,
        # namespace): lets the HTTP facade answer "did this watcher miss
        # anything?" the way a real apiserver's watch cache does (410 Gone
        # on resume from before the retained history). Keyed by namespace so
        # a namespaced watcher isn't spuriously expired by other namespaces'
        # traffic on every reconnect.
        self._last_event_rv: Dict[Tuple[str, str, str], int] = {}
        self._watches: List[_FakeWatch] = []
        #: uids of deleted objects — creates carrying a controller ownerRef
        #: to one of these are garbage-collected immediately (see create())
        self._deleted_uids: set = set()
        #: the CRD schemas every write of a tpu.ai CR is held to, as a real
        #: apiserver holds them
        self._crd_schemas: Dict[Tuple[str, str], dict] = dict(_default_crd_schemas())
        for obj in objects or []:
            self.create(obj)

    def _admit(self, obj: dict, prune: bool = False) -> None:
        """CRD schema admission. ``prune=True`` (updates) first drops the
        fields the schema does not know, as a real apiserver does on a write
        to a stored object, so a CR stored under an older schema does not
        wedge every later status write. Creates are strict: a typo'd new CR
        is a 422."""
        schema = self._crd_schemas.get((obj.get("apiVersion"), obj.get("kind")))
        if schema is None:
            return
        from ..api import schema_validate
        if prune:
            schema_validate.prune(obj, schema)
        errors = schema_validate.validate(obj, schema, obj.get("kind", "object"))
        if errors:
            raise InvalidError(
                f"{obj.get('kind')}/{obj.get('metadata', {}).get('name', '?')} "
                f"is invalid: " + "; ".join(errors))

    # -- helpers -------------------------------------------------------------
    def _key(self, api_version: str, kind: str, name: str, namespace: Optional[str]) -> Key:
        ns = (namespace or "default") if self.scheme.is_namespaced(api_version, kind) else ""
        return (api_version, kind, ns, name)

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def current_rv(self) -> int:
        """Store-wide resourceVersion, the List-envelope resume point."""
        with self._lock:
            return self._rv

    def last_event_rv(self, api_version: str, kind: str,
                      namespace: Optional[str] = None) -> int:
        """rv of the newest event emitted for this kind (0 = never).
        ``namespace=None`` means the all-namespaces watch scope."""
        with self._lock:
            if namespace is not None:
                return self._last_event_rv.get((api_version, kind, namespace), 0)
            return max((rv for (av, k, _), rv in self._last_event_rv.items()
                        if av == api_version and k == kind), default=0)

    def _notify(self, event_type: str, obj: dict) -> None:
        self._last_event_rv[(obj.get("apiVersion"), obj.get("kind"),
                             obj.get("metadata", {}).get("namespace", ""))] = self._rv
        for w in list(self._watches):
            api_version, kind, ns = w._key
            if api_version != obj.get("apiVersion") or kind != obj.get("kind"):
                continue
            if ns and obj.get("metadata", {}).get("namespace", "") != ns:
                continue
            w.push(WatchEvent(type=event_type, object=copy.deepcopy(obj)))

    def _remove_watch(self, w: _FakeWatch) -> None:
        with self._lock:
            if w in self._watches:
                self._watches.remove(w)

    # -- reads ---------------------------------------------------------------
    def get(self, api_version: str, kind: str, name: str, namespace: Optional[str] = None) -> dict:
        with self._lock:
            key = self._key(api_version, kind, name, namespace)
            if key not in self._store:
                raise NotFoundError(f"{kind} {namespace or ''}/{name} not found")
            return copy.deepcopy(self._store[key])

    def list(self, api_version, kind, namespace=None, label_selector=None, field_selector=None) -> List[dict]:
        with self._lock:
            out = []
            for (av, k, ns, _), obj in sorted(self._store.items()):
                if av != api_version or k != kind:
                    continue
                if namespace and ns != namespace:
                    continue
                if not match_label_selector(deep_get(obj, "metadata", "labels"), label_selector):
                    continue
                if not match_field_selector(obj, field_selector):
                    continue
                out.append(copy.deepcopy(obj))
            return out

    # -- writes --------------------------------------------------------------
    def create(self, obj: dict) -> dict:
        obj = copy.deepcopy(obj)
        meta = obj.setdefault("metadata", {})
        self._admit(obj)
        with self._lock:
            namespaced = self.scheme.is_namespaced(obj["apiVersion"], obj["kind"])
            if namespaced:
                meta.setdefault("namespace", "default")
            key = self._key(obj["apiVersion"], obj["kind"], meta["name"], meta.get("namespace"))
            if key in self._store:
                raise AlreadyExistsError(f"{obj['kind']} {meta['name']} already exists")
            meta.setdefault("uid", str(uuid.uuid4()))
            meta.setdefault("creationTimestamp", rfc3339_now())
            meta["resourceVersion"] = self._next_rv()
            meta.setdefault("generation", 1)
            self._store[key] = obj
            self._notify("ADDED", obj)
            created = copy.deepcopy(obj)
            self._collect_if_owner_dead(obj)
        return created

    def update(self, obj: dict) -> dict:
        obj = copy.deepcopy(obj)
        meta = obj.get("metadata", {})
        self._admit(obj, prune=True)
        with self._lock:
            key = self._key(obj["apiVersion"], obj["kind"], meta["name"], meta.get("namespace"))
            current = self._store.get(key)
            if current is None:
                raise NotFoundError(f"{obj['kind']} {meta.get('name')} not found")
            sent_rv = meta.get("resourceVersion")
            if sent_rv is not None and sent_rv != current["metadata"]["resourceVersion"]:
                raise ConflictError(f"resourceVersion conflict on {obj['kind']}/{meta['name']}")
            # no-op writes don't bump resourceVersion or emit events, matching
            # the real apiserver (prevents self-sustaining watch loops)
            normalized = copy.deepcopy(obj)
            normalized["metadata"] = {**current["metadata"],
                                      **{k: v for k, v in meta.items() if k != "resourceVersion"}}
            if normalized == current:
                return copy.deepcopy(current)
            meta["uid"] = current["metadata"]["uid"]
            meta["creationTimestamp"] = current["metadata"]["creationTimestamp"]
            meta["resourceVersion"] = self._next_rv()
            old_spec = current.get("spec")
            if obj.get("spec") != old_spec:
                meta["generation"] = current["metadata"].get("generation", 1) + 1
            else:
                meta["generation"] = current["metadata"].get("generation", 1)
            self._store[key] = obj
            self._notify("MODIFIED", obj)
            updated = copy.deepcopy(obj)
            self._collect_if_owner_dead(obj)  # adoption onto a dead owner
            return updated

    def patch(self, api_version, kind, name, patch, namespace=None) -> dict:
        with self._lock:
            current = self.get(api_version, kind, name, namespace)
            # rv-preconditioned merge patch, matching the real apiserver: a
            # patch carrying metadata.resourceVersion is rejected with 409
            # unless it names the live version (client/preconditions.py
            # builds on this); without one the patch applies blind
            sent_rv = deep_get(patch, "metadata", "resourceVersion")
            if (sent_rv is not None
                    and sent_rv != current["metadata"]["resourceVersion"]):
                raise ConflictError(
                    f"resourceVersion conflict on {kind}/{name} (patch "
                    f"precondition {sent_rv} != {current['metadata']['resourceVersion']})")
            json_merge_patch(current, patch)
            current["metadata"].pop("resourceVersion", None)
            return self.update(current)

    def delete(self, api_version, kind, name, namespace=None) -> None:
        with self._lock:
            key = self._key(api_version, kind, name, namespace)
            obj = self._store.pop(key, None)
            if obj is None:
                raise NotFoundError(f"{kind} {namespace or ''}/{name} not found")
            # deletions advance the store rv and the DELETED event carries it,
            # matching real apiserver semantics (a watcher resuming from
            # before the delete must be able to tell it missed one)
            obj["metadata"]["resourceVersion"] = self._next_rv()
            self._notify("DELETED", obj)
            uid = obj["metadata"].get("uid")
            if uid:  # an ownerRef missing its uid must never match a
                # None tombstone, and cascading on None would collect
                # every uid-less reference
                self._deleted_uids.add(uid)
                self._collect_orphans(uid)

    def _collect_if_owner_dead(self, obj: dict) -> None:
        """GC for the owner-deleted-mid-sweep race (called under the lock
        right after a write lands): a reconcile in flight when its CR is
        deleted re-creates — or adopts, via update — operands owned by the
        now-gone uid; the real garbage collector removes such objects
        shortly after, so the fake must too or they live forever (the
        uninstall e2e flaked exactly this way). Matches _collect_orphans'
        any-ownerRef rule; only uids this store actually DELETED count, so
        fixtures referencing never-created owners stay alive."""
        if any(ref.get("uid") in self._deleted_uids
               for ref in deep_get(obj, "metadata", "ownerReferences",
                                   default=[]) or []):
            try:
                self.delete(obj["apiVersion"], obj["kind"],
                            obj["metadata"]["name"],
                            obj["metadata"].get("namespace"))
            except NotFoundError:
                pass  # a watch handler already removed it

    def _collect_orphans(self, owner_uid: str) -> None:
        """Server-side ownerReference garbage collection (cascade)."""
        doomed = []
        for key, obj in self._store.items():
            for ref in deep_get(obj, "metadata", "ownerReferences", default=[]) or []:
                if ref.get("uid") == owner_uid:
                    doomed.append(key)
                    break
        for api_version, kind, ns, name in doomed:
            try:
                self.delete(api_version, kind, name, ns or None)
            except NotFoundError:
                pass

    def evict(self, name: str, namespace: Optional[str] = None) -> None:
        """The Eviction subresource: every PodDisruptionBudget of the pod's
        namespace whose selector matches it must allow a disruption, else
        429 with :data:`EVICTION_RETRY_AFTER_S`. A budget's headroom is its
        ``status.disruptionsAllowed`` when set, else computed from
        ``minAvailable`` or ``maxUnavailable`` over the matching pods, of
        which only running ones count as healthy. A selector with
        ``matchExpressions`` is refused (501) rather than misread."""
        with self._lock:
            pod = self.get("v1", "Pod", name, namespace)
            ns = pod["metadata"].get("namespace")
            labels = deep_get(pod, "metadata", "labels", default={}) or {}
            for pdb in self.list("policy/v1", "PodDisruptionBudget", ns):
                if deep_get(pdb, "spec", "selector", "matchExpressions"):
                    raise ApiError(
                        f"PDB {pdb['metadata']['name']}: selector.matchExpressions "
                        f"is not supported by the simulator; use matchLabels", 501)
                selector = deep_get(pdb, "spec", "selector", "matchLabels", default={}) or {}
                # policy/v1: an empty selector matches every pod of the namespace
                if not all(labels.get(k) == v for k, v in selector.items()):
                    continue
                allowed = deep_get(pdb, "status", "disruptionsAllowed")
                if allowed is None:
                    allowed = self._disruptions_allowed(pdb, ns, selector)
                if allowed <= 0:
                    raise TooManyRequestsError(
                        f"Cannot evict pod {ns}/{name}: disruption budget "
                        f"{pdb['metadata']['name']} needs "
                        f"{deep_get(pdb, 'spec', 'minAvailable')} available",
                        retry_after=EVICTION_RETRY_AFTER_S)
            self.delete("v1", "Pod", name, namespace)

    def _disruptions_allowed(self, pdb: dict, namespace: str, selector: dict) -> int:
        """A budget's headroom as the disruption controller counts it: only
        running pods are healthy. A ``minAvailable`` percentage rounds up; a
        ``maxUnavailable`` one rounds down, and unhealthy pods use it up."""
        matching = [p for p in self.list("v1", "Pod", namespace)
                    if all(deep_get(p, "metadata", "labels", k) == v
                           for k, v in selector.items())]
        healthy = [p for p in matching
                   if deep_get(p, "status", "phase", default="Running") == "Running"]
        min_avail = deep_get(pdb, "spec", "minAvailable")
        max_unavail = deep_get(pdb, "spec", "maxUnavailable")
        if min_avail is not None:
            if isinstance(min_avail, str) and min_avail.endswith("%"):
                min_avail = -(-len(matching) * int(min_avail[:-1]) // 100)
            return len(healthy) - int(min_avail)
        if max_unavail is not None:
            if isinstance(max_unavail, str) and max_unavail.endswith("%"):
                max_unavail = len(matching) * int(max_unavail[:-1]) // 100
            return int(max_unavail) - (len(matching) - len(healthy))
        return 0  # neither bound set: nothing is evictable

    def update_status(self, obj: dict) -> dict:
        with self._lock:
            meta = obj.get("metadata", {})
            current = self.get(obj["apiVersion"], obj["kind"], meta["name"], meta.get("namespace"))
            if current.get("status", {}) == obj.get("status", {}):
                return current  # no-op status write
            current["status"] = copy.deepcopy(obj.get("status", {}))
            current["metadata"].pop("resourceVersion", None)
            # status updates must not bump generation
            saved_gen = current["metadata"].get("generation", 1)
            updated = self.update(current)
            updated["metadata"]["generation"] = saved_gen
            return updated

    def server_version(self) -> str:
        return "v1.31.0-fake"

    # -- watches -------------------------------------------------------------
    def watch(self, api_version, kind, namespace=None, handler=None,
              relist_handler=None) -> WatchHandle:
        """``relist_handler(items, rv)``, when given, is called once with an
        initial snapshot taken atomically with the watch registration (same
        lock as every write) — cache consumers get a gap-free sync: no event
        can land between the snapshot and the stream start."""
        with self._lock:
            w = _FakeWatch(self, (api_version, kind, namespace or ""), handler)
            self._watches.append(w)
            if relist_handler is not None:
                relist_handler(self.list(api_version, kind, namespace), str(self._rv))
            return w
