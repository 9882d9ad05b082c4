"""Seeded fault injection for the client stack (counterpart of
tpu_operator/client/chaos.py).

Two random injectors, driven by one seeded :class:`random.Random` so a
failing chaos run replays exactly:

* :class:`ChaosClient` wraps any :class:`~.interface.Client` (in practice
  the in-memory fake) and injects call-level faults before delegating:
  429s carrying ``Retry-After``, 503s, connection resets, latency. A
  retried call therefore never applies a write twice.
* :class:`ChaosTransport` takes the place of :class:`~.rest.Transport`
  under a :class:`~.rest.RestClient` (``RestClient(..., transport=...)``)
  and injects wire-level faults: a request refused as a connection reset,
  or answered with a 429 or 503 made up before the server is reached; and
  a watch stream chopped in the connection its ``connect`` returns, either
  reset mid-event (``drop``) or cut after half a JSON line (``truncate``).
  The watch loop must resume either way, with no event lost or doubled.

A third injector, :class:`CrashPointClient`, is deterministic: it records
every mutating call site of an episode (:func:`crash_site`) and can be armed
to simulate a process kill just before or just after one of them.

An injected reset is the transport error the port's ``http.client``
transport raises (``ConnectionResetError``, an ``OSError``), which
``client.errors.is_transient`` counts as retryable.
"""

from __future__ import annotations

import dataclasses
import json
import random
import time
from typing import Dict, List, Optional

from .errors import ApiError, TooManyRequestsError
from .interface import Client, WatchHandle
from .. import consts
from ..utils.hash import object_hash
from ..utils.locks import make_lock


@dataclasses.dataclass
class ChaosPolicy:
    """What to inject, how often. Rates are per-call probabilities in
    [0, 1]; the error mix is drawn uniformly from ``error_kinds``."""

    #: probability a CRUD call fails with an injected transient error
    error_rate: float = 0.0
    #: the transient mix: "429" (Retry-After attached), "503", "reset"
    error_kinds: tuple = ("429", "503", "reset")
    #: Retry-After seconds attached to injected 429s
    retry_after_s: float = 0.05
    #: added latency range (seconds) per surviving call
    latency_s: tuple = (0.0, 0.0)
    #: probability a streaming watch connection is chopped
    watch_chop_rate: float = 0.0
    #: "drop" = connection reset mid-event; "truncate" = a JSON line cut
    #: off mid-byte, then EOF
    truncate_mode: str = "drop"
    #: events a chopped stream delivers before it dies
    chop_after_lines: int = 2
    seed: int = 0

    def __post_init__(self):
        self.rng = random.Random(self.seed)
        self._lock = make_lock("ChaosPolicy._lock")
        #: injected faults by kind: a run asserts the chaos happened
        self.injected: Dict[str, int] = {}

    def _count(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1

    def injected_total(self) -> int:
        with self._lock:
            return sum(self.injected.values())

    # -- injection decisions ---------------------------------------------------
    def draw(self) -> Optional[str]:
        """One draw, in the reference's order (the roll, then the kind):
        the kind to inject, already counted, or None to let the call
        through."""
        with self._lock:
            roll = self.rng.random()
            kind = self.rng.choice(self.error_kinds)
        if roll >= self.error_rate:
            return None
        self._count(kind)
        return kind

    def maybe_fail(self, verb: str) -> None:
        """Raise an injected transient failure, or return to let the call
        through."""
        kind = self.draw()
        if kind is None:
            return
        if kind == "429":
            raise TooManyRequestsError(f"chaos: injected 429 on {verb}",
                                       retry_after=self.retry_after_s)
        if kind == "503":
            raise ApiError(f"chaos: injected 503 on {verb}", 503)
        raise ConnectionResetError(f"chaos: injected connection reset on {verb}")

    def maybe_sleep(self) -> None:
        lo, hi = self.latency_s
        if hi <= 0:
            return
        with self._lock:
            delay = self.rng.uniform(lo, hi)
        time.sleep(delay)

    def should_chop_watch(self) -> bool:
        with self._lock:
            hit = self.rng.random() < self.watch_chop_rate
        if hit:
            self._count(f"watch-{self.truncate_mode}")
        return hit


class ChaosClient(Client):
    """Call-level injector over any client: every CRUD call may fail or
    slow down before it reaches ``inner``; watches pass through (a
    client-level stream has no wire to break). ``exempt`` verbs skip
    injection."""

    def __init__(self, inner: Client, policy: ChaosPolicy, exempt: tuple = ()):
        self.inner = inner
        self.policy = policy
        self.scheme = getattr(inner, "scheme", None)
        self._exempt = set(exempt)

    def _zap(self, verb: str) -> None:
        if verb in self._exempt:
            return
        self.policy.maybe_sleep()
        self.policy.maybe_fail(verb)

    def get(self, api_version, kind, name, namespace=None) -> dict:
        self._zap("GET")
        return self.inner.get(api_version, kind, name, namespace)

    def list(self, api_version, kind, namespace=None, label_selector=None,
             field_selector=None) -> List[dict]:
        self._zap("LIST")
        return self.inner.list(api_version, kind, namespace, label_selector, field_selector)

    def create(self, obj: dict) -> dict:
        self._zap("POST")
        return self.inner.create(obj)

    def update(self, obj: dict) -> dict:
        self._zap("PUT")
        return self.inner.update(obj)

    def patch(self, api_version, kind, name, patch, namespace=None) -> dict:
        self._zap("PATCH")
        return self.inner.patch(api_version, kind, name, patch, namespace)

    def delete(self, api_version, kind, name, namespace=None) -> None:
        self._zap("DELETE")
        return self.inner.delete(api_version, kind, name, namespace)

    def update_status(self, obj: dict) -> dict:
        self._zap("PUT")
        return self.inner.update_status(obj)

    def evict(self, name: str, namespace: Optional[str] = None) -> None:
        self._zap("EVICT")
        return self.inner.evict(name, namespace)

    def server_version(self) -> str:
        self._zap("GET")
        return self.inner.server_version()

    def watch(self, api_version, kind, namespace=None, handler=None,
              relist_handler=None) -> WatchHandle:
        return self.inner.watch(api_version, kind, namespace, handler,
                                relist_handler=relist_handler)

    def stop(self) -> None:
        self.inner.stop()


# -- the wire-level injector ---------------------------------------------------------

class _ChoppedResponse:
    """A streaming ``http.client.HTTPResponse`` that serves at most
    ``after_lines`` watch lines, then dies as a broken connection does:
    ``drop`` raises mid-read, ``truncate`` returns half a JSON line and then
    EOF."""

    def __init__(self, inner, after_lines: int, mode: str):
        self._inner = inner
        self._after = after_lines
        self._mode = mode
        self._served = 0
        self._ended = False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def readline(self, *args) -> bytes:
        if self._ended:
            return b""
        line = self._inner.readline(*args)
        if not line:
            return line
        if self._served >= self._after:
            self._inner.close()
            if self._mode == "truncate":
                self._ended = True
                body = line.rstrip(b"\r\n")
                return body[: max(1, len(body) // 2)]  # half an event, no newline
            raise ConnectionResetError("chaos: watch connection reset mid-stream")
        if line.strip():
            self._served += 1
        return line


class _ChaosConnection:
    """An ``http.client`` connection whose streaming answer may be chopped."""

    def __init__(self, inner, policy: ChaosPolicy):
        self._inner = inner
        self._policy = policy

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def getresponse(self):
        resp = self._inner.getresponse()
        if resp.status < 400 and self._policy.should_chop_watch():
            return _ChoppedResponse(resp, self._policy.chop_after_lines,
                                    self._policy.truncate_mode)
        return resp


class ChaosTransport:
    """Wire-level injector for :class:`~.rest.RestClient`: pass as its
    ``transport``. A plain request may be refused (connection reset) or
    answered with a made-up 429 (``Retry-After`` attached) or 503 before the
    server is reached; a watch's connection may be chopped."""

    def __init__(self, inner, policy: ChaosPolicy):
        self.inner = inner
        self.policy = policy

    def __getattr__(self, name):
        # scheme, host, port, prefix, headers, target, close
        return getattr(self.inner, name)

    @staticmethod
    def _synthesize(code: int, headers: Optional[dict] = None):
        from .rest import Response

        body = b'{"kind":"Status","message":"chaos: injected response","code":%d}' % code
        return Response(code, {"Content-Type": "application/json", **(headers or {})}, body)

    def request(self, method: str, path: str, params: Optional[dict] = None,
                body: Optional[bytes] = None, content_type: str = "application/json",
                timeout: Optional[float] = None):
        policy = self.policy
        policy.maybe_sleep()
        kind = policy.draw()
        if kind == "reset":
            raise ConnectionResetError(f"chaos: injected connection reset on {method}")
        if kind == "429":
            return self._synthesize(429, {"Retry-After": str(policy.retry_after_s)})
        if kind is not None:
            return self._synthesize(503)
        return self.inner.request(method, path, params, body, content_type, timeout=timeout)

    def connect(self, timeout: Optional[float]):
        return _ChaosConnection(self.inner.connect(timeout), self.policy)


# -- the deterministic kill-point injector -------------------------------------------

class OperatorCrashed(Exception):
    """The simulated kill: raised at the armed crash point and from every
    later call on the dead client. Not an ApiError: a killed process runs
    no per-object error handling, so no ``except ApiError`` may swallow it."""


def _patch_paths(patch: dict, prefix: str = "") -> List[str]:
    """Sorted dotted leaf-key paths of a merge-patch body, the shape of the
    write. ``metadata.resourceVersion`` is left out: it is a precondition,
    not payload."""
    out = []
    for key in sorted(patch):
        path = f"{prefix}.{key}" if prefix else key
        if path == "metadata.resourceVersion":
            continue
        value = patch[key]
        if isinstance(value, dict) and value:
            out.extend(_patch_paths(value, path))
        else:
            out.append(path)
    return out


def crash_site(verb: str, api_version: Optional[str], kind: Optional[str],
               name: Optional[str], patch: Optional[dict] = None,
               obj: Optional[dict] = None) -> str:
    """A stable identifier for one mutating call site: an Event keys on its
    involved object's name and its reason (never its random name), a PATCH
    on the sorted leaf-key paths of its body (never its values).

    A decision journal's mirror ConfigMap keys on its record's subsystem,
    kind, trigger and decision, never its name: the name is the record's
    content address, which holds the episode id, and a health episode's id
    holds the node's ``-since`` stamp (each episode its own id), so the same
    decision in another run of an episode is another name. The reference's
    episode ids hold no stamp, and it keys the ConfigMap on its name."""
    if obj is not None:
        kind = obj.get("kind") or kind
        api_version = obj.get("apiVersion") or api_version
        meta = obj.get("metadata", {})
        if kind == "Event":
            involved = obj.get("involvedObject", {})
            return (f"{verb} Event/{involved.get('kind')}:"
                    f"{involved.get('name')}:{obj.get('reason')}")
        if kind == "ConfigMap" and consts.PROVENANCE_LABEL in (meta.get("labels") or {}):
            record = json.loads((obj.get("data") or {}).get("record") or "{}")
            decided = object_hash({k: record.get(k) for k in ("trigger", "decision")})
            return (f"{verb} ConfigMap/prov:{record.get('subsystem')}:"
                    f"{record.get('kind')}:{decided}")
        name = meta.get("name") or meta.get("generateName")
    site = f"{verb} {kind}/{name}"
    if patch:
        site += " [" + ",".join(_patch_paths(patch)) + "]"
    return site


class CrashPointClient(Client):
    """Deterministic kill-point injector for crash-recovery soaks.

    Unarmed (``arm=None``) every mutating call goes through while its
    :func:`crash_site` is collected, in first-occurrence order, in
    :attr:`sites`: one recorded episode is the replay matrix. Armed
    (``arm=(site, "before"|"after")``) the first call at ``site`` simulates a
    kill: ``before`` drops the write, ``after`` lets it land; either way
    :class:`OperatorCrashed` is raised and every later call raises too."""

    MUTATING = ("POST", "PUT", "STATUS", "PATCH", "DELETE", "EVICT")

    def __init__(self, inner: Client, arm: Optional[tuple] = None):
        self.inner = inner
        self.scheme = getattr(inner, "scheme", None)
        self.arm = arm
        #: mutating site keys, first-occurrence order
        self.sites: List[str] = []
        self._seen: set = set()
        self.fired = False
        self.dead = False
        self._lock = make_lock("CrashPointClient._lock")

    def _alive(self) -> None:
        if self.dead:
            raise OperatorCrashed("crashed operator: client is dead")

    def _gate(self, site: str, dispatch):
        with self._lock:
            self._alive()
            if site not in self._seen:
                self._seen.add(site)
                self.sites.append(site)
            armed = self.arm is not None and not self.fired and self.arm[0] == site
            if armed:
                self.fired = True
                if self.arm[1] == "before":
                    self.dead = True
                    raise OperatorCrashed(f"killed before {site}")
        if not armed:
            return dispatch()
        try:
            # crash-after: the write reached the apiserver (a 409 counts as
            # reached) and the process dies before it sees the answer
            dispatch()
        finally:
            with self._lock:
                self.dead = True
        raise OperatorCrashed(f"killed after {site}")

    # -- mutating verbs --------------------------------------------------------
    def create(self, obj: dict) -> dict:
        site = crash_site("POST", None, None, None, obj=obj)
        return self._gate(site, lambda: self.inner.create(obj))

    def update(self, obj: dict) -> dict:
        site = crash_site("PUT", None, None, None, obj=obj)
        return self._gate(site, lambda: self.inner.update(obj))

    def update_status(self, obj: dict) -> dict:
        site = crash_site("STATUS", None, None, None, obj=obj)
        return self._gate(site, lambda: self.inner.update_status(obj))

    def patch(self, api_version, kind, name, patch, namespace=None) -> dict:
        site = crash_site("PATCH", api_version, kind, name, patch=patch)
        return self._gate(site, lambda: self.inner.patch(api_version, kind, name, patch,
                                                         namespace))

    def delete(self, api_version, kind, name, namespace=None) -> None:
        site = crash_site("DELETE", api_version, kind, name)
        return self._gate(site, lambda: self.inner.delete(api_version, kind, name, namespace))

    def evict(self, name: str, namespace: Optional[str] = None) -> None:
        site = crash_site("EVICT", "v1", "Pod", name)
        return self._gate(site, lambda: self.inner.evict(name, namespace))

    # -- reads and plumbing: they die with the process, never crash points ------
    def get(self, api_version, kind, name, namespace=None) -> dict:
        self._alive()
        return self.inner.get(api_version, kind, name, namespace)

    def list(self, api_version, kind, namespace=None, label_selector=None,
             field_selector=None) -> List[dict]:
        self._alive()
        return self.inner.list(api_version, kind, namespace, label_selector, field_selector)

    def watch(self, api_version, kind, namespace=None, handler=None,
              relist_handler=None) -> WatchHandle:
        self._alive()
        return self.inner.watch(api_version, kind, namespace, handler,
                                relist_handler=relist_handler)

    def server_version(self) -> str:
        self._alive()
        return self.inner.server_version()

    def stop(self) -> None:
        self.inner.stop()
