"""The apiserver client over plain REST (counterpart of
tpu_operator/client/rest.py), on the standard library's ``http.client``:
the card's machine and a node image need no ``requests``.

:class:`RestClient` is the operator's: GET, LIST (label and field
selectors), POST, PUT, merge PATCH, DELETE, the status subresource, and streaming
watches, for every kind of the scheme (core
``v1``, ``apps/v1``, RBAC, the operator's ``tpu.ai/v1`` ClusterPolicy...).
:class:`ApiClient` is the validator's: the same transport, held to the
``v1`` Nodes, Pods and Events its service account may touch.

Error statuses raise the :mod:`~tpu_operator_torch.client.errors`
hierarchy; transport failures raise ``OSError`` or
``http.client.HTTPException``.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import queue
import ssl
import threading
import urllib.parse
from typing import Callable, List, Optional

from .. import tracing
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

log = logging.getLogger(__name__)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

#: default per-call deadline (``--api-timeout``); LIST keeps 60 s and the
#: watch stream its own 330 s read timeout
DEFAULT_TIMEOUT_S = 30.0
LIST_TIMEOUT_S = 60.0
WATCH_TIMEOUT_S = 330.0


def parse_retry_after(value: Optional[str]) -> Optional[float]:
    """``Retry-After`` header → seconds (None when absent or unparseable),
    in both forms RFC 9110 allows: delta-seconds and HTTP-date."""
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        import datetime
        from email.utils import parsedate_to_datetime

        when = parsedate_to_datetime(value)
        return max(0.0, (when - datetime.datetime.now(when.tzinfo)).total_seconds())
    except (TypeError, ValueError):
        return None


def _in_cluster_config() -> dict:
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    if not host:
        raise RuntimeError("no apiserver: set KUBE_API_URL or run in-cluster")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    with open(os.path.join(SA_DIR, "token")) as f:
        token = f.read().strip()
    ca = os.path.join(SA_DIR, "ca.crt")
    return {"base_url": f"https://{host}:{port}", "token": token,
            "verify": ca if os.path.exists(ca) else True}


class Response:
    """A finished HTTP exchange: status, headers and the whole body."""

    def __init__(self, status: int, headers, body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    def json(self):
        return json.loads(self.body) if self.body else {}


class Transport:
    """HTTP(S) to one apiserver, with one keep-alive connection per thread.
    A request on a connection the server has closed since its last use is
    sent once more on a fresh one (nothing was processed: the server closes
    only idle connections)."""

    def __init__(self, base_url: str, token: Optional[str] = None, verify=True):
        url = urllib.parse.urlsplit(base_url.rstrip("/"))
        if url.scheme not in ("http", "https"):
            raise ValueError(f"apiserver URL must be http(s): {base_url!r}")
        self.scheme = url.scheme
        self.host = url.hostname or "localhost"
        self.port = url.port
        self.prefix = url.path
        self.headers = {"Accept": "application/json"}
        if token:
            self.headers["Authorization"] = f"Bearer {token}"
        self._context = None
        if self.scheme == "https":
            if verify is False:
                self._context = ssl._create_unverified_context()
            else:
                self._context = ssl.create_default_context(
                    cafile=verify if isinstance(verify, str) else None)
        self._local = threading.local()

    def connect(self, timeout: Optional[float]) -> http.client.HTTPConnection:
        if self.scheme == "https":
            return http.client.HTTPSConnection(self.host, self.port, timeout=timeout,
                                               context=self._context)
        return http.client.HTTPConnection(self.host, self.port, timeout=timeout)

    def target(self, path: str, params: Optional[dict] = None) -> str:
        query = f"?{urllib.parse.urlencode(params)}" if params else ""
        return f"{self.prefix}{path}{query}"

    def request(self, method: str, path: str, params: Optional[dict] = None,
                body: Optional[bytes] = None, content_type: str = "application/json",
                timeout: Optional[float] = DEFAULT_TIMEOUT_S) -> Response:
        headers = dict(self.headers)
        if body is not None:
            headers["Content-Type"] = content_type
        target = self.target(path, params)
        for attempt in (0, 1):
            conn = getattr(self._local, "conn", None)
            reused = conn is not None
            if conn is None:
                conn = self._local.conn = self.connect(timeout)
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            try:
                conn.request(method, target, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.RemoteDisconnected, BrokenPipeError,
                    ConnectionResetError, http.client.CannotSendRequest):
                conn.close()
                self._local.conn = None
                if reused and attempt == 0:
                    continue
                raise
            except BaseException:
                conn.close()
                self._local.conn = None
                raise
            if resp.will_close:
                conn.close()
                self._local.conn = None
            return Response(resp.status, resp.headers, data)
        raise AssertionError("unreachable")

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


def raise_for(resp: Response) -> None:
    """The typed ApiError of an error status (nothing below 400)."""
    if resp.status < 400:
        return
    try:
        message = resp.json().get("message") or resp.body.decode(errors="replace")
    except (ValueError, AttributeError):
        message = resp.body.decode(errors="replace")
    if resp.status == 404:
        raise NotFoundError(message)
    if resp.status == 409:
        if "already exists" in message:
            raise AlreadyExistsError(message)
        raise ConflictError(message)
    if resp.status == 422:
        raise InvalidError(message)
    if resp.status == 429:
        raise TooManyRequestsError(
            message, retry_after=parse_retry_after(resp.headers.get("Retry-After")))
    raise ApiError(message, resp.status)


class RestClient(Client):
    def __init__(self, base_url: Optional[str] = None, token: Optional[str] = None,
                 verify=None, scheme: Optional[Scheme] = None,
                 default_timeout: Optional[float] = DEFAULT_TIMEOUT_S):
        if base_url is None:
            cfg = _in_cluster_config()
            base_url, token, verify = cfg["base_url"], cfg["token"], cfg["verify"]
        self.base_url = base_url.rstrip("/")
        self.scheme = scheme or default_scheme()
        self.transport = Transport(self.base_url, token,
                                   verify if verify is not None else True)
        self.default_timeout = default_timeout
        #: optional telemetry hook called (method, status_code) per response
        #: (client-go's rest_client_requests_total analog)
        self.on_response: Optional[Callable[[str, int], None]] = None

    @classmethod
    def from_env(cls, **kwargs):
        """``$KUBE_API_URL`` when set, else the in-cluster service address
        and service-account token."""
        url = os.environ.get("KUBE_API_URL")
        if url:
            return cls(url, **kwargs)
        cfg = _in_cluster_config()
        return cls(cfg["base_url"], cfg["token"], cfg["verify"], **kwargs)

    # -- paths -----------------------------------------------------------------
    def resource_path(self, api_version: str, kind: str, namespace: Optional[str] = None,
                      name: Optional[str] = None, subresource: Optional[str] = None) -> str:
        info = self.scheme.info(api_version, kind)
        parts = ["", "api" if "/" not in api_version else "apis", api_version]
        if info.namespaced and not (namespace is None and name is None):
            # named operations default to "default"; a nameless path with no
            # namespace is the all-namespaces list or watch (/api/v1/pods)
            parts += ["namespaces", namespace or "default"]
        parts.append(info.plural)
        if name:
            parts.append(name)
        if subresource:
            parts.append(subresource)
        return "/".join(parts)

    @staticmethod
    def _selector_param(selector: Optional[dict]) -> Optional[str]:
        if not selector:
            return None
        return ",".join(k if v is None else f"{k}={v}" for k, v in selector.items())

    def _notify_response(self, method: str, code: int) -> None:
        if self.on_response is not None:
            try:
                self.on_response(method, code)
            except Exception:  # telemetry never breaks the request path
                pass

    def _request(self, method: str, path: str, params: Optional[dict] = None,
                 obj=None, content_type: str = "application/json",
                 timeout: Optional[float] = None) -> Response:
        """One apiserver round trip, as an api span of the active trace (a
        free no-op outside one). An error status raises the typed ApiError;
        404 leaves the span's status ok (absence is an answer)."""
        body = None if obj is None else json.dumps(obj).encode()
        with tracing.api_span(method, path) as sp:
            resp = self.transport.request(
                method, path, params, body, content_type,
                timeout=timeout if timeout is not None else self.default_timeout)
            sp.set_attribute("code", resp.status)
            self._notify_response(method, resp.status)
            if resp.status != 404:
                raise_for(resp)
        raise_for(resp)
        return resp

    # -- CRUD ------------------------------------------------------------------
    def get(self, api_version, kind, name, namespace=None) -> dict:
        return self._request("GET", self.resource_path(api_version, kind, namespace,
                                                       name)).json()

    def _list_body(self, api_version, kind, namespace=None, params=None) -> dict:
        """LIST returning the whole List envelope (a watch resumes from its
        ``metadata.resourceVersion``)."""
        body = self._request("GET", self.resource_path(api_version, kind, namespace),
                             params=params or None, timeout=LIST_TIMEOUT_S).json()
        for item in body.get("items", []):  # list items omit these
            item.setdefault("apiVersion", api_version)
            item.setdefault("kind", kind)
        return body

    def list(self, api_version, kind, namespace=None, label_selector=None,
             field_selector=None) -> List[dict]:
        params = {}
        if label_selector:
            params["labelSelector"] = self._selector_param(label_selector)
        if field_selector:
            params["fieldSelector"] = ",".join(f"{k}={v}" for k, v in field_selector.items())
        return self._list_body(api_version, kind, namespace, params).get("items", [])

    def create(self, obj: dict) -> dict:
        ns = obj.get("metadata", {}).get("namespace")
        return self._request("POST", self.resource_path(obj["apiVersion"], obj["kind"], ns),
                             obj=obj).json()

    def update(self, obj: dict) -> dict:
        meta = obj["metadata"]
        path = self.resource_path(obj["apiVersion"], obj["kind"], meta.get("namespace"),
                                  meta["name"])
        return self._request("PUT", path, obj=obj).json()

    def patch(self, api_version, kind, name, patch, namespace=None) -> dict:
        """JSON merge patch; a ``metadata.resourceVersion`` in it makes the
        apiserver refuse the write with 409 if the object changed since."""
        return self._request("PATCH", self.resource_path(api_version, kind, namespace, name),
                             obj=patch, content_type="application/merge-patch+json").json()

    def delete(self, api_version, kind, name, namespace=None) -> None:
        self._request("DELETE", self.resource_path(api_version, kind, namespace, name))

    def update_status(self, obj: dict) -> dict:
        meta = obj["metadata"]
        path = self.resource_path(obj["apiVersion"], obj["kind"], meta.get("namespace"),
                                  meta["name"], "status")
        return self._request("PUT", path, obj=obj).json()

    def evict(self, name: str, namespace: Optional[str] = None) -> None:
        """POST a policy/v1 Eviction to the pod's ``eviction`` subresource;
        a budget's refusal raises ``TooManyRequestsError`` with the answer's
        ``Retry-After`` in ``retry_after``."""
        self._request("POST", self.resource_path("v1", "Pod", namespace, name, "eviction"),
                      obj={"apiVersion": "policy/v1", "kind": "Eviction",
                           "metadata": {"name": name, "namespace": namespace}})

    def server_version(self) -> str:
        return self._request("GET", "/version").json().get("gitVersion", "unknown")

    def stop(self) -> None:
        self.transport.close()

    # -- watch -----------------------------------------------------------------
    def watch(self, api_version, kind, namespace=None, handler=None,
              relist_handler=None) -> WatchHandle:
        """``relist_handler(items, rv)``, when given, receives each full LIST
        snapshot (initial sync and every 410 resync) instead of per-item
        synthetic ADDED events."""
        return _RestWatch(self, api_version, kind, namespace, handler, relist_handler)


class _RestWatch(WatchHandle):
    """Streaming watch on a background thread with automatic reconnect.

    On (re)connect without a resume point the watcher re-LISTs and
    delivers an ADDED event per item before streaming, so a consumer misses
    no state changed while the stream was down (it may see duplicates;
    reconcilers are level-driven). A clean stream end resumes from the last
    streamed resourceVersion; an ERROR event or a refused connect (410 Gone
    and the like) relists. :meth:`stop` closes the stream's socket, which
    ends the thread promptly."""

    def __init__(self, client: RestClient, api_version: str, kind: str,
                 namespace: Optional[str], handler: Optional[Callable[[WatchEvent], None]],
                 relist_handler: Optional[Callable[[List[dict], str], None]] = None):
        self._client = client
        self._api_version = api_version
        self._kind = kind
        self._namespace = namespace
        self._handler = handler
        self._relist_handler = relist_handler
        self._stopped = threading.Event()
        self._conn: Optional[http.client.HTTPConnection] = None
        self._conn_lock = threading.Lock()
        self._queue: "queue.Queue[WatchEvent]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"watch-{kind}")
        self._thread.start()

    def _emit(self, event: WatchEvent) -> None:
        if self._handler:
            self._handler(event)
        else:
            self._queue.put(event)

    def _relist(self) -> str:
        body = self._client._list_body(self._api_version, self._kind, self._namespace)
        items = body.get("items", [])
        rv = ""
        for item in items:
            rv = item.get("metadata", {}).get("resourceVersion", rv)
        # resume from the List envelope's rv: an item's rv only says when
        # that item last changed
        rv = body.get("metadata", {}).get("resourceVersion") or rv
        if self._relist_handler is not None:
            self._relist_handler(items, rv)
        else:
            for item in items:
                self._emit(WatchEvent(type="ADDED", object=item))
        return rv

    def _stream(self, rv: str) -> tuple:
        """One watch connection: (last rv, whether to relist, back-off s)."""
        params = {"watch": "true", "allowWatchBookmarks": "true"}
        if rv:
            params["resourceVersion"] = rv
        transport = self._client.transport
        path = self._client.resource_path(self._api_version, self._kind, self._namespace)
        conn = transport.connect(WATCH_TIMEOUT_S)
        with self._conn_lock:
            if self._stopped.is_set():
                return rv, False, 0.0
            self._conn = conn
        try:
            conn.request("GET", transport.target(path, params), headers=transport.headers)
            resp = conn.getresponse()
            self._client._notify_response("WATCH", resp.status)
            if resp.status >= 400:
                # the rv itself may be what the server refuses (410 Gone):
                # relist, promptly for a 410, after a pause otherwise
                return "", True, 0.2 if resp.status == 410 else 2.0
            while not self._stopped.is_set():
                line = resp.readline()
                if not line:
                    return rv, False, 1.0  # clean end: resume, no relist
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                etype, obj = event.get("type"), event.get("object", {})
                if etype == "ERROR":
                    # an in-stream Status (410 Gone et al.), never an object
                    return "", True, 0.2 if obj.get("code") == 410 else 2.0
                rv = obj.get("metadata", {}).get("resourceVersion", rv)
                if etype == "BOOKMARK":
                    continue
                obj.setdefault("apiVersion", self._api_version)
                obj.setdefault("kind", self._kind)
                self._emit(WatchEvent(type=etype, object=obj))
            return rv, False, 0.0
        finally:
            with self._conn_lock:
                self._conn = None
            conn.close()

    def _run(self) -> None:
        rv = ""
        while not self._stopped.is_set():
            try:
                if not rv:
                    rv = self._relist()
                rv, relist, pause = self._stream(rv)
                if relist:
                    rv = ""
                self._stopped.wait(pause)
            except (OSError, http.client.HTTPException, ValueError, ApiError) as e:
                # transport or LIST failure, or a truncated line: back off
                # and resume from the last good point (a stale one comes
                # back as 410, never as silent loss)
                if not self._stopped.is_set():
                    log.debug("watch %s: %s; retrying", self._kind, e)
                self._stopped.wait(2.0)

    def stop(self) -> None:
        self._stopped.set()
        with self._conn_lock:
            conn = self._conn
        if conn is not None and conn.sock is not None:
            try:
                conn.sock.shutdown(2)  # wakes the reader blocked on the socket
            except OSError:
                pass

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def events(self, idle_timeout: float = 0.5):
        """Yield events as they arrive; return after ``idle_timeout`` s of quiet."""
        while not self._stopped.is_set():
            try:
                yield self._queue.get(timeout=idle_timeout)
            except queue.Empty:
                return


#: what the validator's service account may touch
_VALIDATOR_KINDS = {("v1", "Node"), ("v1", "Pod"), ("v1", "Event")}


class ApiClient(RestClient):
    """The validator's client: :class:`RestClient` held to ``v1`` Nodes,
    Pods and Events (:meth:`from_env` reads ``$KUBE_API_URL``, else the
    in-cluster service address and token)."""

    def __init__(self, base_url: str, token: Optional[str] = None, verify=True,
                 timeout: float = 10.0):
        super().__init__(base_url, token, verify, default_timeout=timeout)

    def resource_path(self, api_version: str, kind: str, *args, **kwargs) -> str:
        if (api_version, kind) not in _VALIDATOR_KINDS:
            raise ValueError(f"the validator's client serves v1 Nodes and Pods (and "
                             f"Events), not {api_version} {kind}")
        return super().resource_path(api_version, kind, *args, **kwargs)
