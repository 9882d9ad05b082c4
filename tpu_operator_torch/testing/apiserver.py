"""A minimal in-process Kubernetes API server (copy of
tpu_operator/testing/apiserver.py, over the port's own FakeClient).

An HTTP facade over :class:`~tpu_operator_torch.client.FakeClient`, the
envtest analog: the port's :class:`~tpu_operator_torch.client.RestClient`
speaks genuine HTTP/JSON to it, exercising URL layout, selectors,
merge-patch content types and streaming watches over a socket. The CPU
tests drive the operator against it, and ``chip_smoke.py`` runs one in
process as the card's cluster.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..client.errors import ApiError, TooManyRequestsError
from ..client.fake import FakeClient
from ..client.scheme import Scheme, default_scheme


def _parse_selector(raw: str) -> dict:
    sel = {}
    for term in raw.split(","):
        if not term:
            continue
        if "=" in term:
            k, v = term.split("=", 1)
            sel[k] = v
        else:
            sel[term] = None
    return sel


class _Router:
    def __init__(self, scheme: Scheme):
        self._by_plural = {}
        for (api_version, kind), info in scheme._kinds.items():
            self._by_plural[(api_version, info.plural)] = kind

    def resolve(self, path: str) -> Tuple[str, str, Optional[str], Optional[str], Optional[str]]:
        """path -> (api_version, kind, namespace, name, subresource)."""
        parts = [p for p in path.split("/") if p]
        if not parts or parts[0] not in ("api", "apis"):
            raise ApiError(f"unroutable path {path}", 404)
        if parts[0] == "api":
            api_version, rest = parts[1], parts[2:]
        else:
            api_version, rest = f"{parts[1]}/{parts[2]}", parts[3:]
        namespace = None
        if rest and rest[0] == "namespaces" and len(rest) > 1:
            namespace, rest = rest[1], rest[2:]
        if not rest:
            raise ApiError(f"no resource in path {path}", 404)
        plural, rest = rest[0], rest[1:]
        kind = self._by_plural.get((api_version, plural))
        if kind is None:
            raise ApiError(f"unknown resource {api_version}/{plural}", 404)
        name = rest[0] if rest else None
        subresource = rest[1] if len(rest) > 1 else None
        return api_version, kind, namespace, name, subresource


class MiniApiServer:
    """HTTP facade over a FakeClient; start() returns the base URL. It
    answers in microseconds, where a real apiserver takes milliseconds: a
    control-plane time measured against it is a lower bound."""

    def __init__(self, backend: Optional[FakeClient] = None, scheme: Optional[Scheme] = None,
                 watch_idle_timeout_s: float = 5.0):
        self.scheme = scheme or default_scheme()
        self.backend = backend or FakeClient(self.scheme)
        # how long an event-less watch stream stays open before the server
        # closes it — real apiservers do this on a timer; clients must
        # resume. Short by default, so a stopped server's stream threads
        # end soon after it
        self.watch_idle_timeout_s = watch_idle_timeout_s
        self._router = _Router(self.scheme)
        #: requests served, by (verb, kind): GET, LIST, WATCH, POST, PUT
        #: (``PUT/status`` for the status subresource), PATCH, DELETE,
        #: EVICT (a POST to a pod's ``eviction`` subresource)
        self.requests: "collections.Counter[Tuple[str, str]]" = collections.Counter()
        #: every eviction request: (unix time, namespace, pod, HTTP status)
        self.evictions: list = []
        self._count_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _count(self, verb: str, kind: str) -> None:
        with self._count_lock:
            self.requests[(verb, kind)] += 1

    @property
    def request_count(self) -> int:
        """Requests served so far, of every verb."""
        with self._count_lock:
            return sum(self.requests.values())

    def request_counts(self) -> dict:
        """verb -> requests served so far, writes (POST, PUT, PATCH,
        DELETE, EVICT) also summed under ``write``."""
        with self._count_lock:
            counts = collections.Counter()
            for (verb, _), n in self.requests.items():
                counts[verb.split("/")[0]] += n
        counts["write"] = sum(counts[v] for v in ("POST", "PUT", "PATCH", "DELETE", "EVICT"))
        return dict(counts)

    # -- lifecycle -----------------------------------------------------------
    def start(self, port: int = 0) -> str:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                try:
                    return json.loads(self.rfile.read(length)) if length else {}
                except ValueError:
                    raise ApiError("malformed JSON request body", 400)

            def _send(self, code: int, obj, headers: Optional[dict] = None) -> None:
                payload = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for key, value in (headers or {}).items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(payload)

            def _fail(self, err: ApiError) -> None:
                headers = {}
                if isinstance(err, TooManyRequestsError) and err.retry_after is not None:
                    headers["Retry-After"] = format(err.retry_after, "g")
                self._send(err.code, {"kind": "Status", "message": str(err), "code": err.code},
                           headers)

            def do_GET(self):
                try:
                    url = urlparse(self.path)
                    if url.path == "/version":
                        # real apiservers serve /version unauthenticated
                        self._send(200, {"gitVersion":
                                         server.backend.server_version()})
                        return
                    params = parse_qs(url.query)
                    api_version, kind, ns, name, _ = server._router.resolve(url.path)
                    if name:
                        server._count("GET", kind)
                        self._send(200, server.backend.get(api_version, kind, name, ns))
                        return
                    label_selector = _parse_selector(params["labelSelector"][0]) if "labelSelector" in params else None
                    field_selector = _parse_selector(params["fieldSelector"][0]) if "fieldSelector" in params else None
                    if params.get("watch", ["false"])[0] == "true":
                        server._count("WATCH", kind)
                        self._watch(api_version, kind, ns, params)
                        return
                    server._count("LIST", kind)
                    # the List envelope carries the store-wide rv — the only
                    # safe watch-resume point (item rvs can be arbitrarily
                    # old). Read it BEFORE snapshotting items: a write landing
                    # between the two then yields an envelope rv OLDER than
                    # reality, which fails safe (spurious 410 → relist) where
                    # the opposite order silently loses the interleaved event.
                    envelope_rv = str(server.backend.current_rv())
                    items = server.backend.list(api_version, kind, ns, label_selector, field_selector)
                    self._send(200, {"kind": f"{kind}List", "apiVersion": api_version,
                                     "metadata": {"resourceVersion": envelope_rv},
                                     "items": items})
                except ApiError as e:
                    self._fail(e)

            def _chunk(self, payload: dict) -> None:
                line = json.dumps(payload).encode() + b"\n"
                self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
                self.wfile.flush()

            def _start_chunked(self) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

            def _watch(self, api_version, kind, ns, params):
                # Real watch-cache semantics: this server keeps NO event
                # history, so any resume from before the latest event for
                # this kind has provably missed events — answer with an
                # in-stream ERROR/410 Status (exactly how a real apiserver
                # reports "too old resource version") so the client relists.
                # rv="0" is the k8s "any recent state" idiom (client-go
                # informers use it routinely) — a real apiserver never answers
                # it with Expired, so neither do we
                client_rv = params.get("resourceVersion", [""])[0]
                if client_rv == "0":
                    client_rv = ""
                # register the live watch FIRST, then judge staleness: an
                # event landing between the check and the registration would
                # otherwise be neither replayed nor flagged — the exact lost-
                # event window the 410 machinery exists to close
                events: "queue.Queue" = queue.Queue()
                handle = server.backend.watch(api_version, kind, ns, handler=events.put)
                if client_rv:
                    try:
                        stale = int(client_rv) < server.backend.last_event_rv(api_version, kind, ns)
                    except ValueError:
                        stale = True
                    if stale:
                        handle.stop()
                        try:
                            self._start_chunked()
                            self._chunk({"type": "ERROR", "object": {
                                "kind": "Status", "apiVersion": "v1",
                                "status": "Failure", "reason": "Expired", "code": 410,
                                "message": f"too old resource version: {client_rv}"}})
                            self.wfile.write(b"0\r\n\r\n")
                        except (BrokenPipeError, ConnectionResetError):
                            pass
                        return
                try:
                    self._start_chunked()
                    while True:
                        try:
                            ev = events.get(timeout=server.watch_idle_timeout_s)
                        except queue.Empty:
                            break
                        self._chunk({"type": ev.type, "object": ev.object})
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
                finally:
                    handle.stop()

            def _evict(self, ns, name):
                server._count("EVICT", "Pod")
                self._body()  # the Eviction object; the pod is named by the path
                code = 201
                try:
                    server.backend.evict(name, ns)
                except ApiError as e:
                    code = e.code
                    raise
                finally:
                    with server._count_lock:
                        server.evictions.append((time.time(), ns, name, code))
                self._send(201, {"kind": "Status", "status": "Success"})

            def do_POST(self):
                try:
                    api_version, kind, ns, name, sub = server._router.resolve(
                        urlparse(self.path).path)
                    if kind == "Pod" and name and sub == "eviction":
                        self._evict(ns, name)
                        return
                    server._count("POST", kind)
                    obj = self._body()
                    obj.setdefault("apiVersion", api_version)
                    obj.setdefault("kind", kind)
                    if ns:
                        obj.setdefault("metadata", {}).setdefault("namespace", ns)
                    self._send(201, server.backend.create(obj))
                except ApiError as e:
                    self._fail(e)

            def do_PUT(self):
                try:
                    api_version, kind, ns, name, sub = server._router.resolve(urlparse(self.path).path)
                    server._count("PUT/status" if sub == "status" else "PUT", kind)
                    obj = self._body()
                    if sub == "status":
                        self._send(200, server.backend.update_status(obj))
                    else:
                        self._send(200, server.backend.update(obj))
                except ApiError as e:
                    self._fail(e)

            def do_PATCH(self):
                try:
                    api_version, kind, ns, name, _ = server._router.resolve(urlparse(self.path).path)
                    server._count("PATCH", kind)
                    self._send(200, server.backend.patch(api_version, kind, name, self._body(), ns))
                except ApiError as e:
                    self._fail(e)

            def do_DELETE(self):
                try:
                    api_version, kind, ns, name, _ = server._router.resolve(urlparse(self.path).path)
                    server._count("DELETE", kind)
                    server.backend.delete(api_version, kind, name, ns)
                    self._send(200, {"kind": "Status", "status": "Success"})
                except ApiError as e:
                    self._fail(e)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return f"http://127.0.0.1:{self._httpd.server_address[1]}"

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
