"""Operator process wiring (counterpart of tpu_operator/controllers/manager.py;
NVIDIA's cmd/gpu-operator/main.go:74-233): build the client, register the
ClusterPolicy controller, serve metrics and health, run until signalled.

The client chain is ``WriteBatcher → RestClient``. The reference's leader
election, read cache, retry and circuit-breaker layers, write fence, flight
recorder and ``/debug`` endpoints, and its TPUDriver, upgrade, autoscale
and migration controllers wait for their slices.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import __version__
from ..client.batch import WriteBatcher
from ..client.rest import RestClient
from .clusterpolicy_controller import (
    ClusterPolicyReconciler,
    setup_clusterpolicy_controller,
)
from .metrics import OperatorMetrics
from .runtime import ControllerManager, Request

log = logging.getLogger(__name__)


def serve_health_and_metrics(metrics: OperatorMetrics, metrics_port: int,
                             health_port: int, app: "OperatorApp" = None,
                             host: str = "0.0.0.0"):
    """``/metrics`` on ``metrics_port``; ``/healthz`` (liveness) and
    ``/readyz`` (503 until the controllers run) on ``health_port``. A port
    of 0 serves nothing. Returns the servers."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, payload, code: int = 200) -> None:
            self._send(code, json.dumps(payload).encode(), "application/json")

    class MetricsHandler(Handler):
        def do_GET(self):
            if self.path.rstrip("/") == "/metrics":
                self._send(200, metrics.scrape(), "text/plain; version=0.0.4")
            else:
                self._send(404, b"", "text/plain")

    class HealthHandler(Handler):
        def do_GET(self):
            path = self.path.split("?")[0].rstrip("/")
            if path == "/healthz":
                self._json({"status": "ok", "version": __version__})
            elif path == "/readyz":
                ready = app is None or app.ready()
                self._json({"status": "ok" if ready else "unready",
                            "version": __version__}, 200 if ready else 503)
            else:
                self._send(404, b"", "text/plain")

    servers = []
    for port, handler in ((metrics_port, MetricsHandler), (health_port, HealthHandler)):
        if not port:
            continue
        server = ThreadingHTTPServer((host, port), handler)
        server.daemon_threads = True
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
    return servers


class OperatorApp:
    """The assembled operator: client + controllers + metrics/health servers."""

    def __init__(self, client, namespace=None, metrics_port: int = 0, health_port: int = 0):
        self.client = client
        self.metrics = OperatorMetrics()
        self.metrics.wire_tracing()
        self._started = threading.Event()
        self.manager = ControllerManager(client)
        self.clusterpolicy_reconciler = ClusterPolicyReconciler(
            client, namespace=namespace, metrics=self.metrics)
        self.clusterpolicy_controller = self.manager.add(
            setup_clusterpolicy_controller(client, self.clusterpolicy_reconciler))
        for controller in self.manager.controllers:
            controller.instrument(self.metrics)
        # rest_client_requests_total rides the innermost RestClient
        rest = client
        while hasattr(rest, "inner"):
            rest = rest.inner
        if hasattr(rest, "on_response"):
            rest.on_response = self.metrics.observe_rest_response
        from ..client.batch import find_batcher

        self.batcher = find_batcher(client)
        if self.batcher is not None:
            self.batcher.bind_read_client(client)
            self.metrics.wire_batching(self.batcher)
        self._metrics_port = metrics_port
        self._health_port = health_port
        self._servers: list = []

    def start(self) -> None:
        if not self._servers:
            self._servers = serve_health_and_metrics(
                self.metrics, self._metrics_port, self._health_port, self)
        self.manager.start()
        self._started.set()
        # kick an initial reconcile even if no watch event ever fires
        for policy in self.client.list("tpu.ai/v1", "ClusterPolicy"):
            self.clusterpolicy_controller.queue.add(Request(name=policy["metadata"]["name"]))

    def ready(self) -> bool:
        return self._started.is_set()

    def stop(self) -> None:
        self.manager.stop()
        if self.batcher is not None:
            self.batcher.stop()  # best-effort flush of any deferred writes
        for s in self._servers:
            s.shutdown()
            s.server_close()
        self._servers = []


def run_operator(args) -> int:
    logging.basicConfig(level=getattr(logging, args.log_level.upper()),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log.info("gpu-operator %s starting", __version__)
    if args.api_server:
        direct = RestClient(base_url=args.api_server, token=args.token,
                            default_timeout=args.api_timeout)
    else:
        direct = RestClient.from_env(default_timeout=args.api_timeout)
    # write coalescer: a sweep's per-node label/annotation writes merge into
    # one preconditioned PATCH per object
    client = WriteBatcher(direct)
    app = OperatorApp(client, namespace=args.namespace,
                      metrics_port=args.metrics_port, health_port=args.health_port)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # not the main thread (tests)
    app.start()
    log.info("controllers running; metrics :%s health :%s", args.metrics_port,
             args.health_port)
    stop.wait()
    log.info("shutting down")
    app.stop()
    direct.stop()
    return 0
