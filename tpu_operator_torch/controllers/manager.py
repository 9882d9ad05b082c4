"""Operator process wiring (counterpart of tpu_operator/controllers/manager.py;
NVIDIA's cmd/gpu-operator/main.go:74-233): build the client chain, register
the ClusterPolicy and GPUDriver controllers, serve metrics and health, and
run until signalled, or, under ``--leader-elect``, until leadership is lost.

The client chain, outermost first: ``CachedClient`` (informer reads; off
with ``--no-cache-reads``) → ``WriteBatcher`` (write coalescing) →
``RetryingClient`` (retries, token bucket, circuit breaker) →
``FencedClient`` (the leader write fence) → ``RestClient``. The elector
talks to the ``RestClient`` directly. The reference's flight recorder and
``/debug`` endpoints, and its upgrade, autoscale and migration controllers,
wait for their slices.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import __version__
from ..client.batch import WriteBatcher, find_batcher
from ..client.cache import CachedClient
from ..client.fenced import FencedClient, find_fenced
from ..client.resilience import (
    CircuitBreaker,
    RetryingClient,
    TokenBucket,
    find_resilience,
)
from ..client.rest import RestClient
from .clusterpolicy_controller import (
    ClusterPolicyReconciler,
    setup_clusterpolicy_controller,
)
from .gpudriver_controller import GPUDriverReconciler, setup_gpudriver_controller
from .metrics import OperatorMetrics
from .runtime import ControllerManager, Request

log = logging.getLogger(__name__)


def serve_health_and_metrics(metrics: OperatorMetrics, metrics_port: int,
                             health_port: int, app: "OperatorApp" = None,
                             host: str = "0.0.0.0"):
    """``/metrics`` on ``metrics_port``; ``/healthz`` (liveness) and
    ``/readyz`` (503 until leadership, when elected, and every informer's
    first sync) on ``health_port``. A port of 0 serves nothing. Returns the
    servers."""

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
                if app is None:
                    self._json({"status": "ok", "version": __version__})
                    return
                ready, detail = app.readiness()
                self._json(detail, 200 if ready else 503)
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
        self.elector = None  # set by run_operator under --leader-elect
        self._started = threading.Event()
        self.manager = ControllerManager(client)
        self.clusterpolicy_reconciler = ClusterPolicyReconciler(
            client, namespace=namespace, metrics=self.metrics)
        self.clusterpolicy_controller = self.manager.add(
            setup_clusterpolicy_controller(client, self.clusterpolicy_reconciler))
        self.manager.add(setup_gpudriver_controller(
            client, GPUDriverReconciler(client, namespace=namespace)))
        for controller in self.manager.controllers:
            controller.instrument(self.metrics)
        # rest_client_requests_total rides the innermost RestClient; the
        # resilience layer and the fence feed their families wherever they
        # sit in the chain
        rest = client
        while hasattr(rest, "inner"):
            rest = rest.inner
        if hasattr(rest, "on_response"):
            rest.on_response = self.metrics.observe_rest_response
        self.resilience = find_resilience(client)
        if self.resilience is not None:
            self.metrics.wire_resilience(self.resilience)
        self.fenced = find_fenced(client)
        if self.fenced is not None:
            self.metrics.wire_fencing(self.fenced)
        self.batcher = find_batcher(client)
        if self.batcher is not None:
            self.batcher.bind_read_client(client)
            self.metrics.wire_batching(self.batcher)
        self._metrics_port = metrics_port
        self._health_port = health_port
        self._servers: list = []

    def start(self) -> None:
        self.start_servers()
        self.start_controllers()

    def start_servers(self) -> None:
        """Health and metrics from process start: a standby replica under
        leader election reconciles nothing but must answer its probes."""
        if not self._servers:
            self._servers = serve_health_and_metrics(
                self.metrics, self._metrics_port, self._health_port, self)

    def start_controllers(self) -> None:
        """The reconcile loops: on the leader only."""
        self.manager.start()
        self._started.set()
        # kick an initial reconcile even if no watch event ever fires
        for policy in self.client.list("tpu.ai/v1", "ClusterPolicy"):
            self.clusterpolicy_controller.queue.add(Request(name=policy["metadata"]["name"]))

    def readiness(self):
        """(ready, detail) for ``/readyz``: unready until leadership (when
        elected) and every started informer's first sync. A degraded
        informer (its sync timed out; reads go direct) counts as serving,
        and an open breaker reports ``degraded`` but stays ready: a restart
        would only trade a warm cache for a cold one."""
        if self.elector is not None:
            leader_ok = self.elector.is_leader.is_set()
            leader = {"enabled": True, "is_leader": leader_ok,
                      "identity": self.elector.identity}
        else:
            leader_ok = self._started.is_set()
            leader = {"enabled": False, "controllers_started": leader_ok}
        stats = self.client.stats() if hasattr(self.client, "stats") else []
        unsynced = [f"{s['apiVersion']}/{s['kind']}" for s in stats
                    if not s["synced"] and not s.get("degraded")]
        breaker = (self.resilience.breaker.snapshot()
                   if self.resilience is not None else None)
        degraded = breaker is not None and breaker["state"] != "closed"
        ready = leader_ok and not unsynced
        detail = {
            "status": ("degraded" if ready and degraded
                       else "ok" if ready else "unready"),
            "version": __version__,
            "leader": leader,
            "unsynced_informers": unsynced,
        }
        if breaker is not None:
            detail["breaker"] = breaker
        return ready, detail

    def stop(self) -> None:
        self.manager.stop()
        if self.batcher is not None:
            self.batcher.stop()  # best-effort flush of any deferred writes
        for s in self._servers:
            s.shutdown()
            s.server_close()
        self._servers = []


def build_client(args, direct: RestClient):
    """The operator's client chain over ``direct`` (see the module
    docstring), and the fence in it, which the elector binds to."""
    # the fence sits under the retry layer: a fenced write is not transient
    # and must never charge the breaker. Unbound (no --leader-elect) it
    # passes every write through
    fenced = FencedClient(direct)
    client = RetryingClient(
        fenced,
        limiter=TokenBucket(qps=args.api_qps, burst=args.api_burst),
        breaker=CircuitBreaker(threshold=args.breaker_threshold))
    # the coalescer above retry and fence: a flushed patch still rides the
    # limiter and the fence
    client = WriteBatcher(client)
    if args.cache_reads:
        # reconcile reads from informer caches, as in controller-runtime;
        # writes go through to the apiserver
        client = CachedClient(client)
    return client, fenced


def run_operator(args) -> int:
    logging.basicConfig(level=getattr(logging, args.log_level.upper()),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log.info("gpu-operator %s starting", __version__)
    if args.api_server:
        direct = RestClient(base_url=args.api_server, token=args.token,
                            default_timeout=args.api_timeout)
    else:
        direct = RestClient.from_env(default_timeout=args.api_timeout)
    client, fenced = build_client(args, direct)
    app = OperatorApp(client, namespace=args.namespace,
                      metrics_port=args.metrics_port, health_port=args.health_port)
    stop = threading.Event()
    exit_code = [0]
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # not the main thread (tests)

    elector = None
    if args.leader_elect:
        from .leader import LeaderElector

        def on_lost():
            # exit rather than risk two writers
            log.error("leadership lost; exiting for a clean restart")
            exit_code[0] = 1
            stop.set()

        # the elector talks to the apiserver directly: a retry sleeping out
        # its back-off inside a renewal could overrun the renew deadline,
        # and an open breaker must never block the renewals that keep the
        # lease through an apiserver brownout
        elector = LeaderElector(direct, app.clusterpolicy_reconciler.namespace)
        app.elector = elector
        # every write is checked against the elector's live view
        fenced.bind(elector)
        app.start_servers()  # probes answer while standing by
        elector.run(on_started=app.start_controllers, on_stopped=on_lost)
        log.info("leader election on; waiting for leadership as %s", elector.identity)
    else:
        app.start()
    log.info("metrics :%s health :%s", args.metrics_port, args.health_port)
    stop.wait()
    log.info("shutting down")
    if elector is not None:
        elector.release()
    app.stop()
    client.stop()  # the informers' watches
    direct.stop()
    return exit_code[0]
