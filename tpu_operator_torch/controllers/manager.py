"""Operator process wiring (counterpart of tpu_operator/controllers/manager.py;
NVIDIA's cmd/gpu-operator/main.go:74-233): build the client chain, register
the ClusterPolicy, GPUDriver and upgrade controllers, serve metrics and
health, and run until signalled, or, under ``--leader-elect``, until
leadership is lost.

The client chain, outermost first: ``CachedClient`` (informer reads; off
with ``--no-cache-reads``) → ``WriteBatcher`` (write coalescing) →
``RetryingClient`` (retries, token bucket, circuit breaker) →
``FencedClient`` (the leader write fence) → ``RestClient``. The elector
talks to the ``RestClient`` directly.

The app also builds the operator's black box: the decision-provenance
journal (on the client chain, so its mirror writes are fenced), the flight
recorder (``--trace-buffer-size``) and its tracer, and the join profiler,
and serves them on the health port under ``/debug`` (:data:`DEBUG_ROUTES`;
``--no-debug-endpoints`` serves none). The reference's autoscale and
migration controllers, and its ``/debug/capacity`` route, wait for their
slice; its ``/debug/opsan`` belongs to a race sanitizer the port does not
have.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import __version__, consts, tracing
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
from .upgrade_controller import UpgradeReconciler, setup_upgrade_controller

log = logging.getLogger(__name__)

#: every /debug route the health server answers
DEBUG_ROUTES = ("/debug/informers", "/debug/traces", "/debug/join-traces",
                "/debug/queue", "/debug/state", "/debug/threads",
                "/debug/timeline")


def _query_int(query: dict, key: str, default: int) -> int:
    try:
        return int((query.get(key) or [str(default)])[0])
    except ValueError:
        return default


def serve_health_and_metrics(metrics: OperatorMetrics, metrics_port: int,
                             health_port: int, app: "OperatorApp" = None,
                             host: str = "0.0.0.0"):
    """``/metrics`` on ``metrics_port``; ``/healthz`` (liveness),
    ``/readyz`` (503 until leadership, when elected, and every informer's
    first sync) and, unless the app turned them off, the :data:`DEBUG_ROUTES`
    on ``health_port``. A port of 0 serves nothing. Returns the servers."""

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
            self._send(code, json.dumps(payload, default=str).encode(), "application/json")

    class MetricsHandler(Handler):
        def do_GET(self):
            if self.path.rstrip("/") == "/metrics":
                self._send(200, metrics.scrape(), "text/plain; version=0.0.4")
            else:
                self._send(404, b"", "text/plain")

    class HealthHandler(Handler):
        def _debug(self, path: str, query: dict):
            """The ``/debug`` page at ``path``: JSON, or text for threads."""
            if path == "/debug/informers":
                # cache introspection: the kinds cached, synced, their sizes
                client = app.client
                return client.stats() if hasattr(client, "stats") else []
            if path == "/debug/traces":
                # the flight recorder: ?controller=&error=true&trace_id=&limit=
                errors_only = (query.get("error") or ["false"])[0].lower() in (
                    "1", "true", "yes")
                trace_id = (query.get("trace_id") or query.get("trace") or [None])[0]
                roots = app.recorder.traces(
                    controller=(query.get("controller") or [None])[0],
                    errors_only=errors_only, trace_id=trace_id,
                    limit=_query_int(query, "limit", 50))
                return {"stats": dict(app.recorder.stats(),
                                      dropped_spans_total=tracing.dropped_spans_total()),
                        "count": len(roots),
                        "traces": [r.to_dict() for r in roots]}
            if path == "/debug/join-traces":
                # per-node join traces with their critical path; ?node=&limit=
                traces = app.join_profiler.join_traces(
                    limit=_query_int(query, "limit", 20),
                    node=(query.get("node") or [None])[0])
                return {"stats": app.join_profiler.stats(),
                        "reconcile_latency": app.join_profiler.reconcile_latency(),
                        "count": len(traces), "traces": traces}
            if path == "/debug/queue":
                return [c.debug_state() for c in app.manager.controllers]
            if path == "/debug/state":
                return app.debug_state()
            if path == "/debug/timeline":
                # the provenance journal; ?node=&episode=&limit=
                records = app.journal.timeline(
                    node=(query.get("node") or [None])[0],
                    episode=(query.get("episode") or [None])[0],
                    limit=_query_int(query, "limit", 100))
                return {"stats": app.journal.debug_state(), "count": len(records),
                        "episodes": app.journal.episodes(), "records": records}
            # /debug/threads: every thread's stack, as a goroutine dump
            frames = sys._current_frames()
            lines = []
            for thread in threading.enumerate():
                lines.append(f"--- {thread.name} (daemon={thread.daemon}) ---")
                frame = frames.get(thread.ident)
                if frame is not None:
                    lines.extend(line.rstrip() for line in traceback.format_stack(frame))
            return "\n".join(lines)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            path = parsed.path.rstrip("/")
            if path in DEBUG_ROUTES and app is not None and app.debug_endpoints:
                page = self._debug(path, urllib.parse.parse_qs(parsed.query))
                if isinstance(page, str):
                    self._send(200, page.encode(), "text/plain")
                else:
                    self._json(page)
            elif path == "/healthz":
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

    def __init__(self, client, namespace=None, metrics_port: int = 0, health_port: int = 0,
                 trace_buffer_size: int = tracing.DEFAULT_BUFFER_SIZE,
                 debug_endpoints: bool = True):
        from ..joinprofile import JoinProfiler
        from ..provenance import DecisionJournal

        self.client = client
        self.metrics = OperatorMetrics()
        # the decision-provenance journal, shared by every actuating
        # reconciler: its mirror ConfigMaps ride the same batched and fenced
        # chain as the actuations; the on-disk JSONL, where a path is set,
        # survives a restart
        self.journal = DecisionJournal(
            client=client,
            namespace=namespace or os.environ.get(consts.NAMESPACE_ENV,
                                                  consts.DEFAULT_NAMESPACE),
            path=os.environ.get(consts.JOURNAL_PATH_ENV) or None)
        self.metrics.wire_provenance(self.journal)
        # every worker roots its reconciles here; finished traces land in
        # the flight recorder behind /debug/traces
        self.recorder = tracing.FlightRecorder(trace_buffer_size)
        self.tracer = tracing.Tracer(self.recorder, self.metrics)
        tracing.set_default_tracer(self.tracer)
        # the join profiler: fed the finished traces and each sweep's nodes,
        # it stitches per-node join traces behind /debug/join-traces
        self.join_profiler = JoinProfiler(metrics=self.metrics)
        self.tracer.on_finalize = self.join_profiler.on_trace
        self.metrics.wire_tracing()
        self.debug_endpoints = debug_endpoints
        self.elector = None  # set by run_operator under --leader-elect
        self._started = threading.Event()
        self.manager = ControllerManager(client)
        self.clusterpolicy_reconciler = ClusterPolicyReconciler(
            client, namespace=namespace, metrics=self.metrics,
            join_profiler=self.join_profiler, journal=self.journal)
        self.clusterpolicy_controller = self.manager.add(
            setup_clusterpolicy_controller(client, self.clusterpolicy_reconciler))
        self.manager.add(setup_gpudriver_controller(
            client, GPUDriverReconciler(client, namespace=namespace)))
        # the rolling driver upgrade, journaling into the shared journal
        self.upgrade_reconciler = UpgradeReconciler(client, namespace=namespace,
                                                    metrics=self.metrics, journal=self.journal)
        self.upgrade_controller = self.manager.add(
            setup_upgrade_controller(client, self.upgrade_reconciler))
        for controller in self.manager.controllers:
            controller.instrument(self.metrics, self.tracer)
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

    def debug_state(self) -> dict:
        """``/debug/state``: what a "why is it not working yet" question
        needs on one page: readiness, leadership, informer sync, each
        controller's queue, the flight recorder, the join profiler and the
        journal."""
        ready, detail = self.readiness()
        return {
            "ready": ready,
            "readiness": detail,
            "informers": self.client.stats() if hasattr(self.client, "stats") else [],
            "controllers": [c.debug_state() for c in self.manager.controllers],
            "flight_recorder": self.recorder.stats(),
            "join_profiler": self.join_profiler.stats(),
            "journal": self.journal.debug_state(),
        }

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
    # every record logged under a reconcile trace carries its id, to match
    # against an Event's tpu.ai/trace-id and /debug/traces
    tracing.install_log_correlation()
    logging.basicConfig(level=getattr(logging, args.log_level.upper()),
                        format="%(asctime)s %(levelname)s %(name)s "
                               "[trace=%(trace_id)s]: %(message)s")
    log.info("gpu-operator %s starting", __version__)
    if args.api_server:
        direct = RestClient(base_url=args.api_server, token=args.token,
                            default_timeout=args.api_timeout)
    else:
        direct = RestClient.from_env(default_timeout=args.api_timeout)
    client, fenced = build_client(args, direct)
    app = OperatorApp(client, namespace=args.namespace,
                      metrics_port=args.metrics_port, health_port=args.health_port,
                      trace_buffer_size=args.trace_buffer_size,
                      debug_endpoints=args.debug_endpoints)
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
