"""Node-status exporter (counterpart of tpu_operator/validator/metrics.py):
the node-local status files as Prometheus gauges, refreshed periodically.

The metric names, labels and HELP text are the TPU operator's
(``tpu_operator_node_*``), so one set of dashboards reads both. The text
exposition format is written here: the port has no ``prometheus_client``.
``-c metrics`` execs the native ``gpu-exporter``
(``tpu_operator_torch/native/gpu_exporter.cc``), which writes the same text,
when it finds it, as the reference execs its ``tpu-exporter``.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from .. import consts
from .driver import discover_devices
from .status import StatusFiles, failed_local_chips, partial_sweep

log = logging.getLogger(__name__)

COMPONENTS = ("driver", "plugin", "workload")
REFRESH_INTERVAL = 30.0


def _format_value(value: float) -> str:
    """A sample value as Prometheus clients write it: Go's float format, so
    a value at or above 10^6 goes to an exponent (1.792207e+09)."""
    value = float(value)
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if math.isnan(value):
        return "NaN"
    s = repr(value)
    dot = s.find(".")
    if value > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


class Gauge:
    """One gauge family: a value per label tuple (the empty tuple when the
    family has no labels)."""

    def __init__(self, name: str, documentation: str, labelnames: Tuple[str, ...] = ()):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._values[()] = 0.0

    def set(self, value: float, /, **labels: str) -> None:
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            self._values[key] = float(value)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()
            if not self.labelnames:
                self._values[()] = 0.0

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.documentation)}",
                 f"# TYPE {self.name} gauge"]
        with self._lock:
            samples = list(self._values.items())
        for key, value in samples:
            labels = ",".join(f'{n}="{_escape_label(v)}"'
                              for n, v in zip(self.labelnames, key))
            lines.append(f"{self.name}{{{labels}}} {_format_value(value)}" if labels
                         else f"{self.name} {_format_value(value)}")
        return "\n".join(lines) + "\n"


class Counter:
    """One counter family, written as ``prometheus_client`` writes it: the
    ``_total`` samples, then a ``_created`` gauge family holding when each
    label tuple was first counted."""

    def __init__(self, name: str, documentation: str, labelnames: Tuple[str, ...] = ()):
        self.name = name if name.endswith("_total") else name + "_total"
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._values: Dict[Tuple[str, ...], Tuple[float, float]] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, /, **labels: str) -> None:
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            value, created = self._values.get(key, (0.0, time.time()))
            self._values[key] = (value + amount, created)

    def expose(self) -> str:
        with self._lock:
            samples = list(self._values.items())
        created = self.name[: -len("_total")] + "_created"
        lines = [f"# HELP {self.name} {_escape_help(self.documentation)}",
                 f"# TYPE {self.name} counter"]
        tail = [f"# HELP {created} {_escape_help(self.documentation)}",
                f"# TYPE {created} gauge"] if samples else []
        for key, (value, since) in samples:
            labels = ",".join(f'{n}="{_escape_label(v)}"' for n, v in zip(self.labelnames, key))
            braces = f"{{{labels}}}" if labels else ""
            lines.append(f"{self.name}{braces} {_format_value(value)}")
            tail.append(f"{created}{braces} {_format_value(since)}")
        return "\n".join(lines + tail) + "\n"


class NodeMetrics:
    def __init__(self, status: Optional[StatusFiles] = None):
        self.status = status or StatusFiles()
        self.ready = {
            c: Gauge(f"tpu_operator_node_{c}_ready",
                     f"1 when the {c} validation barrier is present on this node")
            for c in COMPONENTS
        }
        self.device_nodes = Gauge("tpu_operator_node_tpu_device_nodes",
                                  "TPU device nodes visible on this node")
        # per-GPU health from the workload barrier's attribution: the
        # signal behind the device plugin's per-unit gate
        self.chip_healthy = Gauge(
            "tpu_operator_node_chip_healthy",
            "1 when the most recent full-host workload sweep holds no "
            "failure attributed to this chip; 0 on attributed failure OR "
            "any unattributable/corrupt failure record (fail safe, every "
            "chip reads 0); series absent while only a partial-coverage "
            "sweep result exists",
            ("chip",))
        self.last_refresh = Gauge("tpu_operator_node_metrics_last_refresh_ts_seconds",
                                  "Timestamp of the last metrics refresh")
        # measured throughput from the perf barrier (0 until it has run)
        self.perf = {
            key: Gauge(f"tpu_operator_node_{key}", help_text)
            for key, help_text in (
                ("mxu_tflops",
                 "Measured MXU throughput (bf16 TFLOP/s) from perf validation"),
                ("hbm_gbps",
                 "Measured HBM bandwidth (GB/s) from perf validation"),
            )
        }
        # all-reduce bandwidth exists only once the barrier holds a number:
        # a single GPU never measures it, and 0.0 would read as a dead fabric
        self._ici: Optional[Gauge] = None

    def families(self):
        return [*self.ready.values(), self.device_nodes, self.chip_healthy,
                self.last_refresh, *self.perf.values(),
                *([self._ici] if self._ici is not None else [])]

    def refresh(self) -> None:
        for component, gauge in self.ready.items():
            gauge.set(1 if self.status.is_ready(component) else 0)
        n_devices = len(discover_devices())
        self.device_nodes.set(n_devices)
        workload = self.status.read("workload")
        corrupt = workload is None and os.path.exists(self.status.path("workload"))
        # a GPU that fell off the bus must not keep its stale series
        self.chip_healthy.clear()
        if not (workload is not None and workload.get("passed") is not False
                and partial_sweep(workload, n_devices)):
            # (a partial-coverage pass says nothing of the gated GPUs: no series)
            failed = None
            if corrupt:
                failed = frozenset(range(n_devices))  # fail safe, as the plugin
            elif workload is not None and workload.get("passed") is False:
                failed = failed_local_chips(workload, n_devices)
                if failed is None:  # unattributable: every GPU reads unhealthy
                    failed = frozenset(range(n_devices))
            for chip in range(n_devices):
                self.chip_healthy.set(0 if failed is not None and chip in failed else 1,
                                      chip=str(chip))
        perf = self.status.read("perf") or {}
        for key, gauge in self.perf.items():
            value = perf.get(key)
            # back to 0 when the barrier is cleared, so stale numbers never
            # look current
            gauge.set(value if isinstance(value, (int, float)) else 0)
        self._set_ici(perf.get("ici_allreduce_gbps"))
        self.last_refresh.set(time.time())

    def _set_ici(self, value) -> None:
        measured = isinstance(value, (int, float)) and not isinstance(value, bool)
        if not measured:
            self._ici = None
            return
        if self._ici is None:
            self._ici = Gauge(
                "tpu_operator_node_ici_allreduce_gbps",
                "Measured ICI allreduce bus bandwidth (GB/s) from perf "
                "validation; series absent when the sweep skipped the "
                "measurement (single chip)")
        self._ici.set(value)

    def scrape(self) -> bytes:
        return "".join(f.expose() for f in self.families()).encode("utf-8")


def http_server(port: int, scrape: Callable[[], bytes]) -> ThreadingHTTPServer:
    """A server answering ``GET /metrics`` on ``port`` (0: any free port)
    with ``scrape()``, bound but not yet serving."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path.rstrip("/") != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            payload = scrape()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    return ThreadingHTTPServer(("0.0.0.0", port), Handler)


def find_exporter_binary() -> Optional[str]:
    """The native ``gpu-exporter``; ``$GPU_NATIVE_EXPORTER=0`` keeps the
    Python server."""
    from .native import find_native_binary

    return find_native_binary("gpu-exporter", consts.EXPORTER_BIN_ENV,
                              disable_env=consts.NATIVE_EXPORTER_ENV)


def _exec_native_exporter(port: int, status_dir: Optional[str] = None) -> None:
    """Replace this process with the native exporter if one is usable.
    Returns when none is found or the exec fails (a binary for another
    architecture passes the X_OK check), and the caller serves from
    Python."""
    binary = find_exporter_binary()
    if not binary:
        return
    log.info("delegating to native exporter %s", binary)
    args = [binary, f"--port={port}"]
    if status_dir:
        args.append(f"--status-dir={status_dir}")
    try:
        os.execv(binary, args)
    except OSError as e:
        log.warning("native exporter exec failed (%s); falling back to in-process server", e)


def serve(port: int, metrics: Optional[NodeMetrics] = None,
          refresh_interval: float = REFRESH_INTERVAL,
          ready_event: Optional[threading.Event] = None,
          stop_event: Optional[threading.Event] = None,
          status_dir: Optional[str] = None) -> int:
    """Serve ``/metrics`` on ``port`` (0: any free port), refreshing every
    ``refresh_interval`` s until ``stop_event`` is set (forever without).
    Called as the component does (no metrics object, no events), it execs
    the native exporter when one is found."""
    if metrics is None and ready_event is None and stop_event is None:
        _exec_native_exporter(port, status_dir)
    metrics = metrics or NodeMetrics(status=StatusFiles(status_dir) if status_dir else None)
    metrics.refresh()
    stop = stop_event or threading.Event()
    server = http_server(port, metrics.scrape)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    if ready_event:
        ready_event.set()
    log.info("node-status exporter on :%d", server.server_address[1])
    try:
        while not stop.wait(refresh_interval):
            metrics.refresh()
    finally:
        server.shutdown()
        server.server_close()
    return 0
