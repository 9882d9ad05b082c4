"""Operator Prometheus metrics (counterpart of
tpu_operator/controllers/metrics.py): the families the ported ClusterPolicy
path writes, under the reference's names, so one set of dashboards reads
both operators.

The port has no ``prometheus_client``: the families here keep its call
shape (``.labels(...).inc()``, ``.set``, ``.set_function``, ``.observe``,
``.set_to_current_time``) and :meth:`OperatorMetrics.scrape` writes the
text exposition format as that library does (counters as ``_total`` with a
``_created`` stamp, histograms as cumulative ``_bucket`` lines with
``_count``, ``_sum`` and ``_created``).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

def _format(value: float) -> str:
    """A sample value as Go's float formatting writes it (1e+06 and up go
    to an exponent), as Prometheus clients do."""
    value = float(value)
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if math.isnan(value):
        return "NaN"
    text = repr(value)
    dot = text.find(".")
    if value > 0 and dot > 6:
        mantissa = f"{text[0]}.{text[1:dot]}{text[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return text


def _escape(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _labels(pairs) -> str:
    """``{a="x",b="y"}``, label names sorted, as prometheus_client writes them."""
    text = ",".join(f'{name}="{_escape(str(value))}"' for name, value in sorted(pairs))
    return f"{{{text}}}" if text else ""


class _Child:
    """One label tuple's value (or the family's own, without labels)."""

    def __init__(self, buckets: Tuple[float, ...] = ()):
        self.value = 0.0
        self.function: Optional[Callable[[], float]] = None
        self.created = time.time()
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def set_to_current_time(self) -> None:
        self.set(time.time())

    def set_function(self, function: Callable[[], float]) -> None:
        self.function = function

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self.counts[i] += 1

    def read(self) -> float:
        return float(self.function()) if self.function is not None else self.value


class _Family:
    def __init__(self, name: str, documentation: str, labelnames=(),
                 buckets: Tuple[float, ...] = ()):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = _Child(self.buckets)

    def labels(self, **labels) -> _Child:
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self.buckets)
            return child

    def clear(self) -> None:
        with self._lock:
            self._children.clear()
            if not self.labelnames:
                self._children[()] = _Child(self.buckets)

    def _own(self) -> _Child:
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._own().inc(amount)

    def set(self, value: float) -> None:
        self._own().set(value)

    def set_to_current_time(self) -> None:
        self._own().set_to_current_time()

    def set_function(self, function) -> None:
        self._own().set_function(function)

    def observe(self, value: float) -> None:
        self._own().observe(value)

    def samples(self) -> List[Tuple[Tuple[Tuple[str, str], ...], _Child]]:
        with self._lock:
            items = list(self._children.items())
        return [(tuple(zip(self.labelnames, key)), child) for key, child in items]


class Gauge(_Family):
    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.documentation}", f"# TYPE {self.name} gauge"]
        lines += [f"{self.name}{_labels(pairs)} {_format(child.read())}"
                  for pairs, child in self.samples()]
        return lines


class Counter(_Family):
    def __init__(self, name: str, documentation: str, labelnames=()):
        super().__init__(name[:-len("_total")] if name.endswith("_total") else name,
                         documentation, labelnames)

    def expose(self) -> List[str]:
        samples = self.samples()
        lines = [f"# HELP {self.name}_total {self.documentation}",
                 f"# TYPE {self.name}_total counter"]
        lines += [f"{self.name}_total{_labels(pairs)} {_format(child.read())}"
                  for pairs, child in samples]
        if samples:
            lines += [f"# HELP {self.name}_created {self.documentation}",
                      f"# TYPE {self.name}_created gauge"]
            lines += [f"{self.name}_created{_labels(pairs)} {_format(child.created)}"
                      for pairs, child in samples]
        return lines


class Histogram(_Family):
    def __init__(self, name: str, documentation: str, labelnames=(), *,
                 buckets: Tuple[float, ...]):
        super().__init__(name, documentation, labelnames, tuple(buckets) + (math.inf,))

    def expose(self) -> List[str]:
        samples = self.samples()
        lines = [f"# HELP {self.name} {self.documentation}", f"# TYPE {self.name} histogram"]
        for pairs, child in samples:
            # counts are cumulative: observe bumps every bound at or above
            for bound, count in zip(child.buckets, child.counts):
                le = (("le", "+Inf" if bound == math.inf else _format(bound)),)
                lines.append(f"{self.name}_bucket{_labels(pairs + le)} {_format(count)}")
            lines.append(f"{self.name}_count{_labels(pairs)} {_format(child.count)}")
            lines.append(f"{self.name}_sum{_labels(pairs)} {_format(child.sum)}")
        if samples:
            lines += [f"# HELP {self.name}_created {self.documentation}",
                      f"# TYPE {self.name}_created gauge"]
            lines += [f"{self.name}_created{_labels(pairs)} {_format(child.created)}"
                      for pairs, child in samples]
        return lines


class OperatorMetrics:
    def __init__(self):
        self.families: List[_Family] = []
        add = self._add
        self.reconciliation_total = add(Counter(
            "tpu_operator_reconciliation_total",
            "Total number of ClusterPolicy reconciliations"))
        self.reconciliation_failed = add(Counter(
            "tpu_operator_reconciliation_failed_total",
            "Number of failed ClusterPolicy reconciliations"))
        self.reconciliation_status = add(Gauge(
            "tpu_operator_reconciliation_status",
            "1 when the last reconciliation reached ready, 0 otherwise"))
        self.reconciliation_last_success = add(Gauge(
            "tpu_operator_reconciliation_last_success_ts_seconds",
            "Timestamp of the last successful reconciliation"))
        self.gpu_nodes_total = add(Gauge(
            "tpu_operator_tpu_nodes_total",
            "Number of accelerator nodes in the cluster (GPU nodes here; "
            "the name is the reference's)"))
        # the rolling driver upgrade (the upgrade controller, every sweep);
        # names and help texts are the reference's
        self.upgrades_in_progress = add(Gauge(
            "tpu_operator_nodes_upgrades_in_progress",
            "Nodes currently upgrading the TPU driver"))
        self.upgrades_done = add(Gauge(
            "tpu_operator_nodes_upgrades_done",
            "Nodes that completed driver upgrade"))
        self.upgrades_failed = add(Gauge(
            "tpu_operator_nodes_upgrades_failed",
            "Nodes with failed driver upgrade"))
        self.upgrades_pending = add(Gauge(
            "tpu_operator_nodes_upgrades_pending",
            "Nodes pending driver upgrade"))
        self.upgrades_available = add(Gauge(
            "tpu_operator_nodes_upgrades_available",
            "Nodes available for driver upgrade"))
        self.slice_partition_failed_nodes = add(Gauge(
            "tpu_operator_slice_partition_failed_nodes",
            "Nodes whose slice partitioner rejected the desired partition "
            "(tpu.ai/slice.config.state=failed)"))
        # the GPU-health machine (the ClusterPolicy sweep's _sweep_health)
        self.node_health_state = add(Gauge(
            "tpu_operator_node_health_state",
            "Nodes in each chip-health state (tpu.ai/health-state label: "
            "healthy/degraded/quarantined/remediating/recovered/failed)",
            ["state"]))
        self.remediation_attempts = add(Counter(
            "tpu_operator_remediation_attempts_total",
            "Chip-health remediation actions fired (validator recycle, "
            "escalating to driver restart)"))
        self.partition_retile_total = add(Counter(
            "tpu_operator_partition_retile_total",
            "Node transitions into a health-aware re-tiled slice layout "
            "(tpu.ai/slice.config.state=retiled)"))
        self.drain_deadline_missed = add(Counter(
            "tpu_operator_drain_deadline_missed_total",
            "Planned re-tile drain deadlines that expired without a "
            "workload ack (force path taken)"))
        self.drains_in_progress = add(Gauge(
            "tpu_operator_drains_in_progress",
            "Nodes currently inside an open drain window (tpu.ai/"
            "planned-retile published, no matching drain-ack yet)"))
        self.migration_snapshots = add(Counter(
            "tpu_operator_migration_snapshots_total",
            "Operator-driven transparent snapshots taken after a drain "
            "deadline expired without a workload ack (the CRIU-style "
            "path that replaces a bare force-retile)"))
        self.serving_slo_failing_nodes = add(Gauge(
            "tpu_operator_serving_slo_failing_nodes",
            "Nodes whose serving SLO probe failed or failed closed "
            "(tpu.ai/serving-slo label is failed or corrupt)"))
        self.serving_decode_p99 = add(Gauge(
            "tpu_operator_serving_decode_p99_seconds",
            "Worst-rung decode-step p99 latency measured by the node's "
            "serving SLO probe", ["node"]))
        self.serving_throughput = add(Gauge(
            "tpu_operator_serving_throughput_tokens_per_s",
            "Peak steady-state decode throughput measured by the node's "
            "serving SLO probe", ["node"]))
        self.serving_slo_attainment = add(Gauge(
            "tpu_operator_serving_slo_attainment_ratio",
            "Fraction of probed decode steps on the node that met the "
            "per-step latency SLO (min over batch rungs)", ["node"]))
        # the join profiler (joinprofile.JoinProfiler) and the flight
        # recorder's reconcile latency summary
        self.join_phase_seconds = add(Histogram(
            "tpu_operator_join_phase_seconds",
            "Critical-path attribution of one node's join wall-clock, per "
            "phase (reconcile / ds-rollout-wait / image-pull / xla-compile / "
            "barrier-handshake / validation-run / serving-probe / other); "
            "observed once per completed join",
            ["phase"], buckets=(.01, .1, .5, 1, 2, 5, 10, 30, 60, 300)))
        self.reconcile_latency = add(Gauge(
            "tpu_operator_reconcile_latency_seconds",
            "Rolling reconcile root-span latency summary (window of recent "
            "sweeps across all controllers), by quantile (p50/p99); feeds "
            "bench.py's control_plane_scale_envelope",
            ["quantile"]))
        self.trace_dropped = add(Gauge(
            "tpu_operator_trace_dropped_total",
            "Spans dropped because no trace was active on the calling thread"))
        # the decision-provenance journal (fed through wire_provenance)
        self.decision_records = add(Counter(
            "tpu_operator_decision_records_total",
            "Decision records appended to the provenance journal, by the "
            "subsystem that recorded them (autoscale / migrate / health / "
            "upgrade / partitioner)", ["subsystem"]))
        self.episode_duration = add(Histogram(
            "tpu_operator_episode_duration_seconds",
            "End-to-end duration of a closed provenance episode (first "
            "decision record to terminal outcome record), by the episode's "
            "root decision kind (scale-down / migrate / drain / remediate / "
            "upgrade)", ["kind"],
            buckets=(.1, .5, 1, 5, 15, 60, 300, 900, 3600)))
        self.provenance_orphans = add(Counter(
            "tpu_operator_provenance_orphans_total",
            "Audited actuations (node delete / re-tile plan / snapshot / "
            "restore) found unclaimed by any decision record — each one is "
            "an actuation with no recorded 'why'"))
        self.episode_open_age = add(Gauge(
            "tpu_operator_episode_open_age_seconds",
            "Age of the oldest provenance episode still awaiting a terminal "
            "outcome record (0 when none open) — the TPUEpisodeStuck alert "
            "signal"))
        self.workqueue_depth = add(Gauge(
            "tpu_operator_workqueue_depth",
            "Current number of pending requests in a controller workqueue", ["name"]))
        self.workqueue_adds = add(Counter(
            "tpu_operator_workqueue_adds_total",
            "Total requests enqueued to a controller workqueue", ["name"]))
        self.workqueue_retries = add(Counter(
            "tpu_operator_workqueue_retries_total",
            "Total rate-limited (backoff) re-enqueues", ["name"]))
        self.workqueue_queue_duration = add(Histogram(
            "tpu_operator_workqueue_queue_duration_seconds",
            "Time a request waited in the queue before being picked up", ["name"],
            buckets=(.001, .01, .1, 1, 5, 10, 60)))
        self.reconcile_duration = add(Histogram(
            "tpu_operator_reconcile_duration_seconds",
            "Wall-clock duration of a single reconcile call", ["name"],
            buckets=(.001, .01, .1, 1, 5, 10, 60)))
        self.reconcile_phase = add(Histogram(
            "tpu_operator_reconcile_phase_seconds",
            "Wall-clock duration of one reconcile phase (render, apply, "
            "status-update, …), fed by the tracing layer's phase spans",
            ["controller", "phase"], buckets=(.001, .01, .1, 1, 5, 10, 60)))
        self.reconcile_errors = add(Counter(
            "tpu_operator_reconcile_errors_total",
            "Reconcile calls that raised (and were requeued with backoff)", ["name"]))
        self.rest_requests = add(Counter(
            "tpu_operator_rest_client_requests_total",
            "HTTP requests issued to the apiserver, by method and code",
            ["method", "code"]))
        # the client's resilience layer and write fence
        self.api_retries = add(Counter(
            "tpu_operator_api_retries_total",
            "Transient apiserver failures retried by the client resilience "
            "layer, by verb and reason (429 / 5xx code / transport)",
            ["verb", "reason"]))
        self.api_breaker_state = add(Gauge(
            "tpu_operator_api_breaker_state",
            "Apiserver circuit breaker state: 0=closed, 1=half-open, 2=open "
            "(open = degraded mode: calls short-circuit, reconcilers requeue)"))
        self.api_breaker_transitions = add(Counter(
            "tpu_operator_api_breaker_transitions_total",
            "Circuit breaker state transitions, by state entered", ["state"]))
        self.api_throttle_seconds = add(Counter(
            "tpu_operator_api_client_throttle_seconds_total",
            "Cumulative time requests waited on the client-side token-bucket "
            "rate limiter"))
        self.fenced_writes = add(Counter(
            "tpu_operator_fenced_writes_total",
            "Mutating apiserver calls rejected by the leader write fence "
            "(this replica attempted a write after losing, or before "
            "holding, leadership), by verb", ["verb"]))
        self.batched_writes = add(Counter(
            "tpu_operator_batched_writes_total",
            "Per-object writes deferred into the write coalescer instead of "
            "being dispatched individually"))
        self.write_batch_size = add(Histogram(
            "tpu_operator_write_batch_size",
            "Deferred writes folded into one flushed PATCH, per object",
            buckets=(1, 2, 3, 5, 8, 13, 21, 34)))

    def _add(self, family):
        self.families.append(family)
        return family

    def wire_tracing(self) -> None:
        """Mirror the tracing module's dropped-span counter at scrape time."""
        from .. import tracing

        self.trace_dropped.set_function(tracing.dropped_spans_total)

    def observe_rest_response(self, method: str, code: int) -> None:
        """RestClient.on_response hook target."""
        self.rest_requests.labels(method=method, code=str(code)).inc()

    def wire_resilience(self, resilience) -> None:
        """The RetryingClient's hooks: retries, throttle waits, and the
        breaker's state gauge and transitions."""
        from ..client.resilience import STATE_VALUES

        resilience.on_retry = (
            lambda verb, reason:
            self.api_retries.labels(verb=verb, reason=reason).inc())
        resilience.on_throttle = self.api_throttle_seconds.inc
        self.api_breaker_state.set_function(
            lambda: STATE_VALUES.get(resilience.breaker.state, 0))

        def on_state_change(old: str, new: str) -> None:
            self.api_breaker_transitions.labels(state=new).inc()

        resilience.breaker.on_state_change = on_state_change

    def wire_fencing(self, fenced) -> None:
        """The FencedClient's rejection hook: a nonzero
        ``tpu_operator_fenced_writes_total`` is a deposed replica caught
        writing."""
        fenced.on_fenced = (
            lambda verb: self.fenced_writes.labels(verb=verb).inc())

    def wire_provenance(self, journal) -> None:
        """The decision journal's hooks: records per subsystem, closed
        episodes' durations, the audit's orphans, and the oldest open
        episode's age (read at scrape time)."""
        journal.on_record = (
            lambda subsystem:
            self.decision_records.labels(subsystem=subsystem).inc())
        journal.on_episode_closed = (
            lambda kind, duration_s:
            self.episode_duration.labels(kind=kind).observe(duration_s))
        journal.on_orphan = self.provenance_orphans.inc
        self.episode_open_age.set_function(journal.oldest_open_age)

    def wire_batching(self, batcher) -> None:
        """The WriteBatcher's hooks: deferred writes and batch sizes."""
        batcher.on_batched = self.batched_writes.inc
        batcher.on_flush = self.write_batch_size.observe

    def scrape(self) -> bytes:
        lines: List[str] = []
        for family in self.families:
            lines += family.expose()
        return ("\n".join(lines) + "\n").encode()
