"""ClusterPolicy reconciler: the main loop of the operator (counterpart of
tpu_operator/controllers/clusterpolicy_controller.py).

NVIDIA's hot path (controllers/clusterpolicy_controller.go:94-235 +
state_manager.go:753-979): each reconcile labels GPU nodes, sweeps the
ordered state DAG, and gates ``status.state=ready`` on every state's
readiness, requeueing after 5 s while anything is NotReady. Level-driven
and idempotent: every sweep re-renders and re-applies everything
(hash-skips make that cheap).

After the state sweep, one observation per sweep goes to the join
profiler, and :meth:`ClusterPolicyReconciler._sweep_health` drives the
per-node GPU-health machine, each decision of which lands in the shared
provenance journal before it acts, and rolls its states up into the
``NodeHealthDegraded`` condition.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from concurrent import futures
from typing import Callable, List, Optional

from .. import consts, events, tracing
from ..api.clusterpolicy import ClusterPolicy, State
from ..client.batch import batch_window
from ..client.errors import ConflictError, NotFoundError
from ..client.interface import Client, WatchEvent
from ..conditions import (
    NODE_HEALTH_DEGRADED,
    REASON_NODE_HEALTH_DEGRADED,
    REASON_OPERAND_NOT_READY,
    REASON_READY,
    REASON_RECONCILE_FAILED,
    REASON_SERVING_NOT_REPORTING,
    REASON_SERVING_SLO_FAILED,
    REASON_SERVING_SLO_MET,
    REASON_SLICE_PARTITION_FAILED,
    SERVING_VALIDATED,
    SLICE_PARTITION_FAILED,
    get_condition,
    is_new_error,
    make_condition,
    mark_error,
    mark_ready,
    set_condition,
)
from ..health import HealthCounts, HealthStateMachine
from ..health import drain as drain_protocol
from ..nodeinfo import label_gpu_nodes
from ..state.manager import (
    INFO_CLUSTER_INFO,
    INFO_CLUSTER_POLICY,
    INFO_NAMESPACE,
    INFO_NODE_POOLS,
    INFO_NODES,
    InfoCatalog,
    Manager,
)
from ..state.nodepool import NodePool, get_node_pools, shard_by_pools
from ..state.operands import cluster_policy_states
from ..utils import deep_get, register_shared
from .metrics import OperatorMetrics
from .predicates import filtered_node_mapper
from .runtime import Controller, Reconciler, Request, Result

log = logging.getLogger(__name__)

#: reference requeues 5 s on NotReady (clusterpolicy_controller.go:165,193)
NOT_READY_REQUEUE = 5.0

#: watch events drive reconciles now; the periodic LIST-resync is a lost-
#: event safety net, not the cadence (jittered uniform(period/2, period))
RESYNC_PERIOD_S = float(os.environ.get("GPU_OPERATOR_RESYNC_S", "300"))

#: parallel workers for the pool-sharded node sweeps (health, serving):
#: pools reconcile independently, so one slow/degraded pool never
#: serializes the rest of the fleet behind it
POOL_SWEEP_WORKERS = max(1, int(os.environ.get("GPU_OPERATOR_POOL_WORKERS",
                                               "4")))


class ClusterPolicyReconciler(Reconciler):
    name = "clusterpolicy"

    def __init__(self, client: Client, namespace: Optional[str] = None,
                 metrics: Optional[OperatorMetrics] = None,
                 cluster_info=None, requeue_after: float = NOT_READY_REQUEUE,
                 join_profiler=None, journal=None):
        from ..provenance import DecisionJournal

        self.client = client
        self.namespace = namespace or os.environ.get(consts.NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
        self.metrics = metrics or OperatorMetrics()
        #: the shared decision-provenance journal, handed to every health
        #: machine a sweep builds (one per pool shard, one journal)
        self.journal = journal or DecisionJournal()
        self.cluster_info = cluster_info
        self.requeue_after = requeue_after
        #: joinprofile.JoinProfiler (None outside the assembled operator):
        #: one observation per sweep
        self.join_profiler = join_profiler
        self.state_manager = Manager(cluster_policy_states(client))
        #: last-seen tpu.ai/slice.config.state per node: the retile counter
        #: ticks on a transition INTO "retiled", not on every sweep that
        #: sees it
        self._last_slice_state: dict = register_shared(
            "ClusterPolicyController._last_slice_state", {})
        #: the last sweep's health rollup and serving failures (/debug/queue)
        self._last_health_counts: dict = register_shared(
            "ClusterPolicyController._last_health_counts", {})
        self._last_serving_failing: list = []

    def debug_state(self) -> dict:
        return {
            "node_health": dict(self._last_health_counts),
            "slice_states": {n: s for n, s in
                             sorted(self._last_slice_state.items()) if s},
            "serving_failing": list(self._last_serving_failing),
        }

    # -- singleton guard (reference clusterpolicy_controller.go:121-126) ------
    def _resolve_singleton(self, request: Request) -> Optional[ClusterPolicy]:
        policies = self.client.list("tpu.ai/v1", "ClusterPolicy")
        if not policies:
            return None
        policies.sort(key=lambda p: (p["metadata"].get("creationTimestamp", ""),
                                     p["metadata"]["name"]))
        primary = policies[0]
        for extra in policies[1:]:
            if deep_get(extra, "status", "state") != State.IGNORED:
                extra.setdefault("status", {})["state"] = State.IGNORED
                self._write_status(extra)
        if primary["metadata"]["name"] != request.name:
            return None  # reconcile of a non-primary instance: nothing to do
        return ClusterPolicy.from_obj(primary)

    def _write_status(self, obj: dict,
                      unchanged_from: Optional[dict] = None) -> None:
        if unchanged_from is not None and obj.get("status") == unchanged_from:
            # O(events) discipline: an identical status is not written, so
            # a ready steady-state sweep generates zero status traffic —
            # set_condition keeps lastTransitionTime stable on unchanged
            # conditions precisely so this comparison can work
            return
        with tracing.phase_span("status-update") as sp:
            try:
                self.client.update_status(obj)
            except (ConflictError, NotFoundError) as e:
                # benign write race with a concurrent editor; the level-driven
                # requeue re-reads and self-heals (reference relies on the same)
                sp.set_attribute("write_race", str(e))

    def _ensure_psa_labels(self, policy: ClusterPolicy) -> None:
        """spec.psa.enabled: label the operator namespace privileged for
        Pod Security Admission — operand pods need device nodes and
        hostPaths, so a PSA-enforcing cluster rejects them all otherwise
        (reference setPodSecurityLabelsForNamespace,
        controllers/state_manager.go:600-648)."""
        if not policy.spec.psa.enabled:
            return
        want = {f"pod-security.kubernetes.io/{mode}": "privileged"
                for mode in ("enforce", "audit", "warn")}
        try:
            ns = self.client.get("v1", "Namespace", self.namespace)
        except NotFoundError:
            # simulator clusters often carry no Namespace objects; a real
            # cluster always has one for a running operator
            log.debug("psa: namespace object %s absent; skipping", self.namespace)
            return
        labels = deep_get(ns, "metadata", "labels", default={}) or {}
        patch = {k: v for k, v in want.items() if labels.get(k) != v}
        if patch:
            log.info("psa: labeling namespace %s: %s", self.namespace, patch)
            self.client.patch("v1", "Namespace", self.namespace,
                              {"metadata": {"labels": patch}})

    def reconcile(self, request: Request) -> Result:
        self.metrics.reconciliation_total.inc()
        try:
            # one flush window per sweep: every deferred per-node write the
            # sweep generates merges into one PATCH per object, dispatched
            # at window exit (or by the batcher's deadline safety net)
            with batch_window(self.client):
                return self._reconcile(request)
        except Exception:
            self.metrics.reconciliation_failed.inc()
            self.metrics.reconciliation_status.set(0)
            raise

    def _pool_parallel(self, jobs: List[Callable[[], object]]) -> list:
        """Run one job per pool shard. Sequential for a single shard (or
        workers=1); otherwise a bounded thread pool. Results in job order;
        the first job exception re-raises after all complete (FencedError/
        BreakerOpenError then reach the runtime worker's handlers)."""
        if len(jobs) <= 1 or POOL_SWEEP_WORKERS <= 1:
            return [job() for job in jobs]
        workers = min(POOL_SWEEP_WORKERS, len(jobs))
        with futures.ThreadPoolExecutor(
                max_workers=workers,
                thread_name_prefix="pool-sweep") as pool:
            return [f.result() for f in
                    [pool.submit(job) for job in jobs]]

    def _surface_slice_failures(self, policy: ClusterPolicy,
                                nodes: List[dict]) -> None:
        """A node whose slice partitioner rejected its desired partition
        (impossible split -> tpu.ai/slice.config.state=failed) must be
        visible on the CR, not only as a node label: auxiliary
        SlicePartitionFailed condition + a Warning Event on transition.
        The condition rides the same status write as Ready/Error (set
        later this sweep), so readers never see it detached."""
        failed = sorted(
            n["metadata"]["name"] for n in nodes
            if deep_get(n, "metadata", "labels",
                        consts.TPU_SLICE_STATE_LABEL) == "failed")
        self.metrics.slice_partition_failed_nodes.set(len(failed))
        conditions = policy.obj.setdefault("status", {}).setdefault(
            "conditions", [])
        current = get_condition(policy.obj, SLICE_PARTITION_FAILED)
        if failed:
            message = ("slice partition rejected on node(s): "
                       + ", ".join(failed))
            if (current is None or current.get("status") != "True"
                    or current.get("message") != message):
                events.record(self.client, self.namespace, policy.obj,
                              events.WARNING, REASON_SLICE_PARTITION_FAILED,
                              message)
            set_condition(conditions, make_condition(
                SLICE_PARTITION_FAILED, "True",
                REASON_SLICE_PARTITION_FAILED, message))
        elif current is not None and current.get("status") == "True":
            set_condition(conditions, make_condition(
                SLICE_PARTITION_FAILED, "False", REASON_READY, ""))

    def _scan_serving_shard(self, shard: List[dict]) -> tuple:
        """Per-pool serving scan: publish per-node gauges, return this
        shard's (failing, reporting). Touches only its own pool's nodes —
        gauge label sets are per-node, so parallel shards never collide."""
        from ..validator.serving import parse_serving_detail

        failing: List[str] = []
        reporting = 0
        for node in shard:
            name = node["metadata"]["name"]
            verdict = deep_get(node, "metadata", "labels",
                               consts.SERVING_SLO_LABEL)
            if verdict is None:
                continue
            reporting += 1
            if verdict != "passed":
                failing.append(name)
            detail = parse_serving_detail(deep_get(
                node, "metadata", "annotations",
                consts.SERVING_SLO_ANNOTATION))
            if "p99_ms" in detail:
                self.metrics.serving_decode_p99.labels(node=name).set(
                    detail["p99_ms"] / 1000.0)
            if "tokens_per_s" in detail:
                self.metrics.serving_throughput.labels(node=name).set(
                    detail["tokens_per_s"])
            if "attainment" in detail:
                self.metrics.serving_slo_attainment.labels(node=name).set(
                    detail["attainment"])
        return failing, reporting

    def _sweep_serving(self, policy: ClusterPolicy, nodes: List[dict],
                       pools: Optional[List[NodePool]] = None) -> None:
        """Roll the per-node serving-SLO verdicts up to the CR. Feature
        discovery publishes each node's verdict as the ``tpu.ai/serving-slo``
        label with measured numbers in the detail annotation; this sweep
        republishes them as operator gauges and maintains a
        ``ServingValidated`` condition + transition-gated Warning Event.
        Nodes with no verdict (serving validation disabled, or not yet
        probed) are no-information: they neither fail nor certify. The scan
        is sharded by node pool and runs pools in parallel workers."""
        self.metrics.serving_decode_p99.clear()
        self.metrics.serving_throughput.clear()
        self.metrics.serving_slo_attainment.clear()
        shards = shard_by_pools(nodes, pools if pools is not None
                                else get_node_pools(nodes))
        scans = self._pool_parallel(
            [lambda shard=shard: self._scan_serving_shard(shard)
             for shard in shards])
        failing = [name for shard_failing, _ in scans
                   for name in shard_failing]
        reporting = sum(n for _, n in scans)
        self.metrics.serving_slo_failing_nodes.set(len(failing))
        self._last_serving_failing = sorted(failing)
        conditions = policy.obj.setdefault("status", {}).setdefault(
            "conditions", [])
        current = get_condition(policy.obj, SERVING_VALIDATED)
        if failing:
            message = ("serving SLO failing on node(s): "
                       + ", ".join(sorted(failing)))
            if (current is None or current.get("status") != "False"
                    or current.get("message") != message):
                events.record(self.client, self.namespace, policy.obj,
                              events.WARNING, REASON_SERVING_SLO_FAILED,
                              message)
            set_condition(conditions, make_condition(
                SERVING_VALIDATED, "False", REASON_SERVING_SLO_FAILED,
                message))
        elif reporting:
            set_condition(conditions, make_condition(
                SERVING_VALIDATED, "True", REASON_SERVING_SLO_MET,
                f"serving SLO met on {reporting} reporting node(s)"))
        elif current is not None:
            # every verdict label vanished (serving disabled / nodes
            # replaced): without this the condition freezes at its last
            # True/False and a stale SLO-failed message lives forever
            set_condition(conditions, make_condition(
                SERVING_VALIDATED, "Unknown", REASON_SERVING_NOT_REPORTING,
                "no nodes reporting a serving-SLO verdict"))

    @staticmethod
    def _next_drain_deadline(nodes: List[dict]) -> Optional[float]:
        """Seconds until the nearest open drain-plan deadline, or None when
        no window is open. An expiring deadline changes nothing on the
        apiserver, so the reconciler schedules its own wakeup for it
        instead of leaning on the (now 300s-class) safety-net resync."""
        now = time.time()
        soonest: Optional[float] = None
        for node in nodes:
            plan = drain_protocol.node_plan(node)
            if plan is None:
                continue
            delay = plan.deadline - now
            if soonest is None or delay < soonest:
                soonest = delay
        if soonest is None:
            return None
        # past-due plans force-release on the very next sweep; the floor
        # keeps a herd of expired plans from busy-looping the worker
        return max(0.25, soonest + 0.1)

    def _sweep_health(self, policy: ClusterPolicy, nodes: List[dict],
                      pools: Optional[List[NodePool]] = None) -> None:
        """Drive the per-node GPU-health machine and publish its rollup:
        per-state gauges, the remediation-attempt, drain-miss and snapshot
        counters, the retile counter (transitions into
        ``tpu.ai/slice.config.state=retiled``), and the ClusterPolicy's
        ``NodeHealthDegraded`` condition with one Warning Event per change
        of its message. Sharded by node pool: each shard gets its own
        machine and pools run in parallel workers, so a pool mid-drain never
        stalls the others."""
        # retiles are counted whatever health.enabled says: the partitioner
        # re-tiles from the barrier on its own
        for node in nodes:
            name = node["metadata"]["name"]
            state = deep_get(node, "metadata", "labels", consts.TPU_SLICE_STATE_LABEL)
            if state == "retiled" and self._last_slice_state.get(name) != "retiled":
                self.metrics.partition_retile_total.inc()
            self._last_slice_state[name] = state

        migrate = policy.spec.migrate
        if not policy.spec.health.enabled:
            machines = [HealthStateMachine(self.client, self.namespace, policy.spec.health,
                                           migrate=migrate, journal=self.journal)]
            machines[0].clear_all(nodes)
            counts = HealthCounts(healthy=len(nodes))
        else:
            shards = shard_by_pools(nodes, pools if pools is not None
                                    else get_node_pools(nodes))
            machines = [HealthStateMachine(self.client, self.namespace, policy.spec.health,
                                           migrate=migrate, journal=self.journal)
                        for _ in shards]
            with tracing.phase_span("health-sweep") as sp:
                shard_counts = self._pool_parallel(
                    [lambda m=machine, s=shard: m.process(s)
                     for machine, shard in zip(machines, shards)])
                counts = HealthCounts()
                for c in shard_counts:
                    counts = counts.merged(c)
                sp.set_attributes(shards=len(machines), **counts.as_dict())
        self._last_health_counts = counts.as_dict()
        for state, value in counts.as_dict().items():
            self.metrics.node_health_state.labels(state=state).set(value)
        attempts_fired = sum(m.attempts_fired for m in machines)
        deadline_misses = sum(m.deadline_misses for m in machines)
        snapshots_taken = sum(m.snapshots_taken for m in machines)
        if attempts_fired:
            self.metrics.remediation_attempts.inc(attempts_fired)
        if deadline_misses:
            self.metrics.drain_deadline_missed.inc(deadline_misses)
        if snapshots_taken:
            self.metrics.migration_snapshots.inc(snapshots_taken)
        self.metrics.drains_in_progress.set(sum(m.plans_pending for m in machines))

        unhealthy = {s: v for s, v in counts.as_dict().items()
                     if s not in ("healthy", "recovered") and v}
        conditions = policy.obj.setdefault("status", {}).setdefault("conditions", [])
        current = get_condition(policy.obj, NODE_HEALTH_DEGRADED)
        if unhealthy:
            message = ("node GPU health: "
                       + ", ".join(f"{v} {s}" for s, v in sorted(unhealthy.items())))
            if (current is None or current.get("status") != "True"
                    or current.get("message") != message):
                events.record(self.client, self.namespace, policy.obj,
                              events.WARNING, REASON_NODE_HEALTH_DEGRADED, message)
            set_condition(conditions, make_condition(
                NODE_HEALTH_DEGRADED, "True", REASON_NODE_HEALTH_DEGRADED, message))
        elif current is not None and current.get("status") == "True":
            set_condition(conditions, make_condition(
                NODE_HEALTH_DEGRADED, "False", REASON_READY, ""))

    def _reconcile(self, request: Request) -> Result:
        start = time.monotonic()
        try:
            policy = self._resolve_singleton(request)
        except NotFoundError:
            policy = None
        if policy is None:
            return Result()
        # status as read this sweep: the pre-write comparison that keeps a
        # no-op sweep from writing an identical status (O(events) traffic)
        status_as_read = copy.deepcopy(policy.obj.get("status"))

        self._ensure_psa_labels(policy)

        # node labeling sweep (state_manager.go:857 labelGPUNodes)
        with tracing.phase_span("label-nodes") as sp:
            label_result = label_gpu_nodes(self.client, policy, self.namespace)
            sp.set_attribute("gpu_nodes", label_result.gpu_nodes)
        self.metrics.gpu_nodes_total.set(label_result.gpu_nodes)
        # one pool computation per sweep: the sharding source for the
        # node-facing sweeps below and for any state that fans out per pool
        pools = get_node_pools(label_result.nodes)

        catalog = InfoCatalog()
        catalog[INFO_CLUSTER_POLICY] = policy
        catalog[INFO_NAMESPACE] = self.namespace
        catalog[INFO_CLUSTER_INFO] = self.cluster_info
        catalog[INFO_NODES] = label_result.nodes
        catalog[INFO_NODE_POOLS] = pools

        with tracing.phase_span("sync-state") as sp:
            results = self.state_manager.sync_state(catalog)
            sp.set_attribute("ready", results.ready)
        if self.join_profiler is not None:
            # one join-profiler observation per sweep: schedulability,
            # readiness and the mirrored trace-spans annotation per node
            # (in memory only: no apiserver call can fail here)
            try:
                self.join_profiler.observe(policy, label_result.nodes, results)
            except Exception:  # opalint: disable=breaker-swallow — observe() is in-memory only (no API calls), so no BreakerOpenError can arrive; profiling must never fail a reconcile
                log.debug("join profiler observation failed", exc_info=True)
        # after the (crash-prone) state sweep, right before the status
        # writes: an exception between the Warning Event and the condition
        # landing on the CR would re-emit the event every backoff retry
        self._surface_slice_failures(policy, label_result.nodes)
        self._sweep_health(policy, label_result.nodes, pools)
        self._sweep_serving(policy, label_result.nodes, pools)
        previous_state = deep_get(policy.obj, "status", "state")

        if results.ready:
            if previous_state != State.READY:
                events.record(self.client, self.namespace, policy.obj,
                              events.NORMAL, "Ready", "all operand states are ready")
            policy.set_state(State.READY, self.namespace)
            mark_ready(policy.obj)
            # state + conditions atomically; skipped when nothing changed
            self._write_status(policy.obj, unchanged_from=status_as_read)
            self.metrics.reconciliation_status.set(1)
            self.metrics.reconciliation_last_success.set_to_current_time()
            log.info("ClusterPolicy %s ready (%.3fs, %d GPU nodes)",
                     policy.name, time.monotonic() - start, label_result.gpu_nodes)
            # time-based work must schedule its own wakeup: a drain-plan
            # deadline expiring produces no watch event, and the resync is
            # now a 300s-class safety net, not a 10s poll
            wake = self._next_drain_deadline(label_result.nodes)
            if wake is not None:
                return Result(requeue_after=wake)
            return Result()

        blocker = results.first_not_ready()
        policy.set_state(State.NOT_READY, self.namespace)
        reason = (REASON_RECONCILE_FAILED if blocker and blocker.status.value == "error"
                  else REASON_OPERAND_NOT_READY)
        message = f"state {blocker.state_name} is {blocker.status.value}" if blocker else "not ready"
        if blocker and blocker.message:
            message += f": {blocker.message}"
        if (blocker and blocker.status.value == "error"
                and is_new_error(policy.obj, reason, message)):
            # gate on transition: the 5s requeue + resync would otherwise
            # mint a fresh Event object for the same failure every sweep
            events.record(self.client, self.namespace, policy.obj,
                          events.WARNING, reason, message)
        mark_error(policy.obj, reason, message)
        # state + conditions atomically; skipped when nothing changed
        self._write_status(policy.obj, unchanged_from=status_as_read)
        self.metrics.reconciliation_status.set(0)
        log.info("ClusterPolicy %s not ready: %s", policy.name, message)
        return Result(requeue_after=self.requeue_after)


# -- watch wiring (NVIDIA's SetupWithManager, clusterpolicy_controller.go:355-423)

def _all_policy_requests(client: Client) -> List[Request]:
    return [Request(name=p["metadata"]["name"])
            for p in client.list("tpu.ai/v1", "ClusterPolicy")]




def setup_clusterpolicy_controller(client: Client,
                                   reconciler: ClusterPolicyReconciler) -> Controller:
    controller = Controller(reconciler)

    def map_policy(event: WatchEvent) -> List[Request]:
        return [Request(name=event.object["metadata"]["name"])]

    # node added/changed/removed -> re-reconcile the policy (node labeling
    # + DS scheduling may change; NVIDIA's addWatchNewGPUNode :256-352).
    # Status-only heartbeats are filtered out.
    map_node = filtered_node_mapper(lambda event: _all_policy_requests(client))

    def map_owned(event: WatchEvent) -> List[Request]:
        labels = deep_get(event.object, "metadata", "labels", default={}) or {}
        if consts.STATE_LABEL in labels:
            return _all_policy_requests(client)
        return []

    def map_gpudriver(event: WatchEvent) -> List[Request]:
        # GPUDriver instances appearing or disappearing move the driver
        # state's ownership (hand-over, hand-back): re-reconcile at once
        return _all_policy_requests(client)

    def map_validation_pod(event: WatchEvent) -> List[Request]:
        # multihost rendezvous / serving probe pods completing must
        # re-trigger promptly rather than waiting out the 5s NotReady requeue
        app = deep_get(event.object, "metadata", "labels", "app")
        if app in ("gpu-multihost-validation", "gpu-serving-validation"):
            return _all_policy_requests(client)
        return []

    controller.watches("tpu.ai/v1", "ClusterPolicy", map_policy)
    controller.watches("v1", "Node", map_node)
    # namespaced kinds are watched ONLY in the operator namespace: the
    # owned DaemonSets and validation pods live there, and an unscoped
    # watch against a real apiserver is a cluster-wide pod firehose
    controller.watches("apps/v1", "DaemonSet", map_owned,
                       namespace=reconciler.namespace)
    # the other state-labeled operand kinds: out-of-band drift (a kubectl
    # edit of a rendered Service port, a wiped ConfigMap) must trigger the
    # heal sweep as an event — the jittered safety-net resync is too slow
    # to be the drift-repair path
    controller.watches("v1", "Service", map_owned,
                       namespace=reconciler.namespace)
    controller.watches("v1", "ConfigMap", map_owned,
                       namespace=reconciler.namespace)
    controller.watches("v1", "ServiceAccount", map_owned,
                       namespace=reconciler.namespace)
    controller.watches("tpu.ai/v1alpha1", "GPUDriver", map_gpudriver)
    controller.watches("v1", "Pod", map_validation_pod,
                       namespace=reconciler.namespace)
    # demoted to a safety net: watch events (nodes, owned DaemonSets,
    # GPUDriver CRs, validation pods) drive reconciles; the jittered LIST
    # only recovers mappings lost to a watch-stream gap
    controller.resyncs(lambda: _all_policy_requests(client),
                       period=RESYNC_PERIOD_S)
    return controller
