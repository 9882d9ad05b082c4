"""The deterministic fleet simulator engine (counterpart of
tpu_operator/simulator/engine.py, on GPU nodes).

One synchronous event loop (Podracer, arXiv 2104.06272) composes the
harness pieces — :class:`~tpu_operator_torch.testing.apiserver.
MiniApiServer`, :class:`~tpu_operator_torch.testing.kubelet.
KubeletSimulator`, :class:`~tpu_operator_torch.testing.chaos.PodChaos` /
:class:`NodeChaos`, the ``serving/traffic.py`` seeded generator — behind one
virtual clock and one seeded RNG root, and drives the REAL reconcilers
through the production client chain (CachedClient -> WriteBatcher ->
RetryingClient -> FencedClient -> causality observer -> RestClient over
genuine HTTP).

Determinism contract: per tick the engine (1) fires due injections,
(2) performs all feeder-side actor writes (workload acks, traffic
snapshots, node agents), (3) waits for the informer cache to catch up to
the backend's per-kind event high watermark (``CachedClient.
wait_caught_up``), (4) calls each reconciler's ``reconcile()`` inline and
flushes the write batcher. No free-running threads race the loop, so the
canonical event log of a run is a pure function of (scenario, seed) — the
double-run gate asserts byte identity.

The fleet is GPU nodes: :data:`GPUS_PER_NODE` of ``nvidia.com/gpu`` each,
feature discovery's chip type :data:`GPU_MODEL` and node feature
discovery's NVIDIA PCI label, no slice topology. A healthy node serves the
card's measured frontier (:data:`CARD_FRONTIER`, or the ``frontier`` the
caller measured) times its GPUs.
"""

from __future__ import annotations

import json
import logging
import math
import os
import random
import shutil
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .. import consts
from ..api.clusterpolicy import new_cluster_policy
from ..client.batch import WriteBatcher
from ..client.cache import CachedClient
from ..client.fenced import FencedClient
from ..client.errors import ApiError, BreakerOpenError, NotFoundError
from ..client.resilience import CircuitBreaker, RetryingClient, RetryPolicy
from ..client.rest import RestClient
from ..controllers.runtime import Request
from ..health import drain as drain_protocol
from ..provenance import ActuationObserver, DecisionJournal, causality_audit
from ..serving import traffic
from ..serving import frontier as frontier_schema
from ..testing.apiserver import MiniApiServer
from ..testing.chaos import NodeChaos, PodChaos
from ..testing.kubelet import GPUS_PER_NODE, KubeletSimulator
from ..testing.trainjob import SimulatedTrainingJob
from ..upgrade.machine import (
    DRAIN_REQUIRED,
    DRIVER_COMPONENT,
    IN_PROGRESS_STATES,
    POD_DELETION_REQUIRED,
    WAIT_FOR_JOBS_REQUIRED,
    node_upgrade_state,
)
from ..utils import clock as wallclock
from ..utils import deep_get
from ..validator.status import StatusFiles
from .clock import VirtualClock
from .scenario import Scenario
from .seeds import resolve_seed, seed_for

log = logging.getLogger(__name__)

ZONE_LABEL = "topology.kubernetes.io/zone"
# The fleet's names sort as the reference's do (its ``tpu-NNN`` after the
# herd's ``herd-NNNN`` and before the autoscaler's ``<pool>-aN``; its job pods
# before the DaemonSets' pods): the chaos injectors draw their victims from
# sorted names, so one seed picks the same victims in both.
#: feature discovery's chip type for the card the frontier was measured on
#: (``chip_type_from_kind`` of its name); a node of this model is in the
#: pool of that name
GPU_MODEL = "nvidia-h100-80gb"
#: the card's serving frontier, (batch, p99_ms, tokens_per_s) per point:
#: ``gpu-validator -c serving`` at the CLI defaults (batches 1, 4, 8, 32
#: steps each, dim 256) on one GPU, the first of three runs in one call
#: (the other two: 165567.6 and 167888.4 tokens/s at batch 8)
CARD_FRONTIER: Tuple[Tuple[int, float, float], ...] = (
    (1, 0.0897, 19293.3), (4, 0.07, 79087.6), (8, 0.0514, 159656.2))
#: the card those points were measured on, as ``nvidia-smi
#: --query-gpu=name,power.limit --format=csv,noheader`` prints it
CARD_FRONTIER_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: timed steps behind each point of that run
FRONTIER_SAMPLES = 32
#: ticks between node registration and serving capacity (the join path)
JOIN_DELAY_TICKS = 2
#: SLO ceiling the serving loop reads curves at (mirrors the ClusterPolicy
#: spec.serving.maxDecodeP99Ms default)
MAX_P99_MS = 200.0
#: Events that must be minted at most once per (object, message) — a
#: ``count`` > 1 on any of them is a duplicate protocol Event (the
#: transition-gated emitters re-fired for a transition that already
#: happened, exactly what crash replays and chaos must not cause)
EXACTLY_ONCE_REASONS = (
    "RetilePlanned", "NodeHealthRemediating", "MigrationRestored",
    "MigrationCompleted", "TransparentSnapshotTaken", "HostPluginAdopted",
)

#: env image defaults so render works outside the operator deployment
_IMAGE_ENVS = ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "FEATURE_DISCOVERY_IMAGE",
               "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE",
               "DEVICE_PLUGIN_IMAGE")
#: the simulated cluster's image registry (nothing is pulled)
REGISTRY = "registry.sim/gpu"


def gpu_node(name: str, zone: str, preemptible: bool) -> dict:
    """A GPU node as it joins: the model's labels and its GPU capacity."""
    labels = {
        consts.TPU_CHIP_TYPE_LABEL: GPU_MODEL,
        consts.NFD_NVIDIA_PCI_LABEL: "true",
        ZONE_LABEL: zone,
    }
    if preemptible:
        labels[consts.PREEMPTIBLE_POOL_LABEL] = "true"
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels},
            "status": {"capacity": {
                consts.GPU_RESOURCE_NAME: str(GPUS_PER_NODE)}}}


def node_curve(frontier: Sequence[Tuple[int, float, float]],
               measured_at: float) -> frontier_schema.Frontier:
    """A healthy node's serving curve: each of the GPU's points at
    :data:`GPUS_PER_NODE` times its tokens/s (the node's GPUs serve
    independently)."""
    return frontier_schema.Frontier(
        points=[frontier_schema.FrontierPoint(int(b), float(p99),
                                              float(tps) * GPUS_PER_NODE,
                                              FRONTIER_SAMPLES)
                for b, p99, tps in frontier],
        measured_at=measured_at)


def tokens_per_gpu(frontier: Sequence[Tuple[int, float, float]]) -> float:
    """The nominal tokens/s one healthy GPU serves — the conversion between
    the GPU-denominated demand envelope and the token-denominated serving
    loop: a healthy node's curve at :data:`MAX_P99_MS`, read back through
    the annotation codec (which keeps 6 significant figures), over its GPUs.
    A power of two divides exactly, so with no drift the measured path and
    the GPU-constant path agree."""
    node = frontier_schema.decode_annotation(
        frontier_schema.encode_annotation(node_curve(frontier, 0.0)))
    return node.best_tokens_per_s(MAX_P99_MS) / GPUS_PER_NODE


class ScaleDownAuditor:
    """Every operator Node delete audited against the backend BEFORE it
    executes: a delete without a published drain plan is a *bare* delete,
    a planned delete without a matching drain-ack is *unacked* — both
    universal oracles gate at zero. Infrastructure revocations (kubelet
    spot reclaim, AZ loss) ride the feeder client and are invisible here
    by construction: only the operator's own chain is audited."""

    def __init__(self, inner, backend):
        self._inner = inner
        self._backend = backend
        self.node_deletes = 0
        self.bare_deletes = 0
        self.unacked_deletes = 0

    def delete(self, api_version, kind, name, namespace=None):
        if kind == "Node":
            self.node_deletes += 1
            try:
                node = self._backend.get("v1", "Node", name)
            except NotFoundError:
                node = None
            ann = deep_get(node or {}, "metadata", "annotations",
                           default={}) or {}
            raw_plan = ann.get(consts.RETILE_PLAN_ANNOTATION)
            if not raw_plan:
                self.bare_deletes += 1
            else:
                try:
                    fp = json.loads(raw_plan).get("fingerprint")
                    ack = json.loads(
                        ann.get(consts.DRAIN_ACK_ANNOTATION) or "{}")
                except ValueError:
                    fp, ack = None, {}
                if not fp or ack.get("plan") != fp:
                    self.unacked_deletes += 1
        return self._inner.delete(api_version, kind, name, namespace)

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


class FleetSimulator:
    """Run one scenario end to end; :meth:`run` returns the report dict
    (``report["ok"]`` rolls up the oracle verdicts,
    ``report["canonical"]`` is the byte-stable event log).

    ``frontier``: one GPU's serving curve, (batch, p99_ms, tokens_per_s)
    points, that every healthy node serves :data:`GPUS_PER_NODE` times
    over; :data:`CARD_FRONTIER` when not given."""

    def __init__(self, scenario: Scenario, seed: Optional[int] = None,
                 workdir: Optional[str] = None, latency_s: float = 0.001,
                 frontier: Optional[Sequence[Tuple[int, float, float]]] = None):
        self.scenario = scenario
        self.seed = resolve_seed(seed)
        self.frontier = tuple(tuple(p) for p in (frontier or CARD_FRONTIER))
        self.latency_s = latency_s
        self._workdir = workdir
        self._own_workdir = workdir is None
        # one seeded RNG per consumer, derived from the single root
        self.rng_injections = random.Random(seed_for(self.seed, "injections"))
        self.rng_brownout = random.Random(seed_for(self.seed, "brownout"))
        self.vclock = VirtualClock(tick_s=scenario.tick_s)
        self.injections_applied: List[dict] = []
        self.reconcile_errors: List[str] = []
        self.feeder_faults: List[str] = []
        self._fired = [False] * len(scenario.injections)
        self._brownout_until: Optional[int] = None
        self._herd_seq = 0

    # -- setup ----------------------------------------------------------------
    def _seed_fleet(self, feeder) -> List[str]:
        sc = self.scenario
        names = []
        for i in range(sc.fleet):
            name = f"node-{i:03d}"
            feeder.create(gpu_node(name, f"z{i % sc.zones}", sc.preemptible))
            names.append(name)
        return names

    def _build_chain(self, base_url: str):
        # the causality observer wraps the INNERMOST client: batched
        # writes are observed post-flush with their final merged bodies
        self.observer = ActuationObserver(RestClient(base_url=base_url))
        self.auditor = ScaleDownAuditor(self.observer, self.srv.backend)
        policy = RetryPolicy(max_attempts=5, base_backoff_s=0.02,
                             max_backoff_s=0.25, deadline_s=30.0)
        retry_rng = random.Random(seed_for(self.seed, "retry-jitter"))
        # the full production shape (fence unbound: single replica, no
        # elector — agent-passthrough mode, exactly like the benches).
        # Breaker cooldown and retry deadlines run on the VIRTUAL clock
        # and backoff sleeps are no-ops: within a tick the clock is
        # frozen (attempts bound the retry loop), across ticks the
        # breaker's cooldown elapses in simulated seconds — wall speed
        # never leaks into when a probe reopens the circuit.
        self.batcher = WriteBatcher(RetryingClient(
            FencedClient(self.auditor), policy=policy, rng=retry_rng,
            breaker=CircuitBreaker(cooldown_s=self.scenario.tick_s,
                                   clock=self.vclock.now),
            clock=self.vclock.now, sleep=lambda _s: None))
        self.op_client = CachedClient(self.batcher)
        self.journal = DecisionJournal(client=self.op_client,
                                       now=self.vclock.now)

    # -- determinism barrier ---------------------------------------------------
    def _sync(self) -> None:
        """Flush pending batched writes, then wait until every informer
        has applied the newest event its scope emitted — the per-tick
        read barrier that makes the synchronous loop deterministic."""
        self.batcher.flush()
        if not self.op_client.wait_caught_up(self.srv.backend.last_event_rv,
                                             timeout=10.0):
            log.warning("simulator: informer cache lagging past barrier")

    def feed(self, fn: Callable[[], object], what: str) -> bool:
        """Run one feeder-side actor action, tolerating apiserver faults:
        an external actor failing a write during a brownout IS the chaos
        working — it retries on its next tick. Returns success."""
        try:
            fn()
            return True
        except ApiError as e:
            self.feeder_faults.append(f"{what}: {type(e).__name__}")
            return False

    def _reconcile(self, reconciler, request: Request) -> None:
        try:
            reconciler.reconcile(request)
        except BreakerOpenError as e:
            # degraded mode: the breaker cools down in virtual seconds, so
            # the next tick retries with a closed breaker — record it
            # distinctly (it is chaos working, not a reconcile bug)
            self.reconcile_errors.append(f"breaker-open: {e}")
        except Exception as e:  # level-driven: next tick retries
            self.reconcile_errors.append(f"{type(e).__name__}: {e}")
        self._sync()

    # -- conditions ------------------------------------------------------------
    def _nodes(self) -> List[dict]:
        return self.srv.backend.list("v1", "Node")

    def _condition_true(self, cond: str, tick: int) -> bool:
        if cond == "start":
            return True
        if cond == "drain_open":
            for n in self._nodes():
                plan = drain_protocol.node_plan(n)
                if plan is not None and (
                        drain_protocol.node_acked_plan(n)
                        != plan.fingerprint):
                    return True
            return False
        if cond == "scale_up":
            return len(self._nodes()) > self.scenario.fleet
        if cond == "upgrade":
            return any(node_upgrade_state(n) in IN_PROGRESS_STATES
                       for n in self._nodes())
        if cond == "upgrade.draining":
            window = (WAIT_FOR_JOBS_REQUIRED, POD_DELETION_REQUIRED,
                      DRAIN_REQUIRED)
            return any(node_upgrade_state(n) in window
                       for n in self._nodes())
        if cond.startswith("migration."):
            from ..migrate import migration_state
            phase = cond.split(".", 1)[1]
            for n in self._nodes():
                state = migration_state(n)
                if state and state.get("phase") == phase:
                    return True
            return False
        return False

    # -- injections ------------------------------------------------------------
    def _fire_injections(self, tick: int) -> None:
        for i, inj in enumerate(self.scenario.injections):
            if self._fired[i]:
                continue
            due = (inj.at == tick if inj.at is not None
                   else self._condition_true(inj.when, tick))
            if not due:
                continue
            self._fired[i] = True
            record = {"tick": tick, "kind": inj.kind,
                      "params": {k: v for k, v in sorted(inj.params.items())}}
            record.update(self._apply_injection(inj, tick))
            self.injections_applied.append(record)
            log.info("simulator: injected %s at tick %d: %s",
                     inj.kind, tick, record)

    def _apply_injection(self, inj, tick: int) -> dict:
        params = inj.params
        if inj.kind == "az_loss":
            zones = sorted({deep_get(n, "metadata", "labels", ZONE_LABEL)
                            for n in self._nodes()} - {None})
            if not zones:
                return {"victims": []}
            count = max(1, round(float(params["frac"]) * len(zones)))
            lost = self.rng_injections.sample(zones, min(count, len(zones)))
            victims = sorted(
                n["metadata"]["name"] for n in self._nodes()
                if deep_get(n, "metadata", "labels", ZONE_LABEL) in lost)
            revoked = [name for name in victims
                       if self.feed(lambda n=name:
                                    self.kubelet.revoke_node(n), "az-loss")]
            self._sync()
            return {"zones": sorted(lost), "victims": revoked}
        if inj.kind == "revocation_wave":
            target = params.get("target")
            victims = []
            if target in ("upgrading", "draining"):
                window = (IN_PROGRESS_STATES
                          if target == "upgrading"
                          else (WAIT_FOR_JOBS_REQUIRED,
                                POD_DELETION_REQUIRED, DRAIN_REQUIRED))
                for n in sorted(self._nodes(),
                                key=lambda n: n["metadata"]["name"]):
                    if node_upgrade_state(n) in window:
                        if self.kubelet.revoke_node(n["metadata"]["name"]):
                            victims.append(n["metadata"]["name"])
                            break
            else:
                eligible = sum(
                    1 for n in self._nodes()
                    if deep_get(n, "metadata", "labels",
                                consts.PREEMPTIBLE_POOL_LABEL) == "true")
                count = max(1, round(float(params["frac"]) * eligible))
                for _ in range(count):
                    victim = self.node_chaos.revoke_one()
                    if victim is None:
                        break
                    victims.append(victim)
            self._sync()
            return {"victims": sorted(victims)}
        if inj.kind == "apiserver_brownout":
            dur_ticks = max(1, math.ceil(
                float(params["dur"]) / self.scenario.tick_s))
            self._brownout_until = tick + dur_ticks
            p = float(params["p"])
            rng = self.rng_brownout

            def fault(method: str, path: str) -> Optional[int]:
                return 503 if rng.random() < p else None

            self.srv.fault = fault
            return {"until_tick": self._brownout_until}
        if inj.kind == "thundering_herd":
            joined = []
            for _ in range(int(params["join"])):
                name = f"herd-{self._herd_seq:04d}"
                self._herd_seq += 1
                node = gpu_node(name, f"z{self._herd_seq % self.scenario.zones}",
                                self.scenario.preemptible)
                if self.feed(lambda n=node: self.feeder.create(n), "herd-join"):
                    joined.append(name)
            self._sync()
            return {"victims": [], "joined": len(joined)}
        if inj.kind == "pod_chaos":
            victims = []
            for _ in range(int(params["kills"])):
                victim = self.pod_chaos.kill_one()
                if victim is None:
                    break
                victims.append(victim)
            self._sync()
            return {"victims": sorted(victims)}
        if inj.kind == "frontier_drift":
            # silent per-node degradation: a fraction of the fleet's
            # measured serving curves collapse by ``factor`` (thermal
            # throttling, a bad HBM stack — capacity the GPU-count
            # predictor is blind to). The CapacityCollector must flag the
            # departure and the autoscaler must re-provision from the
            # degraded measurement, not the nominal constant.
            factor = float(params["factor"])
            carriers = []
            for n in sorted(self._nodes(),
                            key=lambda n: n["metadata"]["name"]):
                if frontier_schema.decode_annotation(deep_get(
                        n, "metadata", "annotations",
                        consts.SERVING_FRONTIER_ANNOTATION)) is not None:
                    carriers.append(n)
            if not carriers:
                return {"victims": []}
            count = max(1, round(float(params["frac"]) * len(carriers)))
            victims = []
            for node in self.rng_injections.sample(
                    carriers, min(count, len(carriers))):
                fr = frontier_schema.decode_annotation(deep_get(
                    node, "metadata", "annotations",
                    consts.SERVING_FRONTIER_ANNOTATION))
                for p in fr.points:
                    p.tokens_per_s *= factor
                name = node["metadata"]["name"]
                body = {"metadata": {"annotations": {
                    consts.SERVING_FRONTIER_ANNOTATION:
                        frontier_schema.encode_annotation(fr),
                }}}
                # environment fault, not an operator sweep
                # opalint: disable=unbatched-sweep-write
                if self.feed(lambda n=name, b=body: self.feeder.patch(
                        "v1", "Node", n, b), "frontier-drift"):
                    victims.append(name)
            self._sync()
            return {"victims": sorted(victims)}
        raise AssertionError(f"unhandled injection {inj.kind}")

    def _expire_brownout(self, tick: int) -> None:
        if self._brownout_until is not None and tick >= self._brownout_until:
            self.srv.fault = None
            self._brownout_until = None

    # -- run -------------------------------------------------------------------
    def run(self) -> dict:
        sc = self.scenario
        # set for the run only: the caller's process keeps its environment
        images = [env for env in _IMAGE_ENVS if env not in os.environ]
        for env in images:
            os.environ[env] = f"{REGISTRY}/x:0.1.0"
        if self._own_workdir:
            self._workdir = tempfile.mkdtemp(prefix="gpu-sim-")
        self.srv = MiniApiServer(latency_s=self.latency_s)
        base = self.srv.start()
        # external actors (workloads, node agents, infra chaos) ride a
        # retried-but-unfenced chain: they are not the operator
        self.feeder = RetryingClient(FencedClient(RestClient(base_url=base)),
                                     policy=RetryPolicy(
                                         max_attempts=6, base_backoff_s=0.02,
                                         max_backoff_s=0.25, deadline_s=30.0),
                                     rng=random.Random(
                                         seed_for(self.seed, "feeder-jitter")),
                                     breaker=CircuitBreaker(
                                         cooldown_s=self.scenario.tick_s,
                                         clock=self.vclock.now),
                                     clock=self.vclock.now,
                                     sleep=lambda _s: None)
        self._build_chain(base)
        # the port's simulated kubelet always makes the DaemonSets' pods
        # (the reference's does for the upgrade only); the autoscale and
        # migrate operations render no DaemonSet, so it makes none there
        self.kubelet = KubeletSimulator(self.feeder)
        self.node_chaos = NodeChaos(self.kubelet,
                                    seed=seed_for(self.seed, "node-chaos"))
        self.pod_chaos = PodChaos(self.feeder, consts.DEFAULT_NAMESPACE,
                                  seed=seed_for(self.seed, "pod-chaos"))
        driver = _DRIVERS[sc.operation](self)
        try:
            with wallclock.pinned(self.vclock.now):
                self._seed_fleet(self.feeder)
                driver.setup()
                self._sync()
                for tick in range(sc.ticks):
                    self.vclock.tick = tick
                    self._expire_brownout(tick)
                    self._fire_injections(tick)
                    driver.tick(tick)
                # bounded settle tail: injections are done firing; let
                # in-flight episodes close so oracles judge terminal state
                settle_budget = max(16, sc.ticks // 2,
                                    driver.settle_hint())
                settled_at = None
                for extra in range(settle_budget):
                    tick = sc.ticks + extra
                    self.vclock.tick = tick
                    self._expire_brownout(tick)
                    if not driver.active():
                        settled_at = tick
                        break
                    driver.tick(tick)
                self.srv.fault = None
                return self._report(driver, settled_at)
        finally:
            try:
                self.op_client.stop()
            # teardown: the server is already past its last event, there is
            # nothing left to requeue  # opalint: disable=breaker-swallow
            except Exception:
                log.debug("op_client.stop failed during teardown",
                          exc_info=True)
            self.srv.stop()
            driver.teardown()
            if self._own_workdir:
                shutil.rmtree(self._workdir, ignore_errors=True)
            for env in images:
                os.environ.pop(env, None)

    # -- report + oracles ------------------------------------------------------
    def _terminal_state(self) -> Dict[str, dict]:
        out = {}
        for n in self._nodes():
            name = n["metadata"]["name"]
            out[name] = {
                "labels": dict(sorted((deep_get(
                    n, "metadata", "labels", default={}) or {}).items())),
                "unschedulable": bool(deep_get(
                    n, "spec", "unschedulable", default=False)),
            }
        return out

    def _event_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for e in self.srv.backend.list("v1", "Event",
                                       consts.DEFAULT_NAMESPACE):
            reason = e.get("reason") or "?"
            counts[reason] = counts.get(reason, 0) + int(e.get("count") or 1)
        return dict(sorted(counts.items()))

    def _oracles(self, driver, settled_at) -> List[dict]:
        oracles = []

        def add(name: str, ok: bool, detail: str) -> None:
            oracles.append({"name": name, "ok": bool(ok), "detail": detail})

        add("no_bare_deletes", self.auditor.bare_deletes == 0,
            f"{self.auditor.bare_deletes} bare node deletes "
            f"(of {self.auditor.node_deletes} total)")
        add("no_unacked_deletes", self.auditor.unacked_deletes == 0,
            f"{self.auditor.unacked_deletes} deletes without a matching "
            f"drain-ack")
        dupes = []
        for e in self.srv.backend.list("v1", "Event",
                                       consts.DEFAULT_NAMESPACE):
            if (e.get("reason") in EXACTLY_ONCE_REASONS
                    and int(e.get("count") or 1) > 1):
                dupes.append(f"{e.get('reason')}/"
                             f"{deep_get(e, 'involvedObject', 'name')}"
                             f" x{e.get('count')}")
        add("exactly_once_events", not dupes,
            "duplicates: " + ", ".join(dupes) if dupes else "no duplicates")
        causality = causality_audit(self.journal, self.observer.observed)
        # the gate is ZERO ORPHANS — every operator actuation must be
        # claimed by a decision record. Incomplete episodes are reported
        # but not gated: an infra revocation that eats a node mid-episode
        # legitimately strands the episode without an outcome record,
        # and that is the infrastructure's fault, not the operator's.
        add("causality_clean", not causality.get("orphans"),
            f"orphans={len(causality.get('orphans') or [])} "
            f"incomplete={len(causality.get('incomplete') or [])}")
        add("converged", settled_at is not None,
            f"settled at tick {settled_at}" if settled_at is not None
            else "never quiesced inside the settle budget")
        for name, ok, detail in driver.oracles():
            add(name, ok, detail)
        return oracles

    def _report(self, driver, settled_at) -> dict:
        self._sync()
        oracles = self._oracles(driver, settled_at)
        terminal = self._terminal_state()
        report = {
            "scenario": self.scenario.to_dict(),
            "seed": self.seed,
            "seeds": {name: seed_for(self.seed, name)
                      for name in ("traffic", "pod-chaos", "node-chaos",
                                   "brownout", "injections")},
            "injections_applied": self.injections_applied,
            "injections_unfired": [
                inj.to_dict() for i, inj in
                enumerate(self.scenario.injections) if not self._fired[i]],
            "oracles": oracles,
            "ok": all(o["ok"] for o in oracles),
            "settled_at_tick": settled_at,
            "terminal": terminal,
            "event_counts": self._event_counts(),
            "node_deletes": self.auditor.node_deletes,
            "reconcile_errors": self.reconcile_errors,
            "feeder_faults": self.feeder_faults,
            "operation": driver.report(),
            "causality": causality_audit(self.journal,
                                         self.observer.observed),
        }
        report["canonical"] = canonical_log(report)
        return report


def canonical_log(report: dict) -> str:
    """The byte-stable event log of a run: scenario, injections (tick +
    sorted victims), oracle verdicts, terminal label state. Everything
    here is a pure function of (scenario, seed); path-dependent noise
    (retry counts, wall-clock, annotation timestamps) is deliberately
    excluded so a double run at one seed is byte-identical."""
    payload = {
        "scenario": report["scenario"],
        "seed": report["seed"],
        "injections": [
            {"tick": r["tick"], "kind": r["kind"], "params": r["params"],
             "victims": r.get("victims", []), "zones": r.get("zones", [])}
            for r in report["injections_applied"]],
        "oracles": [{"name": o["name"], "ok": o["ok"]}
                    for o in report["oracles"]],
        "terminal": report["terminal"],
    }
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


# -- operation drivers --------------------------------------------------------

class _Driver:
    def __init__(self, sim: FleetSimulator):
        self.sim = sim

    def setup(self) -> None: ...
    def tick(self, tick: int) -> None: ...
    def active(self) -> bool:
        return False
    def settle_hint(self) -> int:
        """Extra settle ticks the operation needs beyond the generic
        budget — O(fleet) serialized protocols override this."""
        return 0
    def oracles(self):
        return []
    def report(self) -> dict:
        return {}
    def teardown(self) -> None: ...


class _AutoscaleDriver(_Driver):
    """Closed traffic -> capacity loop against the real AutoscaleReconciler,
    demand shaped by the seeded serving-traffic generator: a rise-fall
    envelope (forces a scale-up AND a drained scale-down inside one
    scenario) modulated by the traffic sim's sampled backlog jitter."""

    #: the pool the autoscaler keys the fleet's nodes on: their chip type
    #: (``state.nodepool.get_node_pools``)
    POOL = GPU_MODEL

    def __init__(self, sim: FleetSimulator):
        super().__init__(sim)
        self.tokens_per_gpu = tokens_per_gpu(sim.frontier)

    def setup(self) -> None:
        sim, sc = self.sim, self.sim.scenario
        from ..autoscale import AutoscaleReconciler
        from ..capacity import CapacityCollector

        spec = {
            "autoscale": {
                "enabled": True,
                "targetSloAttainment": 0.9,
                "headroomPct": 20.0,
                "scaleDownDelayS": int(3 * sc.tick_s),
                "cooldownS": int(sc.tick_s),
                "windowS": int(8 * sc.tick_s),
                "minNodes": {"default": 1},
                "maxNodes": {"default": sc.fleet + 10},
            },
            "health": {"drainDeadlineS": int(6 * sc.tick_s)},
        }
        if sc.preemptible:
            spec["autoscale"]["preemptiblePools"] = [self.POOL]
        sim.feeder.create(new_cluster_policy(spec=spec))
        self.capacity = CapacityCollector(
            sim.op_client, consts.DEFAULT_NAMESPACE, now=sim.vclock.now)
        self.reconciler = AutoscaleReconciler(
            sim.op_client, chips_per_node=GPUS_PER_NODE,
            horizon_s=JOIN_DELAY_TICKS * sc.tick_s,
            now=sim.vclock.now, journal=sim.journal,
            capacity=self.capacity)
        # seeded demand: traffic-sim backlog samples modulate a rise-fall
        # envelope spanning the scenario (peak at 1/3, trough at the end).
        # The mix plays over one node in the partitioner's two-halves
        # layout, two groups of GPUS_PER_NODE // 2: the reference's two
        # 4-chip slices, so the demand's shape is the reference's
        half = GPUS_PER_NODE // 2
        tr = traffic.run_scenario(
            groups=[{"chips": list(range(i * half, (i + 1) * half)),
                     "topology": "nvlink"} for i in range(2)],
            seed=seed_for(sim.seed, "traffic"),
            duration_s=float(sc.ticks), arrival_rate_per_s=3.0,
            per_token_ms=25.0, queue_slo_s=1.0, sample_interval_s=1.0)
        series = [s.get("backlog_chips", 0.0)
                  for s in tr.get("timeseries") or [0.0]]
        peak_backlog = max(series) or 1.0
        peak_chips = (sc.fleet + 2) * GPUS_PER_NODE

        def demand_at(tick: int) -> float:
            phase = min(1.0, tick / max(1, int(sc.ticks * 2 / 3)))
            envelope = math.sin(math.pi * phase) ** 2
            jitter = series[min(tick, len(series) - 1)] / peak_backlog
            return peak_chips * envelope * (0.7 + 0.3 * jitter)

        self.demand_at = demand_at
        self.queue = 0.0
        self.attainments: List[float] = []
        self.first_seen: Dict[str, int] = {}
        self.peak_fleet = 0
        #: node-ticks served from a measured curve — the oracle reports
        #: which capacity basis actually judged the run
        self.frontier_node_ticks = 0

    def _ack_open_plans(self, tick: int) -> None:
        # the acking workloads: one drain-ack per open plan, mirrored to
        # the annotation the operator reads (N independent external
        # actors, not an operator sweep — the batcher does not apply)
        for n in self.sim._nodes():
            plan = drain_protocol.node_plan(n)
            if plan is None:
                continue
            if drain_protocol.node_acked_plan(n) == plan.fingerprint:
                continue
            # opalint: disable=unbatched-sweep-write — N independent external actors, not an operator sweep
            self.sim.feed(lambda n=n, fp=plan.fingerprint: self.sim.feeder.patch(
                "v1", "Node", n["metadata"]["name"],
                {"metadata": {"annotations": {
                    consts.DRAIN_ACK_ANNOTATION: json.dumps(
                        {"plan": fp, "step": tick})}}}), "drain-ack")

    def _healthy_frontier_value(self) -> str:
        """A freshly-joined node's measured curve: the card's, times its
        GPUs. Deterministic apart from the virtual-clock timestamp."""
        return frontier_schema.encode_annotation(
            node_curve(self.sim.frontier, self.sim.vclock.now()))

    def _stamp_frontiers(self, serving: List[str],
                         by_name: Dict[str, dict]) -> None:
        # the node agents' probe + feature-discovery mirror, compressed:
        # each serving node publishes its measured curve once on becoming
        # serving (N independent node-side actors, not an operator sweep).
        # Nodes already carrying a curve — including one degraded by the
        # frontier_drift injection — are left alone.
        for name in sorted(serving):
            node = by_name.get(name)
            if node is None or deep_get(
                    node, "metadata", "annotations",
                    consts.SERVING_FRONTIER_ANNOTATION):
                continue
            body = {"metadata": {"annotations": {
                consts.SERVING_FRONTIER_ANNOTATION:
                    self._healthy_frontier_value(),
            }}}
            # opalint: disable=unbatched-sweep-write — N independent node-side actors, not an operator sweep
            self.sim.feed(lambda n=name, b=body: self.sim.feeder.patch(
                "v1", "Node", n, b), "frontier-probe")

    def _capacity_tokens(self, serving: List[str],
                         by_name: Dict[str, dict]) -> float:
        """Fleet token capacity from each serving node's measured curve
        at the SLO ceiling; nodes without a curve serve the nominal
        rate (a drifted node really does serve less)."""
        total = 0.0
        for name in serving:
            fr = frontier_schema.decode_annotation(deep_get(
                by_name.get(name, {}), "metadata", "annotations",
                consts.SERVING_FRONTIER_ANNOTATION))
            if fr is not None and fr.points:
                total += fr.best_tokens_per_s(MAX_P99_MS)
                self.frontier_node_ticks += 1
            else:
                total += GPUS_PER_NODE * self.tokens_per_gpu
        return total

    def tick(self, tick: int) -> None:
        sim = self.sim
        nodes = sim._nodes()
        by_name = {n["metadata"]["name"]: n for n in nodes}
        for name in by_name:
            self.first_seen.setdefault(name, tick)
        self.peak_fleet = max(self.peak_fleet, len(by_name))
        serving = [n for n in by_name
                   if self.first_seen[n] == 0
                   or tick - self.first_seen[n] >= JOIN_DELAY_TICKS]
        self._stamp_frontiers(serving, by_name)
        capacity_tokens = self._capacity_tokens(serving, by_name)
        demand_tokens = self.demand_at(tick) * self.tokens_per_gpu
        outstanding = self.queue + demand_tokens
        served = min(outstanding, capacity_tokens)
        attain = served / outstanding if outstanding > 0 else 1.0
        self.queue = outstanding - served
        if tick < sim.scenario.ticks:
            self.attainments.append(attain)
        sim.feed(lambda: sim.feeder.patch(
            "tpu.ai/v1", "ClusterPolicy", "cluster-policy",
            {"metadata": {"annotations": {
                consts.TRAFFIC_SNAPSHOT_ANNOTATION: json.dumps({
                    "ts": sim.vclock.now(),
                    "queue_depth": round(
                        self.queue
                        / (GPUS_PER_NODE * self.tokens_per_gpu), 3),
                    "backlog_chips": round(
                        outstanding / self.tokens_per_gpu, 3),
                    "attainment": round(attain, 4),
                    "demand_tokens_per_s": round(outstanding, 3),
                })}}}), "traffic-snapshot")
        self._ack_open_plans(tick)
        sim._sync()
        sim._reconcile(self.reconciler, Request(name="cluster-policy"))

    def _resize_in_flight(self) -> bool:
        raw = deep_get(
            self.sim.srv.backend.get("tpu.ai/v1", "ClusterPolicy",
                                     "cluster-policy"),
            "metadata", "annotations", consts.AUTOSCALE_STATE_ANNOTATION)
        try:
            data = json.loads(raw) if raw else {}
        except ValueError:
            return False
        return any((st or {}).get("resize") for st in data.values())

    def _open_plans(self) -> bool:
        for n in self.sim._nodes():
            if drain_protocol.node_plan(n) is not None:
                return True
        return False

    def active(self) -> bool:
        return self._resize_in_flight() or self._open_plans()

    def _capacity_basis(self) -> str:
        return ("frontier-measured" if self.frontier_node_ticks
                else "gpu-constant")

    def oracles(self):
        floor = self.sim.scenario.slo_floor
        mean = (sum(self.attainments) / len(self.attainments)
                if self.attainments else 1.0)
        # the attainment series is computed against the fleet's measured
        # frontier whenever curves are present — a frontier_drift
        # injection really removes serving capacity, so the floor judges
        # whether the autoscaler re-provisioned from the measurement
        yield ("slo_floor", mean >= floor,
               f"mean attainment {mean:.4f} vs floor {floor} "
               f"({self._capacity_basis()} capacity)")

    def report(self) -> dict:
        mean = (sum(self.attainments) / len(self.attainments)
                if self.attainments else 1.0)
        return {
            "kind": "autoscale",
            "mean_attainment": round(mean, 4),
            "min_attainment": round(min(self.attainments), 4)
                if self.attainments else 1.0,
            "peak_fleet": self.peak_fleet,
            "final_fleet": len(self.sim._nodes()),
            "scale_downs": self.sim.auditor.node_deletes,
            "capacity_basis": self._capacity_basis(),
        }


class _MigrateDriver(_Driver):
    """One cooperative cross-node migration episode (src = first node,
    dst = second) through the real MigrationReconciler, with the kubelet
    sim running the node-side migrate agents and a SimulatedTrainingJob
    acking drains; the resume==ack oracle closes the loop.

    Two simulation-terminal phases beyond the controller's own done/
    failed: ``src-revoked`` (the infrastructure ate the migration source
    — there is no migration left to judge) and ``blocked-no-dst`` (the
    destination vanished and zero eligible replacements exist, so the
    controller's designed hold-for-capacity loop can never resolve in a
    fleet this small)."""

    SIM_TERMINAL = ("src-revoked", "blocked-no-dst")

    def setup(self) -> None:
        sim, sc = self.sim, self.sim.scenario
        from ..migrate import MigrationReconciler
        from ..migrate import agent as migrate_agent

        self._prior_transfer = os.environ.get(migrate_agent.TRANSFER_DIR_ENV)
        os.environ[migrate_agent.TRANSFER_DIR_ENV] = sim._workdir
        sim.feeder.create(new_cluster_policy(spec={
            "migrate": {"enabled": True,
                        "snapshotWaitS": int(3 * sc.tick_s),
                        "restoreWaitS": int(10 * sc.tick_s)},
            "health": {"drainDeadlineS": int(3 * sc.tick_s)},
        }))
        self.reconciler = MigrationReconciler(
            sim.op_client, now=sim.vclock.now, journal=sim.journal)
        self.statuses: Dict[str, StatusFiles] = {}
        # every node's GPUs on one NVLink switch: the migrate agent re-maps
        # a restored manifest over these links (where the reference's takes
        # an accelerator and a chip count)
        links = [[None if i == j else "nvlink" for j in range(GPUS_PER_NODE)]
                 for i in range(GPUS_PER_NODE)]
        for i in range(sc.fleet):
            name = f"node-{i:03d}"
            self.statuses[name] = StatusFiles(
                os.path.join(sim._workdir, name))
            sim.kubelet.attach_migrate_agent(name, self.statuses[name],
                                             links=links)
        self.src, self.dst = "node-000", "node-001"
        # the tenant holds the node's whole layout: a GPU node has no
        # named sub-slice partition
        self.job = SimulatedTrainingJob(sim.feeder, self.src,
                                        self.statuses[self.src])
        self.phases: List[str] = []
        self.state: Optional[dict] = None
        self.requested = False

    def _mirror_ack(self) -> None:
        ack = drain_protocol.read_drain_ack(self.statuses[self.src])
        value = drain_protocol.ack_annotation_value(ack)
        if value:
            self.sim.feed(lambda: self.sim.feeder.patch(
                "v1", "Node", self.src,
                {"metadata": {"annotations": {
                    consts.DRAIN_ACK_ANNOTATION: value}}}), "mirror-ack")

    def tick(self, tick: int) -> None:
        from ..migrate import migration_state

        sim = self.sim
        if not self.requested and tick >= 1:
            self.requested = sim.feed(lambda: sim.feeder.patch(
                "v1", "Node", self.src,
                {"metadata": {"annotations": {
                    consts.MIGRATE_REQUEST_ANNOTATION: json.dumps(
                        {"reason": "scenario", "dst": self.dst},
                        sort_keys=True)}}}), "migrate-request")
        sim.feed(self.job.tick, "trainjob-tick")
        self._mirror_ack()
        sim.feed(sim.kubelet.tick, "kubelet-tick")
        sim._sync()
        sim._reconcile(self.reconciler, Request(name=self.src))
        try:
            node = sim.srv.backend.get("v1", "Node", self.src)
        except NotFoundError:
            if self.requested:
                self._note_phase("src-revoked")
            return
        state = migration_state(node)
        if state:
            self.state = state
            self._note_phase(state["phase"])
            self._check_blocked(state)

    def _note_phase(self, phase: str) -> None:
        if phase in self.SIM_TERMINAL:
            self.state = dict(self.state or {}, phase=phase)
        if not self.phases or self.phases[-1] != phase:
            self.phases.append(phase)

    def _check_blocked(self, state: dict) -> None:
        """Destination gone AND no node besides src could host the
        restore: the controller's hold-for-capacity loop is correct but
        unresolvable here — call the episode simulation-terminal."""
        from ..migrate.controller import ACTIVE_PHASES

        dst = state.get("dst")
        if state.get("phase") not in ACTIVE_PHASES or not dst:
            return
        live = {n["metadata"]["name"] for n in self.sim._nodes()}
        if dst in live:
            return
        if not (live - {self.src}):
            self._note_phase("blocked-no-dst")

    def active(self) -> bool:
        if not self.requested:
            return False
        phase = (self.state or {}).get("phase")
        return phase not in ("done", "failed") + self.SIM_TERMINAL

    def oracles(self):
        phase = (self.state or {}).get("phase")
        if not self.requested:
            # the request itself never landed (source revoked before the
            # episode could start): nothing to judge
            yield ("migration_terminal", True,
                   "no migration episode (request never landed)")
            return
        yield ("migration_terminal",
               phase in ("done", "failed") + self.SIM_TERMINAL,
               f"terminal phase {phase!r}")
        if phase == "done":
            resumer = SimulatedTrainingJob(self.sim.feeder, self.dst,
                                          self.statuses[self.dst])
            resume_step = resumer.resume()
            ack = drain_protocol.read_drain_ack(self.statuses[self.src]) or {}
            self._resume_step, self._ack_step = resume_step, ack.get("step")
            yield ("resume_equals_ack",
                   resume_step is not None
                   and resume_step == ack.get("step"),
                   f"resume step {resume_step} vs acked step "
                   f"{ack.get('step')}")

    def report(self) -> dict:
        return {
            "kind": "migrate",
            "phase": (self.state or {}).get("phase"),
            "phases": self.phases,
            "resume_step": getattr(self, "_resume_step", None),
            "ack_step": getattr(self, "_ack_step", None),
        }

    def teardown(self) -> None:
        from ..migrate import agent as migrate_agent

        if self._prior_transfer is None:
            os.environ.pop(migrate_agent.TRANSFER_DIR_ENV, None)
        else:
            os.environ[migrate_agent.TRANSFER_DIR_ENV] = self._prior_transfer


class _UpgradeDriver(_Driver):
    """Rolling driver upgrade through the real ClusterPolicy + Upgrade
    reconcilers with a pod-creating kubelet: install at 1.0, bump to 2.0
    once ready, then the upgrade machine orders the rollout (cordon ->
    wait-for-jobs -> pod restart -> validate -> uncordon) while
    injections land on it.

    Every seeded node carries one GPU-consumer job pod matched by
    ``waitForCompletion.podSelector`` — the job "finishes" (Succeeded)
    a fixed number of ticks after its node is cordoned, so the upgrade
    drain window (wait-for-jobs/pod-deletion) stays OPEN across tick
    boundaries where ``upgrade.draining``-conditioned injections can
    observe and strike it. timeoutSeconds=0 (wait forever) keeps the
    escalation path off the nondeterministic wall clock."""

    TARGET = "2.0"
    JOB_SELECTOR = "app=gpu-job"
    #: ticks a job keeps running after its node is cordoned
    JOB_FINISH_TICKS = 2

    def setup(self) -> None:
        sim = self.sim
        from ..controllers.clusterpolicy_controller import (
            ClusterPolicyReconciler,
        )
        from ..controllers.upgrade_controller import UpgradeReconciler

        # one-at-a-time on small fleets keeps the drain window wide open
        # (the revocation-during-drain scenarios depend on it); larger
        # fleets roll in parallel the way a real operator would, or a
        # serialized roll at ~6 ticks/node outruns any scenario budget
        self.parallel = max(1, sim.scenario.fleet // 3)
        sim.feeder.create(new_cluster_policy(spec={
            "driver": {"repository": REGISTRY, "image": "gpu-validator",
                       "version": "1.0",
                       "upgradePolicy": {
                           "autoUpgrade": True,
                           "maxParallelUpgrades": self.parallel,
                           "waitForCompletion": {
                               "podSelector": self.JOB_SELECTOR,
                               "timeoutSeconds": 0}}},
        }))
        key, _, value = self.JOB_SELECTOR.partition("=")
        for n in sorted(n["metadata"]["name"] for n in sim._nodes()):
            sim.feeder.create({
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": f"gpu-consumer-{n}",
                             "namespace": consts.DEFAULT_NAMESPACE,
                             "labels": {key: value}},
                "spec": {"nodeName": n, "containers": [{
                    "name": "train", "image": f"{REGISTRY}/train:1",
                    "resources": {"requests": {
                        consts.GPU_RESOURCE_NAME: str(GPUS_PER_NODE)}}}]},
                "status": {"phase": "Running"}})
        self.cp = ClusterPolicyReconciler(sim.op_client, requeue_after=0.01,
                                          journal=sim.journal)
        self.up = UpgradeReconciler(sim.op_client, requeue_after=0.01,
                                    journal=sim.journal)
        self.bumped_at: Optional[int] = None
        self.cordoned_at: Dict[str, int] = {}

    def _finish_done_jobs(self, tick: int) -> None:
        """The workload side of wait-for-jobs: a job on a cordoned node
        wraps up JOB_FINISH_TICKS later (checkpoint + exit), releasing
        the upgrade machine to the pod-deletion step."""
        backend = self.sim.srv.backend
        for n in self.sim._nodes():
            name = n["metadata"]["name"]
            if deep_get(n, "spec", "unschedulable", default=False):
                self.cordoned_at.setdefault(name, tick)
            started = self.cordoned_at.get(name)
            if started is None or tick - started < self.JOB_FINISH_TICKS:
                continue
            try:
                pod = backend.get("v1", "Pod", f"gpu-consumer-{name}",
                                  consts.DEFAULT_NAMESPACE)
            except NotFoundError:
                continue
            if deep_get(pod, "status", "phase") == "Running":
                pod = dict(pod, status={"phase": "Succeeded"})
                # feeder-side external-actor write (the job's OWN status
                # transition), not an operator sweep — the batcher does not
                # apply here  # opalint: disable=unbatched-sweep-write
                self.sim.feed(lambda p=pod: self.sim.feeder.update_status(p),
                              "job-finish")

    def _policy_ready(self) -> bool:
        return deep_get(
            self.sim.srv.backend.get("tpu.ai/v1", "ClusterPolicy",
                                     "cluster-policy"),
            "status", "state") == "ready"

    def _driver_pod_images(self) -> Dict[str, str]:
        return {deep_get(p, "spec", "nodeName"):
                p["spec"]["containers"][0]["image"]
                for p in self.sim.srv.backend.list(
                    "v1", "Pod", consts.DEFAULT_NAMESPACE,
                    label_selector={
                        "app.kubernetes.io/component": DRIVER_COMPONENT})}

    def tick(self, tick: int) -> None:
        sim = self.sim
        self._finish_done_jobs(tick)
        sim.feed(sim.kubelet.tick, "kubelet-tick")
        sim._sync()
        sim._reconcile(self.cp, Request(name="cluster-policy"))
        sim._reconcile(self.up, Request(name="driver-upgrade"))
        # the version bump that starts the rollout: first tick the
        # initial install reports ready (guarded so injections that
        # delay readiness just delay the bump)
        if self.bumped_at is None and tick >= 2 and self._policy_ready():
            if sim.feed(lambda: sim.feeder.patch(
                    "tpu.ai/v1", "ClusterPolicy", "cluster-policy",
                    {"spec": {"driver": {"version": self.TARGET}}}),
                    "version-bump"):
                self.bumped_at = tick
                sim._sync()

    def _rolled(self) -> bool:
        images = self._driver_pod_images()
        want = f"{REGISTRY}/gpu-validator:{self.TARGET}"
        live = {n["metadata"]["name"] for n in self.sim._nodes()}
        if not live:
            return False
        return all(images.get(n) == want for n in live) and bool(images)

    def _in_progress(self) -> List[str]:
        return sorted(n["metadata"]["name"] for n in self.sim._nodes()
                      if node_upgrade_state(n) in IN_PROGRESS_STATES)

    def active(self) -> bool:
        if self.bumped_at is None:
            return True  # never even got to the bump: keep settling
        return (not self._rolled() or bool(self._in_progress())
                or not self._policy_ready())

    def settle_hint(self) -> int:
        # the roll is serialized into fleet/parallel waves, each holding
        # its drain window open for JOB_FINISH_TICKS plus the machine's
        # cordon/observe/delete/uncordon steps (~4 ticks)
        waves = -(-self.sim.scenario.fleet // self.parallel)
        return waves * (self.JOB_FINISH_TICKS + 4) + 8

    def oracles(self):
        yield ("upgrade_rolled", self.bumped_at is not None
               and self._rolled(),
               f"bumped_at={self.bumped_at} "
               f"images={sorted(set(self._driver_pod_images().values()))}")
        stuck = self._in_progress()
        yield ("no_stuck_upgrade", not stuck,
               f"nodes stuck in-progress: {stuck}" if stuck
               else "all upgrade states cleared")

    def report(self) -> dict:
        return {
            "kind": "upgrade",
            "bumped_at_tick": self.bumped_at,
            "images": sorted(set(self._driver_pod_images().values())),
            "in_progress": self._in_progress(),
            "fleet": len(self.sim._nodes()),
        }


_DRIVERS: Dict[str, Callable[[FleetSimulator], _Driver]] = {
    "autoscale": _AutoscaleDriver,
    "migrate": _MigrateDriver,
    "upgrade": _UpgradeDriver,
}


def run_scenario_obj(scenario: Scenario, seed: Optional[int] = None,
                     workdir: Optional[str] = None) -> dict:
    """One-call convenience: build the simulator, run, return the report."""
    return FleetSimulator(scenario, seed=seed, workdir=workdir).run()
