"""Split brain on both packages: the twin of tests/test_split_brain.py's two
tests (``test_split_brain_old_leader_fully_fenced`` and
``test_lease_partition_blocks_only_coordination_api``).

Two live replicas of one package's operator, each wired as the operator's
composition root wires it (``CachedClient → WriteBatcher → RetryingClient →
FencedClient → RestClient``, the elector on its own direct client, the fence
bound to the elector), share one MiniApiServer, one node and its agents. The
controllers start off the elector's thread in both cases: the port's elector
does that itself, and the harness does it for the reference's, whose inline
start let a loaded host starve the renew deadline at install.
Replica A leads, then loses the coordination API only (an asymmetric
partition). A must depose itself before the lease can expire for B; B's
takeover bumps the leader epoch exactly once; every write A attempts after
it is fenced, none lands, and the fenced-writes family agrees with the
client; B drives a whole degrade → drain → re-tile → remediate → recover
episode with A still alive. Each package runs as its own case, the
reference's with its own modules and the port's with its (the node, the
agents and the job as the crash-soak twins map them). Under the race
sanitizer (``GPU_OPERATOR_OPSAN=1``, the port's case in the race-soak lane)
the lease is widened from 2 s to 6 s, as the reference's test widens it under
its own switch: the contract is the partition's deposition, not the renew
loop's liveness under a perturbed schedule.
"""

import os
import threading
import time
import types

import pytest

from test_torch_crash_soak import HEALTH_PORT, HEALTH_REF, barrier
from test_torch_migrate import CRASH_PORT, CRASH_REF, CRASH_LABELS, operand_images  # noqa: F401
from test_torch_operator_mapping import map_node
from tpu_operator.client import FakeClient as RefFake
from tpu_operator.client import fenced as ref_fenced
from tpu_operator.client import resilience as ref_resilience
from tpu_operator.client.errors import FencedError as RefFencedError
from tpu_operator.controllers.leader import LeaderElector as RefElector
from tpu_operator_torch import consts
from tpu_operator_torch.client import fenced, resilience
from tpu_operator_torch.client.errors import FencedError
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.controllers.leader import LeaderElector

NAMESPACE = "tpu-operator"
NODE = "node-a"
#: each wait's own bound
WAIT_S = 60.0

SPLIT_REF = types.SimpleNamespace(
    name="reference", crash=CRASH_REF, health=HEALTH_REF, Fenced=ref_fenced.FencedClient,
    Retrying=ref_resilience.RetryingClient, TokenBucket=ref_resilience.TokenBucket,
    Breaker=ref_resilience.CircuitBreaker, Elector=RefElector, FencedError=RefFencedError,
    Fake=RefFake, switch="TPU_OPERATOR_OPSAN")
SPLIT_PORT = types.SimpleNamespace(
    name="port", crash=CRASH_PORT, health=HEALTH_PORT, Fenced=fenced.FencedClient,
    Retrying=resilience.RetryingClient, TokenBucket=resilience.TokenBucket,
    Breaker=resilience.CircuitBreaker, Elector=LeaderElector, FencedError=FencedError,
    Fake=FakeClient, switch="GPU_OPERATOR_OPSAN")


class LeasePartitionedClient:
    """An asymmetric partition around the elector's direct client: once
    :attr:`partitioned` is set, coordination-API calls fail with
    ``ConnectionError`` while everything else still reaches the apiserver."""

    def __init__(self, inner):
        self.inner = inner
        self.partitioned = threading.Event()

    def _gate(self, kind):
        if self.partitioned.is_set() and kind == "Lease":
            raise ConnectionError("asymmetric partition: coordination API unreachable")

    def get(self, api_version, kind, name, namespace=None):
        self._gate(kind)
        return self.inner.get(api_version, kind, name, namespace)

    def create(self, obj):
        self._gate(obj.get("kind"))
        return self.inner.create(obj)

    def update(self, obj):
        self._gate(obj.get("kind"))
        return self.inner.update(obj)


class Replica:
    """One operator replica, its controllers started and stopped by its
    elector."""

    def __init__(self, s, base, ident):
        self.s = s
        c = s.crash
        self.direct = LeasePartitionedClient(c.Rest(base_url=base))
        self.fenced = s.Fenced(c.Rest(base_url=base))
        self.client = c.Cached(c.Batcher(s.Retrying(
            self.fenced, limiter=s.TokenBucket(qps=200.0, burst=400),
            breaker=s.Breaker(threshold=5))))
        self.app = c.App(self.client)
        # a 2 s lease gives a 0.5 s renew deadline; under the sanitizer's
        # schedule perturber the renew loop can be starved past it by
        # scheduling noise alone
        lease = 6.0 if os.environ.get(s.switch) == "1" else 2.0
        self.elector = s.Elector(self.direct, NAMESPACE, identity=ident, lease_duration=lease,
                                 renew_period=0.1, retry_period=0.05)
        self.app.elector = self.elector
        self.fenced.bind(self.elector)
        self.acquired_at = None
        self.deposed_at = None

    def start(self):
        def on_started():
            self.acquired_at = time.monotonic()
            if self.s.name == "reference":
                # the reference's elector runs on_started inline, so a slow
                # controller start (a loaded host) starves its 0.5 s renew
                # deadline and leadership churns at install; the port's
                # elector runs it on its own thread and keeps renewing
                # (controllers/leader.py:_start). The harness gives the
                # reference's start the port's thread, so both cases meet
                # the partition with a steady leader
                threading.Thread(target=self.app.start_controllers, daemon=True,
                                 name="reference-start").start()
            else:
                self.app.start_controllers()

        def on_stopped():
            # the deposed app stays alive: the window between lost
            # leadership and a restart is what the fence is for
            self.deposed_at = time.monotonic()

        self.elector.run(on_started=on_started, on_stopped=on_stopped)

    def stop(self):
        self.elector.release()
        self.app.stop()
        self.client.stop()

    def metric_fenced_total(self):
        """``tpu_operator_fenced_writes_total`` summed over verbs, from the
        replica's own ``/metrics`` text."""
        total = 0.0
        for line in self.app.metrics.scrape().decode().splitlines():
            if line.startswith("tpu_operator_fenced_writes_total"):
                total += float(line.rsplit(" ", 1)[1])
        return int(total)


class SplitBrainHarness:
    """One MiniApiServer, one node with its agents and kubelet, two replicas."""

    def __init__(self, s, tmp_path, monkeypatch):
        self.s = s
        h = s.health
        devdir = tmp_path / "dev"
        devdir.mkdir(parents=True)
        for i in range(8):
            (devdir / f"{h.dev}{i}").write_text("")
        monkeypatch.setenv(h.dev_env, str(devdir / f"{h.dev}*"))
        self.config = tmp_path / "partitions.cfg"
        self.config.write_text(h.partitions)
        self.srv = s.crash.Server()
        base = self.srv.start()
        self.admin = s.crash.Rest(base_url=base)
        self.kubelet = s.crash.kubelet(self.admin).start()
        self.status = s.crash.Status(str(tmp_path / "node" / "status"))
        monkeypatch.setenv("STATUS_DIR", self.status.directory)
        self.status.write("workload", barrier(True))
        self.handoff = str(tmp_path / "node" / "handoff")
        node = {"apiVersion": "v1", "kind": "Node",
                "metadata": {"name": NODE, "labels": dict(CRASH_LABELS)}, "status": {}}
        self.admin.create(map_node(node) if s.crash.port else node)
        self.a = Replica(s, base, "replica-a")
        self.b = Replica(s, base, "replica-b")

    def wait(self, predicate, timeout=WAIT_S, message="condition"):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if predicate():
                    return
            except self.s.crash.errors:
                pass
            time.sleep(0.02)
        raise AssertionError(f"timed out ({timeout} s) waiting for {message}")

    def agent_pass(self):
        h = self.s.health
        h.labels(self.admin, NODE, self.status.directory)
        h.sync(self.admin, NODE, str(self.config), self.handoff, self.status.directory)

    def node(self):
        return self.admin.get("v1", "Node", NODE)

    def annotations(self):
        return self.node()["metadata"].get("annotations") or {}

    def health(self):
        return self.s.health.health_state(self.node())

    def slice_state(self):
        return (self.node()["metadata"].get("labels") or {}).get(consts.TPU_SLICE_STATE_LABEL)

    def install(self):
        """The cluster to a healthy steady state under A's leadership."""
        self.admin.create(self.s.crash.new_policy())
        self.a.start()
        assert self.a.elector.is_leader.wait(timeout=10), "replica A never acquired leadership"
        self.b.start()  # stands by while A renews
        self.wait(lambda: (self.admin.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
                           .get("status") or {}).get("state") == "ready",
                  message="the install ready")
        self.admin.patch("v1", "Node", NODE, {"metadata": {"labels": {
            consts.TPU_SLICE_CONFIG_LABEL: "single-chip"}}})
        self.agent_pass()
        assert self.slice_state() == "success"
        self.wait(lambda: self.health() == "", message="healthy in steady state")

    def drain_episode(self):
        """Degrade, drain, re-tile, remediate, recover, reconciled by the
        replica that leads."""
        drain = self.s.crash.drain
        job = self.s.crash.Job(self.admin, NODE, self.status)
        for _ in range(5):
            job.tick()
        self.status.write("workload", barrier(False, failed=[2]))
        self.agent_pass()
        self.wait(lambda: drain.node_plan(self.node()) is not None,
                  message="the drain plan published")
        job.tick()  # sees the plan, checkpoints, stamps the ack
        ack_step = job.step
        self.agent_pass()
        self.wait(lambda: self.slice_state() == "retiled", message="the incremental re-tile")
        self.wait(lambda: self.health() == self.s.health.remediating,
                  message="the ack released remediation")
        job.crash()
        assert job.resume() == ack_step, "the resume must land on the ack"
        healthy = barrier(True)
        healthy["drain_ack"] = drain.read_drain_ack(self.status)
        self.status.write("workload", healthy)
        self.agent_pass()
        self.wait(lambda: self.health() == "", message="healthy again")
        drain.maybe_ack_plan(self.admin, NODE, self.status)
        self.agent_pass()
        self.wait(lambda: not (set(self.annotations()) & {
            consts.RETILE_PLAN_ANNOTATION, consts.DRAIN_ACK_ANNOTATION,
            consts.HEALTH_ATTEMPTS_ANNOTATION}), message="the episode's keys retired")
        self.agent_pass()
        self.wait(lambda: self.slice_state() == "success", message="the layout restored")

    def teardown(self):
        self.a.stop()
        self.b.stop()
        self.kubelet.stop()
        self.srv.stop()


@pytest.mark.parametrize("s", [SPLIT_REF, SPLIT_PORT], ids=["reference", "port"])
def test_split_brain_old_leader_fully_fenced(s, tmp_path, monkeypatch, operand_images):
    h = SplitBrainHarness(s, tmp_path, monkeypatch)
    try:
        h.install()
        epoch_a = h.a.elector.current_epoch()
        assert epoch_a == 1, "the first acquisition mints epoch 1"
        assert h.a.fenced.fenced_total == 0, "nothing is fenced while A leads uncontested"
        assert h.a.fenced.dispatched_total > 0, "the install dispatched writes under A's epoch"
        assert h.a.fenced.last_dispatched_epoch == epoch_a

        # -- the partition: A loses the coordination API, nothing else --------
        h.a.direct.partitioned.set()
        h.wait(lambda: not h.a.elector.is_leader.is_set(), timeout=10,
               message="A to depose itself at its renew deadline")
        assert h.a.deposed_at is not None
        # no overlap: A stands down strictly before the lease can expire for B
        assert not h.b.elector.is_leader.is_set(), "B took over before A's renew deadline"
        assert h.b.elector.is_leader.wait(timeout=10), "B never took over the expired lease"
        assert h.b.acquired_at > h.a.deposed_at
        assert h.b.elector.current_epoch() == epoch_a + 1, "the takeover bumps the epoch once"

        # -- A's fence: every post-depose write refused, none landed ------------
        dispatched_frozen = h.a.fenced.dispatched_total
        fenced_before = h.a.fenced.fenced_total
        stale_policy = h.a.client.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        battery = [
            lambda: h.a.client.patch("v1", "Node", NODE, {"metadata": {"labels": {
                "tpu.ai/stale-write": "1"}}}),
            lambda: h.a.client.create(
                {"apiVersion": "v1", "kind": "Event",
                 "metadata": {"name": "stale-event", "namespace": NAMESPACE},
                 "involvedObject": {"kind": "Node", "name": NODE},
                 "reason": "StaleWrite", "message": "from the old leader"}),
            lambda: h.a.client.update(stale_policy),
            lambda: h.a.client.update_status(stale_policy),
            lambda: h.a.client.delete("v1", "Pod", "some-pod", NAMESPACE),
            lambda: h.a.client.evict("some-pod", NAMESPACE),
        ]
        for attempt in battery:
            with pytest.raises(s.FencedError):
                attempt()
        # reads stay open: the deposed replica keeps its caches warm
        assert h.a.client.get("v1", "Node", NODE)

        # -- B drives a whole drain and re-tile episode, A still alive ----------
        h.drain_episode()

        # -- the count: every attempt refused, no write landed -----------------
        h.a.app.stop()  # A's workers quiet, then read the counters
        assert h.a.fenced.dispatched_total == dispatched_frozen, "a deposed replica landed a write"
        rejected = h.a.fenced.fenced_total - fenced_before
        assert rejected >= len(battery), f"only {rejected} of >= {len(battery)} fenced"
        assert h.a.metric_fenced_total() == h.a.fenced.fenced_total, \
            "tpu_operator_fenced_writes_total disagrees with the client"
        assert h.a.fenced.last_dispatched_epoch == epoch_a
        assert "tpu.ai/stale-write" not in (h.node()["metadata"].get("labels") or {})
        assert h.b.elector.is_leader.is_set()
        assert h.b.elector.current_epoch() == epoch_a + 1
        assert h.b.fenced.fenced_total == 0, "the live leader never fences its own writes"
    finally:
        h.teardown()


@pytest.mark.parametrize("s", [SPLIT_REF, SPLIT_PORT], ids=["reference", "port"])
def test_lease_partition_blocks_only_coordination_api(s):
    """The harness's partition is asymmetric by construction: Lease calls
    fail, everything else passes through (the reference's over its fake
    client, the port's over its own)."""
    fake = s.Fake()
    wrapped = LeasePartitionedClient(fake)
    fake.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n1"}})
    wrapped.partitioned.set()
    with pytest.raises(ConnectionError):
        wrapped.get("coordination.k8s.io/v1", "Lease", "x", NAMESPACE)
    with pytest.raises(ConnectionError):
        wrapped.update({"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                        "metadata": {"name": "x", "namespace": NAMESPACE}})
    assert wrapped.get("v1", "Node", "n1")["metadata"]["name"] == "n1"
