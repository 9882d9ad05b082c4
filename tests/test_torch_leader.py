"""The port's leader election (``controllers/leader.py``) and write fence
(``client/fenced.py``) twin for twin with the reference's tests/test_leader.py
and tests/test_fencing.py.

Each scenario runs on the reference's elector and fence over its fake
apiserver and on the port's over the port's, with short lease and retry
durations given to the constructors, and returns what it observed; the
observations must be equal. Every wait has its own timeout.

One difference is deliberate (ROADMAP Queue 3): the port's
``current_epoch()`` answers None once the hold window since the last
renewal has passed, so a replica resumed after a pause past its lease is
fenced before its elector thread has run; the reference's keeps admitting
its writes until then (``test_a_paused_leader_is_fenced_before_its_elector_runs``).
"""

import threading
import time
import types

import pytest

from tpu_operator import consts as ref_consts
from tpu_operator.client import fenced as ref_fenced
from tpu_operator.client import resilience as ref_resilience
from tpu_operator.client.cache import CachedClient as RefCached
from tpu_operator.client.errors import FencedError as RefFencedError
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.controllers import leader as ref_leader
from tpu_operator.controllers import runtime as ref_runtime
from tpu_operator_torch import consts
from tpu_operator_torch.client import fenced, resilience
from tpu_operator_torch.client.cache import CachedClient
from tpu_operator_torch.client.errors import FencedError
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.controllers import leader, runtime
from tpu_operator_torch.controllers.metrics import OperatorMetrics

REF = types.SimpleNamespace(leader=ref_leader, fenced=ref_fenced, r=ref_resilience,
                            Fake=RefFake, Cached=RefCached, FencedError=RefFencedError,
                            rt=ref_runtime, consts=ref_consts)
PORT = types.SimpleNamespace(leader=leader, fenced=fenced, r=resilience, Fake=FakeClient,
                             Cached=CachedClient, FencedError=FencedError, rt=runtime,
                             consts=consts)
NS = "tpu-operator"


def both(scenario):
    want = scenario(REF)
    got = scenario(PORT)
    assert got == want
    return got


def elector(m, client, ident, **kw):
    defaults = dict(lease_duration=2.0, renew_period=0.1, retry_period=0.05)
    defaults.update(kw)
    return m.leader.LeaderElector(client, NS, identity=ident, **defaults)


def _lease(m, client):
    return client.get("coordination.k8s.io/v1", "Lease", m.leader.LEASE_NAME, NS)


def _wait(predicate, timeout):
    deadline = time.monotonic() + timeout
    while not predicate() and time.monotonic() < deadline:
        time.sleep(0.02)
    return predicate()


# -- the elector (tests/test_leader.py) ------------------------------------------------

def test_the_lease_is_named_after_the_operator():
    assert leader.LEASE_NAME == "gpu-operator-leader"
    assert ref_leader.LEASE_NAME == "tpu-operator-leader"


def test_single_elector_acquires():
    def scenario(m):
        client = m.Fake()
        e = elector(m, client, "a")
        first = e.try_acquire_or_renew()
        holder = _lease(m, client)["spec"]["holderIdentity"]
        return first, holder, e.try_acquire_or_renew()

    assert both(scenario) == (True, "a", True)


def test_second_elector_blocked_while_lease_live():
    def scenario(m):
        client = m.Fake()
        a, b = elector(m, client, "a"), elector(m, client, "b")
        return a.try_acquire_or_renew(), b.try_acquire_or_renew()

    assert both(scenario) == (True, False)


def test_takeover_after_expiry():
    def scenario(m):
        client = m.Fake()
        a, b = elector(m, client, "a"), elector(m, client, "b")
        first = a.try_acquire_or_renew()
        time.sleep(2.2)  # a stops renewing; its lease expires
        second = b.try_acquire_or_renew()
        spec = _lease(m, client)["spec"]
        return first, second, spec["holderIdentity"], spec["leaseTransitions"]

    assert both(scenario) == (True, True, "b", 1)


def test_run_loop_and_voluntary_release():
    def scenario(m):
        client = m.Fake()
        events = []
        a = elector(m, client, "a")
        a.run(on_started=lambda: events.append("a-start"),
              on_stopped=lambda: events.append("a-stop"))
        seen = [a.is_leader.wait(timeout=2), list(events)]
        b = elector(m, client, "b")
        b.run(on_started=lambda: events.append("b-start"),
              on_stopped=lambda: events.append("b-stop"))
        time.sleep(0.2)
        seen.append(b.is_leader.is_set())
        a.release()
        seen.append(b.is_leader.wait(timeout=3))
        seen.append("b-start" in events)
        b.release()
        return seen

    assert both(scenario) == [True, ["a-start"], False, True, True]


def test_elector_survives_apiserver_outage_within_lease():
    def scenario(m):
        client = m.Fake()
        outage = {"on": False}
        real_get, real_update = client.get, client.update

        def flaky(real):
            def call(*a, **kw):
                if outage["on"]:
                    raise ConnectionError("apiserver down")
                return real(*a, **kw)
            return call

        client.get, client.update = flaky(real_get), flaky(real_update)
        transitions = {"started": 0, "stopped": 0}
        e = elector(m, client, "a", lease_duration=4.0)  # renew deadline 2.5 s
        e.run(on_started=lambda: transitions.__setitem__("started", transitions["started"] + 1),
              on_stopped=lambda: transitions.__setitem__("stopped", transitions["stopped"] + 1))
        seen = []
        try:
            seen.append(_wait(e.is_leader.is_set, 5))
            outage["on"] = True
            time.sleep(0.5)
            seen += [e.is_leader.is_set(), transitions["stopped"]]
            outage["on"] = False
            time.sleep(0.3)
            seen.append(e.is_leader.is_set())
            outage["on"] = True
            seen.append(_wait(lambda: not e.is_leader.is_set(), 6))
            seen.append(transitions["stopped"])
            seen.append(any(t.name == "leader-elector" and t.is_alive()
                            for t in threading.enumerate()))
            outage["on"] = False
            seen.append(_wait(e.is_leader.is_set, 5))
            seen.append(transitions["started"])
        finally:
            e.release()
        return seen

    assert both(scenario) == [True, True, 0, True, True, 1, True, True, 2]


def test_unsatisfiable_retry_period_rejected():
    def scenario(m):
        client = m.Fake()
        try:
            elector(m, client, "a", lease_duration=2.0, retry_period=1.9)
            refused = False
        except ValueError:
            refused = True
        e = elector(m, client, "a", lease_duration=15.0, retry_period=2.0)
        return refused, e.renew_deadline

    refused, deadline = both(scenario)
    assert refused and 2.0 <= deadline < 15.0


def test_the_production_defaults_are_15_5_and_2_seconds():
    for m in (REF, PORT):
        e = m.leader.LeaderElector(m.Fake(), NS, identity="a")
        assert (e.lease_duration, e.renew_period, e.retry_period) == (15.0, 5.0, 2.0)


# -- the epoch (tests/test_fencing.py) -------------------------------------------------

def test_lease_epoch_parses_annotation():
    def scenario(m):
        key = m.consts.LEADER_EPOCH_ANNOTATION
        return [m.leader.lease_epoch(x) for x in (
            {}, {"metadata": {"annotations": {key: "7"}}},
            {"metadata": {"annotations": {key: "junk"}}})]

    assert both(scenario) == [0, 7, 0]
    assert consts.LEADER_EPOCH_ANNOTATION == ref_consts.LEADER_EPOCH_ANNOTATION


def test_first_acquisition_mints_epoch_one():
    def scenario(m):
        client = m.Fake()
        e = elector(m, client, "a")
        e.try_acquire_or_renew()
        seen = [m.leader.lease_epoch(_lease(m, client)), e.epoch, e.current_epoch()]
        e.is_leader.set()
        return seen + [e.current_epoch()]

    assert both(scenario) == [1, 1, None, 1]


def test_renewals_never_bump_the_epoch():
    def scenario(m):
        client = m.Fake()
        e = elector(m, client, "a")
        for _ in range(4):
            e.try_acquire_or_renew()
        return m.leader.lease_epoch(_lease(m, client))

    assert both(scenario) == 1


def test_takeover_bumps_epoch_exactly_once():
    def scenario(m):
        client = m.Fake()
        a = elector(m, client, "a")
        a.try_acquire_or_renew()
        lease = _lease(m, client)
        lease["spec"]["renewTime"] = "1970-01-01T00:00:00.000000Z"
        client.update(lease)
        b = elector(m, client, "b")
        b.try_acquire_or_renew()
        lease = _lease(m, client)
        return lease["spec"]["holderIdentity"], m.leader.lease_epoch(lease), b.epoch

    assert both(scenario) == ("b", 2, 2)


def test_a_paused_leader_is_fenced_before_its_elector_runs():
    """The deliberate difference: a leader whose last renewal is older than
    its renew deadline (a process stopped past its lease) is not the leader
    for the fence, even while ``is_leader`` is still set."""
    views = {}
    for name, m in (("ref", REF), ("port", PORT)):
        e = elector(m, m.Fake(), "a", lease_duration=2.0)
        e.try_acquire_or_renew()
        e.is_leader.set()
        fresh = e.current_epoch()
        time.sleep(e.renew_deadline + 0.1)  # the pause; the elector never ran
        views[name] = (fresh, e.current_epoch())
    assert views == {"ref": (1, 1), "port": (1, None)}


# -- the fence ---------------------------------------------------------------------------

class Fence:
    """The elector's live view, stubbed: current_epoch() -> Optional[int]."""

    def __init__(self, epoch=None):
        self.epoch = epoch

    def current_epoch(self):
        return self.epoch


def _node(name="n1"):
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": {}}}


def test_unbound_fence_is_a_passthrough():
    def scenario(m):
        inner = m.Fake()
        client = m.fenced.FencedClient(inner)
        client.create(_node())
        client.patch("v1", "Node", "n1", {"metadata": {"labels": {"x": "1"}}})
        return (inner.get("v1", "Node", "n1")["metadata"]["labels"], client.fenced_total,
                client.last_dispatched_epoch)

    assert both(scenario) == ({"x": "1"}, 0, None)


def test_leader_writes_dispatch_with_epoch_stamped():
    def scenario(m):
        client = m.fenced.FencedClient(m.Fake())
        client.bind(Fence(epoch=3))
        client.create(_node())
        client.patch("v1", "Node", "n1", {"metadata": {"labels": {"x": "1"}}})
        return client.dispatched_total, client.last_dispatched_epoch, client.fenced_total

    assert both(scenario) == (2, 3, 0)


def test_deposed_replica_every_mutating_verb_fenced():
    def scenario(m):
        inner = m.Fake()
        inner.create(_node())
        before = inner.get("v1", "Node", "n1")
        rejected = []
        client = m.fenced.FencedClient(inner, fence=Fence(epoch=None), on_fenced=rejected.append)
        attempts = [
            lambda: client.create(_node("n2")),
            lambda: client.update(dict(before)),
            lambda: client.patch("v1", "Node", "n1", {"metadata": {"labels": {"x": "1"}}}),
            lambda: client.delete("v1", "Node", "n1"),
            lambda: client.update_status(dict(before)),
        ]
        outcomes = []
        for attempt in attempts:
            try:
                attempt()
                outcomes.append("landed")
            except m.FencedError as e:
                outcomes.append(e.code)
        return (outcomes, rejected, client.fenced_total, dict(client.fenced_by_verb),
                inner.get("v1", "Node", "n1") == before, len(inner.list("v1", "Node")))

    outcomes, rejected, total, by_verb, unchanged, nodes = both(scenario)
    assert outcomes == [403] * 5 and rejected == ["POST", "PUT", "PATCH", "DELETE", "PUT"]
    assert total == 5 and by_verb == {"POST": 1, "PUT": 2, "PATCH": 1, "DELETE": 1}
    assert unchanged and nodes == 1


def test_lease_traffic_bypasses_the_fence():
    def scenario(m):
        inner = m.Fake()
        client = m.fenced.FencedClient(inner, fence=Fence(epoch=None))
        client.create({"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                       "metadata": {"name": "l1", "namespace": "ns"},
                       "spec": {"holderIdentity": "a"}})
        created = client.get("coordination.k8s.io/v1", "Lease", "l1", "ns")
        created["spec"]["holderIdentity"] = "b"
        client.update(created)
        return (inner.get("coordination.k8s.io/v1", "Lease", "l1", "ns")["spec"]["holderIdentity"],
                client.fenced_total)

    assert both(scenario) == ("b", 0)


def test_reads_pass_through_when_deposed():
    def scenario(m):
        inner = m.Fake()
        inner.create(_node())
        client = m.fenced.FencedClient(inner, fence=Fence(epoch=None))
        return (client.get("v1", "Node", "n1")["metadata"]["name"],
                [n["metadata"]["name"] for n in client.list("v1", "Node")])

    assert both(scenario) == ("n1", ["n1"])


def test_fenced_error_not_retried_and_never_charges_breaker():
    def scenario(m):
        calls = {"n": 0}

        class CountingFake(m.Fake):
            def patch(self, *a, **kw):
                calls["n"] += 1
                return super().patch(*a, **kw)

        breaker = m.r.CircuitBreaker(threshold=2)
        client = m.r.RetryingClient(m.fenced.FencedClient(CountingFake(), fence=Fence(None)),
                                    breaker=breaker)
        refused = 0
        for _ in range(5):
            try:
                client.patch("v1", "Node", "n1", {"metadata": {"labels": {"x": "1"}}})
            except m.FencedError:
                refused += 1
        return refused, calls["n"], breaker.snapshot()["state"]

    assert both(scenario) == (5, 0, "closed")


def test_find_fenced_walks_the_production_chain():
    def scenario(m):
        f = m.fenced.FencedClient(m.Fake())
        chain = m.Cached(m.r.RetryingClient(f))
        try:
            found = m.fenced.find_fenced(chain) is f
        finally:
            chain.stop()
        return found, m.fenced.find_fenced(m.Fake()), m.fenced.find_fenced(None)

    assert both(scenario) == (True, None, None)


def test_runtime_requeues_fenced_error_without_error_count():
    def scenario(m):
        calls = []
        done = threading.Event()

        class Deposed(m.rt.Reconciler):
            name = "deposed"

            def reconcile(self, request):
                calls.append(time.monotonic())
                if len(calls) == 1:
                    raise m.FencedError("not the leader", epoch=1)
                done.set()
                return m.rt.Result()

        controller = m.rt.Controller(Deposed())
        controller.queue.add(m.rt.Request("x"))
        controller.start(m.Fake())
        try:
            return done.wait(timeout=5), dict(controller.queue._failures), len(calls)
        finally:
            controller.stop()

    assert both(scenario) == (True, {}, 2)


def test_the_fence_feeds_the_fenced_writes_counter():
    client = fenced.FencedClient(FakeClient(), fence=Fence(None))
    metrics = OperatorMetrics()
    metrics.wire_fencing(client)
    for _ in range(2):
        with pytest.raises(FencedError):
            client.create(_node())
    assert 'tpu_operator_fenced_writes_total{verb="POST"} 2.0' in metrics.scrape().decode()


def test_a_deposed_elector_fences_the_chain_the_operator_builds():
    """``run_operator``'s chain, with the elector bound to the fence: a
    replica that loses the lease to another has its writes refused, and
    the refusal is counted."""
    import argparse

    from tpu_operator_torch.controllers.manager import build_client

    backend = FakeClient()
    args = argparse.Namespace(api_qps=0.0, api_burst=1, breaker_threshold=5, cache_reads=True)
    client, fence = build_client(args, backend)
    try:
        a = elector(PORT, backend, "a")
        assert a.try_acquire_or_renew()
        a.is_leader.set()
        fence.bind(a)
        client.create(_node("n1"))
        lease = _lease(PORT, backend)
        lease["spec"]["renewTime"] = "1970-01-01T00:00:00.000000Z"
        backend.update(lease)
        b = elector(PORT, backend, "b")
        assert b.try_acquire_or_renew()
        assert a.try_acquire_or_renew() is False
        a.is_leader.clear()  # what the elector's loop does on that answer
        with pytest.raises(FencedError):
            client.create(_node("n2"))
        assert fence.fenced_total == 1
        assert [n["metadata"]["name"] for n in backend.list("v1", "Node")] == ["n1"]
    finally:
        client.stop()
