"""Pod eviction through every layer of the port's client chain, against the
reference's.

The Eviction subresource honours PodDisruptionBudgets: the port's fake
answers each budget case as the reference's does (evicted or 429), and its
429 carries a ``Retry-After`` (the reference's sends none). A selector with
``matchExpressions`` is refused with 501 where the reference's fake, which
means to, raises a NameError. Over
HTTP, the port's ``MiniApiServer`` serves the subresource and its
``RestClient`` reads the 429's ``Retry-After`` into
``TooManyRequestsError.retry_after``. The retry layer does not retry a
429 on an eviction (a budget's verdict) but does retry a transport error;
the fence refuses a deposed replica's eviction; the write coalescer flushes
before an eviction; the informer cache removes nothing on its own.
"""

import http.client
import time

import pytest
import requests

from tpu_operator.client import errors as ref_errors
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.client.rest import RestClient as RefRest
from tpu_operator.testing.apiserver import MiniApiServer as RefServer
from tpu_operator_torch.client import errors
from tpu_operator_torch.client.batch import WriteBatcher, batch_window, coalesced_patch
from tpu_operator_torch.client.cache import CachedClient
from tpu_operator_torch.client.fake import EVICTION_RETRY_AFTER_S, FakeClient
from tpu_operator_torch.client.fenced import FencedClient
from tpu_operator_torch.client.interface import Client
from tpu_operator_torch.client.resilience import RetryingClient, RetryPolicy
from tpu_operator_torch.client.rest import RestClient
from tpu_operator_torch.testing.apiserver import MiniApiServer

NS = "ml-team"


def pod(name, labels=None, phase="Running"):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": NS, "labels": dict(labels or {})},
            "spec": {"nodeName": "node-0"}, "status": {"phase": phase}}


def pdb(name="budget", spec=None, status=None, selector=None):
    """A budget over ``app: train`` unless ``selector`` (None: omitted) says."""
    if selector is None:
        selector = {"matchLabels": {"app": "train"}}
    obj = {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
           "metadata": {"name": name, "namespace": NS}, "spec": dict(spec or {})}
    if selector:
        obj["spec"]["selector"] = selector
    if status is not None:
        obj["status"] = status
    return obj


TRAIN = {"app": "train"}

#: (pods as (name, labels, phase), budgets, the outcome of evicting "a")
BUDGETS = {
    "no-budget": ([("a", TRAIN, "Running")], [], "evicted"),
    "min-available-met": ([("a", TRAIN, "Running"), ("b", TRAIN, "Running")],
                          [pdb(spec={"minAvailable": 1})], "evicted"),
    "min-available-short": ([("a", TRAIN, "Running")], [pdb(spec={"minAvailable": 1})], 429),
    "min-available-counts-running-only": (
        [("a", TRAIN, "Running"), ("b", TRAIN, "Succeeded")], [pdb(spec={"minAvailable": 1})],
        429),
    "min-available-percent-rounds-up": (
        [("a", TRAIN, "Running"), ("b", TRAIN, "Running"), ("c", TRAIN, "Running")],
        [pdb(spec={"minAvailable": "50%"})], "evicted"),
    "min-available-percent-short": (
        [("a", TRAIN, "Running"), ("b", TRAIN, "Running")],
        [pdb(spec={"minAvailable": "51%"})], 429),
    "max-unavailable": ([("a", TRAIN, "Running")], [pdb(spec={"maxUnavailable": 1})],
                        "evicted"),
    "max-unavailable-used-by-unhealthy": (
        [("a", TRAIN, "Running"), ("b", TRAIN, "Failed")], [pdb(spec={"maxUnavailable": 1})],
        429),
    "max-unavailable-percent-rounds-down": (
        [("a", TRAIN, "Running"), ("b", TRAIN, "Running"), ("c", TRAIN, "Running")],
        [pdb(spec={"maxUnavailable": "50%"})], "evicted"),
    "neither-bound": ([("a", TRAIN, "Running")], [pdb()], 429),
    "disruptions-allowed-wins": ([("a", TRAIN, "Running")],
                                 [pdb(spec={"minAvailable": 1},
                                      status={"disruptionsAllowed": 1})], "evicted"),
    "disruptions-allowed-zero": ([("a", TRAIN, "Running"), ("b", TRAIN, "Running")],
                                 [pdb(spec={"minAvailable": 0},
                                      status={"disruptionsAllowed": 0})], 429),
    "selector-misses": ([("a", {"app": "web"}, "Running")], [pdb(spec={"minAvailable": 1})],
                        "evicted"),
    "empty-selector-matches-all": ([("a", {"app": "web"}, "Running")],
                                   [pdb(spec={"minAvailable": 1}, selector={})], 429),
    "match-expressions-refused": (
        [("a", TRAIN, "Running")],
        [pdb(spec={"minAvailable": 1}, selector={"matchExpressions": [
            {"key": "app", "operator": "In", "values": ["train"]}]})], 501),
    "missing-pod": ([], [], 404),
}


def outcome(client, evict):
    try:
        evict("a", NS)
    except Exception as e:  # noqa: BLE001 - the code is what is compared
        return getattr(e, "code", type(e).__name__), getattr(e, "retry_after", None)
    left = [p["metadata"]["name"] for p in client.list("v1", "Pod", NS)]
    assert "a" not in left
    return "evicted", None


def seed(client, case):
    pods, budgets, _ = BUDGETS[case]
    for name, labels, phase in pods:
        client.create(pod(name, labels, phase))
    for budget in budgets:
        client.create(budget)


@pytest.mark.parametrize("case", sorted(BUDGETS))
def test_the_fake_s_budgets_match_the_reference(case):
    ref, port = RefFake(), FakeClient()
    seed(ref, case)
    seed(port, case)
    want, want_hint = outcome(ref, ref.evict)
    got, hint = outcome(port, port.evict)
    if case == "match-expressions-refused":
        # the reference's fake means a 501 here, but its ``evict`` names
        # ApiError without importing it (tpu_operator/client/fake.py)
        assert (want, got) == ("NameError", 501)
        return
    assert got == want == BUDGETS[case][2]
    assert want_hint is None
    assert hint == (EVICTION_RETRY_AFTER_S if got == 429 else None)
    survivors = sorted(p["metadata"]["name"] for p in port.list("v1", "Pod", NS))
    assert survivors == sorted(p["metadata"]["name"] for p in ref.list("v1", "Pod", NS))


@pytest.mark.parametrize("case", ["min-available-met", "min-available-short", "missing-pod"])
def test_eviction_over_http_matches_the_reference_s_server(case):
    """The same requests over each package's in-process apiserver and REST
    client: the same verdicts; the port's 429 carries its Retry-After over
    the wire, and the server keeps every eviction request."""
    ref_srv, port_srv = RefServer(), MiniApiServer()
    ref_base, port_base = ref_srv.start(), port_srv.start()
    try:
        ref, port = RefRest(base_url=ref_base), RestClient(port_base)
        seed(ref, case)
        seed(port, case)
        want, _ = outcome(ref, ref.evict)
        got, hint = outcome(port, port.evict)
        assert got == want == BUDGETS[case][2]
        assert hint == (EVICTION_RETRY_AFTER_S if got == 429 else None)
        assert [(ns, name, code) for _, ns, name, code in port_srv.evictions] == [
            (NS, "a", 201 if got == "evicted" else got)]
        assert port_srv.request_counts()["EVICT"] == 1
    finally:
        ref_srv.stop()
        port_srv.stop()


def test_the_retry_after_header_reaches_the_caller(monkeypatch):
    from tpu_operator_torch.client import fake

    srv = MiniApiServer()
    monkeypatch.setattr(fake, "EVICTION_RETRY_AFTER_S", 7.5)
    base = srv.start()
    try:
        client = RestClient(base)
        seed(client, "min-available-short")
        with pytest.raises(errors.TooManyRequestsError) as e:
            client.evict("a", NS)
        assert e.value.retry_after == 7.5
        monkeypatch.setattr(fake, "EVICTION_RETRY_AFTER_S", None)
        with pytest.raises(errors.TooManyRequestsError) as e:
            client.evict("a", NS)
        assert e.value.retry_after is None
    finally:
        srv.stop()


class Scripted(Client):
    """Plays back a script of exceptions, one per call, then succeeds."""

    def __init__(self, *script):
        self.script = list(script)
        self.calls = 0

    def _next(self):
        self.calls += 1
        if self.script:
            raise self.script.pop(0)
        return {"ok": True}

    def evict(self, name, namespace=None):
        self._next()

    def get(self, api_version, kind, name, namespace=None):
        return self._next()


@pytest.mark.parametrize("side", ["reference", "port"])
def test_a_429_on_an_eviction_is_not_retried_a_transport_error_is(side):
    if side == "reference":
        from tpu_operator.client.resilience import RetryingClient as Retrying
        from tpu_operator.client.resilience import RetryPolicy as Policy
        too_many, reset = ref_errors.TooManyRequestsError, requests.ConnectionError("reset")
    else:
        Retrying, Policy = RetryingClient, RetryPolicy
        too_many = errors.TooManyRequestsError
        reset = http.client.RemoteDisconnected("reset")
    inner = Scripted(too_many("PDB", retry_after=7.0))
    client = Retrying(inner, policy=Policy(max_attempts=5, deadline_s=60.0), sleep=lambda s: None)
    with pytest.raises(too_many) as e:
        client.evict("a", NS)
    assert inner.calls == 1 and e.value.retry_after == 7.0
    inner = Scripted(reset)
    Retrying(inner, policy=Policy(max_attempts=5, deadline_s=60.0),
             sleep=lambda s: None).evict("a", NS)
    assert inner.calls == 2
    # any other verb still retries a 429 (overload)
    inner = Scripted(too_many("busy", retry_after=0.0))
    assert Retrying(inner, policy=Policy(max_attempts=5, deadline_s=60.0),
                    sleep=lambda s: None).get("v1", "Pod", "a", NS) == {"ok": True}
    assert inner.calls == 2


class Fence:
    def __init__(self, epoch):
        self.epoch = epoch

    def current_epoch(self):
        return self.epoch


def test_a_deposed_replica_s_eviction_is_fenced():
    fake = FakeClient()
    fake.create(pod("a", TRAIN))
    rejected = []
    client = FencedClient(fake, fence=Fence(None), on_fenced=rejected.append)
    with pytest.raises(errors.FencedError):
        client.evict("a", NS)
    assert rejected == ["EVICT"] and client.fenced_by_verb == {"EVICT": 1}
    assert fake.list("v1", "Pod", NS)  # nothing reached the apiserver
    FencedClient(fake, fence=Fence(3)).evict("a", NS)
    assert not fake.list("v1", "Pod", NS)


class Recorder(FakeClient):
    """A fake that keeps the order of its writes."""

    def __init__(self):
        super().__init__()
        self.writes = []

    def patch(self, api_version, kind, name, patch, namespace=None):
        self.writes.append(("patch", kind, name))
        return super().patch(api_version, kind, name, patch, namespace)

    def evict(self, name, namespace=None):
        self.writes.append(("evict", "Pod", name))
        return super().evict(name, namespace)


def test_the_batcher_flushes_before_an_eviction():
    """A cordon deferred in a sweep's batch window lands before the
    eviction it gates."""
    fake = Recorder()
    fake.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "node-0"}})
    fake.create(pod("a", TRAIN))
    batcher = WriteBatcher(fake)
    with batch_window(batcher):
        coalesced_patch(batcher, "v1", "Node", "node-0", {"spec": {"unschedulable": True}})
        assert fake.writes == []  # deferred
        batcher.evict("a", NS)
        assert fake.writes == [("patch", "Node", "node-0"), ("evict", "Pod", "a")]
    batcher.stop()


def test_the_cache_removes_an_evicted_pod_only_on_its_watch_event():
    fake = FakeClient()
    fake.create(pod("a", TRAIN))
    cache = CachedClient(fake)
    try:
        assert [p["metadata"]["name"] for p in cache.list("v1", "Pod", NS)] == ["a"]
        seen = []
        evict = fake.evict

        def evict_and_look(name, namespace=None):
            seen.append([p["metadata"]["name"] for p in cache.list("v1", "Pod", NS)])
            evict(name, namespace)
        fake.evict = evict_and_look
        cache.evict("a", NS)
        assert seen == [["a"]]
        deadline = time.monotonic() + 5
        while cache.list("v1", "Pod", NS) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert cache.list("v1", "Pod", NS) == []
    finally:
        cache.stop()


def test_every_layer_of_the_chain_evicts():
    """The operator's whole chain: cache, batcher, retries, fence, REST,
    over HTTP to the port's apiserver, PDB-blocked and then allowed."""
    srv = MiniApiServer()
    base = srv.start()
    try:
        rest = RestClient(base)
        chain = CachedClient(WriteBatcher(RetryingClient(FencedClient(rest, fence=Fence(1)))))
        seed(rest, "min-available-short")
        with pytest.raises(errors.TooManyRequestsError) as e:
            chain.evict("a", NS)
        assert e.value.retry_after == EVICTION_RETRY_AFTER_S
        assert [code for *_, code in srv.evictions] == [429]  # one request, not retried
        rest.delete("policy/v1", "PodDisruptionBudget", "budget", NS)
        chain.evict("a", NS)
        assert [code for *_, code in srv.evictions] == [429, 201]
        assert rest.list("v1", "Pod", NS) == []
        chain.stop()
    finally:
        srv.stop()
