"""The port's client resilience layer (``client/resilience.py``) twin for
twin with the reference's tests/test_resilience.py: the token bucket, the
full-jitter retry policy, the circuit breaker, the RetryingClient's
classification, and the runtime's and the app's handling of an open
breaker.

Each scenario runs on the reference's classes and on the port's under the
same scripted faults and a fake clock, and returns what it observed; the
observations must be equal. A transport failure is the reference's
``requests.ConnectionError`` there and ``ConnectionError`` (what the port's
``http.client`` transport raises) here.
"""

import random
import time
import types

import pytest
import requests

from tpu_operator.client import errors as ref_errors
from tpu_operator.client import resilience as ref_resilience
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.controllers import runtime as ref_runtime
from tpu_operator.controllers.metrics import OperatorMetrics as RefMetrics
from tpu_operator_torch.client import errors
from tpu_operator_torch.client import resilience
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.controllers import runtime
from tpu_operator_torch.controllers.manager import OperatorApp
from tpu_operator_torch.controllers.metrics import OperatorMetrics

REF = types.SimpleNamespace(e=ref_errors, r=ref_resilience, Fake=RefFake, rt=ref_runtime,
                            Metrics=RefMetrics,
                            transport=lambda msg: requests.ConnectionError(msg))
PORT = types.SimpleNamespace(e=errors, r=resilience, Fake=FakeClient, rt=runtime,
                             Metrics=OperatorMetrics, transport=lambda msg: ConnectionError(msg))


def both(scenario):
    want = scenario(REF)
    got = scenario(PORT)
    assert got == want
    return got


class FakeClock:
    """A clock whose sleep() advances time: no real waiting."""

    def __init__(self, t: float = 1000.0):
        self.t = t
        self.sleeps = []

    def __call__(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(seconds)
        self.t += seconds


class ScriptedInner:
    """The wrapped client: plays back a script of exceptions and values, one
    per call, then succeeds forever."""

    def __init__(self, *script):
        self.script = list(script)
        self.calls = 0

    def _next(self, *a, **k):
        self.calls += 1
        item = self.script.pop(0) if self.script else {"ok": True}
        if isinstance(item, BaseException):
            raise item
        return item

    get = list = create = update = patch = delete = update_status = server_version = _next

    def watch(self, *a, **k):
        self.calls += 1
        return "watch-handle"

    def stop(self):
        pass


def make_client(m, inner, clock=None, **kw):
    clock = clock or FakeClock()
    kw.setdefault("policy", m.r.RetryPolicy(max_attempts=4, base_backoff_s=0.1,
                                            max_backoff_s=1.0, deadline_s=60.0))
    kw.setdefault("limiter", m.r.TokenBucket(qps=0, burst=1))
    kw.setdefault("breaker", m.r.CircuitBreaker(threshold=3, cooldown_s=5.0, clock=clock))
    kw.setdefault("rng", random.Random(7))
    return m.r.RetryingClient(inner, clock=clock, sleep=clock.sleep, **kw)


def outcome(fn):
    """(exception class name, code) or ("ok", value)."""
    try:
        return ("ok", fn())
    except Exception as e:
        return (type(e).__name__, getattr(e, "code", None))


# -- classification ------------------------------------------------------------------

def test_is_transient_classification():
    def scenario(m):
        e = m.e
        return [e.is_transient(x) for x in (
            e.TooManyRequestsError("slow down"), e.ApiError("boom", 503), e.ApiError("boom", 500),
            m.transport("reset"), e.NotFoundError("gone", 404), e.ConflictError("c", 409),
            e.ApiError("bad request", 400), e.BreakerOpenError("open", retry_in=1.0),
            e.DeadlineExceededError("limiter deadline"), ValueError("not an api error"))]

    assert both(scenario) == [True] * 4 + [False] * 6


def test_the_ports_transport_errors_are_transient():
    import http.client
    import socket

    for exc in (ConnectionResetError("reset"), socket.timeout("slow"), TimeoutError("slow"),
                http.client.RemoteDisconnected("closed"), http.client.IncompleteRead(b"")):
        assert errors.is_transient(exc)
    assert not errors.is_transient(errors.FencedError("fenced"))


# -- token bucket ----------------------------------------------------------------------

def test_token_bucket_burst_then_steady_state():
    def scenario(m):
        clock = FakeClock()
        bucket = m.r.TokenBucket(qps=10.0, burst=3, clock=clock, sleep=clock.sleep)
        return [round(bucket.acquire(), 9) for _ in range(4)]

    assert both(scenario) == [0.0, 0.0, 0.0, 0.1]


def test_token_bucket_refills_while_idle():
    def scenario(m):
        clock = FakeClock()
        bucket = m.r.TokenBucket(qps=10.0, burst=2, clock=clock, sleep=clock.sleep)
        bucket.acquire()
        bucket.acquire()
        clock.t += 10.0
        return [bucket.acquire() == 0.0, bucket.acquire() == 0.0, bucket.acquire() > 0.0]

    assert both(scenario) == [True, True, True]


def test_token_bucket_disabled_at_zero_qps():
    def scenario(m):
        clock = FakeClock()
        bucket = m.r.TokenBucket(qps=0, burst=1, clock=clock, sleep=clock.sleep)
        return [bucket.acquire() for _ in range(100)].count(0.0), clock.sleeps

    assert both(scenario) == (100, [])


def test_token_bucket_respects_deadline():
    def scenario(m):
        clock = FakeClock()
        bucket = m.r.TokenBucket(qps=0.1, burst=1, clock=clock, sleep=clock.sleep)
        bucket.acquire()
        try:
            bucket.acquire(max_wait=1.0)
        except m.e.DeadlineExceededError as exc:
            return exc.code, m.e.is_transient(exc)

    assert both(scenario) == (504, False)


# -- retry policy ----------------------------------------------------------------------

def test_backoff_full_jitter_bounds():
    def scenario(m):
        policy = m.r.RetryPolicy(base_backoff_s=0.2, max_backoff_s=2.0)
        rng = random.Random(42)
        return [policy.backoff(attempt, rng) for attempt in range(1, 10) for _ in range(50)]

    delays = both(scenario)
    for i, delay in enumerate(delays):
        attempt = i // 50 + 1
        assert 0.0 <= delay <= min(2.0, 0.2 * 2 ** (attempt - 1))


# -- circuit breaker -------------------------------------------------------------------

def test_breaker_trips_after_consecutive_failures():
    def scenario(m):
        clock = FakeClock()
        b = m.r.CircuitBreaker(threshold=3, cooldown_s=5.0, clock=clock)
        states = []
        for _ in range(2):
            b.record_failure()
        states.append(b.state)
        b.record_success()
        for _ in range(2):
            b.record_failure()
        states.append(b.state)
        b.record_failure()
        states.append(b.state)
        try:
            b.before_call()
        except m.e.BreakerOpenError as exc:
            states.append(exc.retry_in)
        return states

    assert both(scenario) == ["closed", "closed", "open", 5.0]


def test_breaker_half_open_single_probe():
    def scenario(m):
        clock = FakeClock()
        b = m.r.CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clock)
        b.record_failure()
        seen = [b.state]
        clock.t += 6.0
        b.before_call()
        seen.append(b.state)
        seen.append(outcome(b.before_call)[0])
        b.record_success()
        seen.append(b.state)
        seen.append(outcome(b.before_call)[0])
        return seen

    assert both(scenario) == ["open", "half-open", "BreakerOpenError", "closed", "ok"]


def test_breaker_failed_probe_reopens():
    def scenario(m):
        clock = FakeClock()
        b = m.r.CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clock)
        b.record_failure()
        clock.t += 6.0
        b.before_call()
        b.record_failure()
        return b.state, b.snapshot()

    state, snap = both(scenario)
    assert state == "open" and snap["opened_total"] == 2 and snap["retry_in_s"] > 0


def test_breaker_probe_aborted_releases_slot():
    def scenario(m):
        clock = FakeClock()
        b = m.r.CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clock)
        b.record_failure()
        clock.t += 6.0
        b.before_call()
        b.probe_aborted()
        seen = [b.state]
        b.before_call()
        b.record_success()
        return seen + [b.state]

    assert both(scenario) == ["half-open", "closed"]


def test_breaker_state_change_hook():
    def scenario(m):
        clock = FakeClock()
        b = m.r.CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clock)
        transitions = []
        b.on_state_change = lambda old, new: transitions.append((old, new))
        b.record_failure()
        clock.t += 6.0
        b.before_call()
        b.record_success()
        return transitions

    assert both(scenario) == [("closed", "open"), ("open", "half-open"), ("half-open", "closed")]


# -- RetryingClient --------------------------------------------------------------------

def test_retries_transient_then_succeeds():
    def scenario(m):
        inner = ScriptedInner(m.e.ApiError("boom", 503), m.transport("reset"), {"recovered": True})
        retries = []
        client = make_client(m, inner)
        client.on_retry = lambda verb, reason: retries.append((verb, reason))
        return client.get("v1", "Pod", "p"), inner.calls, retries

    assert both(scenario) == ({"recovered": True}, 3, [("GET", "503"), ("GET", "transport")])


def test_honors_retry_after_from_429():
    def scenario(m):
        clock = FakeClock()
        inner = ScriptedInner(m.e.TooManyRequestsError("busy", retry_after=2.5), {"ok": True})
        make_client(m, inner, clock=clock).get("v1", "Pod", "p")
        return clock.sleeps

    assert both(scenario) == [2.5]


@pytest.mark.parametrize("code", [404, 409, 422])
def test_semantic_4xx_never_retried(code):
    def scenario(m):
        exc = {404: m.e.NotFoundError("gone", 404), 409: m.e.ConflictError("c", 409),
               422: m.e.ApiError("invalid", 422)}[code]
        inner = ScriptedInner(exc, {"never": "reached"})
        client = make_client(m, inner)
        return outcome(lambda: client.get("v1", "Pod", "p")), inner.calls

    assert both(scenario)[1] == 1


def test_max_attempts_exhausted():
    def scenario(m):
        inner = ScriptedInner(*[m.e.ApiError("down", 503)] * 10)
        client = make_client(m, inner, breaker=m.r.CircuitBreaker(threshold=100))
        return outcome(lambda: client.get("v1", "Pod", "p")), inner.calls

    assert both(scenario) == (("ApiError", 503), 4)


def test_deadline_bounds_total_retry_time():
    def scenario(m):
        clock = FakeClock()
        inner = ScriptedInner(*[m.e.TooManyRequestsError("busy", retry_after=50.0)] * 10)
        client = make_client(m, inner, clock=clock,
                             policy=m.r.RetryPolicy(max_attempts=10, deadline_s=60.0))
        return outcome(lambda: client.get("v1", "Pod", "p")), inner.calls, clock.sleeps

    assert both(scenario) == (("TooManyRequestsError", 429), 2, [50.0])


def test_breaker_opens_and_short_circuits():
    def scenario(m):
        clock = FakeClock()
        inner = ScriptedInner(*[m.e.ApiError("down", 503)] * 20)
        client = make_client(m, inner, clock=clock,
                             policy=m.r.RetryPolicy(max_attempts=2, deadline_s=300.0),
                             breaker=m.r.CircuitBreaker(threshold=3, cooldown_s=30.0,
                                                        clock=clock))
        seen = [outcome(lambda: client.get("v1", "Pod", "p")) for _ in range(2)]
        before = inner.calls
        seen.append(outcome(lambda: client.get("v1", "Pod", "p")))
        return seen, client.breaker.state, inner.calls - before

    seen, state, calls = both(scenario)
    assert state == "open" and calls == 0 and seen[-1][0] == "BreakerOpenError"


def test_429_does_not_trip_breaker():
    def scenario(m):
        inner = ScriptedInner(*[m.e.TooManyRequestsError("busy", retry_after=0.1)] * 8)
        client = make_client(m, inner, policy=m.r.RetryPolicy(max_attempts=9, deadline_s=600.0),
                             breaker=m.r.CircuitBreaker(threshold=2))
        client.get("v1", "Pod", "p")
        return client.breaker.state

    assert both(scenario) == "closed"


def test_429_during_half_open_probe_settles_breaker():
    def scenario(m):
        clock = FakeClock()
        breaker = m.r.CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clock)
        breaker.record_failure()
        clock.t += 6.0
        inner = ScriptedInner(m.e.TooManyRequestsError("recovering", retry_after=0.5),
                              {"ok": True})
        client = make_client(m, inner, clock=clock, breaker=breaker)
        first = client.get("v1", "Pod", "p")
        state = breaker.state
        client.get("v1", "Pod", "p")
        return first, state, clock.sleeps, inner.calls

    assert both(scenario) == ({"ok": True}, "closed", [0.5], 3)


def test_limiter_deadline_during_probe_releases_slot():
    def scenario(m):
        clock = FakeClock()
        breaker = m.r.CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clock)
        breaker.record_failure()
        clock.t += 6.0
        limiter = m.r.TokenBucket(qps=0.001, burst=1, clock=clock, sleep=clock.sleep)
        limiter.acquire()
        client = make_client(m, ScriptedInner({"ok": True}), clock=clock, breaker=breaker,
                             limiter=limiter)
        seen = [outcome(lambda: client.get("v1", "Pod", "p"))[0], breaker.state]
        clock.t += 2000.0
        seen += [client.get("v1", "Pod", "p"), breaker.state]
        return seen

    assert both(scenario) == ["DeadlineExceededError", "half-open", {"ok": True}, "closed"]


def test_open_breaker_short_circuits_before_limiter():
    def scenario(m):
        clock = FakeClock()
        breaker = m.r.CircuitBreaker(threshold=1, cooldown_s=60.0, clock=clock)
        breaker.record_failure()
        acquires = []

        class CountingBucket(m.r.TokenBucket):
            def acquire(self, max_wait=None):
                acquires.append(max_wait)
                return super().acquire(max_wait)

        limiter = CountingBucket(qps=1.0, burst=1, clock=clock, sleep=clock.sleep)
        client = make_client(m, ScriptedInner(), clock=clock, breaker=breaker, limiter=limiter)
        return outcome(lambda: client.get("v1", "Pod", "p"))[0], acquires, clock.sleeps

    assert both(scenario) == ("BreakerOpenError", [], [])


def test_semantic_answer_resets_breaker_streak():
    def scenario(m):
        clock = FakeClock()
        breaker = m.r.CircuitBreaker(threshold=3, cooldown_s=5.0, clock=clock)
        inner = ScriptedInner(m.e.ApiError("down", 503), m.e.ApiError("down", 503),
                              m.e.NotFoundError("gone", 404))
        client = make_client(m, inner, clock=clock,
                             policy=m.r.RetryPolicy(max_attempts=1, deadline_s=60.0),
                             breaker=breaker)
        seen = [outcome(lambda: client.get("v1", "Pod", "p"))[0] for _ in range(3)]
        return seen, breaker.snapshot()["consecutive_failures"]

    assert both(scenario) == (["ApiError", "ApiError", "NotFoundError"], 0)


def test_watch_bypasses_open_breaker():
    def scenario(m):
        clock = FakeClock()
        breaker = m.r.CircuitBreaker(threshold=1, cooldown_s=60.0, clock=clock)
        breaker.record_failure()
        client = make_client(m, ScriptedInner(), clock=clock, breaker=breaker)
        return (client.watch("v1", "Pod", handler=lambda e: None),
                outcome(lambda: client.get("v1", "Pod", "p"))[0])

    assert both(scenario) == ("watch-handle", "BreakerOpenError")


def test_throttle_hook_reports_limiter_waits():
    def scenario(m):
        clock = FakeClock()
        waits = []
        client = make_client(m, ScriptedInner(), clock=clock,
                             limiter=m.r.TokenBucket(qps=10.0, burst=1, clock=clock,
                                                     sleep=clock.sleep))
        client.on_throttle = waits.append
        client.get("v1", "Pod", "a")
        client.get("v1", "Pod", "b")
        return [round(w, 9) for w in waits]

    assert both(scenario) == [0.1]


def test_find_resilience_walks_wrapper_chain():
    def scenario(m):
        retrying = make_client(m, ScriptedInner())

        class Outer:
            def __init__(self, inner):
                self.inner = inner

        loop = Outer(None)
        loop.inner = loop
        return (m.r.find_resilience(Outer(retrying)) is retrying,
                m.r.find_resilience(retrying) is retrying,
                m.r.find_resilience(Outer(Outer(ScriptedInner()))),
                m.r.find_resilience(loop))

    assert both(scenario) == (True, True, None, None)


# -- the runtime and the app -------------------------------------------------------------

def test_runtime_requeues_on_breaker_open_without_error():
    def scenario(m):
        import threading

        class Flaky(m.rt.Reconciler):
            name = "flaky"

            def __init__(self):
                self.calls = 0
                self.done = threading.Event()

            def reconcile(self, request):
                self.calls += 1
                if self.calls <= 2:
                    raise m.e.BreakerOpenError("apiserver circuit open", retry_in=0.05)
                self.done.set()
                return m.rt.Result()

        reconciler = Flaky()
        controller = m.rt.Controller(reconciler)
        metrics = m.Metrics()
        controller.instrument(metrics)
        controller.start(m.Fake())
        try:
            controller.queue.add(m.rt.Request(name="x"))
            done = reconciler.done.wait(timeout=10)
            controller.queue.add(m.rt.Request(name="x"))
            deadline = time.monotonic() + 5
            while reconciler.calls < 4 and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            controller.stop()
        scrape = metrics.scrape().decode()
        return (done, reconciler.calls >= 4,
                'tpu_operator_reconcile_errors_total{name="flaky"}' in scrape)

    assert both(scenario) == (True, True, False)


def test_metrics_wire_resilience():
    def scenario(m):
        clock = FakeClock()
        inner = ScriptedInner(m.e.ApiError("down", 503), {"ok": True},
                              *[m.e.ApiError("down", 503)] * 6)
        client = make_client(m, inner, clock=clock,
                             policy=m.r.RetryPolicy(max_attempts=2, deadline_s=600.0),
                             breaker=m.r.CircuitBreaker(threshold=3, cooldown_s=30.0,
                                                        clock=clock))
        metrics = m.Metrics()
        metrics.wire_resilience(client)
        client.get("v1", "Pod", "p")
        for _ in range(3):
            outcome(lambda: client.get("v1", "Pod", "p"))
        scrape = metrics.scrape().decode()
        return [line for line in scrape.splitlines()
                if line.startswith(("tpu_operator_api_retries_total{",
                                    "tpu_operator_api_breaker_state ",
                                    "tpu_operator_api_breaker_transitions_total{"))]

    lines = both(scenario)
    assert 'tpu_operator_api_retries_total{reason="503",verb="GET"} 3.0' in lines
    assert "tpu_operator_api_breaker_state 2.0" in lines
    assert 'tpu_operator_api_breaker_transitions_total{state="open"} 1.0' in lines


def test_readiness_reports_degraded_while_breaker_open():
    client = resilience.RetryingClient(
        FakeClient(), breaker=resilience.CircuitBreaker(threshold=1, cooldown_s=60.0))
    app = OperatorApp(client)
    app._started.set()  # as after start_controllers()
    ready, detail = app.readiness()
    assert ready and detail["status"] == "ok"
    client.breaker.record_failure()
    ready, detail = app.readiness()
    assert ready and detail["status"] == "degraded"
    assert detail["breaker"]["state"] == "open" and detail["breaker"]["retry_in_s"] > 0
    client.breaker.record_success()
    ready, detail = app.readiness()
    assert ready and detail["status"] == "ok"


def test_the_rest_client_errors_are_transient_over_the_wire():
    """A refused connection, as the port's transport raises it, is
    retried and then charges the breaker."""
    from tpu_operator_torch.client.rest import RestClient

    clock = FakeClock()
    client = make_client(PORT, RestClient(base_url="http://127.0.0.1:1", default_timeout=2.0),
                         clock=clock, breaker=resilience.CircuitBreaker(threshold=4, clock=clock))
    first = outcome(lambda: client.get("v1", "Node", "n1"))
    assert first[0] == "ConnectionRefusedError" and len(clock.sleeps) == 3
    assert client.breaker.state == "open"
