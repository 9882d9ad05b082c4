"""Client-stack resilience: deadlines, retry/backoff, rate limit, breaker
(copy of tpu_operator/client/resilience.py).

NVIDIA's operator inherits all of this from client-go — flowcontrol's
token-bucket rate limiter in front of every request, reflector retry loops,
and apiserver priority&fairness honoring ``Retry-After``. The port's REST
layer is its own, so the same discipline lives here as one wrapper:

* **Per-call deadlines** — every HTTP round trip already carries a request
  timeout (:data:`~.rest.DEFAULT_TIMEOUT_S`); this layer adds a *logical*
  call deadline spanning all retry attempts and backoff sleeps, so a
  reconcile worker is never parked longer than ``RetryPolicy.deadline_s``
  on one API call.
* **Retry with full-jitter exponential backoff** for transient failures
  only: 429 (honoring the server's ``Retry-After``), 5xx, and transport
  errors (``OSError`` and ``http.client.HTTPException``, what the port's
  ``http.client`` transport raises). 4xx semantics (NotFound/Conflict/AlreadyExists/Invalid) are
  answers, not failures — they propagate on the first attempt, exactly as
  client-go treats them.
* **Client-side rate limiting** — a token bucket (qps/burst) modeled on
  client-go's ``flowcontrol.NewTokenBucketRateLimiter``, so a hot reconcile
  loop cannot stampede the apiserver even before the server-side limiter
  pushes back.
* **Circuit breaker with degraded mode** — after ``threshold`` consecutive
  hard failures (5xx/transport; a 429 proves the server is alive, so it
  counts as breaker success — resetting the streak and settling a
  half-open probe) the breaker
  opens: non-watch calls short-circuit locally with
  :class:`~.errors.BreakerOpenError` instead of piling onto a struggling
  server. After ``cooldown_s`` it half-opens, letting exactly one probe
  through; probe success closes it. The runtime treats the short-circuit
  as "requeue, don't error", the health server surfaces it as degraded,
  and cached reads keep serving throughout — an apiserver outage degrades
  the operator to read-only patience, never to a crash loop.

Watch streams bypass both the breaker and the limiter: ``_RestWatch`` owns
its own reconnect/backoff machinery, and starving the informer watches
would take down the very caches that make degraded mode livable.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Callable, List, Optional

from .. import tracing
from .errors import (
    ApiError,
    BreakerOpenError,
    DeadlineExceededError,
    FencedError,
    TooManyRequestsError,
    is_transient,
)
from .interface import Client, WatchHandle

log = logging.getLogger(__name__)

#: breaker states (also the value order of the breaker-state gauge)
CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
STATE_VALUES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


@dataclasses.dataclass
class RetryPolicy:
    """Transient-failure retry budget for one logical client call."""

    max_attempts: int = 5
    base_backoff_s: float = 0.2
    max_backoff_s: float = 10.0
    #: logical deadline across ALL attempts + sleeps; a reconcile worker is
    #: never parked longer than this on a single API call
    deadline_s: float = 90.0

    def backoff(self, attempt: int, rng: random.Random) -> float:
        """Full jitter (AWS architecture-blog variant): uniform in
        [0, min(cap, base * 2^attempt)] — decorrelates a thundering herd of
        workers retrying the same outage."""
        cap = min(self.max_backoff_s, self.base_backoff_s * (2 ** (attempt - 1)))
        return rng.uniform(0, cap)


class TokenBucket:
    """client-go flowcontrol analog: ``qps`` steady-state, ``burst`` bucket
    depth. ``acquire`` blocks until a token is available (bounded by
    ``max_wait``) and returns the time actually waited. ``qps <= 0``
    disables limiting entirely."""

    def __init__(self, qps: float, burst: int,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.qps = qps
        self.burst = max(1, burst)
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._tokens = float(self.burst)
        self._last = clock()

    def _refill_locked(self, now: float) -> None:
        self._tokens = min(float(self.burst),
                           self._tokens + (now - self._last) * self.qps)
        self._last = now

    def acquire(self, max_wait: Optional[float] = None) -> float:
        if self.qps <= 0:
            return 0.0
        waited = 0.0
        while True:
            with self._lock:
                now = self._clock()
                self._refill_locked(now)
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return waited
                need = (1.0 - self._tokens) / self.qps
            if max_wait is not None and waited + need > max_wait:
                raise DeadlineExceededError(
                    f"client-side rate limiter: waiting {need:.2f}s for a "
                    f"token would exceed the call deadline")
            self._sleep(need)
            waited += need


class CircuitBreaker:
    """Trips OPEN after ``threshold`` consecutive hard failures; short-
    circuits calls while open; half-opens after ``cooldown_s`` to let one
    probe through; closes again on probe success. Thread-safe — every
    controller worker shares one breaker, which is the point: five workers
    each need not discover the outage independently."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = max(1, threshold)
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._open_until = 0.0
        self._probe_inflight = False
        self._opened_total = 0
        #: hook(old_state, new_state) — metrics/log wiring
        self.on_state_change: Optional[Callable[[str, str], None]] = None

    # -- state ----------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._state == OPEN and self._clock() < self._open_until

    def snapshot(self) -> dict:
        """/readyz + /debug/state detail."""
        with self._lock:
            retry_in = max(0.0, self._open_until - self._clock())
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "threshold": self.threshold,
                "opened_total": self._opened_total,
                "retry_in_s": round(retry_in, 3) if self._state == OPEN else 0.0,
            }

    def _transition_locked(self, new_state: str) -> None:
        old, self._state = self._state, new_state
        if new_state == OPEN:
            self._open_until = self._clock() + self.cooldown_s
            self._opened_total += 1
        hook = self.on_state_change
        if hook is not None and old != new_state:
            try:
                hook(old, new_state)
            except Exception:
                pass

    # -- call protocol ---------------------------------------------------------
    def before_call(self) -> None:
        """Raises :class:`BreakerOpenError` when the call must not go out."""
        with self._lock:
            if self._state == OPEN:
                remaining = self._open_until - self._clock()
                if remaining > 0:
                    raise BreakerOpenError(
                        f"apiserver circuit breaker open after "
                        f"{self._consecutive_failures} consecutive failures; "
                        f"probing in {remaining:.1f}s", retry_in=remaining)
                # cooldown elapsed: this caller becomes the probe
                self._transition_locked(HALF_OPEN)
                self._probe_inflight = True
                return
            if self._state == HALF_OPEN:
                if self._probe_inflight:
                    raise BreakerOpenError(
                        "apiserver circuit breaker half-open; probe in flight",
                        retry_in=0.5)
                self._probe_inflight = True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._transition_locked(CLOSED)

    def probe_aborted(self) -> None:
        """Release the probe slot without a verdict: the call admitted by
        :meth:`before_call` never produced an answer from the server (rate-
        limiter deadline, a nested breaker's short-circuit, or an exception
        escaping between the gate and the wire call). State is left as-is —
        if half-open, the next caller simply becomes the probe. Without
        this, an unclassified escape would leave ``_probe_inflight`` stuck
        and every future call rejected until restart."""
        with self._lock:
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                self._probe_inflight = False
                self._transition_locked(OPEN)  # failed probe: re-open
            elif (self._state == CLOSED
                  and self._consecutive_failures >= self.threshold):
                self._transition_locked(OPEN)


class RetryingClient(Client):
    """The resilience wrapper. Sits below :class:`~.cache.CachedClient` and
    the write coalescer and above the write fence and
    :class:`~.rest.RestClient`, so cache-served reads cost nothing while
    every wire call pays the limiter, the breaker gate, and earns the retry
    budget."""

    def __init__(self, inner: Client,
                 policy: Optional[RetryPolicy] = None,
                 limiter: Optional[TokenBucket] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.scheme = getattr(inner, "scheme", None)
        self.policy = policy or RetryPolicy()
        self.limiter = limiter or TokenBucket(qps=0, burst=1)
        self.breaker = breaker or CircuitBreaker()
        self._rng = rng or random.Random()
        self._clock = clock
        self._sleep = sleep
        #: hook(verb, reason) per retry — feeds tpu_operator_api_retries_total
        self.on_retry: Optional[Callable[[str, str], None]] = None
        #: hook(seconds) per rate-limiter wait — client-side throttle budget
        self.on_throttle: Optional[Callable[[float], None]] = None

    # -- core ------------------------------------------------------------------
    @staticmethod
    def _reason(exc: BaseException) -> str:
        if isinstance(exc, TooManyRequestsError):
            return "429"
        if isinstance(exc, ApiError):
            return str(exc.code)
        return "transport"

    def _notify_retry(self, verb: str, reason: str) -> None:
        if self.on_retry is not None:
            try:
                self.on_retry(verb, reason)
            except Exception:
                pass

    def _call(self, verb: str, fn: Callable, retry_429: bool = True):
        deadline = self._clock() + self.policy.deadline_s
        attempt = 1
        while True:
            # Breaker gate BEFORE the rate limiter: while the breaker is
            # open a call must short-circuit immediately — parking on the
            # token bucket (up to the whole deadline) and draining tokens
            # for requests that never go out would defeat the point of
            # short-circuiting locally.
            self.breaker.before_call()
            # Every admitted call must hand the breaker a verdict
            # (record_success / record_failure); any path escaping without
            # one — limiter deadline, a nested breaker's short-circuit, an
            # unexpected exception — releases the probe slot in the
            # ``finally`` below, else a half-open probe would wedge the
            # breaker and reject every future call until restart.
            settled = False
            try:
                waited = self.limiter.acquire(
                    max_wait=max(0.0, deadline - self._clock()))
                if waited > 0 and self.on_throttle is not None:
                    try:
                        self.on_throttle(waited)
                    except Exception:
                        pass
                try:
                    if attempt == 1:
                        result = fn()
                    else:
                        # retried attempts show up in reconcile traces as
                        # their own spans wrapping the inner api span — a
                        # trace of a flaky apiserver reads attempt-by-attempt
                        with tracing.span("api.retry", kind="api", verb=verb,
                                          attempt=attempt):
                            result = fn()
                except Exception as e:  # noqa: BLE001 - classified below
                    transient = is_transient(e)
                    if isinstance(e, TooManyRequestsError):
                        # 429 proves the server is alive and prioritizing —
                        # the opposite of an outage. It resets the failure
                        # streak and, crucially, settles a half-open probe
                        # (a recovering apiserver commonly answers 429
                        # first; wedging on it would reject every call
                        # until restart).
                        self.breaker.record_success()
                        settled = True
                    elif transient:  # hard failures: 5xx, transport
                        self.breaker.record_failure()
                        settled = True
                    elif not isinstance(e, (BreakerOpenError, FencedError)):
                        self.breaker.record_success()  # the server answered
                        settled = True
                    if not transient or (not retry_429
                                         and isinstance(e, TooManyRequestsError)):
                        raise
                    if attempt >= self.policy.max_attempts:
                        raise
                    retry_after = getattr(e, "retry_after", None)
                    delay = (retry_after if retry_after is not None
                             else self.policy.backoff(attempt, self._rng))
                    if self._clock() + delay > deadline:
                        raise
                    reason = self._reason(e)
                    self._notify_retry(verb, reason)
                    sp = tracing.current_span()
                    if sp is not None:
                        sp.set_attributes(retries=attempt,
                                          last_retry_reason=reason)
                    log.debug("api %s transient failure (%s); retry %d/%d in "
                              "%.2fs", verb, reason, attempt,
                              self.policy.max_attempts - 1, delay)
                    self._sleep(delay)
                    attempt += 1
                    continue
                self.breaker.record_success()
                settled = True
                return result
            finally:
                if not settled:
                    self.breaker.probe_aborted()

    # -- reads -----------------------------------------------------------------
    def get(self, api_version, kind, name, namespace=None) -> dict:
        return self._call("GET", lambda: self.inner.get(
            api_version, kind, name, namespace))

    def list(self, api_version, kind, namespace=None, label_selector=None,
             field_selector=None) -> List[dict]:
        return self._call("LIST", lambda: self.inner.list(
            api_version, kind, namespace, label_selector, field_selector))

    # -- writes ----------------------------------------------------------------
    def create(self, obj: dict) -> dict:
        return self._call("POST", lambda: self.inner.create(obj))

    def update(self, obj: dict) -> dict:
        return self._call("PUT", lambda: self.inner.update(obj))

    def patch(self, api_version, kind, name, patch, namespace=None) -> dict:
        return self._call("PATCH", lambda: self.inner.patch(
            api_version, kind, name, patch, namespace))

    def delete(self, api_version, kind, name, namespace=None) -> None:
        return self._call("DELETE", lambda: self.inner.delete(
            api_version, kind, name, namespace))

    def update_status(self, obj: dict) -> dict:
        return self._call("PUT", lambda: self.inner.update_status(obj))

    def evict(self, name: str, namespace: Optional[str] = None) -> None:
        # a 429 here is a disruption budget's verdict, not overload: retried
        # inside the client it would burn the drain budget the upgrade
        # machine schedules around. Transport errors and 5xx still retry
        return self._call("EVICT", lambda: self.inner.evict(name, namespace),
                          retry_429=False)

    def server_version(self) -> str:
        return self._call("GET", self.inner.server_version)

    # -- passthrough -----------------------------------------------------------
    def watch(self, api_version, kind, namespace=None, handler=None,
              relist_handler=None) -> WatchHandle:
        """Watches bypass retry/limiter/breaker: the watch loop owns its own
        reconnect machinery, and gating it would starve the caches that
        keep degraded mode serving."""
        return self.inner.watch(api_version, kind, namespace, handler,
                                relist_handler=relist_handler)

    def stop(self) -> None:
        self.inner.stop()


def find_resilience(client: Client) -> Optional[RetryingClient]:
    """Locate the RetryingClient in a wrapper chain (CachedClient →
    RetryingClient → RestClient) so the app can wire metrics hooks and
    surface breaker state without caring about stacking order."""
    seen = set()
    while client is not None and id(client) not in seen:
        seen.add(id(client))
        if isinstance(client, RetryingClient):
            return client
        client = getattr(client, "inner", None)
    return None
