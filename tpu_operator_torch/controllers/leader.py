"""Lease-based leader election for multi-replica operator deployments
(copy of tpu_operator/controllers/leader.py).

NVIDIA's operator gets this from controller-runtime's optional leader
election (cmd/gpu-operator/main.go enables it by flag). Same semantics
here: a coordination.k8s.io/v1 Lease named after the operator,
holderIdentity + renewTime, takeover after leaseDurationSeconds without
renewal, and a monotonic epoch on the Lease (``tpu.ai/leader-epoch``) that
the write fence (``client/fenced.py``) checks.

One difference from the reference: :meth:`LeaderElector.current_epoch`
also answers None once the hold window since the last successful renewal
has passed. The reference's answers from ``is_leader`` alone, which only
the elector's own thread clears; a process paused past its lease (a stop
signal, a long stall) resumes with its workers and that thread runs side by
side, and until the thread has run, the fence admitted the deposed
replica's writes.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from typing import Callable, Optional

from .. import consts
from ..client.errors import ApiError, ConflictError, NotFoundError
from ..client.interface import Client

log = logging.getLogger(__name__)

LEASE_NAME = f"{consts.OPERATOR_NAME}-leader"


def lease_epoch(lease: dict) -> int:
    """The monotonic leader epoch recorded on a Lease (0 = pre-fencing
    lease that has never carried one)."""
    raw = (lease.get("metadata", {}).get("annotations") or {}).get(
        consts.LEADER_EPOCH_ANNOTATION, "0")
    try:
        return int(raw)
    except (TypeError, ValueError):
        return 0


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000000Z", time.gmtime())


def _parse(ts: str) -> float:
    import calendar

    try:
        return calendar.timegm(time.strptime(ts.split(".")[0], "%Y-%m-%dT%H:%M:%S"))
    except (ValueError, AttributeError):
        return 0.0


class LeaderElector:
    def __init__(self, client: Client, namespace: str,
                 identity: Optional[str] = None,
                 lease_name: str = LEASE_NAME,
                 lease_duration: float = 15.0,
                 renew_period: float = 5.0,
                 retry_period: float = 2.0):
        self.client = client
        self.namespace = namespace
        self.identity = identity or f"{os.uname().nodename}_{uuid.uuid4().hex[:8]}"
        self.lease_name = lease_name
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self.retry_period = retry_period
        # How long we keep acting as leader when renewal is INDETERMINATE
        # (apiserver unreachable / write races). Strictly less than what
        # peers see: they compute expiry from the advertised integer
        # leaseDurationSeconds and a second-truncated renewTime — up to a
        # full second earlier than our wall clock at the write — so the
        # margin must absorb that truncation plus slack, and the hold
        # window is anchored at the monotonic instant BEFORE the renew RPC
        # (client-go stamps the observation time pre-request). A
        # retry_period that leaves no such window would silently void the
        # renewDeadline < leaseDuration invariant, so it is an error.
        margin = 1.5  # 1 s renewTime truncation + 0.5 s slack
        self.renew_deadline = min(0.8 * lease_duration,
                                  lease_duration - margin)
        # renew_period matters too: after a SUCCESSFUL renew the loop
        # sleeps renew_period, so a renew_period past the deadline means
        # the very next indeterminate attempt finds the window already
        # expired and steps down on a single transient blip
        if self.renew_deadline < max(retry_period, renew_period):
            raise ValueError(
                f"retry_period={retry_period}/renew_period={renew_period} "
                f"leave no indeterminate-renewal window inside "
                f"lease_duration={lease_duration} (renew_deadline would be "
                f"{self.renew_deadline:.2f}s); raise lease_duration or "
                f"lower the periods")
        self.is_leader = threading.Event()
        #: the monotonic fencing token: the Lease epoch under which this
        #: replica last ACQUIRED leadership. Written only by the elector
        #: thread; racy reads are safe (monotonic int). Consumers must gate
        #: on current_epoch() (epoch + is_leader together), never the raw
        #: attribute — a deposed leader still remembers its old epoch.
        self.epoch = 0
        #: monotonic instant before the RPC of the last successful acquire
        #: or renew: the hold window runs from here
        self._renewed_at = float("-inf")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: what ``on_started`` raised on its own thread (see :meth:`_start`)
        self._start_error: Optional[BaseException] = None

    # -- fencing view ---------------------------------------------------------
    def current_epoch(self) -> Optional[int]:
        """The live fencing token: the epoch this replica holds leadership
        under, or None when not (or no longer) the leader. This is the
        elector's LIVE view — it flips to None the moment the indeterminate
        hold window expires, before any peer may legally take over. The
        window is checked here too, so a replica resumed after a pause
        past its lease is fenced before its elector thread has run."""
        if not self.is_leader.is_set():
            return None
        if time.monotonic() - self._renewed_at >= self.renew_deadline:
            return None
        return self.epoch

    # -- lease mechanics ------------------------------------------------------
    def _lease_obj(self, transitions: int = 0, epoch: int = 1) -> dict:
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.lease_name, "namespace": self.namespace,
                         "annotations": {
                             consts.LEADER_EPOCH_ANNOTATION: str(epoch)}},
            "spec": {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": max(1, int(self.lease_duration)),
                "acquireTime": _now(),
                "renewTime": _now(),
                "leaseTransitions": transitions,
            },
        }

    def try_acquire_or_renew(self) -> Optional[bool]:
        """True = held/renewed; False = another replica DEFINITIVELY holds a
        live lease; None = indeterminate (write race, lease vanished) — the
        caller must not treat indeterminate as loss: a leader that steps
        down on a benign resourceVersion race exits the process for
        nothing, and the very next attempt would have renewed fine."""
        start = time.monotonic()
        try:
            lease = self.client.get("coordination.k8s.io/v1", "Lease",
                                    self.lease_name, self.namespace)
        except NotFoundError:
            # epoch must outrun anything this process held before: a lease
            # deleted out from under a former leader must not let it mint
            # an epoch a newer leader already fenced against
            new_epoch = self.epoch + 1
            try:
                self.client.create(self._lease_obj(epoch=new_epoch))
                self.epoch = new_epoch
                self._renewed_at = start
                return True
            except ApiError:
                return None  # racing another creator; retry resolves it
        spec = lease.get("spec", {})
        holder = spec.get("holderIdentity")
        observed_epoch = lease_epoch(lease)
        if holder == self.identity:
            spec["renewTime"] = _now()
            # renewal never bumps the epoch — only acquisition does. A
            # pre-fencing lease (no annotation yet) gets stamped with the
            # epoch this replica believes it holds.
            new_epoch = observed_epoch or max(self.epoch, 1)
        else:
            expiry = _parse(spec.get("renewTime", "")) + spec.get(
                "leaseDurationSeconds", self.lease_duration)
            if time.time() < expiry:
                return False  # someone else holds a live lease
            spec["holderIdentity"] = self.identity
            spec["acquireTime"] = _now()
            spec["renewTime"] = _now()
            spec["leaseTransitions"] = spec.get("leaseTransitions", 0) + 1
            # takeover: fence out every write stamped with an older epoch
            new_epoch = max(observed_epoch, self.epoch) + 1
        lease["spec"] = spec
        lease.setdefault("metadata", {}).setdefault("annotations", {})[
            consts.LEADER_EPOCH_ANNOTATION] = str(new_epoch)
        try:
            self.client.update(lease)
            self.epoch = new_epoch
            self._renewed_at = start
            return True
        except (ConflictError, NotFoundError):
            return None  # lost the write race; next attempt re-reads

    # -- loop -----------------------------------------------------------------
    def run(self, on_started: Callable[[], None],
            on_stopped: Callable[[], None]) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        args=(on_started, on_stopped),
                                        daemon=True, name="leader-elector")
        self._thread.start()

    def _loop(self, on_started, on_stopped) -> None:
        last_renew = 0.0
        while not self._stop.is_set():
            # Pessimistic anchor: peers measure our lease from the renewTime
            # stamped BEFORE the update RPC lands, so the hold window must
            # start from before the call, not after a slow-but-successful
            # round trip (a post-RTT anchor lets a leader outlive the window
            # a standby legally takes over in).
            start = time.monotonic()
            try:
                acquired = self.try_acquire_or_renew()
            except Exception:  # opalint: disable=breaker-swallow — elector survives open breakers too; rationale below
                # the elector thread must survive ANY apiserver failure
                # (transport error, 500, 429): a dead elector is the worst
                # outcome — a leader that reconciles forever without
                # renewing while a standby takes over = split brain, and a
                # standby that can never take over at all
                log.warning("leader election: %s renew/acquire attempt "
                            "failed; retrying", self.identity, exc_info=True)
                acquired = None
            now = time.monotonic()
            if acquired:
                last_renew = start
                if not self.is_leader.is_set():
                    log.info("leader election: %s acquired leadership", self.identity)
                    self._start(on_started)
                self._stop.wait(self.renew_period)
            elif (acquired is None and self.is_leader.is_set()
                  and now - last_renew < self.renew_deadline):
                # renewal indeterminate but within the deadline that is
                # strictly inside what peers consider our live lease: still
                # the leader — keep reconciling, retry promptly
                self._stop.wait(self.retry_period)
            else:
                # definitively rejected, or indeterminate past the renew
                # deadline (a peer may legitimately take over soon)
                if self.is_leader.is_set():
                    log.warning("leader election: %s LOST leadership", self.identity)
                    self.is_leader.clear()
                    on_stopped()
                self._stop.wait(self.retry_period)
        if self._start_error is not None and self.is_leader.is_set():
            # a leader that failed to start MUST step down loudly —
            # swallowing this leaves a renewed lease held by a replica
            # that reconciles nothing (zombie split-brain)
            log.error("leader election: on_started failed; relinquishing %s",
                      self.identity, exc_info=self._start_error)
            self.is_leader.clear()
            try:
                on_stopped()
            except Exception:  # opalint: disable=breaker-swallow — the step-down path: logged, and the elector stops either way
                log.exception("on_stopped also failed")

    def _start(self, on_started: Callable[[], None]) -> None:
        """Set leadership and run ``on_started`` on their own thread, as
        client-go runs OnStartedLeading, and wait for it at most one renew
        period. A quick start ends inside the wait; a slow one (informer
        syncs on a loaded host) goes on while this loop keeps renewing. Run
        inline, a start longer than the renew deadline lapses the hold
        window, and this replica's own fence refuses the very writes the
        start triggers, though no peer could have taken the lease. A
        failure is handed to the loop, which stops and steps down."""
        def run():
            # leadership is set on this thread, right before on_started, as
            # the reference sets it on the elector's
            self.is_leader.set()
            try:
                on_started()
            except Exception as e:  # opalint: disable=breaker-swallow — not swallowed: handed to the loop, which steps down loudly and stops
                self._start_error = e
                self._stop.set()  # this instance is done (prod exits)

        starter = threading.Thread(target=run, daemon=True, name="leader-start")
        starter.start()
        self.is_leader.wait(timeout=self.renew_period)  # the starter's first statement
        starter.join(timeout=self.renew_period)

    def release(self) -> None:
        """Voluntary hand-off on clean shutdown (fast failover)."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if not self.is_leader.is_set():
            return
        try:
            lease = self.client.get("coordination.k8s.io/v1", "Lease",
                                    self.lease_name, self.namespace)
            if lease.get("spec", {}).get("holderIdentity") == self.identity:
                lease["spec"]["holderIdentity"] = ""
                lease["spec"]["renewTime"] = "1970-01-01T00:00:00.000000Z"
                self.client.update(lease)
        except ApiError:
            pass
        self.is_leader.clear()
