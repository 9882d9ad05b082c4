"""The state sweep under an open circuit breaker, the port's against the
reference's.

``Manager.sync_state`` runs every state of a sweep and folds a state's
crash into a ``StateResult`` ERROR, but an open breaker is not a crash:
nothing the sweep does can land, and folding it would show N failed states
(error'd conditions, a counted reconcile error, back-off growth). Both
packages' managers re-raise ``BreakerOpenError``, and the runtime worker
requeues the request after the breaker's cooldown without counting an
error (``controllers/runtime.py``, ``Controller._worker``).
"""

import logging
import threading
import types

import pytest

from test_torch_operator_reconcile import BASE, _nodes, _policy
from test_torch_operator_mapping import map_node, map_spec
from tpu_operator.client import errors as ref_errors
from tpu_operator.client import resilience as ref_resilience
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.controllers import runtime as ref_runtime
from tpu_operator.controllers.clusterpolicy_controller import \
    ClusterPolicyReconciler as RefReconciler
from tpu_operator.controllers.metrics import OperatorMetrics as RefMetrics
from tpu_operator.state import manager as ref_manager
from tpu_operator.state.skel import SyncState as RefSyncState
from tpu_operator_torch.client import errors
from tpu_operator_torch.client import resilience
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.controllers import runtime
from tpu_operator_torch.controllers.clusterpolicy_controller import ClusterPolicyReconciler
from tpu_operator_torch.controllers.metrics import OperatorMetrics
from tpu_operator_torch.state import manager
from tpu_operator_torch.state.skel import SyncState

REF = types.SimpleNamespace(e=ref_errors, r=ref_resilience, rt=ref_runtime, mgr=ref_manager,
                            Sync=RefSyncState, Fake=RefFake, Reconciler=RefReconciler,
                            Metrics=RefMetrics, objects=lambda nodes, spec: (
                                nodes + [_policy(spec)]))
PORT = types.SimpleNamespace(e=errors, r=resilience, rt=runtime, mgr=manager, Sync=SyncState,
                             Fake=FakeClient, Reconciler=ClusterPolicyReconciler,
                             Metrics=OperatorMetrics, objects=lambda nodes, spec: (
                                 [map_node(n) for n in nodes] + [_policy(map_spec(spec))]))


def both(scenario):
    want = scenario(REF)
    got = scenario(PORT)
    assert got == want
    return got


class Raising:
    """A state whose sync raises ``exc``."""

    def __init__(self, name, exc):
        self.name = name
        self.exc = exc

    def sync(self, catalog):
        raise self.exc


class Ready:
    def __init__(self, m, name):
        self.name = name
        self.m = m

    def sync(self, catalog):
        return self.m.mgr.StateResult(self.name, self.m.Sync.READY)


@pytest.mark.parametrize("exc", ["breaker-open", "crash"])
def test_the_sweep_reraises_an_open_breaker_and_folds_a_crash(exc):
    def scenario(m):
        error = (m.e.BreakerOpenError("apiserver circuit open", retry_in=1.5)
                 if exc == "breaker-open" else RuntimeError("boom"))
        ran = []

        class After(Ready):
            def sync(self, catalog):
                ran.append(self.name)
                return super().sync(catalog)

        sweep = m.mgr.Manager([Ready(m, "state-a"), Raising("state-driver", error),
                               After(m, "state-b")])
        try:
            results = sweep.sync_state(None)
        except m.e.BreakerOpenError as e:
            return ("raised", type(e).__name__, e.retry_in, ran)
        return ("results", [(r.state_name, r.status.value, r.message) for r in results.results],
                ran)

    got = both(scenario)
    if exc == "breaker-open":
        # nothing after the open breaker runs: the whole sweep is requeued
        assert got == ("raised", "BreakerOpenError", 1.5, [])
    else:
        assert got == ("results", [("state-a", "ready", ""), ("state-driver", "error", "boom"),
                                   ("state-b", "ready", "")], ["state-b"])


class ReadsCachedWritesBehindAnOpenBreaker:
    """The operator's chain while the apiserver is out: reads answered as
    the informer cache answers them (the fake), every write through a
    ``RetryingClient`` whose breaker is open and stays open (a frozen
    clock), so each write raises ``BreakerOpenError`` at once."""

    def __init__(self, m, fake, cooldown_s=0.2):
        self.fake = fake
        breaker = m.r.CircuitBreaker(threshold=1, cooldown_s=cooldown_s, clock=lambda: 1000.0)
        self.retrying = m.r.RetryingClient(fake, breaker=breaker)
        breaker.record_failure()
        self.get, self.list, self.watch = fake.get, fake.list, fake.watch

    def __getattr__(self, name):
        return getattr(self.retrying, name)


def test_an_open_breaker_mid_sweep_is_requeued_not_counted(caplog):
    """A ClusterPolicy sweep whose state write meets the open breaker: the
    state manager raises it, the reconcile fails with it, and the runtime
    worker requeues the request after the cooldown (0.5 s at least)
    without counting a reconcile error, in both packages."""
    def scenario(m):
        fake = m.Fake(objects=m.objects(_nodes(3), BASE))
        # a healthy first sweep renders every operand
        m.Reconciler(fake, namespace="tpu-operator").reconcile(m.rt.Request("cluster-policy"))
        daemonsets = fake.list("apps/v1", "DaemonSet", "tpu-operator")
        assert daemonsets
        # one operand DaemonSet gone: the next sweep's state must write
        gone = sorted(d["metadata"]["name"] for d in daemonsets)[0]
        fake.delete("apps/v1", "DaemonSet", gone, "tpu-operator")

        reconciler = m.Reconciler(ReadsCachedWritesBehindAnOpenBreaker(m, fake),
                                  namespace="tpu-operator")
        sweeps = []
        done = threading.Event()
        sync_state = reconciler.state_manager.sync_state

        def observed(catalog):
            try:
                results = sync_state(catalog)
            except m.e.BreakerOpenError:
                sweeps.append("breaker-open")
                raise
            finally:
                if len(sweeps) >= 2:
                    done.set()
            sweeps.append("results")
            return results

        reconciler.state_manager.sync_state = observed
        controller = m.rt.Controller(reconciler)
        metrics = m.Metrics()
        controller.instrument(metrics)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            controller.start(fake)
            try:
                controller.queue.add(m.rt.Request(name="cluster-policy"))
                requeued = done.wait(timeout=10)
            finally:
                controller.stop()
        scrape = metrics.scrape().decode()
        errored = [r.getMessage() for r in caplog.records if "errored" in r.getMessage()]
        return (requeued, sweeps[:2],
                f'tpu_operator_reconcile_errors_total{{name="{reconciler.name}"}}' in scrape,
                errored)

    requeued, sweeps, counted, errored = both(scenario)
    assert requeued and sweeps == ["breaker-open", "breaker-open"]
    assert not counted and errored == []
