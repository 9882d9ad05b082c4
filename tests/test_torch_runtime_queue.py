"""The twin of tests/test_runtime_queue.py: the reference's ten cases
against the port's work queue and controller runtime
(``tpu_operator_torch/controllers/runtime.py``), and the deterministic ones
run through both packages' queues side by side.

The side-by-side cases run one script of adds, delays, rate-limited
re-adds and ``forget`` through each package's ``RateLimitingQueue`` on a
fake clock (each module's ``time``), drain what is due at each step with a
non-blocking ``get`` and compare the delivery order, the times of delivery
(the back-off delays among them) and the queue's ``/debug/queue`` state;
the resync jitter is drawn from ``random`` seeded alike for both. The
resync period's switch is ``GPU_OPERATOR_RESYNC_S`` in the port
(``TPU_OPERATOR_RESYNC_S`` in the reference), 300 s by default in both.
"""

import random
import threading
import time
import types

import pytest

import tpu_operator.controllers.runtime as ref_runtime
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.controllers import runtime
from tpu_operator_torch.controllers.runtime import (Controller, RateLimitingQueue, Reconciler,
                                                    Request, Result)

PACKAGES = {"reference": ref_runtime, "port": runtime}


def test_dedup_pending():
    q = RateLimitingQueue()
    q.add(Request("a"))
    q.add(Request("a"))
    q.add(Request("b"))
    assert len(q) == 2


def test_delay_delivery_order():
    q = RateLimitingQueue()
    q.add(Request("slow"), delay=0.15)
    q.add(Request("fast"))
    assert q.get(timeout=1).name == "fast"
    start = time.monotonic()
    assert q.get(timeout=1).name == "slow"
    assert time.monotonic() - start >= 0.05


def test_rate_limited_backoff_grows():
    q = RateLimitingQueue()
    r = Request("x")
    q.add_rate_limited(r)
    assert q.get(timeout=1) == r
    start = time.monotonic()
    q.add_rate_limited(r)
    assert q.get(timeout=2) == r
    assert time.monotonic() - start >= 0.15  # 0.1 * 2^1
    q.forget(r)
    q.add_rate_limited(r)
    start = time.monotonic()
    assert q.get(timeout=1) == r
    assert time.monotonic() - start < 0.15  # back to the base


def test_immediate_add_overrides_pending_delay():
    q = RateLimitingQueue()
    q.add(Request("x"), delay=5.0)
    q.add(Request("x"))
    start = time.monotonic()
    assert q.get(timeout=1).name == "x"
    assert time.monotonic() - start < 0.5
    assert len(q) == 0  # the stale 5 s entry is gone from the accounting


def test_later_add_does_not_extend_earlier_delay():
    q = RateLimitingQueue()
    q.add(Request("x"), delay=0.05)
    q.add(Request("x"), delay=5.0)
    start = time.monotonic()
    assert q.get(timeout=1).name == "x"
    assert time.monotonic() - start < 0.5


def test_get_timeout_returns_none():
    q = RateLimitingQueue()
    assert q.get(timeout=0.05) is None


def test_shutdown_unblocks():
    q = RateLimitingQueue()
    got = []
    t = threading.Thread(target=lambda: got.append(q.get()))
    t.start()
    time.sleep(0.05)
    q.shutdown()
    t.join(timeout=1)
    assert got == [None]
    q.add(Request("after"))  # a no-op after shutdown
    assert len(q) == 0


def test_periodic_resync_reenqueues_lost_work():
    seen = []

    class Rec(Reconciler):
        name = "resync-test"

        def reconcile(self, request):
            seen.append(request)
            return Result()

    controller = Controller(Rec())
    controller.resyncs(lambda: [Request("r")], period=0.05)
    controller.start(FakeClient())
    deadline = time.monotonic() + 5
    while len(seen) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    controller.stop()
    assert len(seen) >= 3


class _Never(Reconciler):
    name = "jitter-test"

    def reconcile(self, request):  # pragma: no cover - never started
        raise AssertionError


def test_resync_delay_full_jitter_on_back_half():
    controller = Controller(_Never())
    controller.resyncs(lambda: [], period=10.0)
    draws = {controller._resync_delay() for _ in range(200)}
    assert all(5.0 <= d <= 10.0 for d in draws)
    assert len(draws) > 1

    controller.resyncs(lambda: [], period=10.0, jitter=False)
    assert controller._resync_delay() == 10.0


def test_all_three_controllers_resync_jittered_with_env_default():
    from tpu_operator_torch.controllers import (clusterpolicy_controller, gpudriver_controller,
                                                upgrade_controller)

    for mod in (clusterpolicy_controller, gpudriver_controller, upgrade_controller):
        assert mod.RESYNC_PERIOD_S == 300.0, mod.__name__


# -- both packages, side by side ------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


#: (op, request name, argument): add with a delay, a rate-limited re-add,
#: forget, a clock step, then everything due is drained
SCRIPT = [
    ("add", "slow", 0.15), ("add", "fast", 0.0), ("drain",),
    ("step", 0.1), ("drain",), ("step", 0.05), ("drain",),
    ("add", "x", 5.0), ("add", "x", 0.0), ("drain",),
    ("add", "y", 0.05), ("add", "y", 5.0), ("step", 0.05), ("drain",),
    ("add", "a", 0.0), ("add", "a", 0.0), ("add", "b", 0.0), ("state",), ("drain",),
] + [op for _ in range(10) for op in (("rate", "r", None), ("state",), ("step", 0.1),
                                      ("drain",), ("step", 100.0), ("drain",))] + [
    ("forget", "r", None), ("rate", "r", None), ("step", 0.1), ("drain",),
    ("rate", "s", None), ("rate", "t", None), ("rate", "s", None), ("state",),
    ("step", 1.0), ("drain",),
]


def run_script(pkg, monkeypatch) -> list:
    clock = FakeClock()
    monkeypatch.setattr(pkg, "time", types.SimpleNamespace(monotonic=clock.monotonic))
    q = pkg.RateLimitingQueue()
    trace = []
    for op in SCRIPT:
        if op[0] == "add":
            q.add(pkg.Request(op[1]), delay=op[2])
        elif op[0] == "rate":
            q.add_rate_limited(pkg.Request(op[1]))
        elif op[0] == "forget":
            q.forget(pkg.Request(op[1]))
        elif op[0] == "step":
            clock.now += op[1]
        elif op[0] == "state":
            trace.append(("state", q.debug_state(), len(q)))
        else:
            while True:
                got = q.get(timeout=0)
                if got is None:
                    break
                trace.append(("got", got.name, round(clock.now - 1000.0, 6)))
    return trace


def test_both_queues_deliver_the_same_script_alike(monkeypatch):
    traces = {name: run_script(pkg, monkeypatch) for name, pkg in PACKAGES.items()}
    assert traces["port"] == traces["reference"]
    got = [t[1] for t in traces["port"] if t[0] == "got"]
    assert got[:4] == ["fast", "slow", "x", "y"]
    # the back-off doubles to its cap, the same in both packages
    backoff = [t[1]["pending"][0]["due_in_s"] for t in traces["port"]
               if t[0] == "state" and [p["request"] for p in t[1]["pending"]] == ["r"]]
    assert backoff[:10] == [min(runtime.BASE_BACKOFF * 2 ** n, runtime.MAX_BACKOFF)
                          for n in range(10)]
    assert (runtime.BASE_BACKOFF, runtime.MAX_BACKOFF) == \
        (ref_runtime.BASE_BACKOFF, ref_runtime.MAX_BACKOFF)


@pytest.mark.parametrize("seed", [0, 20260730])
def test_both_controllers_draw_the_same_resync_jitter_for_a_seed(seed):
    draws = {}
    for name, pkg in PACKAGES.items():
        class Rec(pkg.Reconciler):
            name = "jitter-test"

            def reconcile(self, request):  # pragma: no cover - never started
                raise AssertionError

        controller = pkg.Controller(Rec())
        controller.resyncs(lambda: [], period=10.0)
        random.seed(seed)
        draws[name] = [controller._resync_delay() for _ in range(50)]
    assert draws["port"] == draws["reference"]
    assert all(5.0 <= d <= 10.0 for d in draws["port"])
