"""The port's race sanitizer (``tpu_operator_torch.sanitizer``, opsan) twin
for twin with the reference's tests/test_sanitizer.py.

Each scenario runs through both sanitizers, one after the other and never
both installed at once (their hooks patch ``threading`` and ``queue`` for the
whole process, and each module kept the true originals when this file
imported both): the planted race on every seed, the guarded and the benign
patterns silent, suppression, the report's shape and dump, RLock re-entry,
the factory and the registry with the switch on and off, ``wire_opsan``, the
cross-check, and the ``untracked-shared-state`` fixtures through both
linters. Where a scenario ends in a report, the two reports are compared
field by field (var, kind, held set, thread order; sites with the package's
path mapped). With one root seed and one thread name the two perturbers make
the same decisions.
"""

import ast
import contextlib
import json
import os
import queue
import re
import subprocess
import sys
import textwrap
import threading
import types

import pytest

from test_torch_operator_mapping import map_lint_text, unmap_lint_text
from tpu_operator import tracing as ref_tracing
from tpu_operator.analysis import core as ref_lint_core
from tpu_operator.analysis import graph as ref_lint_graph
from tpu_operator.controllers.metrics import OperatorMetrics as RefMetrics
from tpu_operator.sanitizer import core as ref_core
from tpu_operator.sanitizer import crosscheck as ref_cc
from tpu_operator.sanitizer import hooks as ref_hooks
from tpu_operator.sanitizer import locks as ref_locks
from tpu_operator.sanitizer import perturb as ref_perturb
from tpu_operator.sanitizer import registry as ref_registry
from tpu_operator.utils import locks as ref_factory
from tpu_operator_torch import tracing
from tpu_operator_torch.analysis import core as lint_core
from tpu_operator_torch.analysis import graph as lint_graph
from tpu_operator_torch.controllers.metrics import OperatorMetrics
from tpu_operator_torch.sanitizer import core, crosscheck, hooks, locks, perturb, registry
from tpu_operator_torch.utils import locks as factory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = types.SimpleNamespace(
    name="reference", env="TPU_OPERATOR_OPSAN", core=ref_core, hooks=ref_hooks,
    locks=ref_locks, perturb=ref_perturb, registry=ref_registry, cc=ref_cc,
    factory=ref_factory, Metrics=RefMetrics, tracing=ref_tracing, lint_core=ref_lint_core,
    lint_graph=ref_lint_graph, map=lambda text: text, unmap=lambda text: text)
PORT = types.SimpleNamespace(
    name="port", env="GPU_OPERATOR_OPSAN", core=core, hooks=hooks, locks=locks,
    perturb=perturb, registry=registry, cc=crosscheck, factory=factory,
    Metrics=OperatorMetrics, tracing=tracing, lint_core=lint_core, lint_graph=lint_graph,
    map=map_lint_text, unmap=unmap_lint_text)
PACKAGES = (REF, PORT)


@contextlib.contextmanager
def sanitized(s, perturber=None):
    """``s``'s sanitizer switched on with its happens-before hooks installed
    and a fresh runtime; switched off, uninstalled and reset on the way out."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv(s.env, "1")
        s.hooks.install()
        try:
            yield s.core.reset_runtime(perturber=perturber)
        finally:
            s.hooks.uninstall()
            s.core.reset_runtime()


def map_site(site: str) -> str:
    """A reference report's site in the port's names (the package path)."""
    return map_lint_text(site)


def race_fields(s, rt) -> list:
    """Each race as the fields the twins compare: var, kind, held set,
    site and prior site (paths mapped to the port's), and the thread order
    (the two threads' names, reporting thread first)."""
    out = []
    for r in rt.races:
        site = map_site(r.site) if s is REF else r.site
        prior = map_site(r.prior_site) if s is REF else r.prior_site
        out.append({"var": r.var, "kind": r.kind, "held": list(r.held), "site": site,
                    "prior_site": prior,
                    "threads": [r.thread.split(":", 1)[1], r.prior_thread.split(":", 1)[1]]})
    return out


def both(scenario):
    """``scenario(s)`` on the reference's sanitizer, then the port's: the
    observations must be equal."""
    want = scenario(REF)
    got = scenario(PORT)
    assert got == want
    return got


def _run_threads(*targets):
    threads = [threading.Thread(target=t, name=f"t{i}") for i, t in enumerate(targets)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


# -- vector-clock primitives --------------------------------------------------

def test_vc_join_and_leq():
    def scenario(s):
        a = {"x": 2, "y": 1}
        s.core.vc_join(a, {"x": 1, "z": 3})
        return (a, s.core.vc_leq({"x": 1}, {"x": 2}), s.core.vc_leq({}, {"x": 1}),
                s.core.vc_leq({"x": 3}, {"x": 2}), s.core.vc_leq({"w": 1}, {"x": 2}))

    assert both(scenario) == ({"x": 2, "y": 1, "z": 3}, True, True, False, False)


# -- the planted race: detected on every seed ----------------------------------

def test_planted_race_detected_across_20_seeds():
    """A lock-free two-writer race is caught on all 20 perturber seeds by
    both sanitizers: the lockset state does not depend on the interleaving a
    seed produces."""
    def scenario(s):
        seen = []
        for seed in range(20):
            with sanitized(s, s.perturb.Perturber(seed, sleep=lambda _: None)) as rt:
                shared = s.factory.register_shared("planted.racy", {})

                def writer(key):
                    for i in range(20):
                        shared[key] = i

                _run_threads(lambda: writer("a"), lambda: writer("b"))
                assert rt.races, f"{s.name}: planted race not detected on seed {seed}"
                [r] = race_fields(s, rt)
                assert sorted(r.pop("threads")) == ["t0", "t1"]
                seen.append(r)
        return seen

    races = both(scenario)
    assert {(r["var"], r["kind"], tuple(r["held"])) for r in races} == {
        ("planted.racy", "write", ())}


def test_planted_race_report_field_by_field():
    """The same race with the writers put in order by an Event (no edge the
    sanitizer knows): one report, equal in every field, thread order
    included."""
    def scenario(s):
        with sanitized(s) as rt:
            shared = s.factory.register_shared("ordered.racy", {})
            first_done = threading.Event()

            def first():
                shared["a"] = 1
                first_done.set()

            def second():
                first_done.wait(10)
                shared["b"] = 2

            _run_threads(first, second)
            return race_fields(s, rt)

    [race] = both(scenario)
    assert race["threads"] == ["t1", "t0"] and race["held"] == []
    assert race["site"].startswith("tests/test_torch_sanitizer.py:")


@pytest.mark.parametrize("lock_kind", ["factory", "tracked"])
def test_guarded_access_is_silent_across_seeds(lock_kind):
    def scenario(s):
        for seed in range(5):
            with sanitized(s, s.perturb.Perturber(seed, sleep=lambda _: None)) as rt:
                lock = (s.factory.make_lock("Fixture._lock") if lock_kind == "factory"
                        else s.locks.TrackedLock("Fixture._lock"))
                shared = s.factory.register_shared("guarded.map", {})

                def writer(key):
                    for i in range(20):
                        with lock:
                            shared[key] = i

                _run_threads(lambda: writer("a"), lambda: writer("b"))
                assert not rt.races, rt.races[0].describe()
        return rt.report()["locks"]

    assert both(scenario) == ["Fixture._lock"]


def test_the_runtime_counts_every_access_under_contention():
    """More threads than cores, the interpreter switching threads every
    microsecond: every guarded access is counted (a lost update in the
    runtime's own state would drop some) and none is a race."""
    threads_n, writes = 3 * (os.cpu_count() or 4), 50

    def scenario(s):
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            with sanitized(s) as rt:
                lock = s.locks.TrackedLock("Stress._lock")
                shared = s.factory.register_shared("stress.map", {})

                def writer(key):
                    for i in range(writes):
                        with lock:
                            shared[key] = i

                _run_threads(*[lambda k=k: writer(k) for k in range(threads_n)])
                return rt.accesses_total, rt.races, rt.held_locks()
        finally:
            sys.setswitchinterval(switch)

    assert both(scenario) == (threads_n * writes, [], [])


# -- happens-before: init and hand-off stay silent; the control races ----------

def _init_then_publish(s):
    shared = s.factory.register_shared("init.map", {})
    shared["built"] = 1  # single-threaded init on the parent

    def reader():
        assert shared.get("built") == 1

    _run_threads(reader)


def _join_handoff(s):
    shared = s.factory.register_shared("join.map", {})

    def child():
        shared["child"] = 1

    t = threading.Thread(target=child)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    shared["parent"] = 2  # ordered by the join edge


def _queue_handoff(s):
    shared = s.factory.register_shared("queue.map", {})
    q = queue.Queue()

    def producer():
        shared["k"] = 1
        q.put("token")

    def consumer():
        q.get()
        shared["k2"] = 2  # ordered by the put -> get edge

    _run_threads(producer, consumer)


def _lock_handoff(s):
    """Ownership handed over through a lock the accesses are not under:
    the release -> acquire edge orders the transfer."""
    lock = s.locks.TrackedLock("Handoff._lock")
    shared = s.factory.register_shared("handoff.map", {})
    ready = threading.Event()

    def first_owner():
        shared["a"] = 1
        with lock:
            pass  # publish: the release carries first_owner's clock
        ready.set()

    def second_owner():
        ready.wait()
        with lock:
            pass  # absorb: the acquire joins the lock's clock
        shared["b"] = 2

    _run_threads(first_owner, second_owner)


def _unordered_writers(s):
    """The control of the hand-offs: two writers, no ordering edge at all."""
    shared = s.factory.register_shared("control.map", {})
    gate = threading.Barrier(2)

    def writer(key):
        gate.wait()
        shared[key] = 1

    _run_threads(lambda: writer("a"), lambda: writer("b"))


@pytest.mark.parametrize("pattern, races", [
    (_init_then_publish, 0), (_join_handoff, 0), (_queue_handoff, 0), (_lock_handoff, 0),
    (_unordered_writers, 1)], ids=["init-then-publish", "join", "queue", "lock", "control"])
def test_happens_before_patterns(pattern, races):
    def scenario(s):
        with sanitized(s) as rt:
            pattern(s)
            fields = race_fields(s, rt)
            for r in fields:
                r["threads"] = sorted(r["threads"])
            return fields

    assert len(both(scenario)) == races


# -- suppression and reporting -------------------------------------------------

def test_suppression_requires_rationale_and_silences():
    def scenario(s):
        with sanitized(s) as rt:
            with pytest.raises(ValueError):
                rt.suppress("noisy.", "")
            rt.suppress("noisy.", "intentionally racy test fixture")
            shared = s.factory.register_shared("noisy.map", {})
            gate = threading.Barrier(2)

            def writer(key):
                gate.wait()
                shared[key] = 1

            _run_threads(lambda: writer("a"), lambda: writer("b"))
            return rt.races, rt.report()["suppressions"]

    assert both(scenario) == ([], {"noisy.": "intentionally racy test fixture"})


def test_report_shape_and_dump(tmp_path):
    def scenario(s):
        with sanitized(s) as rt:
            lock_a, lock_b = s.locks.TrackedLock("A._lock"), s.locks.TrackedLock("B._lock")
            shared = s.factory.register_shared("r.map", {})
            with lock_a:
                with lock_b:
                    shared["k"] = 1
            rep = rt.report()
            path = rt.dump(str(tmp_path / s.name))
            assert re.fullmatch(r"opsan-\d+-\d+\.json", os.path.basename(path))
            with open(path) as fh:
                assert json.load(fh) == rep
            rep["lock_edges"] = [[a, b, map_site(site)] for a, b, site in rep["lock_edges"]]
            return rep

    rep = both(scenario)
    assert rep["version"] == 1 and rep["accesses_total"] == 1
    assert "r.map" in rep["tracked_vars"] and rep["locks"] == ["A._lock", "B._lock"]
    assert rep["lock_edges"][0][:2] == ["A._lock", "B._lock"]
    assert set(rep) == {"version", "accesses_total", "tracked_vars", "locks", "lock_edges",
                        "races", "suppressions"}


def test_an_edge_taken_in_package_code_names_the_package_path():
    """A lock acquired inside the package while the test holds another: the
    edge's site is the package file's path from the package's root (the
    port's path holds ``tpu_operator_torch/``, which the reference's cut
    would never find), the same file in both once mapped."""
    def scenario(s):
        with sanitized(s) as rt:
            recorder = s.tracing.FlightRecorder(4)
            outer = s.locks.TrackedLock("Outer._lock")
            with outer:
                recorder.stats()
            [(src, dst, site)] = rt.lock_edges()
            return src, dst, map_site(site).split(":")[0], rt.report()["tracked_vars"]

    src, dst, path, tracked = both(scenario)
    assert (src, dst, path) == ("Outer._lock", "FlightRecorder._lock",
                                "tpu_operator_torch/tracing.py")
    assert tracked == ["FlightRecorder._errors", "FlightRecorder._traces"]


# -- tracked lock semantics ----------------------------------------------------

def test_tracked_rlock_reentrancy_counts_once():
    def scenario(s):
        with sanitized(s) as rt:
            rl = s.locks.TrackedRLock("R._lock")
            with rl:
                with rl:
                    inner = rt.held_locks()
            after = rt.held_locks()
            with pytest.raises(RuntimeError):
                rl.release()
            return inner, after, rt.lock_edges()

    assert both(scenario) == (["R._lock"], [], [])


def test_factory_returns_raw_primitives_when_disabled(monkeypatch):
    def scenario(s):
        monkeypatch.delenv(s.env, raising=False)
        lock, rlock = s.factory.make_lock("X._lock"), s.factory.make_rlock("X._rlock")
        return (type(lock) is type(threading.Lock()),
                isinstance(rlock, (s.locks.TrackedLock, s.locks.TrackedRLock)))

    assert both(scenario) == (True, False)


def test_factory_returns_tracked_when_enabled():
    def scenario(s):
        with sanitized(s):
            return (type(s.factory.make_lock("X._lock")).__name__,
                    type(s.factory.make_rlock("X._rlock")).__name__,
                    s.factory.make_lock("X._lock").name)

    assert both(scenario) == ("TrackedLock", "TrackedRLock", "X._lock")


def test_registry_uniquifies_reregistration():
    def scenario(s):
        with sanitized(s):
            first = s.factory.register_shared("W._pending", {})
            second = s.factory.register_shared("W._pending", {"x": 1})
            return (type(first).__name__, first._opsan_name, second._opsan_name,
                    dict(second), "W._pending#1" in s.registry.registered_names())

    assert both(scenario) == ("TrackedDict", "W._pending", "W._pending#1", {"x": 1}, True)


def test_registry_is_identity_when_disabled(monkeypatch):
    def scenario(s):
        monkeypatch.delenv(s.env, raising=False)
        raw = {}
        return (s.factory.register_shared("X.raw", raw) is raw,
                s.registry.register_shared("X.raw", raw) is raw)

    assert both(scenario) == (True, True)


def test_the_switch_off_loads_no_sanitizer_and_no_torch():
    """With ``GPU_OPERATOR_OPSAN`` unset the factory gives the raw primitive
    and the operator's modules load no module of the sanitizer; with it set
    the sanitizer and its gate load, and nothing loads torch."""
    probe = textwrap.dedent("""
        import sys, threading
        from tpu_operator_torch.utils.locks import make_lock, register_shared
        import tpu_operator_torch.controllers.manager
        import tpu_operator_torch.testing.apiserver
        raw = {}
        print(type(make_lock("X._lock")) is type(threading.Lock()),
              register_shared("X.raw", raw) is raw,
              any(m.startswith("tpu_operator_torch.sanitizer") for m in sys.modules),
              "torch" in sys.modules)
        import tpu_operator_torch.cmd.opsan
        print(any(m.startswith("tpu_operator_torch.sanitizer") for m in sys.modules),
              "torch" in sys.modules, "jax" in sys.modules)
    """)
    env = {k: v for k, v in os.environ.items() if k != "GPU_OPERATOR_OPSAN"}
    env["PYTHONPATH"] = REPO
    off = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True,
                         text=True, timeout=120)
    assert off.returncode == 0, off.stderr
    assert off.stdout.split("\n")[:2] == ["True True False False", "True False False"]
    on = subprocess.run([sys.executable, "-c", probe], env=dict(env, GPU_OPERATOR_OPSAN="1"),
                        capture_output=True, text=True, timeout=120)
    assert on.returncode == 0, on.stderr
    assert on.stdout.split("\n")[:2] == ["False False True False", "True False False"]


def test_wire_opsan_feeds_both_families():
    def scenario(s):
        with sanitized(s) as rt:
            metrics = s.Metrics()
            metrics.wire_opsan(rt)
            shared = s.factory.register_shared("wired.map", {})
            gate = threading.Barrier(2)

            def writer(key):
                gate.wait()
                shared[key] = 1

            _run_threads(lambda: writer("a"), lambda: writer("b"))
            text = metrics.scrape().decode()
            return (len(rt.races), "tpu_operator_opsan_races_total 1.0" in text,
                    "tpu_operator_opsan_tracked_accesses_total 2.0" in text)

    assert both(scenario) == (1, True, True)


# -- the perturber -------------------------------------------------------------

def test_perturber_same_seed_same_trace():
    """One root seed and one thread name give two perturbers the same
    decisions and sleeps; and the parity across packages is exact: the
    reference's perturber and the port's make the same trace."""
    def scenario(s):
        out = {}

        def run():
            sleeps_1, sleeps_2 = [], []
            p1 = s.perturb.Perturber(1234, sleep=sleeps_1.append)
            p2 = s.perturb.Perturber(1234, sleep=sleeps_2.append)
            for i in range(500):
                kind = ("acquire", "release", "access")[i % 3]
                p1.point(kind)
                p2.point(kind)
            assert p1.trace() == p2.trace() and sleeps_1 == sleeps_2
            out.update(trace=p1.trace(), sleeps=sleeps_1, stats=p1.stats())

        t = threading.Thread(target=run, name="steady")
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        return out["trace"], out["sleeps"], out["stats"]

    trace, sleeps, stats = both(scenario)
    assert len(trace) == 500 and stats["points_total"] == 500
    assert stats["threads"] == ["steady"] and {a for _, a in trace} == {"pass", "yield", "sleep"}
    assert len(sleeps) == stats["perturbed_total"]


def test_perturber_different_seed_different_trace():
    def scenario(s):
        p1 = s.perturb.Perturber(1, sleep=lambda _: None)
        p2 = s.perturb.Perturber(2, sleep=lambda _: None)
        for _ in range(500):
            p1.point("access")
            p2.point("access")
        return p1.trace() != p2.trace()

    assert both(scenario) is True


def test_perturber_threads_never_share_rng():
    """A thread consuming extra decision samples does not move another
    thread's sequence: each is keyed by (root seed, thread name)."""
    def scenario(s):
        def worker(p, n, results):
            for _ in range(n):
                p.point("access")
            results[threading.current_thread().name] = p.trace()

        p1 = s.perturb.Perturber(42, sleep=lambda _: None)
        p2 = s.perturb.Perturber(42, sleep=lambda _: None)
        r1, r2 = {}, {}
        for threads in ([threading.Thread(target=worker, args=(p1, 100, r1), name="steady")],
                        [threading.Thread(target=worker, args=(p2, 100, r2), name="steady"),
                         threading.Thread(target=worker, args=(p2, 37, r2), name="noisy")]):
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
        assert r1["steady"] == r2["steady"]
        return r2["steady"]

    both(scenario)


def test_resolve_opsan_seed_precedence(monkeypatch):
    def scenario(s):
        monkeypatch.delenv("OPSAN_SEED", raising=False)
        monkeypatch.delenv("SCENARIO_SEED", raising=False)
        seen = [s.perturb.resolve_opsan_seed()]
        monkeypatch.setenv("SCENARIO_SEED", "111")
        seen.append(s.perturb.resolve_opsan_seed())
        monkeypatch.setenv("OPSAN_SEED", "222")
        seen += [s.perturb.resolve_opsan_seed(), s.perturb.resolve_opsan_seed(333)]
        return seen, s.perturb.DEFAULT_OPSAN_SEED

    assert both(scenario) == ([20260807, 111, 222, 333], 20260807)


# -- the static <-> dynamic cross-check ----------------------------------------

def _fixture_file(tmp_path, name, edges):
    path = tmp_path / f"{name}-dynamic_edges.json"
    path.write_text(json.dumps({"edges": edges}))
    return str(path)


def _result(res):
    return {k: getattr(res, k) for k in ("static_only", "dynamic_only", "fixtured",
                                         "unfixtured", "stale_fixtures")} | {
        "ok": res.ok(), "coverage": res.coverage()}


def test_crosscheck_dynamic_only_requires_fixture(tmp_path):
    def scenario(s):
        static = [("A._lock", "B._lock")]
        dynamic = [("A._lock", "B._lock"), ("C._lock", "D._lock")]
        sites = {e: "x.py:1" for e in dynamic}
        res = s.cc.crosscheck(static, dynamic, sites, fixtures={})
        fixtures = s.cc.load_fixtures(_fixture_file(tmp_path, s.name, [
            {"src": "C._lock", "dst": "D._lock",
             "rationale": "acquired through a callback the resolver cannot see"}]))
        res2 = s.cc.crosscheck(static, dynamic, sites, fixtures)
        return _result(res), _result(res2)

    first, second = both(scenario)
    assert first["unfixtured"] == [("C._lock", "D._lock")] and not first["ok"]
    assert second["ok"] and second["fixtured"] == [("C._lock", "D._lock")]
    assert second["coverage"] == 1.0


def test_crosscheck_coverage_and_stale_fixtures(tmp_path):
    def scenario(s):
        fixtures = s.cc.load_fixtures(_fixture_file(tmp_path, s.name, [
            {"src": "A._lock", "dst": "B._lock",
             "rationale": "was dynamic-only before the analyzer learned it"}]))
        return _result(s.cc.crosscheck([("A._lock", "B._lock"), ("B._lock", "C._lock")],
                                       [("A._lock", "B._lock")], {}, fixtures))

    res = both(scenario)
    assert res["static_only"] == [("B._lock", "C._lock")] and res["coverage"] == 0.5
    assert res["stale_fixtures"] == [("A._lock", "B._lock")] and res["ok"]


def test_crosscheck_fixture_without_rationale_rejected(tmp_path):
    def scenario(s):
        with pytest.raises(ValueError) as e:
            s.cc.load_fixtures(_fixture_file(tmp_path, s.name, [{"src": "A", "dst": "B"}]))
        return str(e.value).split(" in ")[0]

    assert both(scenario) == "fixture edge A->B"


def test_crosscheck_report_merge(tmp_path):
    def scenario(s):
        with sanitized(s) as rt:
            lock_a, lock_b = s.locks.TrackedLock("A._lock"), s.locks.TrackedLock("B._lock")
            with lock_a:
                with lock_b:
                    pass
            rt.dump(str(tmp_path / s.name))
        edges, sites, races = s.cc.load_reports(
            [str(p) for p in (tmp_path / s.name).glob("opsan-*.json")])
        return edges, races, sorted(map_site(v).split(":")[0] for v in sites.values())

    edges, races, sites = both(scenario)
    assert edges == [("A._lock", "B._lock")] and races == []
    assert sites == ["tests/test_torch_sanitizer.py"]


def test_crosscheck_render_names_the_fixture_file():
    """The gate's text names each package's own fixture file."""
    res = {s.name: s.cc.render(s.cc.crosscheck([], [("C._lock", "D._lock")], {}, {}), [])
           for s in PACKAGES}
    assert "tests/cases/opsan/dynamic_edges.json" in res["reference"]
    assert res["port"] == res["reference"].replace("cases/opsan/", "cases/torch_opsan/")


# -- the untracked-shared-state rule, through both linters ----------------------

_RULE = "untracked-shared-state"

_WIDGET = """
    import threading

    class Widget:
        def __init__(self):
            self._jobs = {jobs_value}
            self._lock = threading.Lock()

        def start(self):
            threading.Thread(target=self._worker).start()
            threading.Thread(target=self._drainer).start()

        def _worker(self):
            {worker_access}

        def _drainer(self):
            self._jobs.clear()
"""

_GUARDED = ('with self._lock:\n'
            '                self._jobs["a"] = 1')


def _single_entrypoint():
    src = _WIDGET.format(jobs_value="{}", worker_access='self._jobs["a"] = 1')
    src = src.replace("            threading.Thread(target=self._drainer).start()\n", "")
    return src.replace("        def _drainer(self):\n            self._jobs.clear()\n", "")


_MODULE_LEVEL = """
    import threading

    PENDING = {}

    def _worker():
        PENDING["a"] = 1

    def _drainer():
        PENDING.clear()

    def start():
        threading.Thread(target=_worker).start()
        threading.Thread(target=_drainer).start()
"""

#: (source, the reference's path, findings kept, suppressions applied)
_RULE_CASES = {
    "positive": (_WIDGET.format(jobs_value="{}", worker_access='self._jobs["a"] = 1'),
                 "tpu_operator/controllers/widget.py", 1, 0),
    "registered": ("from tpu_operator.utils import register_shared\n"
                   + textwrap.dedent(_WIDGET.format(
                       jobs_value='register_shared("Widget._jobs", {})',
                       worker_access='self._jobs["a"] = 1')),
                   "tpu_operator/controllers/widget.py", 0, 0),
    "half-guarded": (_WIDGET.format(jobs_value="{}", worker_access=_GUARDED),
                     "tpu_operator/controllers/widget.py", 1, 0),
    "guarded": (_WIDGET.format(jobs_value="{}", worker_access=_GUARDED).replace(
        "self._jobs.clear()", "with self._lock:\n                self._jobs.clear()"),
        "tpu_operator/controllers/widget.py", 0, 0),
    "single-entrypoint": (_single_entrypoint(), "tpu_operator/controllers/widget.py", 0, 0),
    "outside-reconcile-dirs": (_WIDGET.format(jobs_value="{}",
                                              worker_access='self._jobs["a"] = 1'),
                               "tpu_operator/client/widget.py", 0, 0),
    "inline-suppressed": (_WIDGET.format(
        jobs_value="{}  # opalint: disable=untracked-shared-state"
                   " — replaced wholesale before threads start",
        worker_access='self._jobs["a"] = 1'), "tpu_operator/controllers/widget.py", 0, 1),
    "module-level": (_MODULE_LEVEL, "tpu_operator/state/pending.py", 1, 0),
}


@pytest.mark.parametrize("case", sorted(_RULE_CASES))
def test_untracked_shared_state_fixtures(case):
    src, relpath, kept_n, dropped_n = _RULE_CASES[case]

    def scenario(s):
        text, path = textwrap.dedent(s.map(src)), s.map(relpath)
        cfg = s.lint_core.LintConfig()
        project = s.lint_graph.build_from_sources({path: text}, cfg)
        ctx = s.lint_core.FileContext(path, text, ast.parse(text), cfg, project=project)
        found = list(s.lint_core.all_checkers()[_RULE]().check(ctx))
        kept, dropped = s.lint_core.apply_suppressions(found, s.lint_core.suppressions(text))
        return [(f.rule, f.line, f.col, s.unmap(f.message)) for f in kept], dropped

    kept, dropped = both(scenario)
    assert (len(kept), dropped) == (kept_n, dropped_n)
    if kept:
        assert kept[0][0] == _RULE
        assert ("PENDING" if case == "module-level" else "Widget._jobs") in kept[0][3]
