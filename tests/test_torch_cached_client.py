"""The port's informer cache (``client/cache.py``) twin for twin with the
reference's tests/test_cached_client.py.

Each scenario runs once on the reference's stack (its CachedClient over its
FakeClient, or over its RestClient and MiniApiServer) and once on the
port's, and returns what it observed; the two observations must be equal,
and the reference's own assertions hold on them. Every wait has its own
timeout.
"""

import threading
import time
import types

import pytest

from tpu_operator.client import cache as ref_cache
from tpu_operator.client.errors import ConflictError as RefConflict
from tpu_operator.client.errors import NotFoundError as RefNotFound
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.client.rest import RestClient as RefRest
from tpu_operator.testing import MiniApiServer as RefServer
from tpu_operator_torch.client import cache as port_cache
from tpu_operator_torch.client.errors import ConflictError, NotFoundError
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.client.rest import RestClient
from tpu_operator_torch.testing.apiserver import MiniApiServer

REF = types.SimpleNamespace(cache=ref_cache, Fake=RefFake, Rest=RefRest, Server=RefServer,
                            NotFound=RefNotFound, Conflict=RefConflict)
PORT = types.SimpleNamespace(cache=port_cache, Fake=FakeClient, Rest=RestClient,
                             Server=MiniApiServer, NotFound=NotFoundError, Conflict=ConflictError)


def both(scenario):
    """The scenario's observation on the reference's stack and on the
    port's: they must be equal."""
    want = scenario(REF)
    got = scenario(PORT)
    assert got == want
    return got


def _pod(name, ns="default", labels=None):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns,
                         **({"labels": labels} if labels else {})},
            "spec": {}, "status": {"phase": "Running"}}


def _node(name, labels=None):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, **({"labels": labels} if labels else {})},
            "spec": {}, "status": {}}


def _wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def _names(objs):
    return sorted(o["metadata"]["name"] for o in objs)


def _raises(m, fn):
    try:
        fn()
    except m.NotFound:
        return "NotFound"
    except m.Conflict:
        return "Conflict"
    return "ok"


# -- FakeClient backend ------------------------------------------------------------

def test_cache_serves_preexisting_and_live_objects():
    def scenario(m):
        backend = m.Fake()
        backend.create(_pod("a"))
        cached = m.cache.CachedClient(backend)
        first = cached.get("v1", "Pod", "a")["metadata"]["name"]
        backend.create(_pod("b"))
        live = _wait_for(lambda: "b" in _names(cached.list("v1", "Pod", "default")))
        return first, live

    assert both(scenario) == ("a", True)


def test_cache_get_missing_raises_not_found():
    def scenario(m):
        cached = m.cache.CachedClient(m.Fake())
        return _raises(m, lambda: cached.get("v1", "Pod", "nope"))

    assert both(scenario) == "NotFound"


def test_cache_list_selectors_and_scoping():
    def scenario(m):
        backend = m.Fake()
        backend.create(_pod("a", ns="ns1", labels={"app": "x"}))
        backend.create(_pod("b", ns="ns1", labels={"app": "y"}))
        backend.create(_pod("c", ns="ns2", labels={"app": "x"}))
        cached = m.cache.CachedClient(backend)
        return (_names(cached.list("v1", "Pod")),
                _names(cached.list("v1", "Pod", "ns1", label_selector={"app": "x"})),
                _names(cached.list("v1", "Pod", "ns2", field_selector={"metadata.name": "c"})))

    assert both(scenario) == (["a", "b", "c"], ["a"], ["c"])


def test_cache_write_through_and_delete():
    def scenario(m):
        cached = m.cache.CachedClient(m.Fake())
        cached.create(_node("n1"))
        seen = [cached.get("v1", "Node", "n1")["metadata"]["name"]]
        got = cached.get("v1", "Node", "n1")
        got["metadata"].setdefault("labels", {})["x"] = "1"
        cached.update(got)
        seen.append(cached.get("v1", "Node", "n1")["metadata"]["labels"]["x"])
        cached.delete("v1", "Node", "n1")
        seen.append(_raises(m, lambda: cached.get("v1", "Node", "n1")))
        return seen

    assert both(scenario) == ["n1", "1", "NotFound"]


def test_cache_read_mutation_does_not_poison_store():
    def scenario(m):
        backend = m.Fake()
        backend.create(_node("n1"))
        cached = m.cache.CachedClient(backend)
        cached.get("v1", "Node", "n1")["metadata"]["name"] = "mutated"
        return cached.get("v1", "Node", "n1")["metadata"]["name"]

    assert both(scenario) == "n1"


def test_stale_cached_rv_write_surfaces_conflict():
    def scenario(m):
        backend = m.Fake()
        backend.create(_node("n1"))
        cached = m.cache.CachedClient(backend)
        stale = cached.get("v1", "Node", "n1")
        fresh = backend.get("v1", "Node", "n1")
        fresh["metadata"].setdefault("labels", {})["winner"] = "yes"
        backend.update(fresh)
        stale["metadata"].setdefault("labels", {})["winner"] = "no"
        return _raises(m, lambda: cached.update(stale))

    assert both(scenario) == "Conflict"


def test_out_of_order_events_do_not_regress_cache():
    def scenario(m):
        cached = m.cache.CachedClient(m.Fake())
        cached.create(_node("n1"))
        newer = cached.get("v1", "Node", "n1")
        newer["metadata"].setdefault("labels", {})["v"] = "2"
        cached.update(newer)
        informer = next(iter(cached._informers.values()))
        informer.apply("MODIFIED", {"apiVersion": "v1", "kind": "Node",
                                    "metadata": {"name": "n1", "resourceVersion": "1"}})
        return cached.get("v1", "Node", "n1")["metadata"]["labels"]["v"]

    assert both(scenario) == "2"


def test_shared_informer_watch_replays_and_streams():
    def scenario(m):
        backend = m.Fake()
        backend.create(_node("pre"))
        cached = m.cache.CachedClient(backend)
        events = []
        handle = cached.watch("v1", "Node", handler=events.append)
        seen = [_wait_for(lambda: any(e.object["metadata"]["name"] == "pre"
                                      and e.type == "ADDED" for e in events))]
        backend.create(_node("live"))
        seen.append(_wait_for(lambda: any(e.object["metadata"]["name"] == "live"
                                          for e in events)))
        backend.delete("v1", "Node", "live")
        seen.append(_wait_for(lambda: any(e.type == "DELETED" for e in events)))
        handle.stop()
        backend.create(_node("after-stop"))
        time.sleep(0.1)
        seen.append(any(e.object["metadata"]["name"] == "after-stop" for e in events))
        return seen, [(e.type, e.object["metadata"]["name"]) for e in events]

    seen, _ = both(scenario)
    assert seen == [True, True, True, False]


def test_superset_informer_retires_subscriberless_scoped_ones():
    def scenario(m):
        backend = m.Fake()
        backend.create(_pod("a", ns="ns1"))
        backend.create(_pod("b", ns="ns2"))
        cached = m.cache.CachedClient(backend)
        cached.list("v1", "Pod", "ns1")
        events = []
        cached.watch("v1", "Pod", "ns2", handler=events.append)
        before = len(cached._informers)
        cached.list("v1", "Pod")
        keys = sorted(cached._informers, key=str)
        backend.create(_pod("c", ns="ns2"))
        live = _wait_for(lambda: any(e.object["metadata"]["name"] == "c" for e in events))
        return before, keys, live, _names(cached.list("v1", "Pod", "ns1"))

    before, keys, live, ns1 = both(scenario)
    assert before == 2 and live and ns1 == ["a"]
    assert ("v1", "Pod", None) in keys and ("v1", "Pod", "ns2") in keys
    assert ("v1", "Pod", "ns1") not in keys


def test_unsyncable_informer_degrades_to_direct_reads(monkeypatch):
    def scenario(m):
        class NeverSyncs(m.Fake):
            def watch(self, api_version, kind, namespace=None, handler=None,
                      relist_handler=None):
                return super().watch(api_version, kind, namespace, handler)

        monkeypatch.setattr(m.cache, "SYNC_TIMEOUT_S", 0.3)
        backend = NeverSyncs()
        backend.create(_node("n1"))
        cached = m.cache.CachedClient(backend)
        t0 = time.monotonic()
        name = cached.get("v1", "Node", "n1")["metadata"]["name"]
        first = time.monotonic() - t0
        t0 = time.monotonic()
        for _ in range(5):
            cached.get("v1", "Node", "n1")
        rest = time.monotonic() - t0
        return name, first >= 0.3, rest < 0.3 * 5

    assert both(scenario) == ("n1", True, True)


def test_scoped_watch_from_superset_informer_is_filtered():
    def scenario(m):
        backend = m.Fake()
        backend.create(_pod("pre-ns1", ns="ns1"))
        backend.create(_pod("pre-ns2", ns="ns2"))
        cached = m.cache.CachedClient(backend)
        cached.list("v1", "Pod")
        events = []
        handle = cached.watch("v1", "Pod", "ns1", handler=events.append)
        ok = _wait_for(lambda: any(e.object["metadata"]["name"] == "pre-ns1" for e in events))
        backend.create(_pod("live-ns1", ns="ns1"))
        backend.create(_pod("live-ns2", ns="ns2"))
        ok = ok and _wait_for(lambda: any(e.object["metadata"]["name"] == "live-ns1"
                                          for e in events))
        handle.stop()
        return ok, sorted({e.object["metadata"]["name"] for e in events})

    assert both(scenario) == (True, ["live-ns1", "pre-ns1"])


def test_no_deadlock_mapper_reads_during_event_delivery():
    def scenario(m):
        backend = m.Fake()
        cached = m.cache.CachedClient(backend)

        def mapper(event):
            cached.list("v1", "ConfigMap", "default")
            cached.list("v1", "Pod", "default")

        cached.watch("v1", "Pod", "default", handler=mapper)
        errors = []

        def writer():
            for i in range(200):
                try:
                    backend.create(_pod(f"w{i}"))
                except Exception as e:
                    errors.append(e)
                    return

        def reader():
            for api_version, kind, ns in (("v1", "Node", None), ("v1", "Service", None),
                                          ("v1", "Event", None), ("v1", "ServiceAccount", None),
                                          ("apps/v1", "DaemonSet", "default"),
                                          ("coordination.k8s.io/v1", "Lease", "default")):
                try:
                    cached.list(api_version, kind, ns)
                except Exception as e:
                    errors.append(e)
                    return

        threads = [threading.Thread(target=writer, daemon=True),
                   threading.Thread(target=reader, daemon=True)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        return [t.is_alive() for t in threads], errors, len(backend.list("v1", "Pod"))

    assert both(scenario) == ([False, False], [], 200)


# -- over the wire -------------------------------------------------------------------

def _serving(m, scenario, **server_kw):
    srv = m.Server(**server_kw)
    base = srv.start()
    cached = m.cache.CachedClient(m.Rest(base_url=base))
    try:
        return scenario(srv, m.Rest(base_url=base), cached)
    finally:
        cached.stop()
        srv.stop()


def test_shared_informer_one_stream_many_watchers():
    def scenario(m):
        def run(srv, writer, cached):
            writer.create(_node("n1"))
            sinks = [[] for _ in range(3)]
            handles = [cached.watch("v1", "Node", handler=s.append) for s in sinks]
            _wait_for(lambda: all(s for s in sinks), timeout=5)
            time.sleep(0.3)
            t0 = srv.request_count
            writer.create(_node("n2"))
            reached = _wait_for(lambda: all(
                any(e.object["metadata"]["name"] == "n2" for e in s) for s in sinks))
            extra = srv.request_count - t0
            sinks[0][0].object["metadata"]["name"] = "mutated"
            for h in handles:
                h.stop()
            return reached, extra <= 1, sinks[1][0].object["metadata"]["name"]
        return _serving(m, run)

    assert both(scenario) == (True, True, "n1")


def test_cache_over_the_wire_sync_and_events():
    def scenario(m):
        def run(srv, writer, cached):
            writer.create(_pod("a", ns="ns1"))
            seen = [cached.get("v1", "Pod", "a", "ns1")["metadata"]["name"]]
            writer.create(_pod("b", ns="ns1"))
            seen.append(_wait_for(lambda: "b" in _names(cached.list("v1", "Pod", "ns1"))))
            writer.delete("v1", "Pod", "a", "ns1")
            seen.append(_wait_for(
                lambda: _raises(m, lambda: cached.get("v1", "Pod", "a", "ns1")) == "NotFound"))
            return seen
        return _serving(m, run)

    assert both(scenario) == ["a", True, True]


def test_cache_410_resync_purges_entry_deleted_in_the_gap():
    def scenario(m):
        def run(srv, writer, cached):
            writer.create(_pod("doomed", ns="ns1"))
            writer.create(_pod("stays", ns="ns1"))
            seen = [cached.get("v1", "Pod", "doomed", "ns1")["metadata"]["name"]]
            events = []
            handle = cached.watch("v1", "Pod", "ns1", handler=events.append)
            time.sleep(0.5)  # the idle close; then a delete and churn in the gap
            writer.delete("v1", "Pod", "doomed", "ns1")
            writer.create(_pod("churn", ns="ns1"))
            seen.append(_wait_for(lambda: _raises(
                m, lambda: cached.get("v1", "Pod", "doomed", "ns1")) == "NotFound"))
            seen.append(cached.get("v1", "Pod", "stays", "ns1")["metadata"]["name"])
            seen.append(_wait_for(lambda: any(
                e.type == "DELETED" and e.object["metadata"]["name"] == "doomed"
                for e in events)))
            handle.stop()
            return seen
        return _serving(m, run, watch_idle_timeout_s=0.3)

    assert both(scenario) == ["doomed", True, "stays", True]


def test_cache_read_amplification_one_list_per_kind():
    def scenario(m):
        def run(srv, writer, cached):
            for i in range(20):
                writer.create(_node(f"n{i}"))
            cached.get("v1", "Node", "n0")
            time.sleep(0.5)
            t0 = srv.request_count
            for i in range(20):
                cached.get("v1", "Node", f"n{i}")
            cached.list("v1", "Node")
            return srv.request_count - t0
        return _serving(m, run)

    assert both(scenario) == 0


def test_the_port_server_counts_by_verb_and_kind():
    srv = MiniApiServer()
    base = srv.start()
    try:
        client = RestClient(base_url=base)
        client.create(_node("n1"))
        client.get("v1", "Node", "n1")
        client.list("v1", "Node")
        client.patch("v1", "Node", "n1", {"metadata": {"labels": {"a": "b"}}})
        node = client.get("v1", "Node", "n1")
        client.update_status(node)
        client.delete("v1", "Node", "n1")
        assert srv.requests[("GET", "Node")] == 2
        assert srv.requests[("PUT/status", "Node")] == 1
        counts = srv.request_counts()
        assert (counts["POST"], counts["LIST"], counts["PATCH"], counts["DELETE"]) == (1, 1, 1, 1)
        assert counts["write"] == 4 and srv.request_count == 7
    finally:
        srv.stop()


@pytest.mark.parametrize("verb", ["GET", "LIST"])
def test_reads_through_the_cache_reach_the_wire_once(verb):
    """The join's read load through the chain: after the first read starts
    the informer, reads of the kind cost no request."""
    srv = MiniApiServer()
    base = srv.start()
    cached = port_cache.CachedClient(RestClient(base_url=base))
    try:
        RestClient(base_url=base).create(_node("n1"))
        for _ in range(5):
            if verb == "GET":
                cached.get("v1", "Node", "n1")
            else:
                cached.list("v1", "Node")
        assert srv.requests[("LIST", "Node")] == 1
        assert srv.requests[("GET", "Node")] == 0
    finally:
        cached.stop()
        srv.stop()
