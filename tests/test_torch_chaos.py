"""The port's fault injectors (tpu_operator_torch/client/chaos.py) against the
reference's (tpu_operator/client/chaos.py).

Each scenario runs on both packages with the same seed and the same calls,
and what it observed must be equal: the faults a ``ChaosPolicy`` injects,
call by call, through the call-level ``ChaosClient`` and through the wire
(the reference's ``ChaosSession``, a ``requests.Session``; the port's
``ChaosTransport`` under its ``http.client`` ``RestClient``); the crash
sites ``crash_site`` names and ``CrashPointClient`` records; the watch
loop's recovery from chopped streams (the twins of
tests/test_watch_resume.py's two wire-fault cases); and the write batcher's
transparency to kill points (tests/test_write_batcher.py). An injected
reset is ``requests.ConnectionError`` in the reference and
``ConnectionResetError`` in the port: both are named ``reset`` here.
"""

import json
import threading
import time
import types

import pytest
import requests

from tpu_operator.client import batch as ref_batch
from tpu_operator.client import chaos as ref_chaos
from tpu_operator.client import rest as ref_rest
from tpu_operator.client.errors import ApiError as RefApiError
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.testing import MiniApiServer as RefServer
from tpu_operator_torch import consts
from tpu_operator_torch.client import batch
from tpu_operator_torch.client import chaos
from tpu_operator_torch.client import rest
from tpu_operator_torch.client.errors import ApiError
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.testing.apiserver import MiniApiServer
from tpu_operator_torch.utils import deep_get

REF = types.SimpleNamespace(
    chaos=ref_chaos, rest=ref_rest, batch=ref_batch, Fake=RefFake, Server=RefServer,
    ApiError=RefApiError,
    wire=lambda base, policy: ref_rest.RestClient(base_url=base,
                                                  session=ref_chaos.ChaosSession(policy)))
PORT = types.SimpleNamespace(
    chaos=chaos, rest=rest, batch=batch, Fake=FakeClient, Server=MiniApiServer,
    ApiError=ApiError,
    wire=lambda base, policy: rest.RestClient(
        base, transport=chaos.ChaosTransport(rest.Transport(base), policy)))
SIDES = (REF, PORT)


def _node(name="n1", labels=None):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": dict(labels or {})}}


def _pod(name, ns="ns1"):
    return {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": ns},
            "spec": {"containers": [{"name": "c", "image": "busybox"}]}}


def _outcome(side, call):
    """What one call came to: ok, 429 (with its Retry-After), 503, reset."""
    try:
        call()
        return "ok"
    except side.ApiError as e:
        if e.code == 429:
            return f"429 retry_after={e.retry_after}"
        return str(e.code)
    except (requests.ConnectionError, ConnectionResetError):
        return "reset"


def _script(client):
    """One scripted call list over every verb."""
    calls = [lambda: client.create(_node("n1"))]
    for i in range(12):
        calls += [lambda: client.get("v1", "Node", "n1"),
                  lambda: client.list("v1", "Node"),
                  lambda i=i: client.patch("v1", "Node", "n1",
                                           {"metadata": {"labels": {"i": str(i)}}}),
                  lambda i=i: client.create(_node(f"m{i}"))]
    return calls


# -- the policy's draws -----------------------------------------------------------------

def test_chaos_client_injects_the_same_faults_for_one_seed():
    seen = []
    for side in SIDES:
        policy = side.chaos.ChaosPolicy(error_rate=0.3, seed=1729)
        backend = side.Fake()
        client = side.chaos.ChaosClient(backend, policy)
        outcomes = [_outcome(side, call) for call in _script(client)]
        seen.append((outcomes, dict(policy.injected), policy.injected_total(),
                     sorted(n["metadata"]["name"] for n in backend.list("v1", "Node"))))
    assert seen[1] == seen[0]
    outcomes, injected, total, _ = seen[1]
    assert set(injected) == {"429", "503", "reset"} and total == sum(injected.values())
    assert {"ok", "reset", "503"} <= set(outcomes)


def test_exempt_verbs_skip_injection_on_both():
    for side in SIDES:
        policy = side.chaos.ChaosPolicy(error_rate=1.0, seed=3)
        client = side.chaos.ChaosClient(side.Fake(), policy, exempt=("POST", "GET"))
        client.create(_node())
        assert client.get("v1", "Node", "n1")["metadata"]["name"] == "n1"
        assert policy.injected_total() == 0


def test_the_wire_injects_the_same_faults_for_one_seed():
    """The same seed over the same requests through each package's wire
    injector and its own apiserver: the same call fails the same way."""
    seen = []
    for side in SIDES:
        srv = side.Server()
        base = srv.start()
        try:
            policy = side.chaos.ChaosPolicy(error_rate=0.35, retry_after_s=0.25, seed=1729)
            client = side.wire(base, policy)
            outcomes = [_outcome(side, call) for call in _script(client)]
            plain = side.rest.RestClient(base_url=base)
            nodes = sorted(n["metadata"]["name"] for n in plain.list("v1", "Node"))
            seen.append((outcomes, dict(policy.injected), nodes))
        finally:
            srv.stop()
    assert seen[1] == seen[0]
    assert "429 retry_after=0.25" in seen[1][0]


# -- crash sites --------------------------------------------------------------------------

def test_crash_site_normalizes_event_names_as_the_reference():
    event = {"apiVersion": "v1", "kind": "Event",
             "metadata": {"name": "gpu-a.a1b2c3d4e5f6"},
             "involvedObject": {"kind": "Node", "name": "gpu-a"},
             "reason": "NodeHealthDegraded"}
    event2 = dict(event, metadata={"name": "gpu-a.ffffffffffff"})
    for e in (event, event2):
        site = chaos.crash_site("POST", None, None, None, obj=e)
        assert site == ref_chaos.crash_site("POST", None, None, None, obj=e)
        assert site == "POST Event/Node:gpu-a:NodeHealthDegraded"


def test_a_journal_mirror_is_one_site_whatever_its_episode():
    """A decision journal's mirror ConfigMap is keyed on its record's
    subsystem, kind, trigger and decision, not on its name (the record's
    content address, which holds the episode id): the same decision in
    another run of an episode is the same site, another decision another
    site; the reference keys it on the name
    (tests/test_torch_operator_mapping.py, ``number_journal_sites``)."""
    def mirror(episode, decision):
        record = {"episode": episode, "subsystem": "health", "kind": "remediate",
                  "trigger": {"type": "attempt", "n": 1}, "decision": decision}
        return {"apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": f"prov-{episode}", "namespace": "tpu-operator",
                             "labels": {consts.PROVENANCE_LABEL: "health"}},
                "data": {"record": json.dumps(record)}}

    first = chaos.crash_site("POST", None, None, None, obj=mirror("ep-1", {"attempt": 1}))
    again = chaos.crash_site("POST", None, None, None, obj=mirror("ep-2", {"attempt": 1}))
    other = chaos.crash_site("POST", None, None, None, obj=mirror("ep-1", {"attempt": 2}))
    assert first == again != other
    assert first.startswith("POST ConfigMap/prov:health:remediate:")
    ref = [ref_chaos.crash_site("POST", None, None, None, obj=mirror(e, {"attempt": 1}))
           for e in ("ep-1", "ep-2")]
    assert ref == ["POST ConfigMap/prov-ep-1", "POST ConfigMap/prov-ep-2"]
    plain = {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "cfg"}}
    assert chaos.crash_site("POST", None, None, None, obj=plain) == "POST ConfigMap/cfg"


@pytest.mark.parametrize("patch", [
    {"metadata": {"labels": {"x": "1"}, "resourceVersion": "42"}},
    {"metadata": {"labels": {"x": "2"}}},
    {"metadata": {"annotations": {"x": "1"}}},
    {"metadata": {"annotations": {"a": None, "b": {}}, "labels": {"z": "1"}}},
    {"spec": {"unschedulable": True}},
    None,
])
def test_crash_site_patch_shape_as_the_reference(patch):
    for verb, kind in (("PATCH", "Node"), ("DELETE", "Pod")):
        assert chaos.crash_site(verb, "v1", kind, "n1", patch=patch) == \
            ref_chaos.crash_site(verb, "v1", kind, "n1", patch=patch)


@pytest.mark.parametrize("when, landed", [("before", False), ("after", True)])
def test_crash_point_client_before_and_after_as_the_reference(when, landed):
    seen = []
    for side in SIDES:
        site = side.chaos.crash_site("PATCH", "v1", "Node", "n1",
                                     patch={"metadata": {"labels": {"x": "1"}}})
        fake = side.Fake()
        fake.create(_node())
        client = side.chaos.CrashPointClient(fake, arm=(site, when))
        with pytest.raises(side.chaos.OperatorCrashed):
            client.patch("v1", "Node", "n1", {"metadata": {"labels": {"x": "1"}}})
        after = []
        for call in (lambda: client.get("v1", "Node", "n1"),
                     lambda: client.delete("v1", "Node", "n1")):
            try:
                call()
                after.append("ok")
            except side.chaos.OperatorCrashed:
                after.append("crashed")
        got = deep_get(fake.get("v1", "Node", "n1"), "metadata", "labels", "x")
        seen.append((site, client.fired, client.dead, got == "1", after))
    assert seen[1] == seen[0]
    assert seen[1][3] is landed and seen[1][4] == ["crashed", "crashed"]


def _episode(client):
    """A scripted episode over every mutating verb."""
    client.create(_node("n1"))
    client.create(_pod("w-0", "tenant"))
    client.patch("v1", "Node", "n1", {"metadata": {"labels": {"x": "1"}}})
    client.patch("v1", "Node", "n1", {"metadata": {"labels": {"x": "2"},
                                                   "resourceVersion": None}})
    client.patch("v1", "Node", "n1", {"metadata": {"annotations": {"a": "1"}}})
    node = client.get("v1", "Node", "n1")
    node["spec"] = {"unschedulable": True}
    client.update(node)
    node = client.get("v1", "Node", "n1")
    node["status"] = {"capacity": {"nvidia.com/gpu": "8"}}
    client.update_status(node)
    client.create({"apiVersion": "v1", "kind": "Event",
                   "metadata": {"name": "n1.0123", "namespace": "tenant"},
                   "involvedObject": {"kind": "Node", "name": "n1"}, "reason": "Drained"})
    client.evict("w-0", "tenant")
    client.delete("v1", "Node", "n1")


def test_crash_point_client_records_the_same_sites():
    sites = []
    for side in SIDES:
        client = side.chaos.CrashPointClient(side.Fake())
        _episode(client)
        assert not client.fired
        sites.append(client.sites)
    assert sites[1] == sites[0]
    assert sites[1][:3] == ["POST Node/n1", "POST Pod/w-0", "PATCH Node/n1 [metadata.labels.x]"]


@pytest.mark.parametrize("when", ["before", "after"])
def test_every_recorded_site_fires_on_both(when):
    record = chaos.CrashPointClient(FakeClient())
    _episode(record)
    for site in record.sites:
        fired = []
        for side in SIDES:
            client = side.chaos.CrashPointClient(side.Fake(), arm=(site, when))
            try:
                _episode(client)
            except side.chaos.OperatorCrashed:
                pass
            fired.append((client.fired, client.dead, len(client.sites)))
        assert fired[1] == fired[0] and fired[1][0], site


# -- the watch over chopped streams ---------------------------------------------------------

def _wait_for(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def _chaotic_watch_run(side, truncate_mode, monkeypatch):
    """Every watch stream is chopped after 2 events while a plain writer
    creates pods. Returns what the consumer saw: the pods delivered, the
    streamed (not relisted) events, the relist count and the faults."""
    srv = side.Server()
    base = srv.start()
    try:
        policy = side.chaos.ChaosPolicy(watch_chop_rate=1.0, truncate_mode=truncate_mode,
                                        chop_after_lines=2, seed=7)
        watcher = side.wire(base, policy)
        writer = side.rest.RestClient(base_url=base)
        writer.create(_pod("seed"))
        relists = {"n": 0}
        real_relist = side.rest._RestWatch._relist

        def counting_relist(self):
            relists["n"] += 1
            return real_relist(self)

        monkeypatch.setattr(side.rest._RestWatch, "_relist", counting_relist)
        streamed, relisted = [], set()
        lock = threading.RLock()

        def handler(ev):
            with lock:
                streamed.append((ev.type, ev.object["metadata"]["name"],
                                 ev.object["metadata"].get("resourceVersion"),
                                 ev.object.get("kind")))

        def on_relist(items, rv):
            with lock:
                relisted.update(i["metadata"]["name"] for i in items)

        def seen():
            with lock:
                return {name for _, name, _, _ in streamed} | relisted

        handle = watcher.watch("v1", "Pod", "ns1", handler, relist_handler=on_relist)
        try:
            assert _wait_for(lambda: "seed" in seen())
            expected = {"seed"} | {f"p{i}" for i in range(6)}
            for i in range(6):
                writer.create(_pod(f"p{i}"))
            assert _wait_for(lambda: expected <= seen(), timeout=30)
            with lock:
                return {"lost": sorted(expected - seen()), "streamed": list(streamed),
                        "relists": relists["n"], "faults": policy.injected_total(),
                        "kinds": set(policy.injected)}
        finally:
            handle.stop()
            monkeypatch.undo()
    finally:
        srv.stop()


@pytest.mark.parametrize("mode", ["drop", "truncate"])
def test_watch_resumes_after_chopped_streams_as_the_reference(mode, monkeypatch):
    """The twins of tests/test_watch_resume.py's drop and truncate cases:
    every pod arrives on both; each package relists at most once per
    chopped stream; the port's stream delivers no event twice (a resume
    starts after the last whole event) and no wire garbage."""
    ref = _chaotic_watch_run(REF, mode, monkeypatch)
    port = _chaotic_watch_run(PORT, mode, monkeypatch)
    for got in (ref, port):
        assert got["lost"] == []
        assert got["faults"] > 0 and got["relists"] <= 1 + got["faults"]
        assert got["kinds"] == {f"watch-{mode}"}
        assert all(t in ("ADDED", "MODIFIED", "DELETED") and kind != "Status"
                   for t, _, _, kind in got["streamed"])
    events = [(t, name, rv) for t, name, rv, _ in port["streamed"]]
    assert len(events) == len(set(events))


# -- the write batcher is transparent to kill points --------------------------------------

def _batched_episode(side, client):
    batcher = side.batch.find_batcher(client)
    with side.batch.batch_window(batcher):
        side.batch.coalesced_patch(batcher, "v1", "Node", "n1",
                                   {"metadata": {"labels": {"tpu.ai/state": "ready"}}})
        side.batch.coalesced_patch(batcher, "v1", "Node", "n1",
                                   {"metadata": {"annotations": {"tpu.ai/since": "t0"}}})


def test_batched_writes_are_one_crash_site_as_the_reference():
    """The twin of tests/test_write_batcher.py's chaos-transparency case:
    two deferred writes fold into one merged site, a replay records the
    same site, and a kill before it leaves no part of the batch."""
    seen = []
    for side in SIDES:
        runs = []
        for _ in range(2):
            backend = side.Fake()
            backend.create(_node())
            cpc = side.chaos.CrashPointClient(backend)
            b = side.batch.WriteBatcher(cpc, max_delay_s=None)
            try:
                _batched_episode(side, b)
            finally:
                b.stop()
            runs.append(cpc.sites)
        assert runs[0] == runs[1] and len(runs[0]) == 1
        armed = side.chaos.CrashPointClient(side.Fake(), arm=(runs[0][0], "before"))
        armed.inner.create(_node())
        b = side.batch.WriteBatcher(armed, max_delay_s=None)
        with pytest.raises(side.chaos.OperatorCrashed):
            _batched_episode(side, b)
        meta = armed.inner.get("v1", "Node", "n1")["metadata"]
        seen.append((runs[0], armed.fired, "tpu.ai/state" in (meta.get("labels") or {}),
                     "tpu.ai/since" in (meta.get("annotations") or {})))
    assert seen[1] == seen[0]
    assert seen[1][1:] == (True, False, False)
