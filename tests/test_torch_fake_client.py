"""The twin of tests/test_fake_client.py: the reference's cases on the
port's in-memory apiserver (``tpu_operator_torch/client/fake.py``), its
per-pool driver kind the ``GPUDriver``; and one script of writes, reads and
evictions through both packages' fakes, which must leave the same objects,
raise the same errors and deliver the same watch events.
"""

import copy

import pytest

from tpu_operator_torch.api.gpudriver import GPU_DRIVER_API_VERSION, GPU_DRIVER_KIND
from tpu_operator_torch.client import FakeClient

from tpu_operator_torch.client import ConflictError, NotFoundError
from tpu_operator_torch.client.errors import AlreadyExistsError



@pytest.fixture
def fake_client():
    return FakeClient()


def _gpu_driver(name, spec):
    return {"apiVersion": GPU_DRIVER_API_VERSION, "kind": GPU_DRIVER_KIND,
            "metadata": {"name": name}, "spec": spec}

def mk_pod(name, ns="default", labels=None, node=None):
    pod = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": ns, "labels": labels or {}},
        "spec": {},
    }
    if node:
        pod["spec"]["nodeName"] = node
    return pod


def test_create_get_roundtrip(fake_client):
    created = fake_client.create(mk_pod("p1"))
    assert created["metadata"]["uid"]
    assert created["metadata"]["resourceVersion"]
    got = fake_client.get("v1", "Pod", "p1", "default")
    assert got["metadata"]["uid"] == created["metadata"]["uid"]


def test_create_duplicate_fails(fake_client):
    fake_client.create(mk_pod("p1"))
    with pytest.raises(AlreadyExistsError):
        fake_client.create(mk_pod("p1"))


def test_get_missing_raises(fake_client):
    with pytest.raises(NotFoundError):
        fake_client.get("v1", "Pod", "nope")


def test_list_with_selectors(fake_client):
    fake_client.create(mk_pod("a", labels={"app": "x"}, node="n1"))
    fake_client.create(mk_pod("b", labels={"app": "y"}, node="n1"))
    fake_client.create(mk_pod("c", labels={"app": "x"}, node="n2"))
    assert len(fake_client.list("v1", "Pod")) == 3
    assert [p["metadata"]["name"] for p in fake_client.list("v1", "Pod", label_selector={"app": "x"})] == ["a", "c"]
    assert [p["metadata"]["name"] for p in fake_client.list(
        "v1", "Pod", label_selector={"app": "x"}, field_selector={"spec.nodeName": "n1"})] == ["a"]
    # exists-style selector
    assert len(fake_client.list("v1", "Pod", label_selector={"app": None})) == 3


def test_update_conflict_on_stale_rv(fake_client):
    created = fake_client.create(mk_pod("p1"))
    stale = copy.deepcopy(created)
    created["spec"]["nodeName"] = "n1"
    fake_client.update(created)
    stale["spec"]["nodeName"] = "n2"
    with pytest.raises(ConflictError):
        fake_client.update(stale)


def test_noop_update_does_not_bump_rv_or_notify(fake_client):
    # mirrors the real apiserver: identical PUT is a no-op (no watch event),
    # which is what keeps status-writing controllers from self-triggering
    created = fake_client.create(mk_pod("p1"))
    seen = []
    fake_client.watch("v1", "Pod", handler=seen.append)
    updated = fake_client.update(created)
    assert updated["metadata"]["resourceVersion"] == created["metadata"]["resourceVersion"]
    fake_client.update_status(updated)  # empty -> empty status: also a no-op
    assert seen == []


def test_update_bumps_generation_only_on_spec_change(fake_client):
    created = fake_client.create(mk_pod("p1"))
    assert created["metadata"]["generation"] == 1
    created["spec"]["nodeName"] = "n9"
    updated = fake_client.update(created)
    assert updated["metadata"]["generation"] == 2
    updated["metadata"]["labels"] = {"z": "1"}
    again = fake_client.update(updated)
    assert again["metadata"]["generation"] == 2


def test_patch_merge_and_null_delete(fake_client):
    fake_client.create(mk_pod("p1", labels={"keep": "1", "drop": "2"}))
    fake_client.patch("v1", "Pod", "p1", {"metadata": {"labels": {"drop": None, "new": "3"}}}, "default")
    got = fake_client.get("v1", "Pod", "p1")
    assert got["metadata"]["labels"] == {"keep": "1", "new": "3"}


def test_patch_preserves_unrelated_nulls(fake_client):
    # RFC 7386: only nulls present in the patch document delete keys.
    pod = mk_pod("p1")
    pod["spec"]["tolerations"] = None
    fake_client.create(pod)
    fake_client.patch("v1", "Pod", "p1", {"metadata": {"labels": {"a": "1"}}}, "default")
    got = fake_client.get("v1", "Pod", "p1")
    assert "tolerations" in got["spec"] and got["spec"]["tolerations"] is None


def test_status_subresource_does_not_touch_spec_or_generation(fake_client):
    created = fake_client.create(mk_pod("p1"))
    created["status"] = {"phase": "Running"}
    created["spec"] = {"mutated": True}  # must be ignored by update_status
    updated = fake_client.update_status(created)
    assert updated["status"] == {"phase": "Running"}
    live = fake_client.get("v1", "Pod", "p1")
    assert live["metadata"]["generation"] == 1


def test_owner_reference_cascade_delete(fake_client):
    owner = fake_client.create({
        "apiVersion": "apps/v1", "kind": "DaemonSet",
        "metadata": {"name": "ds", "namespace": "default"}, "spec": {},
    })
    child = mk_pod("child")
    child["metadata"]["ownerReferences"] = [{
        "apiVersion": "apps/v1", "kind": "DaemonSet",
        "name": "ds", "uid": owner["metadata"]["uid"],
    }]
    fake_client.create(child)
    fake_client.delete("apps/v1", "DaemonSet", "ds", "default")
    with pytest.raises(NotFoundError):
        fake_client.get("v1", "Pod", "child")


def test_watch_delivers_events(fake_client):
    seen = []
    handle = fake_client.watch("v1", "Pod", handler=seen.append)
    fake_client.create(mk_pod("p1"))
    fake_client.delete("v1", "Pod", "p1", "default")
    assert [e.type for e in seen] == ["ADDED", "DELETED"]
    handle.stop()
    fake_client.create(mk_pod("p2"))
    assert len(seen) == 2


def test_cluster_scoped_objects(fake_client):
    fake_client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n1"}})
    got = fake_client.get("v1", "Node", "n1")
    assert "namespace" not in got["metadata"] or not got["metadata"].get("namespace")


def test_unregistered_kind_raises_distinct_kind_error(fake_client):
    """A typo'd kind must surface as KindNotServedError — which the many
    `except NotFoundError` (= object absent) sites do NOT swallow — so
    programming errors stay loud."""
    from tpu_operator_torch.client import KindNotServedError

    with pytest.raises(KindNotServedError):
        fake_client.get("tpu.ai/v1", "ClusterPolcy", "x")  # note the typo
    assert not issubclass(KindNotServedError, NotFoundError)
    # ...but it still carries the API-server-compatible 404 code
    assert KindNotServedError.code == 404


def test_schema_admission_covers_every_write_path(fake_client):
    """create, update, PATCH and the status subresource all route through
    CRD schema admission — no write path can rubber-stamp an object a real
    apiserver rejects."""
    from tpu_operator_torch.client.errors import InvalidError

    with pytest.raises(InvalidError):
        fake_client.create(_gpu_driver("bad", {"driverType": "unknown"}))

    fake_client.create(_gpu_driver("ok", {"image": "img"}))
    with pytest.raises(InvalidError):
        fake_client.patch("tpu.ai/v1alpha1", "GPUDriver", "ok",
                          {"spec": {"driverType": "unknown"}})
    live = fake_client.get("tpu.ai/v1alpha1", "GPUDriver", "ok")
    live["spec"]["imagePullPolicy"] = "Sometimes"
    with pytest.raises(InvalidError):
        fake_client.update(live)
    live = fake_client.get("tpu.ai/v1alpha1", "GPUDriver", "ok")
    live["status"] = {"state": "sort-of-ready"}
    with pytest.raises(InvalidError):
        fake_client.update_status(live)
    # the object survived every rejected write untouched
    final = fake_client.get("tpu.ai/v1alpha1", "GPUDriver", "ok")
    assert final["spec"].get("driverType", "standard") == "standard"
    assert "status" not in final or not final["status"].get("state")


# -- eviction PDB semantics: an empty selector, maxUnavailable -----------------

def _mk_pod(name, ns="ns1", labels=None, phase="Running"):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns,
                         "labels": labels or {}},
            "spec": {}, "status": {"phase": phase}}


def _mk_pdb(name, ns="ns1", selector=None, **spec):
    return {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"selector": {"matchLabels": selector or {}}, **spec}}


def test_empty_selector_pdb_matches_all_pods(fake_client):
    """policy/v1: an empty selector selects every pod in the namespace —
    skipping it would permit evictions a real apiserver rejects with 429."""
    from tpu_operator_torch.client.errors import TooManyRequestsError

    fake_client.create(_mk_pod("w", labels={"app": "x"}))
    fake_client.create(_mk_pdb("all", selector={}, minAvailable=1))
    with pytest.raises(TooManyRequestsError):
        fake_client.evict("w", "ns1")


def test_max_unavailable_headroom(fake_client):
    from tpu_operator_torch.client.errors import TooManyRequestsError

    for i in range(3):
        fake_client.create(_mk_pod(f"w{i}", labels={"app": "x"}))
    fake_client.create(_mk_pdb("pdb", selector={"app": "x"}, maxUnavailable=1))
    fake_client.evict("w0", "ns1")  # one disruption allowed
    # w0 gone -> 2 matching, all healthy, but 1 is already disrupted
    # relative to the original 3... the controller recomputes from current
    # state: 2 matching, 2 healthy, maxUnavailable=1 -> headroom 1
    fake_client.evict("w1", "ns1")
    # now only w2 remains; an unhealthy pod consumes the headroom
    fake_client.create(_mk_pod("w3", labels={"app": "x"}, phase="Failed"))
    with pytest.raises(TooManyRequestsError):
        fake_client.evict("w2", "ns1")


def test_pdb_with_neither_bound_blocks(fake_client):
    """A PDB without minAvailable or maxUnavailable (invalid upstream, but
    representable) fails closed."""
    from tpu_operator_torch.client.errors import TooManyRequestsError

    fake_client.create(_mk_pod("w", labels={"app": "x"}))
    fake_client.create(_mk_pdb("pdb", selector={"app": "x"}))
    with pytest.raises(TooManyRequestsError):
        fake_client.evict("w", "ns1")


def test_create_against_deleted_owner_is_garbage_collected(fake_client):
    """The owner-deleted-mid-sweep race: a reconcile in flight when its CR
    is deleted re-creates operands owned by the now-gone uid. The real GC
    removes them shortly after; the fake does so immediately — else they
    live forever and uninstall never converges. Never-created owner uids
    are NOT collected (fixture convenience: pods 'owned' by a DS the test
    didn't bother creating)."""
    owner = fake_client.create({"apiVersion": "tpu.ai/v1",
                                "kind": "ClusterPolicy",
                                "metadata": {"name": "cluster-policy"},
                                "spec": {}})
    dead_uid = owner["metadata"]["uid"]
    fake_client.delete("tpu.ai/v1", "ClusterPolicy", "cluster-policy")

    fake_client.create({"apiVersion": "apps/v1", "kind": "DaemonSet",
                        "metadata": {"name": "orphan", "namespace": "ns",
                                     "ownerReferences": [{
                                         "kind": "ClusterPolicy",
                                         "name": "cluster-policy",
                                         "uid": dead_uid,
                                         "controller": True}]},
                        "spec": {}})
    assert fake_client.list("apps/v1", "DaemonSet", "ns") == []

    # never-created owner uid: stays (fixtures rely on this)
    fake_client.create({"apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": "ds-pod", "namespace": "ns",
                                     "ownerReferences": [{
                                         "kind": "DaemonSet",
                                         "name": "user-ds",
                                         "uid": "never-existed",
                                         "controller": True}]},
                        "spec": {}})
    assert fake_client.get("v1", "Pod", "ds-pod", "ns")


def _script(client, errors):
    """Writes, reads and evictions: each step's error class name or None."""
    def step(fn, *args):
        try:
            fn(*args)
            return None
        except Exception as e:  # the class name is what is compared
            return type(e).__name__

    pods = [_mk_pod(f"w{i}", labels={"app": "x" if i % 2 else "y"},
                    phase="Running" if i % 3 else "Failed") for i in range(6)]
    for pod in pods:
        errors.append(step(client.create, copy.deepcopy(pod)))
    errors.append(step(client.create, copy.deepcopy(pods[0])))  # AlreadyExists
    errors.append(step(client.get, "v1", "Pod", "nope", "ns1"))  # NotFound
    client.create(_mk_pdb("pdb", selector={"app": "x"}, maxUnavailable=1))
    for name in ("w1", "w3", "w5", "w0"):
        errors.append(step(client.evict, name, "ns1"))
    live = client.get("v1", "Pod", "w2", "ns1")
    stale = copy.deepcopy(live)
    live["spec"]["nodeName"] = "n1"
    errors.append(step(client.update, live))
    stale["spec"]["nodeName"] = "n2"
    errors.append(step(client.update, stale))  # Conflict
    errors.append(step(client.patch, "v1", "Pod", "w2",
                       {"metadata": {"labels": {"app": None, "new": "1"}}}, "ns1"))
    live = client.get("v1", "Pod", "w2", "ns1")
    live["status"] = {"phase": "Succeeded"}
    errors.append(step(client.update_status, live))
    errors.append(step(client.delete, "v1", "Pod", "w4", "ns1"))
    errors.append(step(client.get, "tpu.ai/v1", "ClusterPolcy", "x"))  # KindNotServed


def _view(obj):
    meta = {k: v for k, v in obj["metadata"].items()
            if k not in ("uid", "creationTimestamp", "resourceVersion")}
    return dict(obj, metadata=meta)


def test_both_packages_fakes_answer_one_script_alike():
    from tpu_operator.client import FakeClient as RefFake

    seen = {}
    for name, fake in (("port", FakeClient), ("reference", RefFake)):
        client, errors, events = fake(), [], []
        client.watch("v1", "Pod", handler=lambda e, out=events: out.append(
            (e.type, e.object["metadata"]["name"])))
        _script(client, errors)
        seen[name] = {"errors": errors, "events": events,
                      "pods": [_view(p) for p in client.list("v1", "Pod", "ns1")]}
    assert seen["port"] == seen["reference"]
    assert "AlreadyExistsError" in seen["port"]["errors"]
    assert "TooManyRequestsError" in seen["port"]["errors"]
