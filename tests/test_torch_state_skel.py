"""The twin of tests/test_state_skel.py: the reference's cases on the
port's ``StateSkel`` (``tpu_operator_torch/state/skel.py``): owner, state
label and hash on apply, the hash skip, Service fields kept, the readiness
math, the sync-state walk, deletes, drift healed and its damping; and one
sequence of applies, drifts and deletes through both packages' skeletons,
which must leave the same objects and take the same writes.
"""

import copy

import pytest

from tpu_operator import state as ref_state
from tpu_operator.client import FakeClient as RefFake
from tpu_operator_torch import consts
from tpu_operator_torch.client import FakeClient, NotFoundError
from tpu_operator_torch.state import StateSkel, SyncState
from tpu_operator_torch.state.skel import is_daemonset_ready



@pytest.fixture
def fake_client():
    return FakeClient()

def mk_ds(name="ds1", image="img:1"):
    return {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": {"name": name, "namespace": "tpu-operator"},
        "spec": {"template": {"spec": {"containers": [{"name": "c", "image": image}]}}},
    }


def mk_owner(fake_client):
    return fake_client.create({
        "apiVersion": "tpu.ai/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "cluster-policy"}, "spec": {},
    })


def test_apply_sets_owner_state_label_and_hash(fake_client):
    skel = StateSkel("state-driver", fake_client)
    owner = mk_owner(fake_client)
    applied = skel.create_or_update_objs([mk_ds()], owner=owner)
    live = fake_client.get("apps/v1", "DaemonSet", "ds1", "tpu-operator")
    assert live["metadata"]["labels"][consts.STATE_LABEL] == "state-driver"
    assert live["metadata"]["ownerReferences"][0]["uid"] == owner["metadata"]["uid"]
    assert consts.SPEC_HASH_ANNOTATION in live["metadata"]["annotations"]
    assert applied[0]["metadata"]["resourceVersion"]


def test_unchanged_daemonset_skips_write(fake_client):
    skel = StateSkel("s", fake_client)
    skel.create_or_update_objs([mk_ds()])
    rv1 = fake_client.get("apps/v1", "DaemonSet", "ds1", "tpu-operator")["metadata"]["resourceVersion"]
    skel.create_or_update_objs([mk_ds()])
    rv2 = fake_client.get("apps/v1", "DaemonSet", "ds1", "tpu-operator")["metadata"]["resourceVersion"]
    assert rv1 == rv2  # hash-skip: no API write


def test_changed_daemonset_updates(fake_client):
    skel = StateSkel("s", fake_client)
    skel.create_or_update_objs([mk_ds(image="img:1")])
    skel.create_or_update_objs([mk_ds(image="img:2")])
    live = fake_client.get("apps/v1", "DaemonSet", "ds1", "tpu-operator")
    assert live["spec"]["template"]["spec"]["containers"][0]["image"] == "img:2"


def test_update_preserves_service_cluster_ip(fake_client):
    skel = StateSkel("s", fake_client)
    svc = {"apiVersion": "v1", "kind": "Service",
           "metadata": {"name": "svc", "namespace": "tpu-operator"},
           "spec": {"ports": [{"port": 9400}]}}
    skel.create_or_update_objs([svc])
    # apiserver allocates a clusterIP
    live = fake_client.get("v1", "Service", "svc", "tpu-operator")
    live["spec"]["clusterIP"] = "10.0.0.42"
    fake_client.update(live)
    svc2 = {"apiVersion": "v1", "kind": "Service",
            "metadata": {"name": "svc", "namespace": "tpu-operator"},
            "spec": {"ports": [{"port": 9401}]}}
    skel.create_or_update_objs([svc2])
    live = fake_client.get("v1", "Service", "svc", "tpu-operator")
    assert live["spec"]["clusterIP"] == "10.0.0.42"
    assert live["spec"]["ports"][0]["port"] == 9401


def test_daemonset_readiness_math():
    assert is_daemonset_ready({"status": {"desiredNumberScheduled": 0}})
    assert is_daemonset_ready({"status": {
        "desiredNumberScheduled": 4, "numberAvailable": 4, "updatedNumberScheduled": 4}})
    assert not is_daemonset_ready({"status": {
        "desiredNumberScheduled": 4, "numberAvailable": 3, "updatedNumberScheduled": 4}})
    assert not is_daemonset_ready({"status": {
        "desiredNumberScheduled": 4, "numberAvailable": 4, "updatedNumberScheduled": 2}})


def test_get_sync_state_walks_applied_objects(fake_client):
    skel = StateSkel("s", fake_client)
    applied = skel.create_or_update_objs([mk_ds()])
    assert skel.get_sync_state(applied) == SyncState.READY  # no nodes: vacuous
    for n in ("n1", "n2"):
        fake_client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": n}})
    # nodes exist but DS status still empty -> fresh-DS race must be notReady
    assert skel.get_sync_state(applied) == SyncState.NOT_READY
    live = fake_client.get("apps/v1", "DaemonSet", "ds1", "tpu-operator")
    live["status"] = {"desiredNumberScheduled": 2, "numberAvailable": 1, "updatedNumberScheduled": 2}
    fake_client.update_status(live)
    assert skel.get_sync_state(applied) == SyncState.NOT_READY
    live["status"] = {"desiredNumberScheduled": 2, "numberAvailable": 2, "updatedNumberScheduled": 2}
    fake_client.update_status(live)
    assert skel.get_sync_state(applied) == SyncState.READY


def test_delete_objs_and_list_owned(fake_client):
    skel = StateSkel("s", fake_client)
    skel.create_or_update_objs([mk_ds()])
    owned = skel.list_owned("apps/v1", "DaemonSet", "tpu-operator")
    assert len(owned) == 1
    skel.delete_objs(owned)
    try:
        fake_client.get("apps/v1", "DaemonSet", "ds1", "tpu-operator")
        assert False, "should be deleted"
    except NotFoundError:
        pass
    skel.delete_objs(owned)  # idempotent


def test_out_of_band_drift_is_healed(fake_client):
    """The fingerprint skip only proves the operator's LAST WRITE matched;
    a kubectl edit to a rendered object (dropped ClusterRole verb,
    rewritten Service port) leaves the stored hash intact, so the skip
    must also verify the live object still carries every rendered field —
    else drift persists until the operator's own template changes."""

    skel = StateSkel("state-test", fake_client)
    role = {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRole",
            "metadata": {"name": "drift-role"},
            "rules": [{"apiGroups": [""], "resources": ["nodes"],
                       "verbs": ["get", "list", "watch", "patch"]}]}
    skel.create_or_update_objs([copy.deepcopy(role)])

    # out-of-band edit: drop the patch verb (privilege-reduction attack on
    # the operator's own RBAC)
    live = fake_client.get("rbac.authorization.k8s.io/v1", "ClusterRole",
                           "drift-role")
    live["rules"][0]["verbs"] = ["get"]
    fake_client.update(live)

    skel.create_or_update_objs([copy.deepcopy(role)])
    healed = fake_client.get("rbac.authorization.k8s.io/v1", "ClusterRole",
                             "drift-role")
    assert healed["rules"][0]["verbs"] == ["get", "list", "watch", "patch"]


def test_unchanged_object_skips_write(fake_client):
    """The flip side: an unchanged, undrifted object is NOT rewritten
    every sweep (steady-state write load must be O(changes), not
    O(sweeps) — the r4 scale-envelope finding)."""

    skel = StateSkel("state-test", fake_client)
    svc = {"apiVersion": "v1", "kind": "Service",
           "metadata": {"name": "skip-svc", "namespace": "tpu-operator"},
           "spec": {"ports": [{"port": 9400}]}}
    skel.create_or_update_objs([copy.deepcopy(svc)])
    rv1 = fake_client.get("v1", "Service", "skip-svc",
                          "tpu-operator")["metadata"]["resourceVersion"]
    writes = {"n": 0}
    orig = fake_client.update

    def counting_update(obj):
        writes["n"] += 1
        return orig(obj)

    fake_client.update = counting_update
    try:
        skel.create_or_update_objs([copy.deepcopy(svc)])
    finally:
        fake_client.update = orig
    assert writes["n"] == 0
    rv2 = fake_client.get("v1", "Service", "skip-svc",
                          "tpu-operator")["metadata"]["resourceVersion"]
    assert rv1 == rv2


def test_drift_heal_damping_bounds_webhook_fight(fake_client):
    """A mutating admission webhook that appends a toleration to a RENDERED
    list re-creates drift after every heal; re-applying forever is an
    unbounded UPDATE/warn loop (r4 VERDICT weak-#2). After DRIFT_HEAL_LIMIT
    consecutive heals the object must degrade to hash-only skip: bounded
    writes, ONE warning Event naming the diverging path, then silence."""

    from tpu_operator_torch.state.skel import DRIFT_HEAL_LIMIT

    def mk_tolerating_ds():
        ds = mk_ds(name="webhooked")
        ds["spec"]["template"]["spec"]["tolerations"] = [
            {"key": consts.GPU_RESOURCE_NAME, "operator": "Exists"}]
        return ds

    skel = StateSkel("state-test", fake_client)
    orig_create, orig_update = fake_client.create, fake_client.update

    def mutate(obj):
        if obj.get("kind") == "DaemonSet":
            tolerations = obj["spec"]["template"]["spec"].setdefault(
                "tolerations", [])
            if not any(t.get("key") == "injected" for t in tolerations):
                tolerations.append({"key": "injected", "operator": "Exists"})
        return obj

    fake_client.create = lambda obj: orig_create(mutate(copy.deepcopy(obj)))
    heal_updates = {"n": 0}

    def admitting_update(obj):
        heal_updates["n"] += 1
        return orig_update(mutate(copy.deepcopy(obj)))

    fake_client.update = admitting_update
    try:
        skel.create_or_update_objs([mk_tolerating_ds()])
        for _ in range(10):
            skel.create_or_update_objs([mk_tolerating_ds()])
    finally:
        fake_client.create, fake_client.update = orig_create, orig_update

    # LIMIT heals + the one-time damped-marker bookkeeping patch (the
    # fake's patch routes through update): 4 writes across 10 sweeps,
    # NOT one per sweep forever
    assert heal_updates["n"] == DRIFT_HEAL_LIMIT + 1
    suspended = [e for e in fake_client.list("v1", "Event", "tpu-operator")
                 if e.get("reason") == "DriftHealSuspended"]
    assert len(suspended) == 1, "exactly one loud Event, not one per sweep"
    assert "tolerations" in suspended[0]["message"]
    live = fake_client.get("apps/v1", "DaemonSet", "webhooked", "tpu-operator")
    assert live["metadata"]["annotations"][consts.DRIFT_HEALS_ANNOTATION] \
        == str(DRIFT_HEAL_LIMIT + 1)  # damped marker


def test_drift_heal_counter_resets_when_drift_settles(fake_client):
    """A one-off kubectl edit healed successfully must hand back the full
    heal budget — only SUSTAINED fights damp."""
    skel = StateSkel("state-test", fake_client)
    skel.create_or_update_objs([mk_ds(name="edited")])
    live = fake_client.get("apps/v1", "DaemonSet", "edited", "tpu-operator")
    live["spec"]["template"]["spec"]["containers"][0]["image"] = "rogue:1"
    fake_client.update(live)

    skel.create_or_update_objs([mk_ds(name="edited")])  # heal sweep
    live = fake_client.get("apps/v1", "DaemonSet", "edited", "tpu-operator")
    assert live["spec"]["template"]["spec"]["containers"][0]["image"] == "img:1"
    assert live["metadata"]["annotations"][consts.DRIFT_HEALS_ANNOTATION] == "1"

    skel.create_or_update_objs([mk_ds(name="edited")])  # settled sweep
    live = fake_client.get("apps/v1", "DaemonSet", "edited", "tpu-operator")
    assert consts.DRIFT_HEALS_ANNOTATION not in live["metadata"]["annotations"]


def test_template_change_resumes_after_damping(fake_client):
    """Damping is per rendered template: when the operator's OWN render
    changes, the normal update path runs and the damped marker is dropped
    with it."""
    from tpu_operator_torch.state.skel import DRIFT_HEAL_LIMIT

    skel = StateSkel("state-test", fake_client)
    skel.create_or_update_objs([mk_ds(name="damped")])
    live = fake_client.get("apps/v1", "DaemonSet", "damped", "tpu-operator")
    live["metadata"]["annotations"][consts.DRIFT_HEALS_ANNOTATION] = \
        str(DRIFT_HEAL_LIMIT + 1)
    live["spec"]["template"]["spec"]["containers"][0]["image"] = "rogue:1"
    fake_client.update(live)

    skel.create_or_update_objs([mk_ds(name="damped")])  # damped: no heal
    live = fake_client.get("apps/v1", "DaemonSet", "damped", "tpu-operator")
    assert live["spec"]["template"]["spec"]["containers"][0]["image"] == "rogue:1"

    skel.create_or_update_objs([mk_ds(name="damped", image="img:2")])
    live = fake_client.get("apps/v1", "DaemonSet", "damped", "tpu-operator")
    assert live["spec"]["template"]["spec"]["containers"][0]["image"] == "img:2"
    assert consts.DRIFT_HEALS_ANNOTATION not in live["metadata"]["annotations"]


def test_returning_webhook_reannounces_suspension(fake_client):
    """Damping is per-fight, not per-object-forever: when the drift settles
    (counter cleared) and the webhook later COMES BACK, the new fight must
    produce its own DriftHealSuspended event — not be silently re-damped."""
    from tpu_operator_torch.state.skel import DRIFT_HEAL_LIMIT

    skel = StateSkel("state-test", fake_client)
    skel.create_or_update_objs([mk_ds(name="flappy")])

    def fight_until_damped():
        for _ in range(DRIFT_HEAL_LIMIT + 2):
            live = fake_client.get("apps/v1", "DaemonSet", "flappy",
                                   "tpu-operator")
            live["spec"]["template"]["spec"]["containers"][0]["image"] = "rogue:1"
            fake_client.update(live)
            skel.create_or_update_objs([mk_ds(name="flappy")])

    fight_until_damped()
    # settle: live matches render again, counter + reported-flag cleared
    live = fake_client.get("apps/v1", "DaemonSet", "flappy", "tpu-operator")
    live["spec"]["template"]["spec"]["containers"][0]["image"] = "img:1"
    fake_client.update(live)
    skel.create_or_update_objs([mk_ds(name="flappy")])
    live = fake_client.get("apps/v1", "DaemonSet", "flappy", "tpu-operator")
    assert consts.DRIFT_HEALS_ANNOTATION not in live["metadata"]["annotations"]

    fight_until_damped()  # the webhook returns
    suspended = [e for e in fake_client.list("v1", "Event", "tpu-operator")
                 if e.get("reason") == "DriftHealSuspended"]
    # event aggregation (client-go style) folds the identical re-announcement
    # into the same Event object and bumps count — so the second fight shows
    # up as count == 2 on one object, not a second object
    assert sum(e.get("count", 1) for e in suspended) == 2, \
        "each distinct fight announces itself once"
    assert len(suspended) == 1, "identical announcements aggregate"


def _sequence(state_mod, client):
    """Applies, an out-of-band edit, a re-apply, a status walk and a
    delete through one package's skeleton; each step's writes counted."""
    writes = []
    for verb in ("create", "update", "patch", "delete"):
        inner = getattr(client, verb)

        def counted(*args, _inner=inner, _verb=verb, **kwargs):
            writes.append(_verb)
            return _inner(*args, **kwargs)
        setattr(client, verb, counted)
    skel = state_mod.StateSkel("state-test", client)
    owner = client.create({"apiVersion": "tpu.ai/v1", "kind": "ClusterPolicy",
                           "metadata": {"name": "cluster-policy"}, "spec": {}})
    svc = {"apiVersion": "v1", "kind": "Service",
           "metadata": {"name": "svc", "namespace": "tpu-operator"},
           "spec": {"ports": [{"port": 9400}]}}
    objs = [mk_ds("a"), mk_ds("b", image="img:2"), svc]
    skel.create_or_update_objs(copy.deepcopy(objs), owner=owner)
    skel.create_or_update_objs(copy.deepcopy(objs), owner=owner)  # the hash skip
    live = client.get("apps/v1", "DaemonSet", "a", "tpu-operator")
    live["spec"]["template"]["spec"]["containers"][0]["image"] = "drifted:9"
    client.update(live)
    skel.create_or_update_objs(copy.deepcopy(objs), owner=owner)  # the drift healed
    state = skel.get_sync_state(skel.create_or_update_objs(copy.deepcopy(objs), owner=owner))
    skel.delete_objs([mk_ds("b")])
    kept = []
    for kind, api in (("DaemonSet", "apps/v1"), ("Service", "v1")):
        for obj in client.list(api, kind, "tpu-operator"):
            # the spec hash covers the owner's uid, which differs
            meta = {k: v for k, v in obj["metadata"].items()
                    if k not in ("uid", "creationTimestamp", "resourceVersion",
                                 "ownerReferences", "annotations")}
            meta["annotations"] = sorted(obj["metadata"].get("annotations") or {})
            kept.append(dict(obj, metadata=meta))
    return {"writes": writes, "state": str(state).rsplit(".", 1)[-1], "objects": kept}


def test_both_packages_skeletons_take_the_same_writes():
    from tpu_operator_torch import state as port_state

    assert _sequence(port_state, FakeClient()) == _sequence(ref_state, RefFake())
