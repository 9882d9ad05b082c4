"""The upgrade's validator recycle against a cache that reports its deletes
late: the port's machine (tpu_operator_torch/upgrade/machine.py) beside the
reference's, on the same inputs.

At ``validation-required`` both machines delete the node's validator pods
and stamp the template they recycled for; the next sweep certifies the node
on the validator pods it then lists. Behind an informer cache that next
sweep may start before the watch has reported the deletes (the machine's
own node write wakes it at once), and the deleted pods are still listed,
Ready, with no ``deletionTimestamp``. The client here keeps each pod it
deleted in its Pod lists for a number of sweeps after the delete. On it the
reference certifies the node on the validators it has just deleted and
uncordons it, and no validator ever ran against the new driver; the port
records the uids it deleted and waits, cordoned, until a validator created
after the recycle is Ready. That holds on both ways into
``validation-required`` (from ``pod-restart-required``, and the retry out of
``upgrade-failed``) and after an operator killed at every write of the
recycle. Without the lag the two machines agree (the parity cases of
tests/test_torch_upgrade.py and the resume cases of
tests/test_torch_upgrade_controller.py).
"""

import copy

import pytest

from test_torch_upgrade import NS, PORT, REF, World
from tpu_operator_torch import consts


class Killed(BaseException):
    """The operator's process dies: nothing in a sweep catches it."""


class LaggingPods:
    """A client whose Pod lists keep each pod it deleted, as it was when
    deleted, for ``sweeps`` sweeps after the delete: an informer whose watch
    reports deletes late. Writes go through. ``kill_at`` = (site, "before" |
    "after") kills the process at the first write the site matches: before
    drops the write, after lets it land."""

    def __init__(self, inner, sweeps=1, kill_at=None):
        self.inner = inner
        self.sweeps = sweeps
        self.kill_at = kill_at
        self.sweep = 0
        self.ghosts = {}
        self.sites = []

    def tick(self):
        self.sweep += 1

    def _write(self, site, call):
        self.sites.append(site)
        armed = self.kill_at is not None and self.kill_at[0] == site
        if armed and self.kill_at[1] == "before":
            self.kill_at = None
            raise Killed(site)
        result = call()
        if armed:
            self.kill_at = None
            raise Killed(site)
        return result

    def delete(self, api_version, kind, name, namespace=None, **kw):
        if kind == "Pod":
            live = [p for p in self.inner.list("v1", "Pod", namespace)
                    if p["metadata"]["name"] == name]
            if live:
                self.ghosts[(namespace, name)] = (copy.deepcopy(live[0]),
                                                  self.sweep + self.sweeps)
        return self._write(f"delete {kind}/{name}", lambda: self.inner.delete(
            api_version, kind, name, namespace, **kw))

    def patch(self, api_version, kind, name, patch, namespace=None):
        anns = (patch.get("metadata") or {}).get("annotations") or {}
        site = f"patch {kind}/{name}"
        if anns.get(consts.UPGRADE_REVALIDATED_ANNOTATION):
            site += " record"  # the recycle's stamp (the same key in both packages)
        return self._write(site, lambda: self.inner.patch(api_version, kind, name, patch,
                                                          namespace))

    def list(self, api_version, kind, namespace=None, label_selector=None,
             field_selector=None):
        items = self.inner.list(api_version, kind, namespace, label_selector=label_selector,
                                field_selector=field_selector)
        if kind != "Pod":
            return items
        listed = {(p["metadata"].get("namespace"), p["metadata"]["name"]) for p in items}
        for (ns, name), (pod, until) in self.ghosts.items():
            labels = pod["metadata"].get("labels") or {}
            if (self.sweep <= until and (ns, name) not in listed
                    and namespace in (None, ns)
                    and all(labels.get(k) == v for k, v in (label_selector or {}).items())
                    and all((pod.get("spec") or {}).get(path.split(".", 1)[1]) == v
                            for path, v in (field_selector or {}).items())):
                items.append(copy.deepcopy(pod))
        return items

    def __getattr__(self, name):
        return getattr(self.inner, name)


class LagWorld(World):
    """A package's World whose machines read and write through
    :class:`LaggingPods`; the test's own reads and writes go to the fake."""

    def __init__(self, side, sweeps=1, kill_at=None):
        super().__init__(side)
        self.lagging = LaggingPods(self.client, sweeps, kill_at)

    def machine(self, **policy):
        spec = self.s.Policy.from_dict({"autoUpgrade": True, **policy})
        return self.m.UpgradeStateMachine(self.lagging, NS, spec, now=self.clock,
                                          journal=self.journal)

    def process(self, sm):
        try:
            return super().process(sm)
        finally:
            self.lagging.tick()

    def uid(self, name):
        return self.client.get("v1", "Pod", name, NS)["metadata"]["uid"]

    def recycled(self):
        raw = (self.node()["metadata"].get("annotations") or {}).get(
            consts.UPGRADE_RECYCLED_VALIDATORS_ANNOTATION)
        return set(raw.split(",")) if raw else set()


def to_validation(w):
    """Setup, then sweeps to validation-required: the recycle runs on the
    last of them. Returns the machine and the recycled validator's uid."""
    w.setup()
    val_uid = w.uid("val-0")
    sm = w.machine()
    w.process(sm)
    w.process(sm)
    w.process(sm)  # the deleted old driver pod, still listed: deleted again
    w.client.create(w.mk_pod("drv-0-new", "node-0", "driver", "img:2"))
    w.process(sm)
    assert w.state() == w.m.VALIDATION_REQUIRED and w.cordoned()
    assert "val-0" not in w.pods(), "the validator pod recycled"
    return sm, val_uid


def fresh_validator_certifies(w, sm, recycled_uids):
    """The port at validation-required, cordoned, over more sweeps than the
    lag; then a validator created after the recycle certifies the node."""
    for _ in range(3):
        w.process(sm)
        assert w.state() == w.m.VALIDATION_REQUIRED and w.cordoned()
        assert w.recycled() == recycled_uids
    w.client.create(w.mk_pod("val-0-new", "node-0", "validator", "v:1"))
    assert w.uid("val-0-new") not in recycled_uids
    w.process(sm)
    assert w.state() == w.m.DONE and not w.cordoned()
    w.process(sm)
    assert w.state() == w.m.UNKNOWN
    anns = w.node()["metadata"].get("annotations") or {}
    assert consts.UPGRADE_RECYCLED_VALIDATORS_ANNOTATION not in anns
    assert consts.UPGRADE_REVALIDATED_ANNOTATION not in anns


def test_a_recycled_validator_a_cache_still_lists_does_not_certify():
    """Input: the full upgrade of one node, Pod lists keeping each deleted
    pod one sweep. The reference's next sweep after the recycle reads the
    deleted ``val-0``, Ready, and ends ``upgrade-done``, uncordoned, with no
    validator created since; the port waits at ``validation-required``,
    cordoned, until ``val-0-new`` is Ready."""
    ref = LagWorld(REF)
    sm, _ = to_validation(ref)
    ref.process(sm)
    assert ref.state() == ref.m.DONE and not ref.cordoned()
    assert not any(p.startswith("val-") for p in ref.pods()), "no validator ran since"

    port = LagWorld(PORT)
    sm, val_uid = to_validation(port)
    assert port.recycled() == {val_uid}
    fresh_validator_certifies(port, sm, {val_uid})


def test_the_retry_out_of_upgrade_failed_waits_for_a_fresh_validator():
    """Input: the new driver pod Failed (``upgrade-failed``), then replaced
    by a healthy one: the retry goes to ``validation-required`` and recycles
    ``val-0``, and Pod lists keep it one sweep. The reference's next sweep
    certifies the node on it; the port's waits for a validator created
    after the recycle."""
    ended = {}
    for side in (REF, PORT):
        w = LagWorld(side)
        w.setup()
        val_uid = w.uid("val-0")
        sm = w.machine()
        w.process(sm)
        w.process(sm)
        w.process(sm)
        w.client.create(w.mk_pod("drv-0-new", "node-0", "driver", "img:2", phase="Failed",
                                 ready=False))
        w.process(sm)
        assert w.state() == w.m.FAILED and w.cordoned()
        w.client.delete("v1", "Pod", "drv-0-new", NS)
        w.client.create(w.mk_pod("drv-0-fresh", "node-0", "driver", "img:2"))
        w.process(sm)
        assert w.state() == w.m.VALIDATION_REQUIRED and "val-0" not in w.pods()
        w.process(sm)
        ended[side.name] = (w.state(), w.cordoned())
        if side.port:
            assert w.recycled() == {val_uid}
            fresh_validator_certifies(w, sm, {val_uid})
    assert ended == {"reference": (REF.m.DONE, False),
                     "port": (PORT.m.VALIDATION_REQUIRED, True)}


def test_the_lag_is_what_the_reference_trips_on():
    """Without the lag the reference waits at ``validation-required`` as the
    port does: the fault is the stale read alone."""
    for side in (REF, PORT):
        w = LagWorld(side, sweeps=0)
        sm, _ = to_validation(w)
        w.process(sm)
        assert w.state() == w.m.VALIDATION_REQUIRED and w.cordoned(), side.name


#: every write of the recycle, before and after it lands: two validator
#: pods' deletes and the record
RECYCLE_KILLS = [(site, when) for site in ("delete Pod/val-0", "delete Pod/val-1",
                                           "patch Node/node-0 record")
                 for when in ("before", "after")]


def killed_in_recycle(side, kill_at):
    """The upgrade of a node with two validator pods, the operator killed
    at ``kill_at`` in the recycle and a fresh one started; Pod lists keep
    each deleted pod two sweeps, across the restart. Returns the world, the
    uids of the two validators, and whether the node left
    validation-required before a validator created after the recycle
    existed."""
    w = LagWorld(side, sweeps=2, kill_at=kill_at)
    w.setup()
    w.client.create(w.mk_pod("val-1", "node-0", "validator", "v:1"))
    uids = {w.uid("val-0"), w.uid("val-1")}
    sm = w.machine()
    for _ in range(2 + w.lagging.sweeps):  # past the old driver pod's lag
        w.process(sm)
    w.client.create(w.mk_pod("drv-0-new", "node-0", "driver", "img:2"))
    try:
        w.process(sm)
        raise AssertionError(f"{side.name}: {kill_at} never reached: {w.lagging.sites}")
    except Killed:
        pass
    sm = w.machine()  # the restarted operator
    stale = False
    for _ in range(4):
        w.process(sm)
        if w.state() != w.m.VALIDATION_REQUIRED:
            stale = True
            break
    return w, sm, uids, stale


@pytest.mark.parametrize("site,when", RECYCLE_KILLS)
def test_an_operator_killed_in_the_recycle_certifies_only_on_a_fresh_validator(site, when):
    """Input: a node with two validator pods, the operator killed before or
    after each write of the recycle (each delete, the record), Pod lists
    keeping each deleted pod two sweeps. A kill before the record leaves no
    record: the restarted operator recycles again, deleting (or finding
    gone) what it still lists, and the sweep after still reads those pods.
    A kill after it leaves the record, and the restarted operator reads the
    deleted pods. Either way the reference certifies the node on a
    validator it deleted.
    The port never does: it ends at ``upgrade-done`` only through a
    validator created after the recycle, and never waits on a pod it did
    not delete."""
    ref, _, _, ref_stale = killed_in_recycle(REF, (site, when))
    assert ref_stale and ref.state() == ref.m.DONE and not ref.cordoned()
    port, sm, uids, port_stale = killed_in_recycle(PORT, (site, when))
    assert not port_stale and port.cordoned()
    assert {"val-0", "val-1"}.isdisjoint(port.pods())
    assert port.recycled() <= uids and port.recycled()
    fresh_validator_certifies(port, sm, port.recycled())


def test_the_recycle_s_record_is_one_write_after_its_deletes():
    """The recycle's writes in order: every delete, then one Node patch
    carrying the template and the deleted uids together."""
    w = LagWorld(PORT, sweeps=0)
    w.setup()
    w.client.create(w.mk_pod("val-1", "node-0", "validator", "v:1"))
    uids = {w.uid("val-0"), w.uid("val-1")}
    sm = w.machine()
    for _ in range(3):
        w.process(sm)
    w.client.create(w.mk_pod("drv-0-new", "node-0", "driver", "img:2"))
    start = len(w.lagging.sites)
    w.process(sm)
    sites = [s for s in w.lagging.sites[start:] if "val-" in s or "record" in s]
    assert sites == ["delete Pod/val-0", "delete Pod/val-1", "patch Node/node-0 record"]
    assert w.recycled() == uids
    anns = w.node()["metadata"]["annotations"]
    assert anns[consts.UPGRADE_REVALIDATED_ANNOTATION]
