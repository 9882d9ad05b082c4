"""The port's GPU-health machine (tpu_operator_torch/health/machine.py)
against the reference's, twin for twin with tests/test_health.py.

Each of the reference's 26 cases runs as one script on both packages: the
same node on each package's fake, the same fake clock, the same verdicts,
one shared decision journal per side, and a BRAND NEW machine for every
sweep (so every step is also a resume after an operator restart). After
each sweep the node's health label, annotations and cordon, the sweep's
``HealthCounts`` and counters are logged; at the end the Events (reason,
type, message, count), the pods left and the journal's decision kinds per
episode. The reference's log, mapped through
tests/test_torch_operator_mapping.py, must equal the port's. The scripts
keep the reference's own assertions, which hold on both sides.

Episode ids differ between the packages by design (the mapping's
health section): the logs name episodes by order of
appearance. The last tests pin that difference on the input that shows the
reference's fault, and that a crash replay still lands on the same ids;
and the repaired admin clear, which lifts the machine's own cordon where
the reference leaves the node unschedulable.
"""

import types

import pytest

from test_torch_operator_mapping import (HEALTH_COMPONENTS, map_health_node_annotations,
                                         map_health_text)
from tpu_operator import consts as ref_consts
from tpu_operator.api.clusterpolicy import HealthSpec as RefHealthSpec
from tpu_operator.api.clusterpolicy import MigrateSpec as RefMigrateSpec
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.health import drain as ref_drain
from tpu_operator.health import machine as ref_machine
from tpu_operator.provenance import DecisionJournal as RefJournal
from tpu_operator_torch import consts
from tpu_operator_torch.api.clusterpolicy import HealthSpec, MigrateSpec
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.controllers.metrics import OperatorMetrics
from tpu_operator_torch.health import drain, machine
from tpu_operator_torch.provenance import DecisionJournal

NS = "tpu-operator"
NODE = "node-0"

REF = types.SimpleNamespace(
    consts=ref_consts, HealthSpec=RefHealthSpec, Fake=RefFake, m=ref_machine,
    drain=ref_drain, Journal=RefJournal,
    failed_ids=ref_machine.failed_chips_from_annotation,
    migrate_spec=RefMigrateSpec.from_dict,
    validator="tpu-operator-validator", driver="tpu-driver",
    accelerator=(ref_consts.GKE_TPU_ACCELERATOR_LABEL, "tpu-v5-lite-podslice"))
PORT = types.SimpleNamespace(
    consts=consts, HealthSpec=HealthSpec, Fake=FakeClient, m=machine,
    drain=drain, Journal=DecisionJournal,
    failed_ids=machine.failed_gpus_from_annotation,
    migrate_spec=MigrateSpec.from_dict,
    validator=HEALTH_COMPONENTS["tpu-operator-validator"],
    driver=HEALTH_COMPONENTS["tpu-driver"],
    accelerator=(consts.GKE_ACCELERATOR_LABEL, "nvidia-h100-80gb"))


class Clock:
    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


class World:
    """One package's cluster, clock and journal, driven as the reference's
    tests drive theirs, with a log of what each sweep left behind."""

    def __init__(self, side):
        self.s = side
        self.c = side.consts
        self.client = side.Fake()
        self.clock = Clock()
        self.journal = side.Journal(now=self.clock)
        self.log = []
        self._names = {}
        #: the ClusterPolicy's ``migrate`` sub-spec, as each package takes it
        self.migrate = None

    # -- the cluster --------------------------------------------------------------
    def mk_node(self, verdict=None):
        key, value = self.s.accelerator
        node = {"apiVersion": "v1", "kind": "Node",
                "metadata": {"name": NODE, "labels": {
                    key: value, self.c.deploy_label("driver"): "true"}},
                "spec": {}, "status": {}}
        if verdict is not None:
            node["metadata"]["annotations"] = {self.c.WORKLOAD_HEALTH_ANNOTATION: verdict}
        return node

    def mk_pod(self, name, component):
        return {"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": name, "namespace": NS,
                             "labels": {"app.kubernetes.io/component": component}},
                "spec": {"nodeName": NODE}, "status": {"phase": "Running"}}

    def setup(self, verdict="failed"):
        self.client.create({
            "apiVersion": "apps/v1", "kind": "DaemonSet",
            "metadata": {"name": "driver", "namespace": NS},
            "spec": {"template": {
                "metadata": {"labels": {"app.kubernetes.io/component": self.s.driver}},
                "spec": {"nodeSelector": {self.c.deploy_label("driver"): "true"},
                         "containers": [{"name": "i", "image": "img:1"}]}}}})
        self.client.create(self.mk_node(verdict))
        self.client.create(self.mk_pod("val-0", self.s.validator))
        self.client.create(self.mk_pod("drv-0", self.s.driver))

    def node(self):
        return self.client.get("v1", "Node", NODE)

    def state(self):
        return self.s.m.node_health_state(self.node())

    def anns(self):
        return self.node()["metadata"].get("annotations") or {}

    def patch_node(self, labels=None, annotations=None):
        meta = {}
        if labels is not None:
            meta["labels"] = labels
        if annotations is not None:
            meta["annotations"] = annotations
        self.client.patch("v1", "Node", NODE, {"metadata": meta})

    def set_verdict(self, verdict):
        self.patch_node(annotations={self.c.WORKLOAD_HEALTH_ANNOTATION: verdict})

    def roll_driver(self):
        self.client.patch("apps/v1", "DaemonSet", "driver", {
            "spec": {"template": {"spec": {"containers": [
                {"name": "i", "image": "img:NEW"}]}}}}, NS)

    def events(self, reason):
        return [e for e in self.client.list("v1", "Event", NS) if e.get("reason") == reason]

    def pods(self):
        return sorted(p["metadata"]["name"] for p in self.client.list("v1", "Pod", NS))

    # -- sweeps -------------------------------------------------------------------
    def machine(self, **spec):
        return self.s.m.HealthStateMachine(self.client, NS, self.s.HealthSpec.from_dict(spec),
                                           now=self.clock, journal=self.journal,
                                           migrate=self.migrate)

    def sweep(self, **spec):
        spec.setdefault("drainDeadlineS", 0)
        sm = self.machine(**spec)
        counts = sm.process(self.client.list("v1", "Node"))
        self.observe(sm, counts)
        return sm, counts

    def drain_sweep(self, deadline=120):
        return self.sweep(drainDeadlineS=deadline)

    def to_quarantined(self, deadline=120):
        self.drain_sweep(deadline)   # healthy -> degraded
        self.clock.t += 30
        self.drain_sweep(deadline)   # degraded -> quarantined
        self.clock.t += 30
        assert self.state() == self.s.m.QUARANTINED

    def ack_plan(self, step=7):
        plan = self.s.drain.node_plan(self.node())
        assert plan is not None
        self.patch_node(annotations={self.c.DRAIN_ACK_ANNOTATION:
                                     '{"plan": "%s", "step": %d}' % (plan.fingerprint, step)})
        return plan

    def flap_once(self, **spec):
        """healthy -> degraded -> healthy (one full flap)."""
        self.set_verdict("failed")
        self.sweep(**spec)
        self.set_verdict("passed")
        self.clock.t += 60
        self.sweep(**spec)
        self.clock.t += 60

    def drive_to_failed(self):
        self.set_verdict("failed")
        for _ in range(3):
            self.sweep()
            self.clock.t += 30
        for _ in range(3):
            self.clock.t += 601
            self.sweep()
        assert self.state() == self.s.m.FAILED

    # -- the log ------------------------------------------------------------------
    def _name(self, kind, value):
        """Episode ids and template fingerprints by order of appearance."""
        names = self._names.setdefault(kind, {})
        return names.setdefault(value, f"{kind}{len(names) + 1}")

    def observe(self, sm, counts):
        node = self.node()
        anns = {}
        for key, value in sorted((node["metadata"].get("annotations") or {}).items()):
            if key == self.c.PROVENANCE_EPISODE_ANNOTATION:
                value = self._name("episode", value)
            elif key in (self.c.HEALTH_FAILED_TEMPLATE_ANNOTATION,
                         self.c.HEALTH_FLAP_STICKY_ANNOTATION):
                value = self._name("template", value)
            anns[key] = value
        self.log.append({
            "state": self.s.m.node_health_state(node), "annotations": anns,
            "unschedulable": (node.get("spec") or {}).get("unschedulable"),
            "counts": counts.as_dict(), "fired": sm.attempts_fired,
            "misses": sm.deadline_misses, "pending": sm.plans_pending,
            "snapshots": sm.snapshots_taken,
        })

    def episodes(self):
        """The journal's decision kinds per episode, in episode order."""
        out = []
        for ep in sorted(self.journal.episodes(), key=lambda e: e["first_ts"]):
            out.append([r.kind for r in self.journal.chain(ep["episode"])])
        return out

    def record(self, mapped=False):
        text = map_health_text if mapped else (lambda t: t)
        events = sorted((e["type"], e["reason"], text(e["message"]), int(e.get("count") or 1))
                        for e in self.client.list("v1", "Event", NS))
        log = self.log
        if mapped:
            log = [dict(e, annotations=map_health_node_annotations(e["state"], e["annotations"]))
                   if isinstance(e, dict) else e for e in log]
        return {"log": log, "events": events, "pods": self.pods(),
                "episodes": self.episodes(), "replayed": self.journal.replayed_total}


# -- the reference's 26 cases, as scripts over either package -------------------------

def case_verdict_parsing(w):
    parse, ids = w.s.m.parse_workload_health, w.s.failed_ids
    assert parse(w.mk_node(verdict="passed")) is True
    assert parse(w.mk_node(verdict="failed")) is False
    assert parse(w.mk_node(verdict="failed:1,3")) is False
    assert parse(w.mk_node(verdict="corrupt")) is False
    assert parse(w.mk_node()) is None, "absence is no-information, never failure"
    assert ids(w.mk_node(verdict="failed:1,3")) == [1, 3]
    assert ids(w.mk_node(verdict="failed")) is None
    assert ids(w.mk_node(verdict="passed")) is None
    w.log.append([(v, parse(w.mk_node(verdict=v)), ids(w.mk_node(verdict=v)))
                  for v in ("passed", "failed", "failed:1,3", "failed:x", "corrupt", None)])


def case_healthy_nodes_get_no_writes(w):
    w.setup(verdict="passed")
    rv_before = w.node()["metadata"]["resourceVersion"]
    _, counts = w.sweep()
    assert counts.healthy == 1
    assert w.state() == w.s.m.HEALTHY
    assert w.node()["metadata"]["resourceVersion"] == rv_before, \
        "the steady state must not touch the node"


def case_no_verdict_is_not_failure(w):
    w.setup(verdict=None)
    _, counts = w.sweep()
    assert counts.healthy == 1
    assert w.state() == w.s.m.HEALTHY


def case_full_degrade_quarantine_remediate_fail_flow(w):
    m, c = w.s.m, w.c
    w.setup(verdict="failed:2")
    _, counts = w.sweep()
    assert w.state() == m.DEGRADED and counts.degraded == 1
    assert w.anns()[c.HEALTH_STATE_SINCE_ANNOTATION]
    assert w.events("NodeHealthDegraded")
    w.clock.t += 30  # still failing on the next sweep: confirmed
    _, counts = w.sweep()
    assert w.state() == m.QUARANTINED and counts.quarantined == 1
    assert w.events("NodeHealthQuarantined")
    w.clock.t += 30
    sm, _ = w.sweep()
    assert w.state() == m.REMEDIATING
    assert w.anns()[c.HEALTH_ATTEMPTS_ANNOTATION] == "1" and sm.attempts_fired == 1
    # attempt 1 recycles the validator pod (forced revalidation), driver stays
    assert "val-0" not in w.pods() and "drv-0" in w.pods()
    w.clock.t += 30  # within the wait budget: no escalation, no extra writes
    sm, _ = w.sweep()
    assert sm.attempts_fired == 0 and w.anns()[c.HEALTH_ATTEMPTS_ANNOTATION] == "1"
    # budget exhausted, still failing: attempt 2 escalates to driver restart
    w.client.create(w.mk_pod("val-1", w.s.validator))
    w.clock.t += 601
    sm, _ = w.sweep()
    assert w.anns()[c.HEALTH_ATTEMPTS_ANNOTATION] == "2" and sm.attempts_fired == 1
    assert "drv-0" not in w.pods() and "val-1" not in w.pods()
    w.clock.t += 601  # attempt 3 (the default max)
    w.sweep()
    assert w.anns()[c.HEALTH_ATTEMPTS_ANNOTATION] == "3"
    w.clock.t += 601  # attempts exhausted -> sticky failed
    _, counts = w.sweep()
    assert w.state() == m.FAILED and counts.failed == 1
    assert w.anns()[c.HEALTH_FAILED_TEMPLATE_ANNOTATION]
    assert w.events("NodeHealthFailed")
    w.clock.t += 601  # sticky: later sweeps leave it alone
    w.sweep()
    assert w.state() == m.FAILED


def case_recovery_mid_remediation(w):
    m, c = w.s.m, w.c
    w.setup(verdict="failed")
    for _ in range(3):  # degraded -> quarantined -> remediating
        w.sweep()
        w.clock.t += 30
    assert w.state() == m.REMEDIATING
    w.set_verdict("passed")
    _, counts = w.sweep()
    assert w.state() == m.RECOVERED and counts.recovered == 1
    assert c.HEALTH_ATTEMPTS_ANNOTATION not in w.anns()
    assert w.events("NodeHealthRecovered")
    w.clock.t += 30  # settled: label cleared, machine left
    _, counts = w.sweep()
    assert w.state() == m.HEALTHY and counts.healthy == 1
    assert c.HEALTH_STATE_SINCE_ANNOTATION not in w.anns()


def case_one_sweep_blip_recovers_directly(w):
    w.setup(verdict="failed")
    w.sweep()
    assert w.state() == w.s.m.DEGRADED
    w.set_verdict("passed")
    w.clock.t += 30
    w.sweep()
    assert w.state() == w.s.m.HEALTHY


def case_cordon_on_quarantine_knob(w):
    m = w.s.m
    w.setup(verdict="failed")
    w.sweep(cordonOnQuarantine=True)
    w.clock.t += 30
    w.sweep(cordonOnQuarantine=True)
    assert w.state() == m.QUARANTINED and w.node()["spec"]["unschedulable"] is True
    w.set_verdict("passed")
    w.clock.t += 30
    w.sweep(cordonOnQuarantine=True)
    assert w.state() == m.RECOVERED and not w.node()["spec"].get("unschedulable")


def case_flap_damping_goes_sticky_with_one_event(w):
    m, c = w.s.m, w.c
    w.setup(verdict="passed")
    w.flap_once()
    w.flap_once()
    assert w.state() == m.HEALTHY
    # third degradation inside the window trips the damper
    w.set_verdict("failed")
    w.sweep()
    assert w.state() == m.QUARANTINED and w.anns()[c.HEALTH_FLAP_STICKY_ANNOTATION]
    assert len(w.events("NodeHealthFlapping")) == 1
    # sticky: bounded writes, further sweeps are pure reads
    rv = w.node()["metadata"]["resourceVersion"]
    for _ in range(5):
        w.clock.t += 60
        _, counts = w.sweep()
        assert counts.quarantined == 1
    assert w.node()["metadata"]["resourceVersion"] == rv, \
        "a flap-damped node must not be written again"
    assert len(w.events("NodeHealthFlapping")) == 1


def case_flap_window_prunes_old_entries(w):
    w.setup(verdict="passed")
    w.flap_once()
    w.flap_once()
    w.clock.t += 4000  # both entries age out of the default 3600 s window
    w.set_verdict("failed")
    w.sweep()
    assert w.state() == w.s.m.DEGRADED, "stale flap history must not trip the damper"


def case_relapse_after_recovery_counts_as_flap(w):
    w.setup(verdict="failed")
    w.sweep(flapThreshold=2)  # degraded (flap entry 1)
    w.set_verdict("passed")
    w.clock.t += 30
    w.sweep(flapThreshold=2)
    w.clock.t += 30
    w.sweep(flapThreshold=2)
    w.set_verdict("failed")
    w.sweep(flapThreshold=2)
    assert w.state() == w.s.m.QUARANTINED
    assert w.events("NodeHealthFlapping")


def case_template_change_clears_sticky_failed(w):
    w.setup()
    w.drive_to_failed()
    w.roll_driver()  # a new pod template supersedes the failure
    w.clock.t += 30
    w.sweep()
    assert w.state() == w.s.m.HEALTHY
    assert w.c.HEALTH_FAILED_TEMPLATE_ANNOTATION not in w.anns()
    assert w.events("NodeHealthReset")


def case_manual_label_clear_wipes_everything(w):
    c = w.c
    w.setup()
    w.drive_to_failed()
    w.patch_node(labels={c.HEALTH_STATE_LABEL: None})  # the admin's way out
    w.set_verdict("passed")
    w.sweep()
    for key in (c.HEALTH_STATE_SINCE_ANNOTATION, c.HEALTH_ATTEMPTS_ANNOTATION,
                c.HEALTH_FLAP_HISTORY_ANNOTATION, c.HEALTH_FLAP_STICKY_ANNOTATION,
                c.HEALTH_FAILED_TEMPLATE_ANNOTATION):
        assert key not in w.anns(), f"{key} must be wiped on manual clear"


def case_template_change_lifts_flap_quarantine(w):
    w.setup(verdict="passed")
    w.flap_once()
    w.flap_once()
    w.set_verdict("failed")
    w.sweep()
    assert w.state() == w.s.m.QUARANTINED
    w.roll_driver()
    w.clock.t += 30
    w.sweep()
    assert w.state() == w.s.m.HEALTHY
    assert w.c.HEALTH_FLAP_HISTORY_ANNOTATION not in w.anns(), \
        "lifting the quarantine must reset the flap history too"


def case_resume_mid_remediation_after_operator_restart(w):
    c = w.c
    w.setup(verdict="failed")
    for _ in range(3):
        w.sweep()
        w.clock.t += 30
    w.clock.t += 601
    w.sweep()  # attempt 2
    assert w.anns()[c.HEALTH_ATTEMPTS_ANNOTATION] == "2"
    w.clock.t += 601
    w.sweep()
    assert w.anns()[c.HEALTH_ATTEMPTS_ANNOTATION] == "3"
    w.clock.t += 601
    w.sweep()
    assert w.state() == w.s.m.FAILED


def case_corrupt_since_annotation_restamps(w):
    c = w.c
    w.setup(verdict="failed")
    for _ in range(3):
        w.sweep()
        w.clock.t += 30
    w.patch_node(annotations={c.HEALTH_STATE_SINCE_ANNOTATION: "not-a-timestamp"})
    w.clock.t += 5000
    sm, _ = w.sweep()
    # a corrupt since is a fresh budget, NOT an instant escalation
    assert sm.attempts_fired == 0
    assert w.anns()[c.HEALTH_ATTEMPTS_ANNOTATION] == "1"


def case_unknown_state_label_routed_by_verdict(w):
    w.setup(verdict="passed")
    w.patch_node(labels={w.c.HEALTH_STATE_LABEL: "bogus"})
    w.sweep()
    assert w.state() == w.s.m.HEALTHY


def case_clear_all_removes_machine_state(w):
    c = w.c
    w.setup(verdict="failed")
    for _ in range(3):
        w.sweep(cordonOnQuarantine=True)
        w.clock.t += 30
    assert w.state() == w.s.m.REMEDIATING
    w.machine(cordonOnQuarantine=True).clear_all(w.client.list("v1", "Node"))
    assert w.state() == w.s.m.HEALTHY
    assert not w.node()["spec"].get("unschedulable")
    assert c.HEALTH_ATTEMPTS_ANNOTATION not in w.anns()
    assert c.HEALTH_STATE_SINCE_ANNOTATION not in w.anns()
    w.log.append(sorted(w.anns()))


def case_drain_gate_publishes_plan_and_holds_quarantine(w):
    w.setup(verdict="failed:2")
    w.patch_node(labels={w.c.TPU_SLICE_CONFIG_LABEL: "split-2x2"})
    w.to_quarantined()
    sm, counts = w.drain_sweep()
    # the gate held: still quarantined, NO remediation fired, plan published
    assert w.state() == w.s.m.QUARANTINED and counts.quarantined == 1
    assert sm.attempts_fired == 0 and sm.plans_pending == 1
    plan = w.s.drain.node_plan(w.node())
    assert plan.reason == w.s.drain.REASON_RETILE and plan.blocked == [2]
    assert plan.deadline == w.clock.t + 120
    assert plan.fingerprint == w.s.drain.plan_fingerprint("split-2x2", [2])
    assert len(w.events("RetilePlanned")) == 1


def case_drain_gate_publishes_once_across_operator_restarts(w):
    w.setup(verdict="failed:2")
    w.to_quarantined()
    for _ in range(5):
        sm, _ = w.drain_sweep()
        assert w.state() == w.s.m.QUARANTINED and sm.plans_pending == 1
        w.clock.t += 10
    assert sum(e.get("count", 1) for e in w.events("RetilePlanned")) == 1


def case_drain_gate_ack_releases_remediation(w):
    w.setup(verdict="failed:2")
    w.to_quarantined()
    w.drain_sweep()  # publishes the plan
    w.ack_plan()
    sm, _ = w.drain_sweep()
    assert w.state() == w.s.m.REMEDIATING
    assert sm.attempts_fired == 1 and sm.plans_pending == 0 and sm.deadline_misses == 0


def case_drain_gate_deadline_expiry_forces_with_miss(w):
    w.setup(verdict="failed:2")
    w.to_quarantined(deadline=60)
    w.drain_sweep(deadline=60)  # publish; no ack ever
    w.clock.t += 59  # window still open: held
    sm, _ = w.drain_sweep(deadline=60)
    assert w.state() == w.s.m.QUARANTINED and sm.deadline_misses == 0
    w.clock.t += 2  # past the deadline: fail-safe force
    sm, _ = w.drain_sweep(deadline=60)
    assert w.state() == w.s.m.REMEDIATING
    assert sm.deadline_misses == 1 and sm.plans_pending == 0
    assert w.events("RetileDeadlineExpired")


def case_drain_gate_disabled_keeps_immediate_remediation(w):
    w.setup(verdict="failed:2")
    w.to_quarantined(deadline=0)
    sm, _ = w.drain_sweep(deadline=0)
    assert w.state() == w.s.m.REMEDIATING and sm.attempts_fired == 1
    assert w.s.drain.node_plan(w.node()) is None
    assert not w.events("RetilePlanned")


def case_drain_gate_supersedes_plan_when_more_chips_fail(w):
    w.setup(verdict="failed:2")
    w.to_quarantined()
    w.drain_sweep()
    first = w.s.drain.node_plan(w.node())
    w.clock.t += 30
    w.set_verdict("failed:2,5")
    w.drain_sweep()
    assert w.state() == w.s.m.QUARANTINED
    second = w.s.drain.node_plan(w.node())
    assert second.fingerprint != first.fingerprint and second.blocked == [2, 5]
    assert second.deadline == w.clock.t + 120
    assert sum(e.get("count", 1) for e in w.events("RetilePlanned")) == 2


def case_drain_gate_recovery_retires_plan_and_ack(w):
    c = w.c
    w.setup(verdict="failed:2")
    w.to_quarantined()
    w.drain_sweep()
    w.ack_plan()
    w.drain_sweep()  # -> remediating
    assert w.state() == w.s.m.REMEDIATING
    assert c.RETILE_PLAN_ANNOTATION in w.anns()  # survives INTO remediation
    w.set_verdict("passed")
    w.drain_sweep()  # -> recovered
    w.clock.t += 30
    w.drain_sweep()  # -> healthy
    assert c.RETILE_PLAN_ANNOTATION not in w.anns()
    assert c.DRAIN_ACK_ANNOTATION not in w.anns()
    assert w.state() == w.s.m.HEALTHY


def case_drain_gate_unattributed_failure_plans_remediate(w):
    w.setup(verdict="failed")
    w.to_quarantined()
    w.drain_sweep()
    plan = w.s.drain.node_plan(w.node())
    assert plan.reason == w.s.drain.REASON_REMEDIATE and plan.blocked == []


def case_drain_gate_corrupt_plan_annotation_republishes(w):
    w.setup(verdict="failed:2")
    w.to_quarantined()
    w.drain_sweep()
    w.patch_node(annotations={w.c.RETILE_PLAN_ANNOTATION: "{not json"})
    w.drain_sweep()
    plan = w.s.drain.node_plan(w.node())
    assert plan is not None and plan.fingerprint == w.s.drain.plan_fingerprint(None, [2])


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def test_the_twins_are_the_reference_s_26_cases():
    import ast

    with open(__file__.replace("test_torch_health.py", "test_health.py")) as f:
        tree = ast.parse(f.read())
    ref_tests = {n.name[len("test_"):] for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert set(CASES) == ref_tests and len(CASES) == 26


@pytest.mark.parametrize("case", sorted(CASES))
def test_machine_matches_reference(case):
    ref, port = World(REF), World(PORT)
    CASES[case](ref)
    CASES[case](port)
    assert port.record() == ref.record(mapped=True)


# -- the episode fault, and crash replays ------------------------------------------

EPISODE_SPEC = {"drainDeadlineS": 5, "maxRemediationAttempts": 2, "remediationWaitS": 30}


def two_episodes(w, metrics=None, after_sweep=None):
    """The input that shows the reference's fault: one node fails, recovers
    during attempt 1 (``recovered``, then ``healthy``), then fails again
    with the same verdict string until it is ``failed``."""
    if metrics is not None:
        metrics.wire_provenance(w.journal)
    w.setup(verdict="failed")

    def step(dt=1):
        w.sweep(**EPISODE_SPEC)
        if after_sweep is not None:
            after_sweep()
        w.clock.t += dt

    step()        # degraded
    step()        # quarantined
    step(6)       # the plan is published; its 5 s deadline passes
    step()        # forced: remediating, attempt 1
    w.set_verdict("passed")
    step()        # recovered
    step(60)      # healthy
    assert w.state() == w.s.m.HEALTHY
    w.set_verdict("failed")
    step()        # degraded
    step()        # quarantined
    step(6)       # the plan again
    step(31)      # forced: attempt 1
    step(31)      # attempt 2
    step()        # failed
    assert w.state() == w.s.m.FAILED


def test_a_second_episode_gets_its_own_id_and_all_its_records():
    metrics = OperatorMetrics()
    port = World(PORT)
    two_episodes(port, metrics)
    assert port.episodes() == [
        ["drain-plan", "drain-force", "remediate", "health-recover"],
        ["drain-plan", "drain-force", "remediate", "remediate", "health-failed"]]
    assert port.journal.replayed_total == 0
    assert all(e["closed"] for e in port.journal.episodes())
    text = metrics.scrape().decode()
    assert 'tpu_operator_episode_duration_seconds_count{kind="drain-plan"} 2.0' in text
    assert 'tpu_operator_decision_records_total{subsystem="health"} 9.0' in text
    # the second episode announces itself as the first did
    for reason in ("RetilePlanned", "RetileDeadlineExpired"):
        assert sum(int(e.get("count") or 1) for e in port.events(reason)) == 2, reason
    assert sum(int(e.get("count") or 1) for e in port.events("NodeHealthRemediating")) == 3

    # the reference folds the second episode into the first, closed one
    ref = World(REF)
    two_episodes(ref)
    assert ref.episodes() == [["drain-plan", "drain-force", "remediate", "health-recover",
                               "remediate", "health-failed"]]
    assert ref.journal.replayed_total == 3
    for reason in ("RetilePlanned", "RetileDeadlineExpired"):
        assert len(ref.events(reason)) == 1, reason
    # and both walked the same states
    assert [e["state"] for e in port.log] == [e["state"] for e in ref.log]


def test_replaying_the_same_node_state_mints_the_same_id():
    w = World(PORT)
    w.setup(verdict="failed")
    w.sweep(**EPISODE_SPEC)
    w.clock.t += 1
    w.sweep(**EPISODE_SPEC)  # quarantined: no episode stamped yet
    node = w.node()
    assert w.c.PROVENANCE_EPISODE_ANNOTATION not in (node["metadata"].get("annotations") or {})
    ids = {machine.HealthStateMachine(PORT.Fake(), NS)._episode_for(
        {**node, "metadata": dict(node["metadata"])}) for _ in range(3)}
    assert len(ids) == 1
    later = dict(node["metadata"], annotations=dict(
        node["metadata"]["annotations"], **{w.c.HEALTH_STATE_SINCE_ANNOTATION:
                                            "2030-01-01T00:00:00Z"}))
    assert machine.HealthStateMachine(PORT.Fake(), NS)._episode_for(
        {**node, "metadata": later}) not in ids


class _RefuseEachPlanOnce:
    """A client that refuses the first patch of each distinct plan
    annotation value: an operator killed between a decision record and the
    write it licenses."""

    def __init__(self, inner):
        self.inner = inner
        self.refused = set()
        self.tripped = False

    def patch(self, api_version, kind, name, patch, namespace=None):
        from tpu_operator_torch.client.errors import ApiError

        plan = ((patch.get("metadata") or {}).get("annotations") or {}).get(
            consts.RETILE_PLAN_ANNOTATION)
        if plan and plan not in self.refused:
            self.refused.add(plan)
            self.tripped = True
            raise ApiError("injected: killed before the plan landed", code=500)
        return self.inner.patch(api_version, kind, name, patch, namespace)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_a_crash_replay_lands_each_episode_s_records_on_the_same_ids():
    """Both episodes of the fault's input with each plan write refused once
    after its decision record landed, and the sweep run again at the same
    instant by a fresh machine (the restarted operator): the replayed
    records dedupe onto the originals, one per episode, and the journal is
    the uninterrupted run's, record id for record id."""
    clean, crashed = World(PORT), World(PORT)
    two_episodes(clean)
    flaky = crashed.client = _RefuseEachPlanOnce(crashed.client)

    def replay():
        if flaky.tripped:
            flaky.tripped = False
            crashed.sweep(**EPISODE_SPEC)

    two_episodes(crashed, after_sweep=replay)
    assert len(flaky.refused) == 2
    assert crashed.journal.replayed_total == 2
    assert crashed.episodes() == clean.episodes()
    assert ([r.record_id for r in crashed.journal.records()]
            == [r.record_id for r in clean.journal.records()])


def test_an_admin_clear_out_of_failed_ends_the_episode_id_too():
    """After the admin's label clear out of sticky ``failed``, the next
    failure opens a new episode in the port; the reference's stamped id
    survives the clear, and its next episode adopts the closed one."""
    def run(w):
        w.setup(verdict="failed")
        for dt in (1, 1, 6, 31, 31, 1):  # degraded ... failed
            w.sweep(**EPISODE_SPEC)
            w.clock.t += dt
        assert w.state() == w.s.m.FAILED
        first = w.anns()[w.c.PROVENANCE_EPISODE_ANNOTATION]
        w.set_verdict("passed")
        w.patch_node(labels={w.c.HEALTH_STATE_LABEL: None})
        w.sweep(**EPISODE_SPEC)
        w.clock.t += 60
        w.set_verdict("failed")
        for dt in (1, 1):  # degraded, quarantined: the plan mints the id
            w.sweep(**EPISODE_SPEC)
            w.clock.t += dt
        w.sweep(**EPISODE_SPEC)
        return first, w.anns()[w.c.PROVENANCE_EPISODE_ANNOTATION]

    first, second = run(World(PORT))
    assert first != second
    first, second = run(World(REF))
    assert first == second


# -- the transparent-snapshot gate (the reference's tests/test_migrate.py
# drives it through its migration controller; here the machine's own) ----------

def snapshot_gate(w, answer):
    """An expired drain deadline with the migrate sub-spec enabled: the
    machine asks the node's migrate agent for a snapshot first; ``answer``
    is the agent's result (None: it never answers)."""
    w.migrate = w.s.migrate_spec({"enabled": True, "snapshotWaitS": 30})
    w.setup(verdict="failed:2")
    w.to_quarantined(deadline=5)
    w.drain_sweep(deadline=5)  # publish; no ack ever
    w.clock.t += 6
    sm, _ = w.drain_sweep(deadline=5)  # the snapshot request
    assert w.state() == w.s.m.QUARANTINED and sm.deadline_misses == 0
    request = w.anns()[w.c.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION]
    assert w.events("MigrationSnapshotRequested")
    fingerprint = w.s.drain.node_plan(w.node()).fingerprint
    if answer is not None:
        w.patch_node(annotations={w.c.MIGRATE_SNAPSHOT_RESULT_ANNOTATION:
                                  '{"plan": "%s", %s}' % (fingerprint, answer)})
        w.clock.t += 1
    else:
        w.clock.t += 31
    sm, _ = w.drain_sweep(deadline=5)
    assert w.state() == w.s.m.REMEDIATING
    w.log.append([request, sm.snapshots_taken, sm.deadline_misses])


@pytest.mark.parametrize("answer", ['"ok": true, "step": 4', '"ok": false, "error": "unreadable"',
                                    None], ids=["taken", "failed", "never"])
def test_the_snapshot_gate_matches_reference(answer):
    ref, port = World(REF), World(PORT)
    snapshot_gate(ref, answer)
    snapshot_gate(port, answer)
    assert port.record() == ref.record(mapped=True)
    assert port.log[-1][1:] == ([1, 0] if answer and "true" in answer else [0, 1])


# -- the admin's clear lifts the machine's own cordon ------------------------------

def _admin_clear(w, sticky):
    """``cordonOnQuarantine`` on; the node driven to sticky ``failed`` or to
    flap-damped quarantine, then the admin removes the health label."""
    spec = {"cordonOnQuarantine": True}
    if sticky == "failed":
        w.setup(verdict="failed")
        for _ in range(3):
            w.sweep(**spec)
            w.clock.t += 30
        for _ in range(3):
            w.clock.t += 601
            w.sweep(**spec)
        assert w.state() == w.s.m.FAILED
    else:
        w.setup(verdict="passed")
        w.flap_once(**spec)
        w.flap_once(**spec)
        w.set_verdict("failed")
        w.sweep(**spec)
        assert w.state() == w.s.m.QUARANTINED
    assert w.node()["spec"].get("unschedulable")
    w.set_verdict("passed")
    w.patch_node(labels={w.c.HEALTH_STATE_LABEL: None})
    w.sweep(**spec)
    assert w.state() == w.s.m.HEALTHY
    return bool(w.node()["spec"].get("unschedulable"))


@pytest.mark.parametrize("sticky", ["failed", "flap-quarantine"])
def test_the_admin_s_clear_uncordons_a_node_the_machine_cordoned(sticky):
    """Input: cordonOnQuarantine, a node the machine cordoned and left in
    sticky ``failed`` (or flap-damped quarantine), the health label removed.
    The reference wipes the annotations and leaves the node cordoned
    (tpu_operator/health/machine.py: HealthStateMachine._process_node, the
    healthy branch); the port lifts the cordon, as its other exits do."""
    assert _admin_clear(World(REF), sticky) is True
    assert _admin_clear(World(PORT), sticky) is False


def test_the_admin_s_clear_keeps_a_cordon_when_the_machine_cordons_nothing():
    """Without cordonOnQuarantine the machine set no cordon, and an
    admin's own cordon stays through the clear."""
    w = World(PORT)
    w.setup(verdict="failed")
    w.client.patch("v1", "Node", NODE, {"spec": {"unschedulable": True}})
    for _ in range(3):
        w.sweep()
        w.clock.t += 30
    for _ in range(3):
        w.clock.t += 601
        w.sweep()
    assert w.state() == machine.FAILED
    w.set_verdict("passed")
    w.patch_node(labels={consts.HEALTH_STATE_LABEL: None})
    w.sweep()
    assert w.state() == machine.HEALTHY and w.node()["spec"]["unschedulable"] is True
