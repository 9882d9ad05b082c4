"""The port's decision-provenance journal (tpu_operator_torch/provenance/)
against the reference's, twin for twin with tests/test_provenance.py.

Each case runs on both packages with the same decisions on the same fake
clock and compares what they leave: record and episode ids (equal content
gives equal ids in both), canonical exports, the disk round trip, the
ConfigMap mirror, the causality audit, the four metric families
``wire_provenance`` feeds, and ``render_explain``'s text. The reference's
two cases that drive its autoscale and migration controllers
(``test_every_protocol_event_carries_trace_id``,
``test_autoscale_events_carry_trace_id``) wait for those controllers'
slices and are not twinned here.
"""

import json
import re
import types

import pytest

import test_torch_health as health_twins
from test_torch_operator_mapping import map_health_text
from tpu_operator import consts as ref_consts
from tpu_operator.client.errors import AlreadyExistsError as RefAlreadyExists
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.controllers.metrics import OperatorMetrics as RefMetrics
from tpu_operator import provenance as ref_prov
from tpu_operator_torch import consts
from tpu_operator_torch import provenance as prov
from tpu_operator_torch.client.errors import AlreadyExistsError
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.controllers.metrics import OperatorMetrics

NS = "tpu-operator"

SIDES = {
    "ref": types.SimpleNamespace(p=ref_prov, consts=ref_consts, Fake=RefFake,
                                 AlreadyExists=RefAlreadyExists, Metrics=RefMetrics),
    "port": types.SimpleNamespace(p=prov, consts=consts, Fake=FakeClient,
                                  AlreadyExists=AlreadyExistsError, Metrics=OperatorMetrics),
}


class Clock:
    def __init__(self, t=1_000.0):
        self.t = t

    def __call__(self):
        return self.t


def record_scale_down(j, episode="ep-1", victim="node-a", inputs=None):
    return j.record_decision(
        "autoscale", "scale-down", episode,
        {"type": "traffic-snapshot", "pool": "p"},
        inputs=inputs or {"attainment": 0.99},
        decision={"victim": victim},
        alternatives=[{"option": "hold", "reason": "forecast below target"}],
        actuations=[{"verb": "plan", "kind": "Node", "name": victim}],
        node=victim)


def close_episode(j, episode="ep-1", victim="node-a"):
    return j.record_decision(
        "autoscale", "scale-down-complete", episode,
        {"type": "drain-ack"}, decision={"node": victim},
        actuations=[{"verb": "delete", "kind": "Node", "name": victim}],
        outcome="node-deleted", node=victim)


def sample(side, metrics, name, **labels):
    """A sample's value from either package's metrics (0 when absent)."""
    if side.Metrics is RefMetrics:
        value = metrics.registry.get_sample_value(name, labels or None)
        return 0.0 if value is None else value
    want = name + ("{" + ",".join(f'{k}="{v}"' for k, v in sorted(labels.items())) + "}"
                   if labels else "")
    for line in metrics.scrape().decode().splitlines():
        if line.startswith(want + " "):
            return float(line.split()[-1])
    return 0.0


# -- the reference's cases, as scripts over either package ---------------------------

def case_replayed_decision_dedupes_on_content(s, tmp_path):
    clock = Clock()
    j = s.p.DecisionJournal(now=clock)
    first = record_scale_down(j, inputs={"attainment": 0.99})
    clock.t += 30.0
    replay = record_scale_down(j, inputs={"attainment": 0.97})
    assert replay is first
    assert j.recorded_total == 1 and j.replayed_total == 1
    other = record_scale_down(j, victim="node-b", episode="ep-2")
    assert other.record_id != first.record_id
    return [first.record_id, other.record_id, j.canonical_export()]


def case_episode_id_is_content_addressed(s, tmp_path):
    ids = [s.p.episode_id("scale-down", "node-a"), s.p.episode_id("scale-down", "node-b"),
           s.p.episode_id("x"), s.p.episode_id("health", "node-a", "failed", "2026-10-17T11:00:00Z")]
    assert ids[0] == s.p.episode_id("scale-down", "node-a") and ids[0] != ids[1]
    assert ids[2].startswith("ep-")
    return ids


def case_episode_chains_and_closes_across_subsystems(s, tmp_path):
    clock = Clock()
    j = s.p.DecisionJournal(now=clock)
    record_scale_down(j)
    clock.t += 10.0
    j.record_decision("migrate", "migrate", "ep-1", {"type": "annotation"}, node="node-a")
    assert not j.episode_complete("ep-1") and j.oldest_open_age() == 10.0
    clock.t += 20.0
    close_episode(j)
    chain = j.chain("ep-1")
    assert [r.subsystem for r in chain] == ["autoscale", "migrate", "autoscale"]
    assert [r.seq for r in chain] == [0, 1, 2]
    assert j.episode_complete("ep-1") and j.oldest_open_age() == 0.0
    (ep,) = j.episodes()
    assert ep["closed"] and ep["duration_s"] == 30.0 and ep["kind"] == "scale-down"
    return [[r.record_id for r in chain], j.episodes(), j.timeline()]


def case_prune_evicts_closed_episodes_before_open_ones(s, tmp_path):
    clock = Clock()
    j = s.p.DecisionJournal(now=clock, bound=4)
    record_scale_down(j, episode="ep-open", victim="node-z")  # stays open
    for i in range(3):
        clock.t += 1.0
        record_scale_down(j, episode=f"ep-{i}", victim=f"node-{i}")
        close_episode(j, episode=f"ep-{i}", victim=f"node-{i}")
    assert len(j.records()) <= 4 and j.pruned_total > 0
    assert j.chain("ep-open"), "the open episode must survive pruning"
    return [j.pruned_total, sorted(r.record_id for r in j.records()), j.debug_state()["records"]]


def case_disk_roundtrip_skips_torn_final_line(s, tmp_path):
    path = str(tmp_path / "journal.jsonl")
    clock = Clock()
    j = s.p.DecisionJournal(now=clock, path=path)
    record_scale_down(j)
    close_episode(j)
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"episode": "ep-torn", "subsys')
    j2 = s.p.DecisionJournal(now=clock, path=path)
    assert len(j2.records()) == 2 and j2.episode_complete("ep-1")
    assert j2.canonical_export() == j.canonical_export()
    with open(path, encoding="utf-8") as f:
        return [f.read(), j2.canonical_export()]


def case_crash_mid_episode_reloads_and_converges(s, tmp_path):
    path = str(tmp_path / "journal.jsonl")
    clock = Clock()
    j = s.p.DecisionJournal(now=clock, path=path)
    record_scale_down(j)
    j2 = s.p.DecisionJournal(now=clock, path=path)  # a fresh process reloads
    assert len(j2.records()) == 1 and not j2.episode_complete("ep-1")
    record_scale_down(j2)  # the crash replay of the same decision
    assert j2.replayed_total == 1 and j2.recorded_total == 0
    close_episode(j2)
    assert j2.episode_complete("ep-1")
    return j2.canonical_export()


def case_configmap_mirror_and_already_exists_stand_down(s, tmp_path):
    client = s.Fake()
    j = s.p.DecisionJournal(client=client, namespace=NS)
    rec = record_scale_down(j)
    cm = client.get("v1", "ConfigMap", f"prov-{rec.record_id}", NS)
    assert cm["metadata"]["labels"][s.consts.PROVENANCE_LABEL] == "autoscale"
    assert json.loads(cm["data"]["record"])["episode"] == "ep-1"
    j2 = s.p.DecisionJournal(client=client, namespace=NS)
    record_scale_down(j2)
    assert j2.mirror_errors_total == 0
    with pytest.raises(s.AlreadyExists):
        client.create(cm)
    record = json.loads(cm["data"]["record"])
    record.pop("ts")
    return [cm["metadata"]["name"], cm["metadata"]["labels"], record]


def case_observer_classifies_wire_actuations(s, tmp_path):
    client = s.Fake()
    for name in ("node-a", "node-b"):
        client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": name}})
    obs = s.p.ActuationObserver(client)
    c = s.consts
    obs.patch("v1", "Node", "node-a", {"metadata": {"annotations": {
        c.RETILE_PLAN_ANNOTATION: "{}"}}})
    obs.patch("v1", "Node", "node-a", {"metadata": {"annotations": {
        c.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION: "{}"}}})
    obs.patch("v1", "Node", "node-b", {"metadata": {"annotations": {
        c.MIGRATION_INBOUND_ANNOTATION: "{}"}}})
    obs.patch("v1", "Node", "node-a", {"metadata": {"annotations": {
        c.RETILE_PLAN_ANNOTATION: None}}})  # clearing a key is bookkeeping
    client.create({"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": "some-pod", "namespace": NS}})
    obs.delete("v1", "Node", "node-a")
    obs.delete("v1", "Pod", "some-pod", NS)  # pods are not audited
    assert [o.verb for o in obs.observed] == ["plan", "snapshot", "restore", "delete"]
    return [o.key() for o in obs.observed]


def case_causality_audit_orphans_and_incomplete(s, tmp_path):
    j = s.p.DecisionJournal()
    record_scale_down(j)
    observed = [s.p.ObservedActuation("plan", "Node", "node-a"),
                s.p.ObservedActuation("delete", "Node", "node-ghost")]
    first = s.p.causality_audit(j, observed)
    assert not first["ok"]
    assert [o["name"] for o in first["orphans"]] == ["node-ghost"]
    assert [i["name"] for i in first["incomplete"]] == ["node-a"]
    close_episode(j)
    second = s.p.causality_audit(j, [s.p.ObservedActuation("plan", "Node", "node-a"),
                                     s.p.ObservedActuation("delete", "Node", "node-a")])
    assert second["ok"] and second["covered"] == 2
    assert second["complete_episodes"] == second["episodes"] == 1
    return [first, second]


def case_wire_provenance_feeds_all_four_families(s, tmp_path):
    clock = Clock()
    metrics = s.Metrics()
    j = s.p.DecisionJournal(now=clock)
    metrics.wire_provenance(j)
    record_scale_down(j)
    clock.t += 12.0
    close_episode(j)
    got = [sample(s, metrics, "tpu_operator_decision_records_total", subsystem="autoscale"),
           sample(s, metrics, "tpu_operator_episode_duration_seconds_count", kind="scale-down"),
           sample(s, metrics, "tpu_operator_episode_duration_seconds_sum", kind="scale-down")]
    s.p.causality_audit(j, [s.p.ObservedActuation("delete", "Node", "node-ghost")])
    got.append(sample(s, metrics, "tpu_operator_provenance_orphans_total"))
    record_scale_down(j, episode="ep-stuck", victim="node-s")
    clock.t += 900.0
    got.append(sample(s, metrics, "tpu_operator_episode_open_age_seconds"))
    assert got == [2.0, 1.0, 12.0, 1.0, 900.0]
    return got


def case_render_explain_shows_causal_chain(s, tmp_path):
    clock = Clock()
    j = s.p.DecisionJournal(now=clock)
    record_scale_down(j)
    clock.t += 30.0
    close_episode(j)
    text = s.p.render_explain(j.timeline(), node="node-a")
    assert "episode ep-1  scale-down  node=node-a  CLOSED in 30.0s" in text
    assert "autoscale/scale-down" in text
    assert "rejected: hold — forecast below target" in text
    assert "actuation: delete Node/node-a" in text
    assert "outcome: node-deleted" in text
    assert s.p.render_explain(j.timeline(), node="nope") == ""
    record_scale_down(j, episode="ep-open", victim="node-o")
    open_text = s.p.render_explain(j.timeline(), episode="ep-open")
    assert "OPEN" in open_text
    return [text, open_text]


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}
#: the reference's cases that drive controllers the port does not have yet
WAITING = {"every_protocol_event_carries_trace_id", "autoscale_events_carry_trace_id"}


def test_the_twins_are_the_reference_s_cases_but_the_waiting_two():
    import ast

    with open(__file__.replace("test_torch_provenance.py", "test_provenance.py")) as f:
        tree = ast.parse(f.read())
    ref_tests = {n.name[len("test_"):] for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert set(CASES) == ref_tests - WAITING and WAITING <= ref_tests


@pytest.mark.parametrize("case", sorted(CASES))
def test_journal_matches_reference(case, tmp_path):
    ref = CASES[case](SIDES["ref"], tmp_path / "ref")
    port = CASES[case](SIDES["port"], tmp_path / "port")
    assert port == ref


@pytest.fixture(autouse=True)
def _dirs(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()


def _episodes_named(text: str) -> str:
    names = {}
    return re.sub(r"ep-[0-9a-f]+", lambda m: names.setdefault(m.group(0), f"ep{len(names) + 1}"),
                  text)


def test_render_explain_of_a_health_episode_is_the_reference_s_after_the_mapping():
    """A drain-gated health episode (plan, ack, remediation, recovery) on
    both machines renders the same chain: the port's text is the
    reference's after the mapping, episode ids named by order."""
    ref, port = health_twins.World(health_twins.REF), health_twins.World(health_twins.PORT)
    health_twins.case_drain_gate_recovery_retires_plan_and_ack(ref)
    health_twins.case_drain_gate_recovery_retires_plan_and_ack(port)
    want = ref_prov.render_explain(ref.journal.timeline(), node="node-0")
    got = prov.render_explain(port.journal.timeline(), node="node-0")
    assert "health/drain-plan" in got and "outcome: recovered" in got
    assert _episodes_named(got) == _episodes_named(map_health_text(want))
    # the same record dicts render byte-identically in either package
    assert prov.render_explain(ref.journal.timeline()) == want
