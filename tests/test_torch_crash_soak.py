"""A health episode killed mid-way, on both packages: the twin of
tests/test_crash_soak.py's tier-1 case (``test_crash_episode_baseline_and_sampled_kills``)
and of its coverage-complete matrix (``test_crash_point_matrix_full_episode``,
slow as the reference's).

Each package's whole operator runs on
``CachedClient(WriteBatcher(CrashPointClient(RestClient)))`` against its own
MiniApiServer and in-memory kubelet; the node agents (feature discovery and
the slice partitioner, over fake NVML on the port's side) and a simulated
training job use a plain client. The episode: join, a GPU (chip) degrades,
the drain plan, the job's ack and checkpoint, the re-tile, remediation, the
job resumed from its checkpoint, recovery, the layout restored. The
crash-free run enumerates the mutating sites, the same on both packages once
the reference's names are mapped; a kill just before and just after the
first drain-plan write must each converge to the baseline's terminal state
with one ``RetilePlanned``, one ``NodeHealthRemediating``, no expired
deadline and the job resumed at its acked step, on both packages alike. The
slow matrix kills the port's operator before and after every site, in an
order shuffled by ``CRASH_SOAK_SEED``. The machinery (the crash harness) is
tests/test_torch_migrate.py's.
"""

import json
import os
import random
import time
import types

import pytest

from test_torch_migrate import CRASH_PORT, CRASH_REF, CrashEpisode, operand_images  # noqa: F401
from test_torch_operator_mapping import map_crash_site, number_journal_sites
from tpu_operator import consts as ref_consts
from tpu_operator.health import REMEDIATING as REF_REMEDIATING
from tpu_operator.health import node_health_state as ref_health_state
from tpu_operator.partitioner import sync_once as ref_sync_once
from tpu_operator.partitioner.partitioner import read_handoff as ref_read_handoff
from tpu_operator.validator.feature_discovery import sync_node_labels as ref_sync_labels
from tpu_operator_torch import consts
from tpu_operator_torch.client import cache as port_cache
from tpu_operator_torch.health import REMEDIATING, node_health_state
from tpu_operator_torch.partitioner.partitioner import read_handoff, sync_once
from tpu_operator_torch.testing import fake_nvml
from tpu_operator_torch.validator.feature_discovery import sync_node_labels

#: the reference's layout (YAML) and the port's (JSON): one group per chip/GPU
REF_PARTITIONS = ("version: v1\npartitions:\n  single-chip:\n"
                  "    - {chips: 1, topology: 1x1, count: all}\n")
PORT_PARTITIONS = json.dumps({"partitions": {"single-chip": [{"chips": 1, "count": "all"}]}})
#: annotations whose values are run-dependent (wall-clock stamps, spans)
VOLATILE = (consts.HEALTH_FLAP_HISTORY_ANNOTATION, consts.TRACE_SPANS_ANNOTATION,
            consts.IMAGE_PREPULL_ANNOTATION)
EVENT_REASONS = ("RetilePlanned", "NodeHealthFlapping", "NodeHealthRemediating",
                 "NodeHealthDegraded", "NodeHealthQuarantined", "NodeHealthRecovered",
                 "RetileDeadlineExpired")

HEALTH_REF = types.SimpleNamespace(
    crash=CRASH_REF, health_state=ref_health_state, remediating=REF_REMEDIATING,
    read_handoff=ref_read_handoff, partitions=REF_PARTITIONS, dev="accel",
    dev_env="TPU_DEV_GLOBS",
    labels=lambda plain, name, status: ref_sync_labels(plain, name, use_jax=False),
    sync=lambda plain, name, config, handoff, status: ref_sync_once(
        plain, name, config, handoff, status_dir=status, drain_deadline_s=120))
_NVML = fake_nvml.FakeNvml(fake_nvml.random_gpus(8, 3))
HEALTH_PORT = types.SimpleNamespace(
    crash=CRASH_PORT, health_state=node_health_state, remediating=REMEDIATING,
    read_handoff=read_handoff, partitions=PORT_PARTITIONS, dev="nvidia",
    dev_env=consts.GPU_DEV_GLOBS_ENV,
    labels=lambda plain, name, status: sync_node_labels(plain, name, device="cpu",
                                                        status_dir=status),
    sync=lambda plain, name, config, handoff, status: sync_once(
        plain, name, config, handoff, status_dir=status, drain_deadline_s=120,
        nvml_lib=_NVML))


def barrier(passed, failed=None):
    payload = {"passed": passed, "n_devices": 8, "local_chips": list(range(8))}
    if failed is not None:
        payload["failed_local_chips"] = list(failed)
    return payload


class HealthCrashEpisode(CrashEpisode):
    """One join, degrade, drain, re-tile, remediate, recover episode."""

    def __init__(self, h, tmp_path, monkeypatch, arm=None):
        super().__init__(h.crash, tmp_path, arm)
        self.h = h
        devdir = tmp_path / "dev"
        devdir.mkdir()
        for i in range(8):
            (devdir / f"{h.dev}{i}").write_text("")
        monkeypatch.setenv(h.dev_env, str(devdir / f"{h.dev}*"))
        monkeypatch.setenv("STATUS_DIR", str(tmp_path / "node" / "status"))
        self.config = tmp_path / "partitions.cfg"
        self.config.write_text(h.partitions)
        self.status = h.crash.Status(str(tmp_path / "node" / "status"))
        self.status.write("workload", barrier(True))
        self.handoff = str(tmp_path / "node" / "handoff")
        self.plain.create(self.node_object("node-a"))

    def agent_pass(self):
        self.h.labels(self.plain, "node-a", self.status.directory)
        self.h.sync(self.plain, "node-a", str(self.config), self.handoff,
                    self.status.directory)

    def health(self):
        return self.h.health_state(self.node("node-a"))

    def slice_state(self):
        return (self.node("node-a")["metadata"].get("labels") or {}).get(
            consts.TPU_SLICE_STATE_LABEL)

    def annotations(self):
        return self.node("node-a")["metadata"].get("annotations") or {}

    def event_count(self, reason):
        return sum(int(e.get("count") or 1) for e in self.plain.list("v1", "Event", "tpu-operator")
                   if e.get("reason") == reason and e["involvedObject"]["name"] == "node-a")

    def terminal_state(self):
        node = self.node("node-a")
        return {"labels": dict(node["metadata"].get("labels") or {}),
                "annotations": {k: v for k, v in self.annotations().items() if k not in VOLATILE},
                "unschedulable": bool((node.get("spec") or {}).get("unschedulable"))}

    def run(self):
        s, drain = self.s, self.s.drain
        self.plain.create(s.new_policy(spec={}))
        self.apps[0].start()
        self.wait(lambda: (self.plain.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
                           .get("status") or {}).get("state") == "ready", "the install ready")
        self.plain.patch("v1", "Node", "node-a", {"metadata": {"labels": {
            consts.TPU_SLICE_CONFIG_LABEL: "single-chip"}}})
        self.agent_pass()
        assert self.slice_state() == "success"
        self.wait(lambda: self.health() == "", "healthy in steady state")
        original = self.h.read_handoff(self.handoff)["groups"]
        assert len(original) == 8

        job = s.Job(self.plain, "node-a", self.status)
        for _ in range(5):
            job.tick()
        # GPU 2 degrades mid-training
        self.status.write("workload", barrier(False, failed=[2]))
        self.agent_pass()
        self.wait(lambda: drain.node_plan(self.node("node-a")) is not None, "the drain plan")
        plan = drain.node_plan(self.node("node-a"))
        job.tick()  # sees the plan: checkpoint, ack
        ack_step = job.step
        assert job.acked_plans == [plan.fingerprint]
        for _ in range(2):
            job.tick()  # steps inside the window, after the checkpoint
        self.agent_pass()  # the ack mirrored, the layout re-tiled
        self.wait(lambda: self.slice_state() == "retiled", "the incremental re-tile")
        self.wait(lambda: self.health() == self.h.remediating, "the ack releasing remediation")
        job.crash()
        resume_step = job.resume()
        job.tick()
        healthy = barrier(True)
        healthy["drain_ack"] = drain.read_drain_ack(self.status)
        self.status.write("workload", healthy)
        self.agent_pass()
        self.wait(lambda: self.health() == "", "healthy again")
        drain.maybe_ack_plan(self.plain, "node-a", self.status)
        assert drain.read_drain_ack(self.status) is None
        self.agent_pass()
        self.wait(lambda: not (set(self.annotations()) & {
            consts.RETILE_PLAN_ANNOTATION, consts.DRAIN_ACK_ANNOTATION,
            consts.HEALTH_ATTEMPTS_ANNOTATION}), "the episode's artifacts retired")
        self.agent_pass()
        self.wait(lambda: self.slice_state() == "success", "the configured layout restored")
        self.wait(lambda: self.h.read_handoff(self.handoff)["groups"] == original,
                  "the handoff restored")
        return {"terminal": self.terminal_state(),
                "events": {r: self.event_count(r) for r in EVENT_REASONS},
                "ack_step": ack_step, "resume_step": resume_step,
                "sites": list(self.crashpoints[0].sites), "all_sites": self.all_sites(),
                "fired": self.crashpoints[0].fired, "crashes": self.crashes}


def run_episode(h, tmp_path, monkeypatch, arm=None):
    episode = HealthCrashEpisode(h, tmp_path, monkeypatch, arm)
    try:
        return episode.run()
    finally:
        episode.teardown()


def check_invariants(summary, baseline):
    assert summary["terminal"] == baseline["terminal"]
    assert summary["events"]["RetilePlanned"] == 1, summary["events"]
    assert summary["events"]["NodeHealthFlapping"] == 0
    assert summary["events"]["NodeHealthRemediating"] == 1
    assert summary["events"]["RetileDeadlineExpired"] == 0
    for reason in ("NodeHealthDegraded", "NodeHealthQuarantined", "NodeHealthRecovered"):
        assert summary["events"][reason] <= 1, reason
    assert summary["resume_step"] == summary["ack_step"] >= 5


def test_crash_episode_baseline_and_sampled_kills(tmp_path, monkeypatch, operand_images):
    baselines = {}
    for h in (HEALTH_REF, HEALTH_PORT):
        name = "port" if h.crash.port else "ref"
        with monkeypatch.context() as m:
            baseline = run_episode(h, tmp_path / name / "baseline", m)
        check_invariants(baseline, baseline)
        assert baseline["crashes"] == 0 and not baseline["fired"]
        assert len(baseline["sites"]) >= 10, baseline["sites"]
        baselines[name] = baseline
    ref, port = baselines["ref"], baselines["port"]
    assert port["events"] == ref["events"]
    assert (port["ack_step"], port["resume_step"]) == (ref["ack_step"], ref["resume_step"])
    assert port["terminal"]["labels"][consts.TPU_SLICE_STATE_LABEL] == \
        ref["terminal"]["labels"][ref_consts.TPU_SLICE_STATE_LABEL] == "success"
    for h in (HEALTH_REF, HEALTH_PORT):
        name = "port" if h.crash.port else "ref"
        plan_site = next(x for x in baselines[name]["sites"]
                         if consts.RETILE_PLAN_ANNOTATION in x and x.startswith("PATCH"))
        for i, when in enumerate(("before", "after")):
            with monkeypatch.context() as m:
                summary = run_episode(h, tmp_path / name / f"kill{i}", m, arm=(plan_site, when))
            assert summary["fired"] and summary["crashes"] == 1, (name, when)
            check_invariants(summary, baselines[name])


def test_the_health_episode_s_sites_are_the_reference_s(tmp_path, monkeypatch,
                                                          operand_images):  # noqa: F811
    """The crash-free episode writes at the same sites on both packages
    once the reference's names are mapped and the decision journal's
    mirror writes are numbered by order (tests/test_torch_operator_mapping.py):
    the port's matrix kills every write the reference's does. An Event
    compares by its object and reason: whether a repeat aggregates into a
    PUT depends on the interleaving, as the reference's matrix says in
    exempting Event sites. The migration twin holds its sites the same way
    (tests/test_torch_migrate.py)."""
    sites = {}
    for h in (HEALTH_REF, HEALTH_PORT):
        name = "port" if h.crash.port else "ref"
        with monkeypatch.context() as m:
            sites[name] = run_episode(h, tmp_path / name, m)["sites"]

    def split(found):
        state = sorted(x for x in found if " Event/" not in x)
        events = {x.split(" ", 1)[1] for x in found if " Event/" in x}
        return state, events

    mapped = number_journal_sites([map_crash_site(x) for x in sites["ref"]])
    assert split(number_journal_sites(sites["port"])) == split(mapped)
    assert len(sites["port"]) == len(set(sites["port"])) >= 10


@pytest.mark.slow
def test_crash_point_matrix_full_episode(tmp_path, monkeypatch, operand_images):  # noqa: F811
    """Coverage-complete on the port: every mutating site of the crash-free
    episode is killed both before and after its write, in the order
    ``CRASH_SOAK_SEED`` (default 20260805) shuffles, and every replay
    converges. An armed site that does not fire again fails, but an Event's
    (whether an announcement aggregates into a PUT depends on the
    interleaving); a state site a replay writes that the record run did not
    fails the whole matrix."""
    with monkeypatch.context() as m:
        baseline = run_episode(HEALTH_PORT, tmp_path / "baseline", m)
    check_invariants(baseline, baseline)
    sites = baseline["sites"]
    assert len(sites) >= 10, sites
    matrix = [(site, when) for site in sites for when in ("before", "after")]
    random.Random(int(os.environ.get("CRASH_SOAK_SEED", "20260805"))).shuffle(matrix)
    observed, failures = set(sites), []
    for i, (site, when) in enumerate(matrix):
        with monkeypatch.context() as m:
            summary = run_episode(HEALTH_PORT, tmp_path / f"ep{i}", m, arm=(site, when))
        observed |= summary["all_sites"]
        if not summary["fired"]:
            if " Event/" not in site:
                failures.append(f"uncovered crash site ({when}): {site}")
            continue
        try:
            check_invariants(summary, baseline)
        except AssertionError as e:
            failures.append(f"kill {when} {site}: {e}")
    uncovered = {x for x in observed - set(sites) if " Event/" not in x}
    if uncovered:
        failures.append("state-mutating sites outside the replay matrix (record run "
                        f"missed them): {sorted(uncovered)}")
    assert not failures, "\n".join(failures)


#: how late the lagging Node watch below delivers each event
WATCH_LAG_S = 0.15


def test_a_lagging_node_watch_announces_each_transition_once(tmp_path, monkeypatch,
                                                             operand_images):  # noqa: F811
    """The port's operator with its Node informer a watch delivery behind
    (each event 150 ms late): its sweeps read their own batched state writes
    back from the cache at once (the batcher hands each flushed object to
    the cache), so none re-derives a transition that already landed and
    announces it twice. The reference's flush bypasses its cache, and a
    lagging watch makes it announce Degraded, Quarantined and Recovered
    again (tests/test_torch_operator_mapping.py, the client chain)."""
    on_event = port_cache._Informer._on_event

    def late(self, event):
        if self.kind == "Node":
            time.sleep(WATCH_LAG_S)
        on_event(self, event)

    monkeypatch.setattr(port_cache._Informer, "_on_event", late)
    with monkeypatch.context() as m:
        summary = run_episode(HEALTH_PORT, tmp_path / "lagging", m)
    check_invariants(summary, summary)
    assert summary["events"]["NodeHealthDegraded"] == 1, summary["events"]
    assert summary["events"]["NodeHealthQuarantined"] == 1, summary["events"]

