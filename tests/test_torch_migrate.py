"""The migrate agent of the PyTorch port (tpu_operator_torch/migrate/) against
the reference's (tpu_operator/migrate/{agent,checkpoint}.py), modelled on
the agent and checkpoint tests of tests/test_migrate.py: twin nodes in
twin fake apiservers, the same requests, the same clock. The annotations,
barrier stamps, v2 checkpoint payloads and Events must agree field by
field; a restore re-maps its manifest over the GPU node's NVML links where
the reference re-tiles on its ICI grid, and where both must place the same
GPUs they do. Then the migration crash episode on both packages (a kill
before and after the durable state write) and, slow, the port's matrix of
a kill before and after every site of the migration.
"""

import json
import os
import random

import pytest

from tpu_operator import consts as ref_consts
from tpu_operator.controllers.metrics import OperatorMetrics
from tpu_operator.health import drain as ref_drain
from tpu_operator.migrate import agent as ref_agent
from tpu_operator.migrate import checkpoint as ref_ckpt
from tpu_operator.testing import MiniApiServer
from tpu_operator.validator.status import StatusFiles as RefStatusFiles
from tpu_operator_torch import consts, nvml
from tpu_operator_torch.client import ApiClient
from tpu_operator_torch.health import drain
from tpu_operator_torch.migrate import agent
from tpu_operator_torch.migrate import checkpoint as ckpt
from tpu_operator_torch.partitioner.partitioner import node_links
from tpu_operator_torch.testing import fake_nvml
from tpu_operator_torch.validator import main as vmain
from tpu_operator_torch.controllers.metrics import OperatorMetrics as PortOperatorMetrics
from tpu_operator_torch.validator.status import StatusFiles

NS = "tpu-operator"
V5E = "tpu-v5-lite-podslice"
NOW = 5.0


def _now():
    return NOW


def mk_node(name):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": {
                ref_consts.GKE_TPU_ACCELERATOR_LABEL: V5E,
                consts.TPU_SLICE_CONFIG_LABEL: "pairs"}},
            "status": {}}


class Twins:
    def __init__(self, fake_client, tmp_path, name="n1"):
        self.name = name
        self.clients = {"ref": type(fake_client)(), "port": type(fake_client)()}
        for client in self.clients.values():
            client.create(mk_node(name))
        self.root = tmp_path
        self.status = {"ref": RefStatusFiles(str(tmp_path / "ref" / name)),
                       "port": StatusFiles(str(tmp_path / "port" / name))}

    def annotate(self, key, value):
        for client in self.clients.values():
            client.patch("v1", "Node", self.name, {"metadata": {"annotations": {
                key: json.dumps(value)}}})

    def annotation(self, key):
        out = {}
        for side, client in self.clients.items():
            raw = (client.get("v1", "Node", self.name)["metadata"].get("annotations")
                   or {}).get(key)
            out[side] = json.loads(raw) if raw else None
        assert out["port"] == out["ref"]
        return out["port"]

    def checkpoints(self, drop=("compile_cache",)):
        out = {}
        for side, status in self.status.items():
            mod = ref_drain if side == "ref" else drain
            loaded = mod.load_checkpoint(mod.checkpoint_path(status.directory))
            text = json.dumps(loaded).replace(status.directory, "<status>")
            out[side] = {k: v for k, v in json.loads(text).items() if k not in drop} \
                if loaded else None
        return out

    def barriers(self):
        out = {side: {k: v for k, v in (s.read("workload") or {}).items()
                      if k not in ("timestamp", "host")}
               for side, s in self.status.items()}
        assert out["port"] == out["ref"]
        return out["port"]


def snapshot_fp():
    return drain.plan_fingerprint("migrate:n1->n2", [])


# -- the checkpoint schema -------------------------------------------------------------

def test_v2_checkpoint_payload_matches_the_reference(tmp_path):
    groups = [{"topology": "nvlink", "chips": [0, 1, 2, 3]}]
    for side, mod, dmod in (("ref", ref_ckpt, ref_drain), ("port", ckpt, drain)):
        mod.save_checkpoint_v2(
            str(tmp_path / side / "drain-checkpoint.json"), 42, rng_state=[1, 2],
            optimizer_state=mod.optimizer_state_pointer(str(tmp_path)),
            manifest=mod.build_manifest("pairs", [3, 1], groups=groups), transparent=True,
            extra={"migrated_from": "n0"}, now=_now)
    ref = ref_drain.load_checkpoint(str(tmp_path / "ref" / "drain-checkpoint.json"))
    port = drain.load_checkpoint(str(tmp_path / "port" / "drain-checkpoint.json"))
    assert port == ref
    assert ckpt.checkpoint_version(port) == 2
    assert ckpt.manifest_layout(port) == drain.plan_fingerprint("pairs", [1, 3])


@pytest.mark.parametrize("value", [None, {"step": 1}, {"step": 1, "version": "x"},
                                   {"version": 2}, [1], "garbage"])
def test_checkpoint_version_matches_the_reference(value):
    assert ckpt.checkpoint_version(value) == ref_ckpt.checkpoint_version(value)
    assert ckpt.manifest_layout(value if isinstance(value, dict) else None) == \
        ref_ckpt.manifest_layout(value if isinstance(value, dict) else None)


def test_v1_checkpoints_still_load(tmp_path):
    path = str(tmp_path / "drain-checkpoint.json")
    drain.save_checkpoint(path, 7, rng_state=[3])
    loaded = drain.load_checkpoint(path)
    assert loaded["step"] == 7 and ckpt.checkpoint_version(loaded) == 1
    assert ckpt.manifest_layout(loaded) is None


def _pcie8():
    gpus = fake_nvml.random_gpus(8, 11)
    return node_links(fake_nvml.FakeNvml(gpus, links=fake_nvml.pcie_links(
        gpus, fake_nvml.two_sockets)))[1]


PAIRS = [{"chips": [0, 1]}, {"chips": [2, 3]}, {"chips": [4, 5]}, {"chips": [6, 7]}]


@pytest.mark.parametrize("blocked", [[], [2], [0, 1, 2, 3, 4], [7]])
def test_remap_manifest_places_the_same_gpus_as_the_reference(blocked):
    """Pairs on a board of four PCIe-switch pairs, beside pairs on the v5e
    2x4 grid: the same shards survive, on the same GPUs, or neither side
    can place them."""
    ref = ref_ckpt.remap_manifest(
        ref_ckpt.build_manifest("pairs", [], groups=[dict(g, topology="1x2") for g in PAIRS]),
        V5E, 8, blocked, "pairs")
    port = ckpt.remap_manifest(
        ckpt.build_manifest("pairs", [], groups=[dict(g, topology="pcie-switch")
                                                 for g in PAIRS]),
        _pcie8(), blocked, "pairs")
    assert (port is None) == (ref is None)
    if port is not None:
        for key in ("layout", "partition", "blocked"):
            assert port[key] == ref[key]
        assert [(s["shard"], s["chips"], s["arrays"]) for s in port["shards"]] == \
            [(s["shard"], s["chips"], s["arrays"]) for s in ref["shards"]]


def test_remap_moves_a_shard_within_its_class():
    """A deliberate difference: a shard is re-placed within its link
    class, not as a grid box; a 4-GPU shard on a socket moves to the other
    socket."""
    manifest = ckpt.build_manifest("halves", [], groups=[
        {"topology": "numa", "chips": [0, 1, 2, 3]}])
    out = ckpt.remap_manifest(manifest, _pcie8(), [1], "halves")
    assert out["shards"][0]["chips"] == [4, 5, 6, 7]
    assert out["shards"][0]["topology"] == "numa"
    assert out["blocked"] == [1]
    grid = ckpt.build_manifest("x", [], groups=[{"topology": "2x2", "chips": [0, 1, 2, 3]}])
    assert ckpt.remap_manifest(grid, _pcie8(), [], "x") is None  # a grid string: refused


# -- corrupt checkpoints -----------------------------------------------------------------

@pytest.mark.parametrize("raw, kind", [('{"step": 5', "torn"), ("[1, 2, 3]", "non-dict"),
                                       ('{"saved_at": 1.0}', "missing-step")])
def test_corrupt_kinds_match_the_reference(tmp_path, raw, kind):
    path = tmp_path / "drain-checkpoint.json"
    path.write_text(raw)
    seen = {"ref": [], "port": []}
    assert ref_drain.load_checkpoint(str(path), on_corrupt=lambda *a: seen["ref"].append(a)) \
        is None
    assert drain.load_checkpoint(str(path), on_corrupt=lambda *a: seen["port"].append(a)) \
        is None
    assert seen["port"] == seen["ref"] == [(kind, raw)]


def _events(client):
    return sorted(({k: v for k, v in e.items() if k not in ("firstTimestamp", "lastTimestamp")}
                   | {"metadata": {k: v for k, v in e["metadata"].items()
                                   if k in ("name", "namespace")}}
                   for e in client.list("v1", "Event", NS)), key=lambda e: e["metadata"]["name"])


def test_the_corrupt_event_is_recorded_once_as_the_reference_records_it(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path)
    ref_metrics, port_metrics = OperatorMetrics(), PortOperatorMetrics()
    reporters = {"ref": ref_ckpt.corrupt_reporter(t.clients["ref"], NS, "n1", ref_metrics),
                 "port": ckpt.corrupt_reporter(t.clients["port"], NS, "n1", port_metrics)}
    path = tmp_path / "drain-checkpoint.json"
    path.write_text('{"step": 5')
    for _ in range(3):
        for side, report in reporters.items():
            (ref_drain if side == "ref" else drain).load_checkpoint(str(path), on_corrupt=report)
    path.write_text("[1]")
    for side, report in reporters.items():
        (ref_drain if side == "ref" else drain).load_checkpoint(str(path), on_corrupt=report)
    assert ref_metrics.checkpoint_corrupt._value.get() == 4
    assert "tpu_operator_checkpoint_corrupt_total 4.0" in port_metrics.checkpoint_corrupt.expose()
    events = _events(t.clients["port"])
    assert len(events) == 2 and events == _events(t.clients["ref"])
    assert {e["reason"] for e in events} == {"CheckpointCorrupt"}


def test_a_torn_checkpoint_counts_once_on_the_operator_s_metrics(fake_client, tmp_path):
    """The reporter on the port's own ``OperatorMetrics`` (the reference's
    family, ``tpu_operator_checkpoint_corrupt_total``) counts a torn
    checkpoint once, as the reference's counts it on its metrics."""
    t = Twins(fake_client, tmp_path)
    counted = {}
    path = tmp_path / "drain-checkpoint.json"
    path.write_text('{"step": 5')
    for side, mod, dmod, metrics in (("ref", ref_ckpt, ref_drain, OperatorMetrics()),
                                     ("port", ckpt, drain, PortOperatorMetrics())):
        report = mod.corrupt_reporter(t.clients[side], NS, "n1", metrics=metrics)
        assert dmod.load_checkpoint(str(path), on_corrupt=report) is None
        text = metrics.scrape().decode()
        counted[side] = [line for line in text.splitlines()
                         if line.startswith("tpu_operator_checkpoint_corrupt_total ")]
    assert counted["port"] == counted["ref"] == ["tpu_operator_checkpoint_corrupt_total 1.0"]


def test_the_corrupt_event_over_http(tmp_path):
    """The port's own client creates the Event; a second emitter of the
    same token gets 409 and stands down."""
    srv = MiniApiServer()
    base = srv.start()
    try:
        client = ApiClient(base)
        report = ckpt.corrupt_reporter(client, NS, "n1")
        report("torn", '{"step": 5')
        report("torn", '{"step": 5')
        events = client.list("v1", "Event", NS)
        assert [e["reason"] for e in events] == ["CheckpointCorrupt"]
        assert events[0]["involvedObject"]["name"] == "n1"
    finally:
        srv.stop()


# -- snapshot ------------------------------------------------------------------------

def test_a_snapshot_matches_the_reference_and_stands_down_once_answered(
        fake_client, tmp_path, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv(consts.COMPILATION_CACHE_DIR_ENV, raising=False)
    t = Twins(fake_client, tmp_path)
    t.annotate(consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION, {"plan": snapshot_fp()})
    for side, status in t.status.items():
        status.write("workload", {"passed": True})
        with open((ref_agent if side == "ref" else agent).process_state_path(
                status.directory), "w") as f:
            json.dump({"step": 9, "rng_state": [4], "partition": "pairs", "blocked": [],
                       "groups": [{"topology": "nvlink", "chips": [0, 1]}]}, f)
    assert ref_agent.snapshot_once(t.clients["ref"], "n1", t.status["ref"], now=_now) is True
    assert agent.snapshot_once(t.clients["port"], "n1", t.status["port"], now=_now) is True
    result = t.annotation(consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION)
    assert result["ok"] is True and result["step"] == 9 and result["plan"] == snapshot_fp()
    loaded = t.checkpoints()
    assert loaded["port"] == loaded["ref"]
    assert loaded["port"]["transparent"] is True and loaded["port"]["step"] == 9
    barrier = t.barriers()
    assert barrier["migrate_snapshot"] == {"plan": snapshot_fp(), "step": 9, "taken_at": NOW}
    assert barrier["passed"] is True
    assert agent.snapshot_once(t.clients["port"], "n1", t.status["port"]) is False
    assert ref_agent.snapshot_once(t.clients["ref"], "n1", t.status["ref"]) is False


def test_a_snapshot_without_process_state_fails_as_the_reference_does(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path)
    t.annotate(consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION, {"plan": snapshot_fp()})
    assert ref_agent.snapshot_once(t.clients["ref"], "n1", t.status["ref"]) is False
    assert agent.snapshot_once(t.clients["port"], "n1", t.status["port"]) is False
    assert t.annotation(consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION)["ok"] is False
    assert t.checkpoints() == {"ref": None, "port": None}


def test_no_request_no_snapshot(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path)
    assert agent.snapshot_once(t.clients["port"], "n1", t.status["port"]) is False
    assert agent.snapshot_once(t.clients["port"], "absent", t.status["port"]) is False


def test_the_dump_hook_and_the_process_state_env(fake_client, tmp_path, monkeypatch):
    t = Twins(fake_client, tmp_path)
    t.annotate(consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION, {"plan": "p1"})
    mirror = tmp_path / "elsewhere.json"
    mirror.write_text(json.dumps({"step": 3}))
    monkeypatch.setenv(agent.PROCESS_STATE_ENV, str(mirror))
    assert agent.snapshot_once(t.clients["port"], "n1", t.status["port"]) is True
    assert t.checkpoints()["port"]["step"] == 3
    t.annotate(consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION, {"plan": "p2"})
    assert agent.snapshot_once(t.clients["port"], "n1", t.status["port"],
                               dump=lambda: {"step": 4}) is True
    assert t.checkpoints()["port"]["step"] == 4


# -- restore ------------------------------------------------------------------------

def test_a_restore_lands_the_transferred_checkpoint_remapped(fake_client, tmp_path,
                                                              monkeypatch):
    t = Twins(fake_client, tmp_path, name="n2")
    fp = snapshot_fp()
    groups = {"ref": [dict(g, topology="1x2") for g in PAIRS],
              "port": [dict(g, topology="pcie-switch") for g in PAIRS]}
    for side, mod, dmod in (("ref", ref_ckpt, ref_drain), ("port", ckpt, drain)):
        mod.save_checkpoint_v2(
            dmod.checkpoint_path(str(tmp_path / side / "n1")), 21, rng_state=[7],
            manifest=mod.build_manifest("pairs", [], groups=groups[side]), now=_now)
    t.annotate(consts.MIGRATION_INBOUND_ANNOTATION, {"plan": fp, "src": "n1", "step": 21})
    monkeypatch.setenv(ref_agent.TRANSFER_DIR_ENV, str(tmp_path / "ref"))
    assert ref_agent.restore_once(t.clients["ref"], "n2", t.status["ref"], namespace=NS,
                                  accelerator=V5E, total_chips=8, now=_now) is True
    monkeypatch.setenv(agent.TRANSFER_DIR_ENV, str(tmp_path / "port"))
    assert agent.restore_once(t.clients["port"], "n2", t.status["port"], namespace=NS,
                              links=_pcie8(), now=_now) is True
    result = t.annotation(consts.MIGRATION_RESTORE_ANNOTATION)
    assert result == {"plan": fp, "ok": True, "step": 21, "src": "n1"}
    loaded = t.checkpoints()
    for side in loaded:
        for shard in loaded[side]["manifest"]["shards"]:
            shard.pop("topology")
    assert loaded["port"] == loaded["ref"]
    assert loaded["port"]["migrated_from"] == "n1" and loaded["port"]["rng_state"] == [7]
    assert t.barriers()["migrate_restore"] == {"plan": fp, "step": 21, "restored_at": NOW}
    assert agent.restore_once(t.clients["port"], "n2", t.status["port"],
                              links=_pcie8()) is False
    assert ref_agent.restore_once(t.clients["ref"], "n2", t.status["ref"]) is False


def test_a_restore_from_the_inbound_minimum(fake_client, tmp_path, monkeypatch):
    monkeypatch.delenv(ref_agent.TRANSFER_DIR_ENV, raising=False)
    monkeypatch.delenv(agent.TRANSFER_DIR_ENV, raising=False)
    t = Twins(fake_client, tmp_path, name="n2")
    t.annotate(consts.MIGRATION_INBOUND_ANNOTATION, {"plan": snapshot_fp(), "src": "n1",
                                                     "step": 13})
    assert ref_agent.restore_once(t.clients["ref"], "n2", t.status["ref"], namespace=NS,
                                  now=_now) is True
    assert agent.restore_once(t.clients["port"], "n2", t.status["port"], namespace=NS,
                              now=_now) is True
    loaded = t.checkpoints()
    assert loaded["port"] == loaded["ref"] and loaded["port"]["step"] == 13
    t.annotation(consts.MIGRATION_RESTORE_ANNOTATION)


def test_an_unreadable_transfer_without_a_step_fails(fake_client, tmp_path, monkeypatch):
    t = Twins(fake_client, tmp_path, name="n2")
    (tmp_path / "xfer" / "n1").mkdir(parents=True)
    (tmp_path / "xfer" / "n1" / "drain-checkpoint.json").write_text('{"step": 5')
    monkeypatch.setenv(ref_agent.TRANSFER_DIR_ENV, str(tmp_path / "xfer"))
    monkeypatch.setenv(agent.TRANSFER_DIR_ENV, str(tmp_path / "xfer"))
    t.annotate(consts.MIGRATION_INBOUND_ANNOTATION, {"plan": snapshot_fp(), "src": "n1"})
    assert ref_agent.restore_once(t.clients["ref"], "n2", t.status["ref"], namespace=NS) \
        is False
    assert agent.restore_once(t.clients["port"], "n2", t.status["port"], namespace=NS) is False
    result = t.annotation(consts.MIGRATION_RESTORE_ANNOTATION)
    assert result["ok"] is False
    assert _events(t.clients["port"]) == _events(t.clients["ref"])
    assert [e["reason"] for e in _events(t.clients["port"])] == ["CheckpointCorrupt"]


# -- the component -----------------------------------------------------------------------

def test_the_cli_component(fake_client, tmp_path, monkeypatch):
    monkeypatch.delenv("NODE_NAME", raising=False)
    assert vmain.run(["-c", "migrate-agent", f"--status-dir={tmp_path}"],
                     client=fake_client) == 1
    t = Twins(fake_client, tmp_path)
    monkeypatch.setenv("NODE_NAME", "n1")
    monkeypatch.setattr(nvml, "_loaded", {"lib": fake_nvml.FakeNvml(
        fake_nvml.random_gpus(2, 1))})
    status_dir = t.status["port"].directory
    os.makedirs(status_dir, exist_ok=True)
    with open(agent.process_state_path(status_dir), "w") as f:
        json.dump({"step": 17}, f)
    t.annotate(consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION, {"plan": "p"})

    class Stop(Exception):
        pass

    def stop(_):
        raise Stop

    monkeypatch.setattr(agent.time, "sleep", stop)
    with pytest.raises(Stop):
        vmain.run(["-c", "migrate-agent", f"--status-dir={status_dir}"],
                  client=t.clients["port"])
    raw = t.clients["port"].get("v1", "Node", "n1")["metadata"]["annotations"][
        consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION]
    assert json.loads(raw)["step"] == 17


def test_a_failing_pass_does_not_end_the_loop(fake_client, tmp_path, monkeypatch):
    class Broken:
        def get(self, *a, **k):
            raise RuntimeError("boom")

    monkeypatch.setattr(agent, "snapshot_once", lambda *a, **k: 1 / 0)
    assert agent.run(Broken(), "n1", StatusFiles(str(tmp_path)), sleep_interval=0,
                     iterations=2, nvml_lib=fake_nvml.FakeNvml([])) == 0


def test_the_links_are_read_at_the_first_pass_nvml_answers(tmp_path, monkeypatch):
    fake = fake_nvml.FakeNvml(fake_nvml.random_gpus(2, 3), fail={"nvmlInit_v2": 9})
    seen = []
    monkeypatch.setattr(agent, "snapshot_once", lambda *a, **k: fake.fail.clear())
    monkeypatch.setattr(agent, "restore_once", lambda *a, links=None, **k: seen.append(links))
    assert agent.run(None, "n1", StatusFiles(str(tmp_path)), sleep_interval=0, iterations=3,
                     nvml_lib=fake) == 0
    assert seen == [None] + [[[None, "nvlink"], ["nvlink", None]]] * 2


# -- the migration controller: the cases of tests/test_migrate.py -----------------------
#
# Each case runs as a script on each package's fake apiserver, reconciler and
# clock; after every reconcile the nodes' migration annotations, the Events
# and the metrics are logged, and the reference's log (its nodes mapped to
# GPU nodes through tests/test_torch_operator_mapping.py) must equal the
# port's.

from test_torch_operator_mapping import map_node, map_pool_name  # noqa: E402
from tpu_operator.api.clusterpolicy import ClusterPolicy as RefPolicy  # noqa: E402
from tpu_operator.api.clusterpolicy import new_cluster_policy as ref_new_policy  # noqa: E402
from tpu_operator.autoscale.controller import AutoscaleReconciler as RefAutoscaler  # noqa: E402
from tpu_operator.cfgtool.main import _migration_cell as ref_migration_cell  # noqa: E402
from tpu_operator.client.fake import FakeClient as RefFake  # noqa: E402
from tpu_operator.controllers.runtime import Request as RefRequest  # noqa: E402
from tpu_operator.migrate import controller as ref_controller  # noqa: E402
from tpu_operator_torch.api.clusterpolicy import ClusterPolicy, new_cluster_policy  # noqa: E402
from tpu_operator_torch.autoscale.controller import AutoscaleReconciler  # noqa: E402
from tpu_operator_torch.cfgtool.main import _migration_cell  # noqa: E402
from tpu_operator_torch.client.fake import FakeClient  # noqa: E402
from tpu_operator_torch.controllers.runtime import Request  # noqa: E402
from tpu_operator_torch.migrate import controller  # noqa: E402

import types  # noqa: E402

REF_SIDE = types.SimpleNamespace(
    port=False, ctl=ref_controller, Fake=RefFake, Request=RefRequest, Policy=RefPolicy,
    new_policy=ref_new_policy, Autoscaler=RefAutoscaler, drain=ref_drain, ckpt=ref_ckpt,
    metrics=lambda m, name, **labels: (m.labels(**labels) if labels else m)._value.get())
PORT_SIDE = types.SimpleNamespace(
    port=True, ctl=controller, Fake=FakeClient, Request=Request, Policy=ClusterPolicy,
    new_policy=new_cluster_policy, Autoscaler=AutoscaleReconciler, drain=drain, ckpt=ckpt,
    metrics=lambda m, name, **labels: m.labels(**labels).read())

#: the pool of TPU_LABELS' nodes, named in the autoscaler's Events
REF_POOL = "v5-lite-podslice-2x2"
TPU_LABELS = {ref_consts.TPU_PRESENT_LABEL: "true",
              ref_consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
              ref_consts.GKE_TPU_TOPOLOGY_LABEL: "2x2"}
MIGRATION_KEYS = (consts.MIGRATE_REQUEST_ANNOTATION, consts.MIGRATION_STATE_ANNOTATION,
                  consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION,
                  consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION,
                  consts.MIGRATION_INBOUND_ANNOTATION, consts.MIGRATION_RESTORE_ANNOTATION,
                  consts.RETILE_PLAN_ANNOTATION, consts.DRAIN_ACK_ANNOTATION,
                  consts.PROVENANCE_EPISODE_ANNOTATION)


class Clock:
    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


class Cluster:
    """One package's cluster for the controller's cases, logging what each
    reconcile leaves."""

    def __init__(self, s):
        self.s = s
        self.client = s.Fake()
        self.clock = Clock()
        self.log = []

    def node(self, name):
        node = {"apiVersion": "v1", "kind": "Node",
                "metadata": {"name": name, "labels": dict(TPU_LABELS)},
                "status": {"capacity": {ref_consts.TPU_RESOURCE_NAME: "4"}}}
        return map_node(node) if self.s.port else node

    def setup(self, migrate=None, drain_deadline_s=60, nodes=("node-a", "node-b")):
        spec = {"enabled": True, "snapshotWaitS": 10, "restoreWaitS": 30}
        spec.update(migrate or {})
        self.client.create(self.s.new_policy(spec={
            "migrate": spec, "health": {"drainDeadlineS": drain_deadline_s}}))
        for name in nodes:
            self.client.create(self.node(name))

    def annotate(self, name, key, value):
        self.client.patch("v1", "Node", name, {"metadata": {"annotations": {key: value}}})

    def request(self, src, dst=None, reason="test"):
        req = {"reason": reason}
        if dst:
            req["dst"] = dst
        self.annotate(src, consts.MIGRATE_REQUEST_ANNOTATION, json.dumps(req))

    def stamp_ack(self, src, fp, step):
        self.annotate(src, consts.DRAIN_ACK_ANNOTATION,
                      self.s.drain.ack_annotation_value({"plan": fp, "step": step}))

    def stamp_restore(self, dst, fp, step, ok=True, src="node-a"):
        self.annotate(dst, consts.MIGRATION_RESTORE_ANNOTATION,
                      json.dumps({"plan": fp, "ok": ok, "step": step, "src": src}))

    def state(self, name="node-a"):
        return self.s.ctl.migration_state(self.client.get("v1", "Node", name))

    def reconciler(self):
        return self.s.ctl.MigrationReconciler(self.client, namespace=NS, now=self.clock)

    def reconcile(self, rec, name="node-a"):
        result = rec.reconcile(self.s.Request(name=name))
        self.observe(rec, result)
        return result

    def observe(self, rec, result=None):
        nodes = {}
        for n in self.client.list("v1", "Node"):
            anns = n["metadata"].get("annotations") or {}
            nodes[n["metadata"]["name"]] = {k: anns[k] for k in MIGRATION_KEYS if k in anns}
        events = sorted((e["reason"], e["involvedObject"]["name"], e["type"],
                         e["message"] if self.s.port else e["message"].replace(
                             REF_POOL, map_pool_name(REF_POOL)),
                         int(e.get("count") or 1))
                        for e in self.client.list("v1", "Event", NS))
        m = rec.metrics
        self.log.append({
            "nodes": nodes, "events": events,
            "requeue": None if result is None else result.requeue_after,
            "in_progress": self.s.metrics(m.migrations_in_progress, "") if not self.s.port
            else m.migrations_in_progress.labels().read(),
            "completed": self.s.metrics(m.migrations_total, "", outcome="completed"),
            "failed": self.s.metrics(m.migrations_total, "", outcome="failed"),
            "snapshots": m.migration_snapshots._value.get() if not self.s.port
            else m.migration_snapshots.labels().read(),
            "deadline_missed": m.drain_deadline_missed._value.get() if not self.s.port
            else m.drain_deadline_missed.labels().read()})

    def events(self, reason):
        return [e for e in self.client.list("v1", "Event", NS) if e.get("reason") == reason]


def case_cooperative_episode_drain_ack_to_done(w):
    w.setup()
    rec = w.reconciler()
    w.request("node-a", dst="node-b")
    w.reconcile(rec)
    fp = w.state()["plan"]
    assert fp == w.s.drain.plan_fingerprint("migrate:node-a->node-b", [])
    w.stamp_ack("node-a", fp, 17)
    w.reconcile(rec)
    assert w.state()["phase"] == "restoring"
    w.stamp_restore("node-b", fp, 17)
    w.reconcile(rec)
    assert w.state()["phase"] == "done" and w.state()["step"] == 17
    w.reconcile(rec)
    assert len(w.events("RetilePlanned")) == 1 and len(w.events("MigrationCompleted")) == 1


def case_deadline_expiry_takes_transparent_snapshot_path(w):
    w.setup(drain_deadline_s=5)
    rec = w.reconciler()
    w.request("node-a", dst="node-b")
    w.reconcile(rec)
    fp = w.state()["plan"]
    w.clock.t += 6.0
    w.reconcile(rec)
    assert w.state()["phase"] == "snapshotting"
    w.annotate("node-a", consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION, json.dumps(
        {"plan": fp, "ok": True, "step": 4, "manifest": w.s.ckpt.build_manifest("2x2", [])}))
    w.reconcile(rec)
    assert w.state()["phase"] == "restoring" and w.state()["step"] == 4
    w.stamp_restore("node-b", fp, 4)
    w.reconcile(rec)
    assert w.state()["phase"] == "done"


def case_failed_snapshot_falls_back_to_counted_force_retile(w):
    w.setup(drain_deadline_s=5)
    rec = w.reconciler()
    w.request("node-a", dst="node-b")
    w.reconcile(rec)
    fp = w.state()["plan"]
    w.clock.t += 6.0
    w.reconcile(rec)
    w.annotate("node-a", consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION, json.dumps(
        {"plan": fp, "ok": False, "error": "process state unreadable"}))
    w.reconcile(rec)
    assert w.state()["phase"] == "failed"
    assert w.s.drain.node_plan(w.client.get("v1", "Node", "node-a")) is not None


def case_snapshot_wait_zero_disables_the_snapshot_path(w):
    w.setup(migrate={"snapshotWaitS": 0}, drain_deadline_s=5)
    rec = w.reconciler()
    w.request("node-a", dst="node-b")
    w.reconcile(rec)
    w.clock.t += 6.0
    w.reconcile(rec)
    assert w.state()["phase"] == "failed" and not w.events("MigrationSnapshotRequested")


def case_vanished_destination_retargets_with_state_intact(w):
    w.setup(nodes=("node-a", "node-b", "node-c"))
    rec = w.reconciler()
    w.request("node-a", dst="node-b")
    w.reconcile(rec)
    fp = w.state()["plan"]
    w.stamp_ack("node-a", fp, 17)
    w.reconcile(rec)
    w.client.delete("v1", "Node", "node-b")
    w.reconcile(rec)
    assert w.state()["dst"] == "node-c" and w.state()["phase"] == "restoring"
    w.stamp_restore("node-c", w.state()["plan"], 17)
    w.reconcile(rec)
    assert w.state()["phase"] == "done"


def case_request_ignored_when_migration_disabled(w):
    w.client.create(w.s.new_policy(spec={}))
    for name in ("node-a", "node-b"):
        w.client.create(w.node(name))
    rec = w.reconciler()
    w.request("node-a", dst="node-b")
    w.reconcile(rec)
    assert w.state() is None
    assert w.s.drain.node_plan(w.client.get("v1", "Node", "node-a")) is None


def case_destination_pick_prefers_empty_uninvolved_nodes(w):
    w.setup(nodes=("node-a", "node-b", "node-c"))
    w.annotate("node-b", consts.MIGRATION_INBOUND_ANNOTATION,
               json.dumps({"plan": "x", "src": "other", "step": 1}))
    rec = w.reconciler()
    w.request("node-a")
    w.reconcile(rec)
    assert w.state()["dst"] == "node-c"


def case_no_destination_holds_with_a_blocked_event(w):
    w.setup(nodes=("node-a",))
    rec = w.reconciler()
    w.request("node-a")
    assert w.reconcile(rec).requeue_after == 5.0
    assert w.state() is None and len(w.events("MigrationBlocked")) == 1


def _autoscale_setup(w, n=3):
    w.client.create(w.s.new_policy(spec={
        "autoscale": {"enabled": True, "scaleDownDelayS": 0, "cooldownS": 0,
                      "minNodes": {"default": 1}, "maxNodes": {"default": 8}},
        "migrate": {"enabled": True}, "health": {"drainDeadlineS": 60}}))
    for i in range(n):
        w.client.create(w.node(f"node-{i}"))
    w.client.patch("tpu.ai/v1", "ClusterPolicy", "cluster-policy", {"metadata": {"annotations": {
        consts.TRAFFIC_SNAPSHOT_ANNOTATION: json.dumps({
            "ts": w.clock.t, "queue_depth": 0, "backlog_chips": 6.0, "attainment": 1.0})}}})
    kw = {"chips_per_node": 4} if w.s.port else {}
    return w.s.Autoscaler(w.client, namespace=NS, now=w.clock, **kw)


def _sweep(w, rec):
    result = rec.reconcile(w.s.Request(name="cluster-policy"))
    w.observe(rec, result)


def case_autoscaler_scale_down_delegates_to_migration(w):
    rec = _autoscale_setup(w)
    _sweep(w, rec)
    [victim] = [n["metadata"]["name"] for n in w.client.list("v1", "Node")
                if consts.MIGRATE_REQUEST_ANNOTATION in (n["metadata"].get("annotations") or {})]
    assert w.s.drain.node_plan(w.client.get("v1", "Node", victim)) is None
    w.clock.t += 5.0
    _sweep(w, rec)
    w.annotate(victim, consts.MIGRATION_STATE_ANNOTATION, json.dumps(
        {"phase": "done", "src": victim, "dst": "node-9", "plan": "fp", "step": 17, "seq": 5}))
    w.clock.t += 5.0
    _sweep(w, rec)
    assert victim not in [n["metadata"]["name"] for n in w.client.list("v1", "Node")]
    assert any("migrated" in e["message"] for e in w.events("AutoscaleDown"))


def case_autoscaler_counts_failed_migration_as_deadline_miss(w):
    rec = _autoscale_setup(w)
    _sweep(w, rec)
    [victim] = [n["metadata"]["name"] for n in w.client.list("v1", "Node")
                if consts.MIGRATE_REQUEST_ANNOTATION in (n["metadata"].get("annotations") or {})]
    w.annotate(victim, consts.MIGRATION_STATE_ANNOTATION, json.dumps(
        {"phase": "failed", "src": victim, "dst": "node-9", "plan": "fp", "seq": 3,
         "error": "snapshot failed"}))
    w.clock.t += 5.0
    _sweep(w, rec)
    assert victim not in [n["metadata"]["name"] for n in w.client.list("v1", "Node")]


CONTROLLER_CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
                    if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_the_migration_controller_matches_the_reference(case):
    ref, port = Cluster(REF_SIDE), Cluster(PORT_SIDE)
    CONTROLLER_CASES[case](ref)
    CONTROLLER_CASES[case](port)
    assert ref.log and port.log == ref.log


def test_a_state_row_still_in_the_batcher_is_not_advanced_twice():
    """The operator's chain, ``CachedClient → WriteBatcher``: another
    controller's window holds the ``done`` row in the batcher, and the
    source's next reconcile reads ``restoring`` from the cache. It waits for
    its own write instead of finalizing again: one completion counted, one
    ``done`` written (the reference finalizes twice here)."""
    from tpu_operator_torch.client.batch import WriteBatcher
    from tpu_operator_torch.client.cache import CachedClient

    w = Cluster(PORT_SIDE)
    w.setup()
    batcher = WriteBatcher(w.client, max_delay_s=3600.0)  # no deadline flush
    cached = CachedClient(batcher)
    batcher.bind_read_client(cached)
    rec = controller.MigrationReconciler(cached, namespace=NS, now=w.clock)
    try:
        w.request("node-a", dst="node-b")
        rec.reconcile(Request(name="node-a"))
        fp = w.state()["plan"]
        w.stamp_ack("node-a", fp, 17)
        rec.reconcile(Request(name="node-a"))
        assert w.state()["phase"] == "restoring"
        w.stamp_restore("node-b", fp, 17)
        batcher.begin()  # another controller's sweep
        rec.reconcile(Request(name="node-a"))
        assert w.state()["phase"] == "restoring"  # the done row is pending
        again = rec.reconcile(Request(name="node-a"))
        assert again.requeue_after == 0.25
        batcher.end()
        assert w.state()["phase"] == "done" and w.state()["seq"] == 4
        assert rec.reconcile(Request(name="node-a")).requeue_after is None
        assert rec.metrics.migrations_total.labels(outcome="completed").read() == 1
        assert len(w.events("MigrationCompleted")) == 1
    finally:
        cached.stop()
        batcher.stop()


def test_migrate_spec_defaults_are_opt_in_as_the_reference():
    out = []
    for s in (REF_SIDE, PORT_SIDE):
        default = s.Policy.from_obj(s.new_policy(spec={})).spec.migrate
        enabled = s.Policy.from_obj(s.new_policy(
            spec={"migrate": {"enabled": True, "snapshotWaitS": 0}})).spec.migrate
        out.append((default.is_enabled(), default.snapshot_wait_s, default.restore_wait_s,
                    enabled.is_enabled(), enabled.snapshot_wait_s, default.to_dict()))
    assert out[1] == out[0]
    assert out[1][:5] == (False, 30, 120, True, 0)


@pytest.mark.parametrize("annotations", [
    {consts.MIGRATION_STATE_ANNOTATION: json.dumps(
        {"phase": "restoring", "src": "node-a", "dst": "node-b", "at_risk": 3, "seq": 4})},
    {consts.MIGRATION_STATE_ANNOTATION: json.dumps(
        {"phase": "done", "src": "a", "dst": "b", "at_risk": 0, "seq": 7})},
    {},
    {consts.MIGRATION_STATE_ANNOTATION: "{not json"},
    {consts.MIGRATION_STATE_ANNOTATION: '"a string"'},
    {consts.MIGRATION_STATE_ANNOTATION: json.dumps({"phase": "draining"})},
], ids=["risk", "zero-risk", "absent", "corrupt", "not-a-dict", "partial"])
def test_the_migration_cell_is_the_reference_s(annotations):
    assert _migration_cell(annotations) == ref_migration_cell(annotations)


# -- a migration episode killed mid-way: the twin of tests/test_crash_soak.py:715 ------
#
# The whole operator (each package's OperatorApp) on
# CachedClient(WriteBatcher(CrashPointClient(RestClient))) against each
# package's MiniApiServer, each package's in-memory kubelet with the migrate
# agents of both nodes, a simulated training job on the source. The
# crash-free episode enumerates the mutating sites; one kill before and one
# after the first write of the durable migration state must each converge
# to exactly one restore, no duplicate Event and no step lost, on both
# packages alike. Every wait has its own timeout of at most 120 s.

import time  # noqa: E402

import requests  # noqa: E402

from tpu_operator.client import rest as ref_rest  # noqa: E402
from tpu_operator.client.batch import WriteBatcher as RefBatcher  # noqa: E402
from tpu_operator.client.cache import CachedClient as RefCached  # noqa: E402
from tpu_operator.client.chaos import CrashPointClient as RefCrashPoint  # noqa: E402
from tpu_operator.client.errors import ApiError as RefApiError  # noqa: E402
from tpu_operator.controllers.manager import OperatorApp as RefApp  # noqa: E402
from tpu_operator.testing import SimulatedTrainingJob as RefJob  # noqa: E402
from tpu_operator.testing.kubelet import KubeletSimulator as RefKubelet  # noqa: E402
from tpu_operator_torch.client import rest  # noqa: E402
from tpu_operator_torch.client.batch import WriteBatcher  # noqa: E402
from tpu_operator_torch.client.cache import CachedClient  # noqa: E402
from tpu_operator_torch.client.chaos import CrashPointClient  # noqa: E402
from tpu_operator_torch.client.errors import ApiError  # noqa: E402
from tpu_operator_torch.controllers.manager import OperatorApp  # noqa: E402
from tpu_operator_torch.testing.apiserver import MiniApiServer as PortServer  # noqa: E402
from tpu_operator_torch.testing.kubelet import KubeletSimulator  # noqa: E402
from tpu_operator_torch.testing.trainjob import SimulatedTrainingJob  # noqa: E402

#: the crash episode's nodes (the reference's 2x4 slice, mapped on the port)
CRASH_LABELS = {ref_consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
                ref_consts.GKE_TPU_TOPOLOGY_LABEL: "2x4"}
#: each wait's own bound
WAIT_S = 120.0
MIGRATION_EVENT_REASONS = ("RetilePlanned", "MigrationCompleted", "MigrationRestored",
                           "MigrationFailed", "MigrationSnapshotRequested",
                           "MigrationSnapshotFailed", "MigrationBlocked",
                           "RetileDeadlineExpired")
MIGRATION_SITE_MARKERS = MIGRATION_KEYS[:-1] + ("Migration", "RetilePlanned")

CRASH_REF = types.SimpleNamespace(
    port=False, Server=MiniApiServer, Rest=ref_rest.RestClient, Crash=RefCrashPoint,
    Cached=RefCached, Batcher=RefBatcher, App=RefApp, Job=RefJob, Status=RefStatusFiles,
    drain=ref_drain, new_policy=ref_new_policy, ctl=ref_controller,
    errors=(RefApiError, requests.RequestException), transfer_env=ref_agent.TRANSFER_DIR_ENV,
    kubelet=lambda client: RefKubelet(client, interval=0.05, create_pods=True),
    agent_kw={"accelerator": CRASH_LABELS[ref_consts.GKE_TPU_ACCELERATOR_LABEL],
              "total_chips": 8})
CRASH_PORT = types.SimpleNamespace(
    port=True, Server=PortServer, Rest=rest.RestClient, Crash=CrashPointClient,
    Cached=CachedClient, Batcher=WriteBatcher, App=OperatorApp, Job=SimulatedTrainingJob,
    Status=StatusFiles, drain=drain, new_policy=new_cluster_policy, ctl=controller,
    errors=(ApiError, OSError), transfer_env=agent.TRANSFER_DIR_ENV,
    kubelet=lambda client: KubeletSimulator(client, interval=0.05), agent_kw={})


@pytest.fixture
def operand_images(monkeypatch):
    for env in ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE", "DEVICE_PLUGIN_IMAGE"):
        monkeypatch.setenv(env, "registry.example/operand:0.1.0")


class CrashEpisode:
    """The operator of one package over a crash-point recorder, restarted
    cold on a fresh client stack whenever its armed kill fires."""

    def __init__(self, s, tmp_path, arm=None):
        self.s = s
        tmp_path.mkdir(parents=True, exist_ok=True)
        self.srv = s.Server()
        self.base = self.srv.start()
        self.plain = s.Rest(base_url=self.base)
        crash = s.Crash(s.Rest(base_url=self.base), arm=arm)
        self.crashpoints = [crash]
        client = s.Cached(s.Batcher(crash))
        self.clients = [client]
        self.apps = [s.App(client)]
        self.kubelet = s.kubelet(self.plain).start()
        self.crashes = 0

    def node_object(self, name):
        node = {"apiVersion": "v1", "kind": "Node",
                "metadata": {"name": name, "labels": dict(CRASH_LABELS)}, "status": {}}
        return map_node(node) if self.s.port else node

    def maybe_restart(self):
        if not self.crashpoints[-1].dead:
            return
        self.apps[-1].stop()
        self.clients[-1].stop()
        crash = self.s.Crash(self.s.Rest(base_url=self.base))
        client = self.s.Cached(self.s.Batcher(crash))
        app = self.s.App(client)
        self.crashpoints.append(crash)
        self.clients.append(client)
        self.apps.append(app)
        app.start()
        self.crashes += 1

    def wait(self, predicate, message, timeout=WAIT_S):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.maybe_restart()
            try:
                if predicate():
                    return
            except self.s.errors:
                pass
            time.sleep(0.02)
        raise AssertionError(f"timed out ({timeout} s) waiting for {message}")

    def node(self, name):
        return self.plain.get("v1", "Node", name)

    def all_sites(self):
        out = set()
        for crash in self.crashpoints:
            out.update(crash.sites)
        return out

    def teardown(self):
        for app in self.apps:
            app.stop()
        for client in self.clients:
            client.stop()
        self.kubelet.stop()
        self.srv.stop()


class MigrationCrashEpisode(CrashEpisode):
    def __init__(self, s, tmp_path, monkeypatch, arm=None):
        super().__init__(s, tmp_path, arm)
        transfer = tmp_path / "transfer"
        self.status = {name: s.Status(str(transfer / name)) for name in ("node-src", "node-dst")}
        monkeypatch.setenv(s.transfer_env, str(transfer))
        for name, status in self.status.items():
            self.plain.create(self.node_object(name))
            self.kubelet.attach_migrate_agent(name, status, **s.agent_kw)

    def event_count(self, reason, name):
        return sum(int(e.get("count") or 1) for e in self.plain.list("v1", "Event", NS)
                   if e.get("reason") == reason and e["involvedObject"]["name"] == name)

    def mirror_ack(self):
        """Feature discovery's part: the barrier's ack onto the node."""
        ack = self.s.drain.read_drain_ack(self.status["node-src"])
        if ack:
            self.plain.patch("v1", "Node", "node-src", {"metadata": {"annotations": {
                consts.DRAIN_ACK_ANNOTATION: self.s.drain.ack_annotation_value(ack)}}})

    def terminal_state(self):
        out = {}
        for name in self.status:
            anns = dict(self.node(name)["metadata"].get("annotations") or {})
            raw = anns.pop(consts.MIGRATION_STATE_ANNOTATION, None)
            state = json.loads(raw) if raw else {}
            out[name] = {"migration": {k: state.get(k) for k in ("phase", "src", "dst", "plan",
                                                                   "step")},
                         "annotations": {k: v for k, v in anns.items() if k in MIGRATION_KEYS}}
        return out

    def settled(self):
        state = self.s.ctl.migration_state(self.node("node-src"))
        if state is None or state["phase"] not in ("done", "failed"):
            return False
        if state["phase"] == "failed":
            return True
        src = self.node("node-src")["metadata"].get("annotations") or {}
        dst = self.node("node-dst")["metadata"].get("annotations") or {}
        working = {consts.MIGRATE_REQUEST_ANNOTATION, consts.RETILE_PLAN_ANNOTATION,
                   consts.DRAIN_ACK_ANNOTATION}
        return not (working & set(src)) and consts.MIGRATION_INBOUND_ANNOTATION not in dst

    def run(self):
        self.plain.create(self.s.new_policy(spec={
            "migrate": {"enabled": True, "snapshotWaitS": 10, "restoreWaitS": 30},
            "health": {"drainDeadlineS": 60}}))
        self.apps[0].start()
        self.wait(lambda: (self.plain.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
                           .get("status") or {}).get("state") == "ready", "install ready")
        job = self.s.Job(self.plain, "node-src", self.status["node-src"])
        for _ in range(5):
            job.tick()
        self.plain.patch("v1", "Node", "node-src", {"metadata": {"annotations": {
            consts.MIGRATE_REQUEST_ANNOTATION: json.dumps(
                {"reason": "crash-soak", "dst": "node-dst"}, sort_keys=True)}}})
        self.wait(lambda: self.s.drain.node_plan(self.node("node-src")) is not None,
                  "the migration's drain plan")
        job.tick()
        ack_step = job.step
        self.mirror_ack()
        self.wait(self.settled, "a terminal phase and its cleanup")
        state = self.s.ctl.migration_state(self.node("node-src"))
        resume_step = self.s.Job(self.plain, "node-dst", self.status["node-dst"]).resume()
        return {
            "phase": state["phase"], "terminal": self.terminal_state(),
            "src_events": {r: self.event_count(r, "node-src") for r in MIGRATION_EVENT_REASONS},
            "dst_events": {r: self.event_count(r, "node-dst") for r in MIGRATION_EVENT_REASONS},
            "ack_step": ack_step, "resume_step": resume_step,
            "sites": migration_sites(self.crashpoints[0].sites),
            "all_sites": set(migration_sites(self.all_sites())),
            "fired": self.crashpoints[0].fired, "crashes": self.crashes,
        }


def migration_sites(sites):
    """The sites of the migration proper (the install's operand writes
    around it are the health episode's matrix's)."""
    return [x for x in sites if any(m in x for m in MIGRATION_SITE_MARKERS)]


def run_migration_episode(s, tmp_path, monkeypatch, arm=None):
    episode = MigrationCrashEpisode(s, tmp_path, monkeypatch, arm=arm)
    try:
        return episode.run()
    finally:
        episode.teardown()


def check_migration_invariants(summary, baseline):
    assert summary["phase"] == "done", summary["phase"]
    assert summary["terminal"] == baseline["terminal"]
    assert summary["resume_step"] == summary["ack_step"] >= 5
    assert summary["src_events"]["RetilePlanned"] == 1
    assert summary["src_events"]["MigrationCompleted"] == 1
    assert summary["dst_events"]["MigrationRestored"] == 1
    for reason in ("MigrationFailed", "MigrationSnapshotRequested", "MigrationSnapshotFailed",
                   "MigrationBlocked", "RetileDeadlineExpired"):
        assert summary["src_events"][reason] == 0, reason


def test_migration_crash_baseline_and_sampled_kills(tmp_path, monkeypatch, operand_images):
    """The crash-free episode on both packages: the same migration sites and
    terminal state; then a kill before and one after the first durable
    state write, each converging on both to one restore, no step lost."""
    baselines = {}
    for s in (CRASH_REF, CRASH_PORT):
        name = "port" if s.port else "ref"
        baseline = run_migration_episode(s, tmp_path / name / "baseline", monkeypatch)
        check_migration_invariants(baseline, baseline)
        assert baseline["crashes"] == 0 and not baseline["fired"]
        assert len(baseline["sites"]) >= 4, baseline["sites"]
        baselines[name] = baseline
    ref, port = baselines["ref"], baselines["port"]
    assert port["terminal"] == ref["terminal"]
    assert (port["src_events"], port["dst_events"]) == (ref["src_events"], ref["dst_events"])
    assert sorted(port["sites"]) == sorted(ref["sites"])
    [state_site] = [x for x in port["sites"] if consts.MIGRATION_STATE_ANNOTATION in x][:1]
    for s in (CRASH_REF, CRASH_PORT):
        name = "port" if s.port else "ref"
        for i, when in enumerate(("before", "after")):
            summary = run_migration_episode(s, tmp_path / name / f"kill{i}", monkeypatch,
                                            arm=(state_site, when))
            assert summary["fired"] and summary["crashes"] == 1, (name, when)
            check_migration_invariants(summary, baselines[name])


@pytest.mark.slow
def test_migration_crash_point_matrix(tmp_path, monkeypatch, operand_images):
    """The twin of tests/test_crash_soak.py's ``test_migration_crash_point_matrix``
    (slow as the reference's), on the port: every mutating site of the
    migration proper (request intake, the durable state record, the plan,
    the ack's intake, the inbound transfer record, the restore's answer, the
    finalize cleanup) is killed before and after its write, in the order
    ``CRASH_SOAK_SEED`` (default 20260805) shuffles; every replay converges
    to one restore, no duplicate Event and no step lost, and a state site
    outside the record run fails the whole matrix."""
    baseline = run_migration_episode(CRASH_PORT, tmp_path / "baseline", monkeypatch)
    check_migration_invariants(baseline, baseline)
    sites = baseline["sites"]
    assert len(sites) >= 4, sites
    matrix = [(site, when) for site in sites for when in ("before", "after")]
    random.Random(int(os.environ.get("CRASH_SOAK_SEED", "20260805"))).shuffle(matrix)
    observed, failures = set(baseline["all_sites"]), []
    for i, (site, when) in enumerate(matrix):
        summary = run_migration_episode(CRASH_PORT, tmp_path / f"ep{i}", monkeypatch,
                                        arm=(site, when))
        observed |= summary["all_sites"]
        if not summary["fired"]:
            failures.append(f"uncovered crash site ({when}): {site}")
            continue
        try:
            check_migration_invariants(summary, baseline)
        except AssertionError as e:
            failures.append(f"kill {when} {site}: {e}")
    uncovered = {x for x in observed - set(sites) if " Event/" not in x}
    if uncovered:
        failures.append("migration state-mutating sites outside the replay matrix (record "
                        f"run missed them): {sorted(uncovered)}")
    assert not failures, "\n".join(failures)
