"""The migrate agent of the PyTorch port (tpu_operator_torch/migrate/) against
the reference's (tpu_operator/migrate/{agent,checkpoint}.py), modelled on
the agent and checkpoint tests of tests/test_migrate.py: twin nodes in
twin fake apiservers, the same requests, the same clock. The annotations,
barrier stamps, v2 checkpoint payloads and Events must agree field by
field; a restore re-maps its manifest over the GPU node's NVML links where
the reference re-tiles on its ICI grid, and where both must place the same
GPUs they do.
"""

import json
import os

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
from tpu_operator_torch.validator.metrics import Counter
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


class PortMetrics:
    def __init__(self):
        self.checkpoint_corrupt = Counter("tpu_operator_checkpoint_corrupt",
                                          "Drain checkpoints found corrupt")


def _events(client):
    return sorted(({k: v for k, v in e.items() if k not in ("firstTimestamp", "lastTimestamp")}
                   | {"metadata": {k: v for k, v in e["metadata"].items()
                                   if k in ("name", "namespace")}}
                   for e in client.list("v1", "Event", NS)), key=lambda e: e["metadata"]["name"])


def test_the_corrupt_event_is_recorded_once_as_the_reference_records_it(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path)
    ref_metrics, port_metrics = OperatorMetrics(), PortMetrics()
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
