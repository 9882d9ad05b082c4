"""The agent side of the drain protocol in the PyTorch port
(tpu_operator_torch/health/drain.py, client.preconditioned_patch,
utils.object_hash) against the JAX package's: the same plans, acks and
checkpoints, timestamps and host aside."""

import json
import os

import pytest

from tpu_operator import consts as ref_consts
from tpu_operator.client import FakeClient
from tpu_operator.client.preconditions import preconditioned_patch as ref_preconditioned_patch
from tpu_operator.health import drain as ref_drain
from tpu_operator.testing import MiniApiServer
from tpu_operator.utils.hash import object_hash as ref_object_hash
from tpu_operator.validator.status import StatusFiles as RefStatusFiles
from tpu_operator_torch import consts
from tpu_operator_torch.client import ApiClient, ConflictError, preconditioned_patch
from tpu_operator_torch.health import drain
from tpu_operator_torch.utils import object_hash
from tpu_operator_torch.validator.status import StatusFiles

NOW = 1_700_000_000.25
ENVELOPE = ("timestamp", "host")


def test_protocol_keys_match_reference():
    for key in ("RETILE_PLAN_ANNOTATION", "DRAIN_ACK_ANNOTATION", "DRAIN_CHECKPOINT_FILE"):
        assert getattr(consts, key) == getattr(ref_consts, key)


@pytest.mark.parametrize("obj", [
    {}, {"partition": "", "blocked": []}, {"partition": "2x2", "blocked": [3, 1]},
    {"b": [1, {"z": 1, "a": None}], "a": "é"}, [1, 2.5, True, None], "text", 7,
])
def test_object_hash_matches_reference(obj):
    assert object_hash(obj) == ref_object_hash(obj)


@pytest.mark.parametrize("partition,blocked", [
    (None, None), ("", []), ("2x4", [5, 1]), ("1x1", ["2", 0]),
])
def test_plan_fingerprint_matches_reference(partition, blocked):
    assert drain.plan_fingerprint(partition, blocked) == \
        ref_drain.plan_fingerprint(partition, blocked)


@pytest.mark.parametrize("raw", [
    None, "", "{", "[]", '{"fingerprint": "ab"}', '{"deadline": 5}',
    '{"fingerprint": "ab", "deadline": "x"}',
    '{"fingerprint": "ab", "deadline": 12.5}',
    '{"fingerprint": "ab", "deadline": 12.5, "reason": "remediate", "blocked": [3, "1"]}',
    '{"fingerprint": "ab", "deadline": 12.5, "blocked": ["x"]}',
])
def test_parse_plan_matches_reference(raw):
    port, ref = drain.parse_plan(raw), ref_drain.parse_plan(raw)
    assert (port is None) == (ref is None)
    if ref is not None:
        assert port.to_json() == ref.to_json()
        assert port.expired(now=12.5) == ref.expired(now=12.5)
        assert port.expired(now=12.4) == ref.expired(now=12.4)


def _node(plan=None):
    ann = {} if plan is None else {consts.RETILE_PLAN_ANNOTATION: plan}
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "n1", "labels": {}, "annotations": ann}, "status": {}}


def _barrier(directory):
    info = RefStatusFiles(directory).read("workload")
    return None if info is None else {k: v for k, v in info.items() if k not in ENVELOPE}


def _checkpoint(directory):
    path = os.path.join(directory, consts.DRAIN_CHECKPOINT_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


PLAN_A = json.dumps({"fingerprint": "aaaa", "deadline": NOW + 60, "reason": "retile",
                     "blocked": [1]})
PLAN_B = json.dumps({"fingerprint": "bbbb", "deadline": NOW + 60, "reason": "remediate",
                     "blocked": []})


@pytest.mark.parametrize("case", ["ack", "already-acked", "new-plan", "retire",
                                  "no-plan-no-ack", "prior-checkpoint", "no-barrier",
                                  "node-read-fails"])
def test_maybe_ack_plan_matches_reference(case, tmp_path, monkeypatch):
    monkeypatch.setenv("GPU_COMPILATION_CACHE_DIR", "/var/cache/build")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/var/cache/build")
    results = {}
    for side, mod, status_cls in (("ref", ref_drain, RefStatusFiles),
                                  ("port", drain, StatusFiles)):
        directory = str(tmp_path / side)
        status = status_cls(directory)
        client = FakeClient()
        plan = {"retire": None, "no-plan-no-ack": None}.get(case, PLAN_A)
        client.create(_node(plan))
        if case != "no-barrier":
            status.write("workload", {"passed": True, "n_devices": 2,
                                      "details": {"compute": {"passed": True}}})
        if case in ("already-acked", "new-plan", "retire"):
            fingerprint = "aaaa" if case != "new-plan" else "old"
            mod.write_drain_ack(status, fingerprint, step=7, checkpoint="/ck",
                                now=lambda: NOW - 5)
        if case == "new-plan":
            client.patch("v1", "Node", "n1", {"metadata": {"annotations": {
                consts.RETILE_PLAN_ANNOTATION: PLAN_B}}})
        if case == "prior-checkpoint":
            mod.save_checkpoint(mod.checkpoint_path(directory), 41, rng_state=[1, 2],
                                now=lambda: NOW - 9)
        if case == "node-read-fails":
            client = object()  # no .get: the pass must swallow it
        acked = mod.maybe_ack_plan(client, "n1", status, now=lambda: NOW)
        results[side] = (acked, _barrier(directory), _checkpoint(directory),
                         mod.read_drain_ack(status),
                         mod.ack_annotation_value(mod.read_drain_ack(status)))
    port, ref = results["port"], results["ref"]
    # the checkpoint's path differs by directory; everything else is equal
    port_barrier, ref_barrier = port[1], ref[1]
    for b in (port_barrier, ref_barrier):
        if b and "drain_ack" in b and "checkpoint" in b["drain_ack"]:
            b["drain_ack"]["checkpoint"] = os.path.basename(b["drain_ack"]["checkpoint"])
    for ack in (port[3], ref[3]):
        if ack and "checkpoint" in ack:
            ack["checkpoint"] = os.path.basename(ack["checkpoint"])
    assert port == ref
    expected_ack = {"ack": True, "already-acked": False, "new-plan": True, "retire": False,
                    "no-plan-no-ack": False, "prior-checkpoint": True, "no-barrier": True,
                    "node-read-fails": False}[case]
    assert port[0] is expected_ack
    if case == "prior-checkpoint":
        assert port[2]["step"] == 41 and port[3]["step"] == 41
    if expected_ack:
        assert port[2]["compile_cache"] == "/var/cache/build"


@pytest.mark.parametrize("content", [None, "{torn", "[1]", '{"saved_at": 1}',
                                     '{"step": 3, "rng_state": [1]}'])
def test_load_checkpoint_matches_reference(content, tmp_path):
    path = str(tmp_path / "ck.json")
    if content is not None:
        with open(path, "w") as f:
            f.write(content)
    seen = {"port": [], "ref": []}
    port = drain.load_checkpoint(path, on_corrupt=lambda k, raw: seen["port"].append((k, raw)))
    ref = ref_drain.load_checkpoint(path, on_corrupt=lambda k, raw: seen["ref"].append((k, raw)))
    assert port == ref
    assert seen["port"] == seen["ref"]


class _RacingClient:
    """Delegates to a FakeClient, but a competing writer lands between the
    first read and the first patch (the window the precondition closes)."""

    def __init__(self, inner):
        self.inner = inner
        self.raced = False
        self.patches = []

    def get(self, *a, **kw):
        return self.inner.get(*a, **kw)

    def patch(self, api_version, kind, name, patch, namespace=None):
        if not self.raced:
            self.raced = True
            self.inner.patch(api_version, kind, name, {"metadata": {"annotations": {
                consts.DRAIN_ACK_ANNOTATION: "competing"}}}, namespace)
        self.patches.append(json.loads(json.dumps(patch)))
        return self.inner.patch(api_version, kind, name, patch, namespace)


def test_preconditioned_patch_rebuilds_on_conflict_as_reference():
    outcomes = {}
    for side, fn in (("ref", ref_preconditioned_patch), ("port", preconditioned_patch)):
        inner = FakeClient()
        inner.create(_node())
        client = _RacingClient(inner)
        seen = []

        def build(fresh):
            current = fresh["metadata"]["annotations"].get(consts.DRAIN_ACK_ANNOTATION)
            seen.append(current)
            return {"metadata": {"annotations": {consts.DRAIN_ACK_ANNOTATION: f"after-{current}"}}}

        out = fn(client, "v1", "Node", "n1", build, sleep=lambda s: None)
        outcomes[side] = (seen, client.patches,
                          out["metadata"]["annotations"][consts.DRAIN_ACK_ANNOTATION])
    assert outcomes["port"] == outcomes["ref"]
    assert outcomes["port"][0] == [None, "competing"]
    assert outcomes["port"][2] == "after-competing"


def test_preconditioned_patch_gives_up_after_its_budget():
    class AlwaysConflict:
        def get(self, *a, **kw):
            return {"metadata": {"resourceVersion": "1"}}

        def patch(self, *a, **kw):
            raise ConflictError("conflict")

    with pytest.raises(ConflictError):
        preconditioned_patch(AlwaysConflict(), "v1", "Node", "n1", lambda o: {}, attempts=3,
                             sleep=lambda s: None)
    assert preconditioned_patch(AlwaysConflict(), "v1", "Node", "n1", lambda o: None) == \
        {"metadata": {"resourceVersion": "1"}}


def test_api_client_patch_and_conflict_over_http():
    srv = MiniApiServer()
    base = srv.start()
    try:
        client = ApiClient(base)
        srv.backend.create(_node())
        node = client.get("v1", "Node", "n1")
        out = client.patch("v1", "Node", "n1", {"metadata": {"labels": {"a": "1"}}})
        assert out["metadata"]["labels"] == {"a": "1"}
        stale = {"metadata": {"resourceVersion": node["metadata"]["resourceVersion"],
                              "labels": {"a": "2"}}}
        with pytest.raises(ConflictError) as err:
            client.patch("v1", "Node", "n1", stale)
        assert err.value.code == 409
        out = preconditioned_patch(client, "v1", "Node", "n1",
                                   lambda fresh: {"metadata": {"labels": {"b": "1"}}})
        assert out["metadata"]["labels"] == {"a": "1", "b": "1"}
    finally:
        srv.stop()
