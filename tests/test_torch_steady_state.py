"""The validator's steady state in the PyTorch port (validator/main.py:
``revalidate_local``, ``drain_watch``, the ``sleep`` loop and the serving
re-probe loop) against the JAX package's, on the CPU. The loops never end
by design: a patched ``time.sleep`` stops them after N cycles."""

import json
import subprocess
import time

import pytest

from tpu_operator.client import FakeClient
from tpu_operator.joinprofile import records as ref_records
from tpu_operator.validator import main as ref_main
from tpu_operator.validator.status import StatusFiles as RefStatusFiles
from tpu_operator_torch import consts
from tpu_operator_torch.validator import main as vmain
from tpu_operator_torch.validator import serving as port_serving
from tpu_operator_torch.validator.status import StatusFiles

TRACE_PARENT = "0123456789abcdef0123456789abcdef-fedcba9876543210"


class _Result:
    def __init__(self, stdout, stderr):
        self.stdout, self.stderr = stdout, stderr


def _canned(monkeypatch, stdout, stderr="", raise_timeout=False):
    """subprocess.run answering with a canned sweep; returns the argvs seen."""
    seen = []

    def fake_run(argv, **kw):
        seen.append((argv, kw))
        if raise_timeout:
            raise subprocess.TimeoutExpired(argv, kw.get("timeout", 0))
        return _Result(stdout, stderr)

    monkeypatch.setattr(subprocess, "run", fake_run)
    return seen


def _barrier(directory):
    info = RefStatusFiles(directory).read("workload")
    return None if info is None else {k: v for k, v in info.items()
                                      if k not in ("timestamp", "host")}


ACK = {"plan": "aaaa", "step": 7, "acked_at": 1.0}
REVALIDATION_CASES = {
    # case: (prior barrier, stdout, stderr, timeout, expected)
    "pass": (None, '{"passed": true, "n_devices": 4}\n', "", False, True),
    "fail": ({"passed": True},
             '{"passed": false, "n_devices": 4, "details": {"psum": {"failed_chips": [1]}}}\n',
             "", False, False),
    "busy": ({"passed": True}, "", "torch.OutOfMemoryError: CUDA out of memory", False, None),
    "timeout": ({"passed": True}, "", "", True, None),
    "log-noise": ({"passed": True}, "{not json\n", "", False, None),
    "noise-after-report": (None, '{"passed": true, "n_devices": 1}\n{truncated\n', "", False,
                           True),
    "drain-ack-carried": ({"passed": True, "drain_ack": ACK},
                          '{"passed": true, "n_devices": 1}\n', "", False, True),
    "fresh-ack-wins": ({"passed": True, "drain_ack": ACK},
                       '{"passed": true, "drain_ack": {"plan": "bbbb"}}\n', "", False, True),
}


@pytest.mark.parametrize("case", sorted(REVALIDATION_CASES))
def test_revalidate_local_matches_reference(case, tmp_path, monkeypatch):
    prior, stdout, stderr, timeout, expected = REVALIDATION_CASES[case]
    outcome = {}
    for side, fn, status_cls in (("ref", ref_main.revalidate_local, RefStatusFiles),
                                 ("port", vmain.revalidate_local, StatusFiles)):
        status = status_cls(str(tmp_path / side))
        if prior is not None:
            status.write("workload", prior)
        before = open(status.path("workload"), "rb").read() if prior is not None else None
        seen = _canned(monkeypatch, stdout, stderr, timeout)
        result = fn(status, 64)
        after = open(status.path("workload"), "rb").read() if prior or result else None
        outcome[side] = (result, _barrier(status.directory), before == after, seen)
    assert outcome["port"][:3] == outcome["ref"][:3]
    assert outcome["port"][0] is expected
    if expected is None:
        assert outcome["port"][2], "a skipped cycle leaves the barrier's bytes alone"
    argv, kw = outcome["port"][3][0]
    script = argv[-1]
    assert "from tpu_operator_torch.validator.workload import ici_health_check" in script
    assert "matrix_dim=64" in script and "device='cuda'" in script
    assert "tpu_operator.validator" not in script
    assert kw["timeout"] == 600.0


def test_revalidate_local_passes_the_device_and_runs_a_real_sweep(tmp_path):
    status = StatusFiles(str(tmp_path))
    status.write("workload", {"passed": False, "drain_ack": ACK})
    assert vmain.revalidate_local(status, 64, timeout=120, device="cpu") is True
    barrier = status.read("workload")
    assert barrier["passed"] is True and barrier["platform"] == "cpu"
    assert barrier["n_devices"] == 1 and barrier["drain_ack"] == ACK
    assert barrier["compile_s"] <= barrier["elapsed_s"]


class _Stop(Exception):
    pass


def _stopping_sleep(monkeypatch, events, cycles):
    """time.sleep that records its call and stops the loop at call ``cycles``."""
    calls = []

    def fake_sleep(seconds):
        calls.append(seconds)
        events.append(("sleep", seconds))
        if len(calls) >= cycles:
            raise _Stop

    monkeypatch.setattr(time, "sleep", fake_sleep)


def _loop_fakes(monkeypatch, module, events, fail_on=2):
    cycle = {"n": 0}

    def fake_revalidate(status, matrix_dim, **kw):
        cycle["n"] += 1
        events.append(("revalidate", matrix_dim))
        if cycle["n"] == fail_on:
            raise RuntimeError("one bad cycle")
        return True

    def fake_drain_watch(client, status):
        events.append(("drain", client is not None))
        return client

    monkeypatch.setattr(module, "revalidate_local", fake_revalidate)
    monkeypatch.setattr(module, "drain_watch", fake_drain_watch)


@pytest.mark.parametrize("interval", ["5", "0"])
def test_sleep_loop_matches_reference(interval, tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_TRACE_PARENT", TRACE_PARENT)
    monkeypatch.setenv("GPU_TRACE_PARENT", TRACE_PARENT)
    runs = {}
    for side, module, extra in (("ref", ref_main, []), ("port", vmain, ["--device=cpu"])):
        events = []
        _loop_fakes(monkeypatch, module, events)
        _stopping_sleep(monkeypatch, events, cycles=4)
        status_dir = str(tmp_path / side)
        with pytest.raises(_Stop):
            module.run(["-c", "sleep", f"--revalidate-interval={interval}",
                        "--sleep-interval=7", "--matrix-dim=64",
                        f"--status-dir={status_dir}", *extra], client=FakeClient())
        spans = ref_records.SpanLog(status_dir).read()
        runs[side] = (events, sorted((r["n"], r["st"]) for r in spans))
    assert runs["port"] == runs["ref"]
    events, spans = runs["port"]
    if interval == "5":
        # drain watch, then the sweep, each cycle; the raising cycle (2) is
        # logged and the loop goes on
        assert events == [("sleep", 5.0), ("drain", True), ("revalidate", 64),
                          ("sleep", 5.0), ("drain", True), ("revalidate", 64),
                          ("sleep", 5.0), ("drain", True), ("revalidate", 64),
                          ("sleep", 5.0)]
        assert spans == [("operand.sleep", "error"), ("revalidate.ici-sweep", "error"),
                         ("revalidate.ici-sweep", "ok"), ("revalidate.ici-sweep", "ok")]
    else:
        assert events == [("sleep", 7.0), ("drain", True)] * 3 + [("sleep", 7.0)]


def test_sleep_without_revalidation_needs_no_card(tmp_path, monkeypatch):
    events = []
    _loop_fakes(monkeypatch, vmain, events)
    _stopping_sleep(monkeypatch, events, cycles=2)
    with pytest.raises(_Stop):
        vmain.run(["-c", "sleep", "--revalidate-interval=0", f"--status-dir={tmp_path}"])
    assert ("revalidate", 64) not in events


def test_sleep_acks_a_plan_and_the_ack_survives_revalidation(tmp_path, monkeypatch):
    """drain_watch and revalidate_local for real (the sweep's output
    canned): a published plan is acked before the sweep rewrites the
    barrier, and the rewrite keeps the ack."""
    monkeypatch.setenv("NODE_NAME", "n1")
    monkeypatch.setenv(consts.COMPILATION_CACHE_DIR_ENV, "/var/cache/build")
    client = FakeClient()
    plan = json.dumps({"fingerprint": "aaaa", "deadline": time.time() + 600,
                       "reason": "retile", "blocked": []})
    client.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "n1", "annotations": {consts.RETILE_PLAN_ANNOTATION: plan}}})
    status = StatusFiles(str(tmp_path))
    status.write("workload", {"passed": True})
    _canned(monkeypatch, '{"passed": true, "n_devices": 1, "platform": "gpu"}\n')
    _stopping_sleep(monkeypatch, [], cycles=3)
    with pytest.raises(_Stop):
        vmain.run(["-c", "sleep", "--revalidate-interval=2", "--device=cpu",
                   f"--status-dir={tmp_path}"], client=client)
    barrier = status.read("workload")
    assert barrier["platform"] == "gpu"
    assert barrier["drain_ack"]["plan"] == "aaaa"
    with open(tmp_path / consts.DRAIN_CHECKPOINT_FILE) as f:
        assert json.load(f)["compile_cache"] == "/var/cache/build"
    # the plan retired: the next pass drops the stamp
    client.patch("v1", "Node", "n1", {"metadata": {"annotations": {
        consts.RETILE_PLAN_ANNOTATION: None}}})
    assert vmain.drain_watch(client, status) is client
    assert "drain_ack" not in status.read("workload")


def test_drain_watch_never_raises(tmp_path, monkeypatch):
    status = StatusFiles(str(tmp_path))
    monkeypatch.delenv("NODE_NAME", raising=False)
    assert vmain.drain_watch(None, status) is None  # no node: nothing to watch
    monkeypatch.setenv("NODE_NAME", "n1")
    monkeypatch.delenv("KUBE_API_URL", raising=False)
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    assert vmain.drain_watch(None, status) is None  # no apiserver: skipped

    class Broken:
        def get(self, *a, **kw):
            raise ConnectionError("apiserver down")

    broken = Broken()
    assert vmain.drain_watch(broken, status) is broken


def test_serving_interval_loop_matches_reference(tmp_path, monkeypatch):
    from tpu_operator.validator import serving as ref_serving

    monkeypatch.setenv("TPU_TRACE_PARENT", TRACE_PARENT)
    monkeypatch.setenv("GPU_TRACE_PARENT", TRACE_PARENT)
    runs = {}
    for side, module, serving, extra in (("ref", ref_main, ref_serving, []),
                                         ("port", vmain, port_serving, ["--device=cpu"])):
        events = []
        probes = {"n": 0}

        def fake_run_serving(status, **kw):
            probes["n"] += 1
            events.append(("probe", kw["batch_sizes"], kw["steps_per_batch"]))
            if probes["n"] == 3:
                raise RuntimeError("one bad probe")
            return 0 if probes["n"] != 2 else 1

        _loop_fakes(monkeypatch, module, events)
        monkeypatch.setattr(serving, "run_serving", fake_run_serving)
        _stopping_sleep(monkeypatch, events, cycles=4)
        status_dir = str(tmp_path / side)
        with pytest.raises(_Stop):
            module.run(["-c", "serving", "--serving-interval=1",
                        "--serving-batch-sizes=1,2", "--serving-steps=8",
                        f"--status-dir={status_dir}", *extra], client=FakeClient())
        spans = ref_records.SpanLog(status_dir).read()
        runs[side] = (events, sorted((r["n"], r["st"], r["a"].get("exit_code"))
                                     for r in spans))
    assert runs["port"] == runs["ref"]
    events, spans = runs["port"]
    probe = ("probe", [1, 2], 8)
    assert events == [probe, ("sleep", 1.0), ("drain", True), probe, ("sleep", 1.0),
                      ("drain", True), probe, ("sleep", 1.0), ("drain", True), probe,
                      ("sleep", 1.0)]
    assert spans == [("operand.serving", "error", None), ("serving.probe", "error", None),
                     ("serving.probe", "ok", 0), ("serving.probe", "ok", 0),
                     ("serving.probe", "ok", 1)]


def test_one_shot_serving_returns_the_probes_code(tmp_path, monkeypatch):
    monkeypatch.setattr(port_serving, "run_serving", lambda status, **kw: 1)
    monkeypatch.setattr(time, "sleep", lambda s: pytest.fail("one shot must not loop"))
    assert vmain.run(["-c", "serving", "--device=cpu", f"--status-dir={tmp_path}"],
                     client=FakeClient()) == 1
