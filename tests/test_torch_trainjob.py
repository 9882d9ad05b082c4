"""The port's simulated training job (tpu_operator_torch/testing/trainjob.py)
against the reference's (tpu_operator/testing/trainjob.py): the twins of
tests/test_drain.py's two training-job cases. Each package's job runs on its
own node, status directory and apiserver fake; the steps, acks, barrier
stamps, checkpoints and mirrored process state must agree, paths aside.
"""

import json
import types

from tpu_operator import consts as ref_consts
from tpu_operator.client.fake import FakeClient as RefFake
from tpu_operator.health import drain as ref_drain
from tpu_operator.migrate import agent as ref_agent
from tpu_operator.testing import SimulatedTrainingJob as RefJob
from tpu_operator.validator.status import StatusFiles as RefStatus
from tpu_operator_torch import consts
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.health import drain
from tpu_operator_torch.migrate import agent
from tpu_operator_torch.testing.trainjob import SimulatedTrainingJob
from tpu_operator_torch.validator.status import StatusFiles

NODE = "node-0"
REF = types.SimpleNamespace(c=ref_consts, drain=ref_drain, agent=ref_agent, Fake=RefFake,
                            Job=RefJob, Status=RefStatus, name="ref")
PORT = types.SimpleNamespace(c=consts, drain=drain, agent=agent, Fake=FakeClient,
                             Job=SimulatedTrainingJob, Status=StatusFiles, name="port")


class Side:
    def __init__(self, s, tmp_path, **job):
        self.s = s
        self.client = s.Fake()
        self.client.create({"apiVersion": "v1", "kind": "Node",
                            "metadata": {"name": NODE, "annotations": {}},
                            "spec": {}, "status": {}})
        self.status = s.Status(str(tmp_path / s.name / "status"))
        self.job = s.Job(self.client, NODE, self.status, **job)

    def publish_plan(self, partition="split", blocked=(2,), deadline=2_000_000.0):
        plan = self.s.drain.RetilePlan(
            fingerprint=self.s.drain.plan_fingerprint(partition, list(blocked)),
            deadline=deadline, reason=self.s.drain.REASON_RETILE, blocked=list(blocked))
        self.client.patch("v1", "Node", NODE, {"metadata": {"annotations": {
            self.s.c.RETILE_PLAN_ANNOTATION: plan.to_json()}}})
        return plan.fingerprint

    def observe(self):
        """The job's visible state, its status directory written as <status>."""
        ack = self.s.drain.read_drain_ack(self.status) or {}
        ckpt = self.s.drain.load_checkpoint(self.s.drain.checkpoint_path(self.status.directory))
        with open(self.s.agent.process_state_path(self.status.directory)) as f:
            process = json.load(f)
        text = json.dumps({"step": self.job.step, "rng": self.job.rng_state,
                           "acked": self.job.acked_plans,
                           "ack": {k: v for k, v in ack.items() if k != "acked_at"},
                           "ckpt": {k: v for k, v in (ckpt or {}).items() if k != "saved_at"},
                           "process": process}, sort_keys=True)
        return json.loads(text.replace(self.status.directory, "<status>"))


def _run_both(tmp_path, script, **job):
    out = []
    for s in (REF, PORT):
        side = Side(s, tmp_path, **job)
        out.append(script(side))
    assert out[1] == out[0]
    return out[1]


def test_trainjob_acks_checkpoint_and_resumes_as_the_reference(tmp_path):
    def script(w):
        log = []
        w.status.write("workload", {"passed": True, "n_devices": 8})
        for _ in range(5):
            w.job.tick()
            log.append(w.observe())
        fp = w.publish_plan()
        w.job.tick()  # sees the plan: checkpoint and ack at step 6
        log.append(w.observe())
        rng_at_ack = w.s.drain.load_checkpoint(
            w.s.drain.checkpoint_path(w.status.directory))["rng_state"]
        w.job.tick()  # a step inside the drain window, after the checkpoint
        w.job.crash()
        resumed = w.job.resume()
        log.append(w.observe())
        return {"log": log, "fp": fp, "resumed": resumed,
                "rng_back": w.job.rng_state == rng_at_ack}

    got = _run_both(tmp_path, script)
    assert got["resumed"] == 6 and got["rng_back"]
    assert got["log"][5]["acked"] == [got["fp"]] and got["log"][5]["ack"]["step"] == 6
    assert got["log"][4]["acked"] == []  # no plan, no ack


def test_trainjob_resume_without_checkpoint_restarts_from_scratch_as_the_reference(tmp_path):
    def script(w):
        w.job.tick()
        w.job.crash()
        return {"resumed": w.job.resume(), "step": w.job.step, "rng": w.job.rng_state}

    assert _run_both(tmp_path, script) == {"resumed": None, "step": 0, "rng": 0}


def test_an_uncooperative_trainjob_never_acks_as_the_reference(tmp_path):
    """A wedged trainer: its steps still move its mirrored process state,
    which a transparent snapshot reads, but it writes no checkpoint and no
    ack."""
    def script(w):
        fp = w.publish_plan()
        for _ in range(3):
            w.job.tick()
        with open(w.s.agent.process_state_path(w.status.directory)) as f:
            process = json.load(f)
        return {"fp": bool(fp), "acked": w.job.acked_plans,
                "ack": w.s.drain.read_drain_ack(w.status), "process": process}

    got = _run_both(tmp_path, script, cooperative=False, partition="pairs", blocked=[1])
    assert got["acked"] == [] and got["ack"] is None
    assert got["process"]["step"] == 3 and got["process"]["blocked"] == [1]
