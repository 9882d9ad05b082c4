"""A simulated training job for drain-protocol soaks (counterpart of
tpu_operator/testing/trainjob.py).

It stands in for a trainer: it advances a step counter, watches its node
for a published ``tpu.ai/planned-retile`` plan, acks it through the real
protocol helpers (a checkpoint at the host-path file, the drain-ack stamp
in the workload barrier) and, after a pod recycle, resumes from the
checkpoint, so a soak can assert that no step is lost beyond the drain
window. Not a subprocess: a soak drives it step by step between operator
sweeps, so its kill and restart points are deterministic.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional

from ..health import drain
from ..migrate import agent as migrate_agent
from ..migrate import checkpoint as migrate_ckpt
from ..validator.status import StatusFiles

log = logging.getLogger(__name__)


class SimulatedTrainingJob:
    """A step counter, an RNG stand-in and the drain protocol.

    ``tick()`` runs one training step and one drain-watch pass, as a real
    trainer's step loop would. ``crash()`` is the pod recycle (memory lost),
    ``resume()`` the restarted pod (state from the host-path checkpoint)."""

    def __init__(self, client, node_name: str, status: StatusFiles, cooperative: bool = True,
                 partition: str = "", blocked: Optional[List[int]] = None):
        self.client = client
        self.node_name = node_name
        self.status = status
        #: False models a wedged trainer: steps run (its memory changes) but
        #: it never checkpoints or acks, the workload a transparent snapshot
        #: exists for
        self.cooperative = cooperative
        #: the layout the checkpoint's sharded-array manifest is keyed by
        self.partition = partition
        self.blocked = list(blocked or [])
        self.step = 0
        #: advanced with the step counter, so a resume that loses steps
        #: also loses RNG sync
        self.rng_state = 0
        self.acked_plans: List[str] = []

    def tick(self) -> int:
        """One training step, then one drain-watch pass (checkpoint and ack
        when a plan is pending). Returns the step counter."""
        self.step += 1
        self.rng_state = (self.rng_state * 6364136223846793005 + 1442695040888963407) % (2 ** 64)
        self._mirror_process_state()
        if not self.cooperative:
            return self.step
        node = self.client.get("v1", "Node", self.node_name)
        plan = drain.node_plan(node)
        if plan is not None and plan.fingerprint not in self.acked_plans:
            self.checkpoint()
            drain.write_drain_ack(self.status, plan.fingerprint, step=self.step,
                                  checkpoint=self._ckpt_path())
            self.acked_plans.append(plan.fingerprint)
            log.info("trainjob: acked plan %s at step %d", plan.fingerprint, self.step)
        return self.step

    def _ckpt_path(self) -> str:
        return drain.checkpoint_path(self.status.directory)

    def _mirror_process_state(self) -> None:
        """Mirror the live {step, rng_state, layout} to the host path the
        migrate agent dumps from: the stand-in for process memory that a
        transparent snapshot reads without the job's help."""
        path = migrate_agent.process_state_path(self.status.directory)
        os.makedirs(self.status.directory, exist_ok=True)
        payload = {"step": self.step, "rng_state": self.rng_state,
                   "partition": self.partition, "blocked": self.blocked}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def checkpoint(self) -> str:
        return migrate_ckpt.save_checkpoint_v2(
            self._ckpt_path(), self.step, rng_state=self.rng_state,
            optimizer_state=migrate_ckpt.optimizer_state_pointer(self.status.directory),
            manifest=migrate_ckpt.build_manifest(self.partition, self.blocked))

    def crash(self) -> None:
        """The pod recycle: all in-memory state gone."""
        self.step = -1
        self.rng_state = -1

    def resume(self) -> Optional[int]:
        """Restart from the host-path checkpoint; None (a restart from
        scratch) when there is none. Returns the resumed step."""
        ckpt = drain.load_checkpoint(self._ckpt_path())
        if ckpt is None:
            self.step = 0
            self.rng_state = 0
            return None
        self.step = int(ckpt["step"])
        self.rng_state = ckpt.get("rng_state", 0)
        log.info("trainjob: resumed from checkpoint at step %d", self.step)
        return self.step
