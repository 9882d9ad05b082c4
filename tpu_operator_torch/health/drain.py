"""The coordinated drain for planned re-tiles, both sides (counterpart of
tpu_operator/health/drain.py).

1. The operator PUBLISHES a plan: the ``tpu.ai/planned-retile`` node
   annotation (fingerprint of the target layout, drain deadline, reason,
   blocked GPUs).
2. A node agent ACKS by checkpointing its step, RNG state and build-cache
   location to a host-path file and stamping a ``drain_ack`` record into
   the workload barrier (:func:`maybe_ack_plan`); feature discovery
   mirrors it to the ``tpu.ai/drain-ack`` annotation for the operator.
3. The partitioner migrates on the ack, or forces the change at the
   deadline, so a drain never wedges.

Every artefact lives in a node annotation, the barrier file or a host-path
file, so an agent or operator restarted mid-drain resumes where it was.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import List, Optional

from .. import consts
from ..utils import deep_get, object_hash

log = logging.getLogger(__name__)

#: plan reasons: a re-tile around gated GPUs, a remediation that recycles
#: the node's pods, the autoscaler's scale-down and a migration's drain (an
#: agent acks every reason alike)
REASON_RETILE = "retile"
REASON_REMEDIATE = "remediate"
REASON_SCALE_DOWN = "scale-down"
REASON_MIGRATE = "migrate"


@dataclasses.dataclass(frozen=True)
class RetilePlan:
    """One published drain plan, as carried by the node annotation."""

    fingerprint: str          #: plan_fingerprint() of the target layout
    deadline: float           #: epoch seconds; hard bound for the drain
    reason: str               #: why the operator drains the node
    blocked: List[int] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({
            "fingerprint": self.fingerprint,
            "deadline": round(float(self.deadline), 3),
            "reason": self.reason,
            "blocked": sorted(int(c) for c in self.blocked),
        }, sort_keys=True)

    def expired(self, now: Optional[float] = None) -> bool:
        return (time.time() if now is None else now) >= self.deadline


def plan_fingerprint(partition: Optional[str], blocked) -> str:
    """Deterministic identity of a planned layout, computable by BOTH the
    operator (partition from the node's slice-config label, blocked from
    the ``failed:<csv>`` verdict annotation) and the partitioner (desired
    label + barrier attribution) without talking to each other."""
    return object_hash({"partition": partition or "",
                        "blocked": sorted(int(c) for c in (blocked or []))})


def parse_plan(raw: Optional[str]) -> Optional[RetilePlan]:
    """A plan from its annotation value; None for absent/corrupt (a corrupt
    plan must never wedge a drain — callers fall back to re-publishing)."""
    if not raw:
        return None
    try:
        data = json.loads(raw)
        return RetilePlan(
            fingerprint=str(data["fingerprint"]),
            deadline=float(data["deadline"]),
            reason=str(data.get("reason", REASON_RETILE)),
            blocked=sorted(int(c) for c in data.get("blocked", [])))
    except (ValueError, TypeError, KeyError):
        return None


def node_plan(node: dict) -> Optional[RetilePlan]:
    return parse_plan(deep_get(node, "metadata", "annotations",
                               consts.RETILE_PLAN_ANNOTATION))


def node_acked_plan(node: dict) -> Optional[str]:
    """The plan fingerprint the node's published drain-ack covers, if any."""
    raw = deep_get(node, "metadata", "annotations", consts.DRAIN_ACK_ANNOTATION)
    if not raw:
        return None
    try:
        return json.loads(raw).get("plan") or None
    except (ValueError, AttributeError):
        return None


# -- drain acks (workload barrier stamps) -------------------------------------

def write_drain_ack(status, fingerprint: str, step: Optional[int] = None,
                    checkpoint: Optional[str] = None,
                    now=time.time) -> dict:
    """Stamp a drain-ack into the existing workload barrier, preserving its
    verdict payload (the ack rides the same atomic tmp+rename write). The
    barrier is the ack's source of truth: node-local, crash-durable, and
    readable by the partitioner without an apiserver round trip."""
    info = status.read("workload") or {}
    ack = {"plan": fingerprint, "acked_at": now()}
    if step is not None:
        ack["step"] = int(step)
    if checkpoint:
        ack["checkpoint"] = checkpoint
    # keep every verdict key; drop the envelope keys status.write re-stamps
    details = {k: v for k, v in info.items()
               if k not in ("component", "timestamp", "host")}
    details["drain_ack"] = ack
    status.write("workload", details)
    return ack


def read_drain_ack(status) -> Optional[dict]:
    """The barrier's drain-ack stamp, or None (no barrier / no ack)."""
    info = status.read("workload")
    ack = (info or {}).get("drain_ack")
    return ack if isinstance(ack, dict) and ack.get("plan") else None


def ack_annotation_value(ack: Optional[dict]) -> Optional[str]:
    """Compact annotation payload for a barrier ack (feature discovery
    publishes it so the operator's sweep can read acks without touching
    node filesystems)."""
    if not ack:
        return None
    out = {"plan": ack.get("plan")}
    if "step" in ack:
        out["step"] = ack["step"]
    return json.dumps(out, sort_keys=True)


# -- checkpoints (host-path files) --------------------------------------------

def checkpoint_path(status_dir: str) -> str:
    return os.path.join(status_dir, consts.DRAIN_CHECKPOINT_FILE)


def save_checkpoint(path: str, step: int, rng_state=None,
                    compile_cache: Optional[str] = None,
                    extra: Optional[dict] = None, now=time.time) -> str:
    """Atomically persist resumable workload state: the step counter, the
    RNG state (so data order replays), and the build-cache location (so
    resume loads the built kernels instead of running ``nvcc``). Same tmp+rename discipline as the
    barriers — a reader never sees a torn checkpoint."""
    payload = {"step": int(step), "saved_at": now()}
    if rng_state is not None:
        payload["rng_state"] = rng_state
    if compile_cache:
        payload["compile_cache"] = compile_cache
    if extra:
        payload.update(extra)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, on_corrupt=None) -> Optional[dict]:
    """The checkpoint payload, or None for absent/corrupt — a corrupt
    checkpoint means a restart from scratch, never a crash.

    ``on_corrupt(kind, raw)`` fires when the file EXISTS but the payload is
    unusable (kind: "torn" | "non-dict" | "missing-step"; raw: the bytes
    read) — absent files are a normal first boot, corrupt ones are silent
    data loss that migrate.checkpoint.corrupt_reporter() turns into a
    counter bump plus a content-addressed CheckpointCorrupt Event on the
    operator's side."""
    try:
        with open(path) as f:
            raw = f.read()
    except (FileNotFoundError, OSError):
        return None
    try:
        data = json.loads(raw)
    except json.JSONDecodeError:
        if on_corrupt is not None:
            on_corrupt("torn", raw)
        return None
    if not isinstance(data, dict):
        if on_corrupt is not None:
            on_corrupt("non-dict", raw)
        return None
    if "step" not in data:
        if on_corrupt is not None:
            on_corrupt("missing-step", raw)
        return None
    return data


# -- agent-side ack hook ------------------------------------------------------

def maybe_ack_plan(client, node_name: str, status,
                   step: Optional[int] = None, rng_state=None,
                   now=time.time) -> bool:
    """One drain-watch pass for a node agent (validator sleep loop, serving
    probe loop): if the node carries a published plan this agent has not
    acked yet, checkpoint and stamp the ack. Returns True when an ack was
    written. Best-effort by design — a failed pass retries next interval,
    and the deadline force-path guarantees progress regardless."""
    try:
        node = client.get("v1", "Node", node_name)
    except Exception as e:  # transient apiserver trouble: retry next pass
        log.debug("drain watch: node read failed (%s)", e)
        return False
    plan = node_plan(node)
    ack = read_drain_ack(status)
    if plan is None:
        if ack:
            # episode over (operator retired the plan): drop the stale
            # stamp so feature discovery clears the node's ack annotation
            info = status.read("workload") or {}
            info.pop("drain_ack", None)
            status.write("workload", {
                k: v for k, v in info.items()
                if k not in ("component", "timestamp", "host")})
        return False
    if ack and ack.get("plan") == plan.fingerprint:
        return False  # already acked this plan
    path = checkpoint_path(status.directory)
    prior = load_checkpoint(path)
    resolved_step = step if step is not None else (
        prior.get("step", 0) if prior else 0)
    save_checkpoint(path, resolved_step, rng_state=rng_state,
                    compile_cache=os.environ.get(consts.COMPILATION_CACHE_DIR_ENV),
                    now=now)
    write_drain_ack(status, plan.fingerprint, step=resolved_step,
                    checkpoint=path, now=now)
    log.info("drain: acked plan %s on %s (step %s, checkpoint %s)",
             plan.fingerprint, node_name, resolved_step, path)
    return True
