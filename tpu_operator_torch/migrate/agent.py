"""The node-side migrate agent: transparent snapshot and restore
(counterpart of tpu_operator/migrate/agent.py).

Two verbs, each driven by a node annotation and answered through the same
host-path and barrier discipline as drain acks:

- **snapshot**: the operator stamps ``tpu.ai/migrate-snapshot-request``
  when a drain deadline passed without an ack. The agent dumps the
  workload's live state, reading the process-state mirror file the training
  harness keeps (the stand-in for process memory: a real GPU process
  checkpoint needs a tool this repository does not hold; the workload
  itself never takes part), writes a restorable v2 checkpoint to the
  drain-checkpoint host path, stamps a ``migrate_snapshot`` record into the
  workload barrier and publishes the outcome on
  ``tpu.ai/migrate-snapshot-result``.
- **restore**: the operator stamps ``tpu.ai/migration-inbound`` on the
  destination. The agent fetches the transferred checkpoint, re-maps its
  manifest onto the node's GPUs through the partitioner's incremental
  re-tile over NVML's link matrix, writes it to the local checkpoint path
  (the resumed tenant loads it like any drain checkpoint), stamps a
  ``migrate_restore`` barrier record and answers on
  ``tpu.ai/migration-restore``.

Both verbs are idempotent: a result annotation that already names the
requested plan makes the agent stand down, so replays and restarts never
snapshot or restore twice. Nothing here imports torch or opens a CUDA
context.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Optional

from .. import consts
from ..client import preconditioned_patch
from ..health import drain
from ..partitioner import topology
from ..utils import deep_get
from . import checkpoint as ckpt_schema

log = logging.getLogger(__name__)

#: overrides where the dump reads the live process state from (default:
#: <status dir>/process-state.json)
PROCESS_STATE_ENV = "GPU_MIGRATE_PROCESS_STATE"
#: the directory the default restore fetch reads transferred checkpoints
#: from: <dir>/<source node>/drain-checkpoint.json (an object store's
#: stand-in)
TRANSFER_DIR_ENV = "GPU_MIGRATE_TRANSFER_DIR"


def process_state_path(status_dir: str) -> str:
    return os.path.join(status_dir, consts.MIGRATE_PROCESS_STATE_FILE)


def read_process_state(path: str) -> Optional[dict]:
    """The live process-state mirror (step, rng_state, optional layout):
    what a process dump would lift from memory. None when absent or
    corrupt, which is a failed snapshot: the operator then falls back to
    its counted force re-tile."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (json.JSONDecodeError, OSError):
        return None
    return data if isinstance(data, dict) and "step" in data else None


def _parse_annotation(node: dict, key: str) -> Optional[dict]:
    raw = deep_get(node, "metadata", "annotations", key)
    if not raw:
        return None
    try:
        data = json.loads(raw)
    except ValueError:
        return None
    return data if isinstance(data, dict) else None


def _publish(client, node_name: str, key: str, payload: dict) -> None:
    value = ckpt_schema.dumps_compact(payload)

    def build(fresh: dict) -> Optional[dict]:
        if deep_get(fresh, "metadata", "annotations", key) == value:
            return None
        return {"metadata": {"annotations": {key: value}}}

    preconditioned_patch(client, "v1", "Node", node_name, build)


def _stamp_barrier(status, key: str, record: dict) -> None:
    """Fold a migration record into the workload barrier, keeping its
    verdict (the discipline of ``drain.write_drain_ack``)."""
    info = status.read("workload") or {}
    details = {k: v for k, v in info.items() if k not in ("component", "timestamp", "host")}
    details[key] = record
    status.write("workload", details)


def _node(client, node_name: str) -> Optional[dict]:
    # the reference re-raises its client's BreakerOpenError here (its loop
    # backs off); the port's client has no circuit breaker, so every read
    # failure is transient trouble, retried next pass
    try:
        return client.get("v1", "Node", node_name)
    except Exception as e:
        log.debug("migrate agent: node read failed (%s)", e)
        return None


def snapshot_once(client, node_name: str, status,
                  dump: Optional[Callable[[], Optional[dict]]] = None, now=time.time) -> bool:
    """One snapshot pass: if the node carries a snapshot request not yet
    answered, take the transparent dump and publish the outcome. Returns
    True when a restorable checkpoint was written."""
    node = _node(client, node_name)
    if node is None:
        return False
    request = _parse_annotation(node, consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION)
    if not request or not request.get("plan"):
        return False
    plan = str(request["plan"])
    result = _parse_annotation(node, consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION)
    if result and result.get("plan") == plan:
        return False  # this request is answered
    if dump is not None:
        state = dump()
    else:
        state = read_process_state(os.environ.get(PROCESS_STATE_ENV)
                                   or process_state_path(status.directory))
    if state is None or "step" not in state:
        log.warning("migrate agent: snapshot of %s failed (no process state)", node_name)
        _publish(client, node_name, consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION,
                 {"plan": plan, "ok": False, "error": "process state unreadable"})
        return False
    step = int(state["step"])
    manifest = state.get("manifest")
    if not isinstance(manifest, dict):
        manifest = ckpt_schema.build_manifest(
            state.get("partition") or deep_get(node, "metadata", "labels",
                                               consts.TPU_SLICE_CONFIG_LABEL),
            state.get("blocked") or [], groups=state.get("groups"))
    ckpt_schema.save_checkpoint_v2(
        drain.checkpoint_path(status.directory), step, rng_state=state.get("rng_state"),
        compile_cache=os.environ.get(consts.COMPILATION_CACHE_DIR_ENV),
        optimizer_state=ckpt_schema.optimizer_state_pointer(status.directory),
        manifest=manifest, transparent=True, now=now)
    _stamp_barrier(status, "migrate_snapshot", {"plan": plan, "step": step, "taken_at": now()})
    _publish(client, node_name, consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION,
             {"plan": plan, "ok": True, "step": step, "manifest": manifest})
    log.info("migrate agent: transparent snapshot of %s at step %d (plan %s)", node_name,
             step, plan)
    return True


def _default_fetch(inbound: dict, on_corrupt=None) -> Optional[dict]:
    base = os.environ.get(TRANSFER_DIR_ENV)
    if not base:
        return None
    path = os.path.join(base, str(inbound.get("src", "")), consts.DRAIN_CHECKPOINT_FILE)
    return drain.load_checkpoint(path, on_corrupt=on_corrupt)


def restore_once(client, node_name: str, status,
                 fetch: Optional[Callable[[dict], Optional[dict]]] = None,
                 links: Optional[topology.Links] = None, metrics=None,
                 namespace: Optional[str] = None, now=time.time) -> bool:
    """One restore pass on a destination node: if an inbound migration not
    yet restored is stamped, fetch the transferred checkpoint, re-map its
    manifest onto this node's GPUs (over ``links``, NVML's pairwise link
    classes; without them the manifest is kept as it came) and land it at
    the local checkpoint path. Returns True when the restore landed."""
    node = _node(client, node_name)
    if node is None:
        return False
    inbound = _parse_annotation(node, consts.MIGRATION_INBOUND_ANNOTATION)
    if not inbound or not inbound.get("plan"):
        return False
    plan = str(inbound["plan"])
    result = _parse_annotation(node, consts.MIGRATION_RESTORE_ANNOTATION)
    if result and result.get("plan") == plan:
        return False  # this migration is restored
    on_corrupt = ckpt_schema.corrupt_reporter(
        client, namespace or os.environ.get(consts.NAMESPACE_ENV, consts.DEFAULT_NAMESPACE),
        node_name, metrics=metrics)
    payload = fetch(inbound) if fetch is not None else _default_fetch(inbound, on_corrupt)
    if payload is None:
        # the full payload is unreachable (source gone, transfer torn): the
        # inbound record carries the committed step and manifest, so the
        # tenant restores from that minimum rather than from scratch
        if "step" not in inbound:
            _publish(client, node_name, consts.MIGRATION_RESTORE_ANNOTATION,
                     {"plan": plan, "ok": False, "src": inbound.get("src"),
                      "error": "transferred checkpoint unreadable"})
            return False
        payload = {"step": inbound["step"], "manifest": inbound.get("manifest")}
    step = int(payload["step"])
    manifest = payload.get("manifest") or inbound.get("manifest")
    if isinstance(manifest, dict) and links is not None:
        remapped = ckpt_schema.remap_manifest(
            manifest, links, [],
            deep_get(node, "metadata", "labels", consts.TPU_SLICE_CONFIG_LABEL))
        manifest = remapped if remapped is not None else manifest
    ckpt_schema.save_checkpoint_v2(
        drain.checkpoint_path(status.directory), step, rng_state=payload.get("rng_state"),
        compile_cache=payload.get("compile_cache"),
        optimizer_state=payload.get("optimizer_state"),
        manifest=manifest if isinstance(manifest, dict) else None,
        extra={"migrated_from": inbound.get("src")}, now=now)
    _stamp_barrier(status, "migrate_restore", {"plan": plan, "step": step, "restored_at": now()})
    _publish(client, node_name, consts.MIGRATION_RESTORE_ANNOTATION,
             {"plan": plan, "ok": True, "step": step, "src": inbound.get("src")})
    log.info("migrate agent: restored the tenant from %s on %s at step %d (plan %s)",
             inbound.get("src"), node_name, step, plan)
    return True


def run(client, node_name: str, status, sleep_interval: float = 60.0,
        iterations: Optional[int] = None, nvml_lib=None) -> int:
    """The agent's loop: a snapshot pass and a restore pass every
    ``sleep_interval`` s (forever, or ``iterations`` times). The restore
    re-maps over the node's NVML links, read at the first pass where NVML
    lists the GPUs; until then, and for a shard over a pair NVML cannot
    answer, manifests are landed as they came."""
    from ..partitioner.partitioner import PartitionError, node_links

    log.info("migrate-agent: watching %s (interval %ss)", node_name, sleep_interval)
    links = None
    count = 0
    while True:
        if links is None:
            try:
                _, links = node_links(nvml_lib)
            except PartitionError as e:
                log.warning("migrate-agent: no link matrix (%s); restores keep their "
                            "manifests", e)
        try:
            snapshot_once(client, node_name, status)
            restore_once(client, node_name, status, links=links)
        except Exception:
            # one bad pass must not crash-loop the agent; the operator's
            # deadline path stays live regardless
            log.exception("migrate-agent pass failed; retrying next interval")
        count += 1
        if iterations is not None and count >= iterations:
            return 0
        time.sleep(sleep_interval)
