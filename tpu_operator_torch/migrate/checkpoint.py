"""Versioned checkpoint payloads for cross-node migration (counterpart of
tpu_operator/migrate/checkpoint.py).

The drain checkpoint (``health/drain.py``) carries ``{step, saved_at,
rng_state?, compile_cache?}``: enough to resume in place, not on another
node, which needs to know how the arrays were sharded over the source
layout. Schema v2 adds, each key additive (v1 payloads load everywhere):

- ``version``: 2;
- ``optimizer_state``: a pointer (host path and format) to the optimizer
  state saved beside the model arrays;
- ``manifest``: the sharded-array manifest, one shard per GPU group (its
  GPUs and link class), keyed by the layout fingerprint
  ``object_hash({partition, blocked})``, the identity the drain protocol and
  the partitioner already share, so the destination re-maps the shards
  through the partitioner's incremental re-tile over its own NVML links.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import List, Optional, Sequence

from .. import events
from ..health import drain
from ..partitioner import topology

#: the current schema; payloads without a ``version`` key are v1
CHECKPOINT_VERSION = 2

#: the file, beside the checkpoint, that an optimizer-state pointer names
OPTIMIZER_STATE_FILE = "optimizer-state.msgpack"


def checkpoint_version(ckpt: Optional[dict]) -> int:
    """The schema version of a loaded payload: 1 without a ``version``
    key, 0 for None or garbage."""
    if not isinstance(ckpt, dict):
        return 0
    try:
        return int(ckpt.get("version", 1))
    except (TypeError, ValueError):
        return 1


def optimizer_state_pointer(status_dir: str, fmt: str = "msgpack") -> dict:
    """The pointer record of the optimizer state saved beside the model
    checkpoint: path and format, never the payload."""
    return {"path": os.path.join(status_dir, OPTIMIZER_STATE_FILE), "format": fmt}


def build_manifest(partition: Optional[str], blocked, groups: Optional[List[dict]] = None,
                   arrays: Sequence[str] = ("params", "opt_state")) -> dict:
    """The sharded-array manifest of a layout: one shard per GPU group,
    keyed by the layout fingerprint the drain protocol uses."""
    shards = [{"shard": idx, "topology": (group or {}).get("topology"),
               "chips": [int(c) for c in (group or {}).get("chips", [])],
               "arrays": list(arrays)}
              for idx, group in enumerate(groups or [])]
    return {"layout": drain.plan_fingerprint(partition, blocked), "partition": partition or "",
            "blocked": sorted(int(c) for c in (blocked or [])), "shards": shards}


def remap_manifest(manifest: dict, links: topology.Links, blocked,
                   partition: Optional[str]) -> Optional[dict]:
    """Re-map a source manifest onto the destination node through the
    partitioner's incremental re-tile over the destination's link matrix:
    shards whose GPUs are still placeable keep them, the rest are
    re-placed within their link class on healthy GPUs. None when any shard
    cannot be placed: the caller picks another node rather than silently
    dropping arrays."""
    shards = manifest.get("shards") or []
    previous = [{"topology": s.get("topology"), "chips": [int(c) for c in s.get("chips", [])]}
                for s in shards]
    try:
        groups, dropped = topology.retile_incremental(links, blocked or [], previous)
    except topology.TopologyError:
        return None
    if dropped or len(groups) != len(shards):
        return None
    out = []
    for shard, group in zip(shards, groups):
        placed = dict(shard)
        placed["topology"] = group.get("topology")
        placed["chips"] = [int(c) for c in group.get("chips", [])]
        out.append(placed)
    return {"layout": drain.plan_fingerprint(partition, blocked), "partition": partition or "",
            "blocked": sorted(int(c) for c in (blocked or [])), "shards": out}


def save_checkpoint_v2(path: str, step: int, rng_state=None,
                       compile_cache: Optional[str] = None,
                       optimizer_state: Optional[dict] = None,
                       manifest: Optional[dict] = None, transparent: bool = False,
                       extra: Optional[dict] = None, now=time.time) -> str:
    """Persist a v2 checkpoint: the v1 payload plus version, optimizer
    pointer and manifest, through the same atomic tmp+rename writer."""
    payload = {"version": CHECKPOINT_VERSION}
    if optimizer_state:
        payload["optimizer_state"] = dict(optimizer_state)
    if manifest:
        payload["manifest"] = manifest
    if transparent:
        # the workload never took part: an operator-driven snapshot
        payload["transparent"] = True
    if extra:
        payload.update(extra)
    return drain.save_checkpoint(path, step, rng_state=rng_state, compile_cache=compile_cache,
                                 extra=payload, now=now)


def corrupt_reporter(client, namespace: str, node_name: str, metrics=None):
    """An ``on_corrupt`` callback for :func:`drain.load_checkpoint` that makes
    a checkpoint dropped as corrupt visible: one bump of
    ``metrics.checkpoint_corrupt`` (when given) and a content-addressed
    ``CheckpointCorrupt`` Event, whose token hashes the corrupt bytes, so
    retried loads of one torn file make one Event."""
    involved = {"apiVersion": "v1", "kind": "Node", "metadata": {"name": node_name}}

    def report(kind: str, raw: str) -> None:
        if metrics is not None:
            metrics.checkpoint_corrupt.inc()
        digest = hashlib.sha1((raw or "").encode()).hexdigest()[:16]
        events.record_once(
            client, namespace, involved, events.WARNING, "CheckpointCorrupt",
            f"{node_name}: drain checkpoint unreadable ({kind}); the workload will restart "
            f"from scratch unless a migration restore supersedes it",
            token=f"{kind}:{digest}")

    return report


def manifest_layout(ckpt: Optional[dict]) -> Optional[str]:
    """The layout fingerprint a checkpoint's manifest was sharded for."""
    manifest = (ckpt or {}).get("manifest")
    if not isinstance(manifest, dict):
        return None
    layout = manifest.get("layout")
    return str(layout) if layout else None


def dumps_compact(payload: dict) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))
