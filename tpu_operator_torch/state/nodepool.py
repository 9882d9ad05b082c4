"""Node-pool partitioning for pool-sharded sweeps (counterpart of
tpu_operator/state/nodepool.py).

NVIDIA's operator partitions GPU nodes by OS / kernel version because it
compiles kernel modules per pool (internal/state/nodepool.go:55-132). The
port places user-space driver libraries, no kernel module; what varies
across a fleet is the GPU model, so pools are keyed on the accelerator:
GKE's ``cloud.google.com/gke-accelerator``, else feature discovery's chip
type. A GPU node has no slice topology, so a pool's ``topology`` is empty.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List

from .. import consts
from ..utils import deep_get

_SANITIZE = re.compile(r"[^a-z0-9-]+")


def sanitize_name(raw: str) -> str:
    return _SANITIZE.sub("-", raw.lower()).strip("-") or "default"


@dataclasses.dataclass
class NodePool:
    name: str                      # DNS-safe pool suffix, e.g. nvidia-h100-80gb
    accelerator: str
    topology: str
    node_selector: Dict[str, str]  # selects exactly this pool's nodes
    node_names: List[str]

    @property
    def size(self) -> int:
        return len(self.node_names)


def get_node_pools(nodes: List[dict]) -> List[NodePool]:
    """Group GPU nodes by accelerator; stable name per pool."""
    pools: Dict[str, NodePool] = {}
    for node in nodes:
        labels = deep_get(node, "metadata", "labels", default={}) or {}
        accelerator = labels.get(consts.GKE_ACCELERATOR_LABEL,
                                 labels.get(consts.TPU_CHIP_TYPE_LABEL, "unknown"))
        if accelerator not in pools:
            selector: Dict[str, str] = {}
            if consts.GKE_ACCELERATOR_LABEL in labels:
                selector[consts.GKE_ACCELERATOR_LABEL] = accelerator
            elif consts.TPU_CHIP_TYPE_LABEL in labels:
                selector[consts.TPU_CHIP_TYPE_LABEL] = accelerator
            pools[accelerator] = NodePool(name=sanitize_name(accelerator),
                                          accelerator=accelerator, topology="",
                                          node_selector=selector, node_names=[])
        pools[accelerator].node_names.append(deep_get(node, "metadata", "name", default=""))
    out = sorted(pools.values(), key=lambda p: p.name)
    for pool in out:
        pool.node_names.sort()
    return out


def shard_by_pools(nodes: List[dict], pools: List[NodePool]) -> List[List[dict]]:
    """Partition ``nodes`` into per-pool shards (same order as ``pools``)
    so node-facing sweeps reconcile pools in parallel workers with no
    cross-pool cross-talk.
    Every node lands in exactly one shard; nodes absent from every pool
    (shouldn't happen — :func:`get_node_pools` covers all inputs) form a
    trailing leftover shard so no node escapes its sweep."""
    by_name: Dict[str, dict] = {
        deep_get(n, "metadata", "name", default=""): n for n in nodes}
    shards: List[List[dict]] = []
    pooled: set = set()
    for pool in pools:
        shard = [by_name[name] for name in pool.node_names if name in by_name]
        pooled.update(pool.node_names)
        if shard:
            shards.append(shard)
    leftover = [node for name, node in sorted(by_name.items())
                if name not in pooled]
    if leftover:
        shards.append(leftover)
    return shards
