"""GPU partition manager (counterpart of tpu_operator/partitioner/partitioner.py).

The reference carves one TPU host's chips into independently schedulable
sub-slices; this carves one GPU node's GPUs into groups that the device
plugin advertises as ``gpu-part-<i>`` units. There is no call on the
device: a partition is a scheduling contract, so applying it means
publishing the grouping atomically where the device plugin picks it up (a
host-path JSON handoff file) and reporting progress in node labels:

    tpu.ai/slice.config        (desired; set by the admin or the ClusterPolicy)
    tpu.ai/slice.config.state  (pending -> success | retiled | failed; set here)

The handoff file is the contract with the device plugin and the telemetry
exporter: ``{"partition": <name>, "groups": [{"topology": "numa", "chips":
[0, 1, 2, 3]}], "applied_at": <epoch s>}`` plus ``"blocked": [...]`` on a
health-gated re-tile. A chip is a GPU, numbered in PCI bus-id order (the
plugin's unit order, CUDA's ordinals in every sweep process); groups are
placed over NVML's link topology (``topology.py``), so the handoff carries
no grid. MIG is not applied here.

Nothing here imports torch or opens a CUDA context: NVML answers it.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time
from typing import Dict, List, Optional

from .. import consts, nvml
from ..client import preconditioned_patch
from ..yamlsubset import SubsetError, parse
from ..health import drain as drainproto
from ..utils import deep_get, pod_requests_resource
from . import topology

log = logging.getLogger(__name__)

DEFAULT_HANDOFF_DIR = consts.DEFAULT_HANDOFF_DIR
HANDOFF_FILE = "partition.json"

STATE_PENDING = "pending"
STATE_SUCCESS = "success"
STATE_FAILED = "failed"
#: the configured layout applied minus health-gated GPUs: every group was
#: re-placed on the healthy GPUs. Back to ``success`` once the workload
#: barrier passes again.
STATE_RETILED = "retiled"

#: the port's default partition table, what the slice-partitioner
#: ConfigMap would hold (the reference ships its own in its manifests):
#: no partition, one unit per GPU, or a node split into two 4-GPU halves
DEFAULT_PARTITIONS: Dict[str, List[dict]] = {
    "all-disabled": [],
    "single-gpu": [{"chips": 1, "count": "all"}],
    "two-halves": [{"chips": 4}, {"chips": 4}],
}


class PartitionError(ValueError):
    pass


def load_config(path: Optional[str]) -> Dict[str, List[dict]]:
    """The partition table in the file at ``path`` (JSON or the YAML subset
    of ``yamlsubset.py``); None gives :data:`DEFAULT_PARTITIONS`."""
    if path is None:
        return {name: [dict(e) for e in layout] for name, layout in DEFAULT_PARTITIONS.items()}
    try:
        with open(path) as f:
            raw = parse(f.read()) or {}
    except SubsetError as e:
        # a malformed ConfigMap is a config failure, not a crash: the node
        # path reports state=failed
        raise PartitionError(f"{path}: invalid table: {e}") from e
    partitions = raw.get("partitions") if isinstance(raw, dict) else None
    if not isinstance(partitions, dict):
        raise PartitionError(f"{path}: missing 'partitions' mapping")
    return partitions


def node_links(nvml_lib=None):
    """The node's GPUs (PCI order) and their pairwise link classes, from
    one NVML session. A pair NVML cannot answer holds the reason in place
    of a class: reading it raises ``topology.UnknownLink``, so only a
    layout that needs that pair fails, and one-GPU groups still place.
    Raises PartitionError where NVML cannot list the GPUs."""
    try:
        with nvml.session(nvml_lib) as s:
            gpus = s.gpus()
            links: List[List[Optional[str]]] = [[None] * len(gpus) for _ in gpus]
            for i, j in itertools.combinations(range(len(gpus)), 2):
                try:
                    links[i][j] = links[j][i] = s.link(gpus[i], gpus[j])
                except nvml.NvmlError as e:
                    links[i][j] = links[j][i] = f"unknown ({e})"
            return gpus, links
    except nvml.NvmlError as e:
        raise PartitionError(f"the node's GPUs: {e}") from e


def compute_partition(layout: List[dict], links: topology.Links,
                      blocked: Optional[frozenset] = None) -> List[dict]:
    """Expand a named layout into GPU groups placed over the node's link
    topology, each group's ``topology`` derived from its placed GPUs
    (``topology.tile_partition``). ``blocked`` GPUs (health-gated) are
    left out of every group."""
    try:
        return topology.tile_partition(links, layout, blocked=blocked)
    except topology.UnknownLink:
        raise  # NVML could not answer for a pair: the node fails, never defers
    except topology.TopologyError as e:
        # config nonsense is a partition failure with an entry-naming
        # reason; anything else escaping the tiler is a bug and stays loud
        raise PartitionError(str(e)) from e


def write_handoff(groups: List[dict], name: str, handoff_dir: str = DEFAULT_HANDOFF_DIR,
                  blocked: Optional[List[int]] = None) -> str:
    os.makedirs(handoff_dir, exist_ok=True)
    path = os.path.join(handoff_dir, HANDOFF_FILE)
    tmp = path + ".tmp"
    payload = {"partition": name, "groups": groups, "applied_at": time.time()}
    if blocked:
        # health-gated GPUs this layout was re-tiled around: part of the
        # handoff's identity, so recovery (blocked -> empty) is a content
        # change that restores the configured layout
        payload["blocked"] = list(blocked)
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)  # the device plugin must never read a torn file
    return path


def read_handoff(handoff_dir: str = DEFAULT_HANDOFF_DIR) -> Optional[dict]:
    try:
        with open(os.path.join(handoff_dir, HANDOFF_FILE)) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def gpu_consumers_on(client, node_name: str) -> int:
    """Live pods on the node that hold ``nvidia.com/gpu``. A new layout
    re-IDs the units the plugin advertises, so applying it under a running
    consumer would strand its allocation; like the reference (and
    mig-manager) the partitioner waits for the node to drain.

    Best-effort, not a lock: a pod can bind between this check and the
    handoff write. Cordon and drain the node first for a guaranteed-safe
    repartition."""
    return sum(
        1 for pod in client.list("v1", "Pod", None, field_selector={"spec.nodeName": node_name})
        if deep_get(pod, "status", "phase") not in ("Succeeded", "Failed")
        and pod_requests_resource(pod, consts.GPU_RESOURCE_NAME))


def _consumers_or_none(client, node_name: str) -> Optional[int]:
    """gpu_consumers_on, with a transient pod-list failure reported as None
    (defer) rather than raised: one apiserver blip mid-pass must not flip a
    node with a valid table to state=failed."""
    try:
        return gpu_consumers_on(client, node_name)
    except Exception as e:
        log.warning("partition consumer check on %s failed (%s); deferring", node_name, e)
        return None


def health_gated_chips(status_dir: Optional[str], total_chips: int) -> frozenset:
    """GPUs the node's workload barrier implicates, by CUDA ordinal (the
    plugin's unit positions): the set the health-aware re-tile places
    around. Empty when the barrier passes, is absent, or records a failure
    that names no GPU (the plugin then gates every unit; no re-tile can
    route around all of them)."""
    from ..validator.status import StatusFiles, failed_local_chips

    status = StatusFiles(status_dir) if status_dir else StatusFiles()
    info = status.read("workload")
    if info is None or info.get("passed") is not False:
        return frozenset()
    return failed_local_chips(info, total_chips) or frozenset()


def _set_state_label(client, node_name: str, value: Optional[str],
                     expected_config: Optional[str]) -> None:
    """rv-preconditioned write of the state label. The patch is re-derived
    against the fresh node on a 409, and re-checks the desired-config label
    the verdict was computed from: a pass whose input went stale mid-flight
    declines instead of clobbering the newer writer."""
    def build(fresh: dict) -> Optional[dict]:
        fresh_labels = deep_get(fresh, "metadata", "labels", default={}) or {}
        if fresh_labels.get(consts.TPU_SLICE_CONFIG_LABEL) != expected_config:
            log.warning("slice state write on %s declined: desired partition changed "
                        "mid-pass (was %r)", node_name, expected_config)
            return None
        if fresh_labels.get(consts.TPU_SLICE_STATE_LABEL) == value:
            return None  # already there (replayed pass): no write
        return {"metadata": {"labels": {consts.TPU_SLICE_STATE_LABEL: value}}}

    preconditioned_patch(client, "v1", "Node", node_name, build)


def sync_once(client, node_name: str, config_path: Optional[str],
              handoff_dir: str = DEFAULT_HANDOFF_DIR,
              total_chips: Optional[int] = None,
              status_dir: Optional[str] = None,
              drain_deadline_s: Optional[int] = None,
              nvml_lib=None, journal=None) -> Optional[str]:
    """One reconcile pass; returns the state written (None: nothing to do).

    ``drain_deadline_s`` > 0 turns on the coordinated drain for
    health-gated re-tiles: the layout write waits for the workload's
    barrier drain ack (matching the plan fingerprint both sides compute
    from the desired partition and the gated GPUs) or for the published
    plan's deadline to pass, then forces. 0 (the default, also through
    ``$GPU_DRAIN_DEADLINE_S``) re-tiles at once.

    ``journal`` (a :class:`~..provenance.DecisionJournal`, optional)
    records the layout write as a decision before it lands: a re-tile
    chains onto the health machine's episode through the node's
    ``tpu.ai/episode-id``; a plain apply opens and closes its own."""
    if status_dir is None:
        status_dir = os.environ.get("STATUS_DIR", consts.VALIDATION_STATUS_DIR)
    if drain_deadline_s is None:
        try:
            drain_deadline_s = int(os.environ.get(consts.DRAIN_DEADLINE_ENV, "0") or 0)
        except ValueError:
            drain_deadline_s = 0
    node = client.get("v1", "Node", node_name)
    labels = deep_get(node, "metadata", "labels", default={}) or {}
    desired = labels.get(consts.TPU_SLICE_CONFIG_LABEL)
    state = labels.get(consts.TPU_SLICE_STATE_LABEL)
    if not desired:
        if state:  # config removed: clear the state label and the handoff
            if read_handoff(handoff_dir) is not None \
                    and _consumers_or_none(client, node_name) != 0:
                # going back to one unit per GPU re-IDs every unit too: it
                # waits for the node to drain like any repartition
                log.warning("partition removal on %s deferred: GPU consumer(s) still "
                            "running", node_name)
                if state != STATE_PENDING:
                    _set_state_label(client, node_name, STATE_PENDING, expected_config=None)
                return STATE_PENDING
            _set_state_label(client, node_name, None, expected_config=None)
            try:
                os.remove(os.path.join(handoff_dir, HANDOFF_FILE))
            except FileNotFoundError:
                pass
        return None
    current = read_handoff(handoff_dir)

    def set_state(value: str) -> None:
        _set_state_label(client, node_name, value, expected_config=desired)

    try:
        table = load_config(config_path)
        if desired not in table:
            raise PartitionError(f"unknown partition {desired!r}; have {sorted(table)}")
        gpus, links = node_links(nvml_lib)
        if total_chips is None:
            chips_label = labels.get(consts.TPU_CHIP_COUNT_LABEL)
            total_chips = int(chips_label) if chips_label else len(gpus)
        if total_chips <= 0:
            raise PartitionError("no GPU on this node")
        if total_chips != len(gpus):
            raise PartitionError(f"the node is labelled with {total_chips} GPU(s), NVML "
                                 f"sees {len(gpus)}")
        if not (labels.get(consts.GKE_ACCELERATOR_LABEL)
                or labels.get(consts.TPU_CHIP_TYPE_LABEL)):
            # bootstrap window, not a failure: the GPU type label comes
            # with feature discovery; stay pending (retried every pass)
            set_state(STATE_PENDING)
            log.info("partition %s on %s: GPU type label not yet present; pending",
                     desired, node_name)
            return STATE_PENDING
        blocked = sorted(health_gated_chips(status_dir, total_chips))
        if blocked and any(g.cuda_ordinal is None for g in gpus):
            # the barrier names CUDA ordinals this node cannot tie to GPUs:
            # the plugin gates every unit, so the failure is unattributed
            log.warning("partition %s on %s: the sweep failed GPU(s) %s but the GPUs' "
                        "CUDA ordinals are unknown; keeping the configured layout",
                        desired, node_name, blocked)
            blocked = []
        target_state = STATE_SUCCESS
        if blocked:
            target_state = STATE_RETILED
            groups = None
            prev_blocked = set(current.get("blocked", [])) if current else None
            if (current and current.get("partition") == desired and current.get("groups")
                    and prev_blocked is not None and set(blocked) >= prev_blocked):
                # incremental re-tile: when GPUs degrade on an applied
                # layout, keep every group that lost none (its unit and
                # tenants stay valid) and re-place only the hit ones. On
                # partial recovery fall through to the full tiler so freed
                # GPUs return to the configured layout.
                try:
                    groups, dropped = topology.retile_incremental(
                        links, blocked, current["groups"])
                    if not groups:
                        groups = None  # total loss: let the full tiler try
                    elif dropped:
                        log.warning("partition %s on %s: %d group(s) lost to gated GPU(s) "
                                    "%s (no healthy placement); %d kept", desired,
                                    node_name, len(dropped), blocked, len(groups))
                except topology.TopologyError as e:
                    log.warning("partition %s on %s: previous handoff unusable for an "
                                "incremental re-tile (%s); recomputing", desired,
                                node_name, e)
            if groups is None:
                try:
                    groups = compute_partition(table[desired], links,
                                               blocked=frozenset(blocked))
                except PartitionError as e:
                    # the re-tile is impossible: defer, don't fail; the
                    # configured layout is valid, its GPUs merely gated
                    if state != STATE_PENDING:
                        set_state(STATE_PENDING)
                    log.warning("partition %s on %s: re-tile around gated GPU(s) %s "
                                "impossible (%s); deferred until recovery", desired,
                                node_name, blocked, e)
                    return STATE_PENDING
        else:
            groups = compute_partition(table[desired], links)
        if (current and current.get("partition") == desired
                and current.get("groups") == groups
                and current.get("blocked", []) == blocked):
            # already applied, verified by content, not by name: a handoff
            # of other groups under the same name is recomputed. Not gated
            # on the state label: a success write lost to a crash leaves
            # pending with a correct live handoff, and pods scheduled on it
            # must not hold the label at pending
            if state != target_state:
                set_state(target_state)
            return target_state
        if blocked and drain_deadline_s > 0:
            # coordinated drain: a health-gated layout change waits for the
            # workload's ack (its barrier stamp carries the fingerprint
            # both sides compute) or for the published plan's deadline.
            # After the content check, so an applied re-tile stays put
            from ..validator.status import StatusFiles

            expected_fp = drainproto.plan_fingerprint(desired, blocked)
            ack = drainproto.read_drain_ack(StatusFiles(status_dir))
            if not (ack and ack.get("plan") == expected_fp):
                plan = drainproto.node_plan(node)
                if plan is None or not plan.expired():
                    if state != STATE_PENDING:
                        set_state(STATE_PENDING)
                    log.info("partition %s on %s: re-tile around %s planned; waiting for "
                             "the workload's drain ack%s", desired, node_name, blocked,
                             "" if plan is None else
                             f" until the deadline ({plan.deadline - time.time():.0f}s left)")
                    return STATE_PENDING
                # deadline passed with no matching ack: force; a wedged
                # workload cannot hold the layout hostage
                log.warning("partition %s on %s: drain deadline passed without an ack%s; "
                            "forcing the re-tile around %s", desired, node_name,
                            "" if plan.fingerprint == expected_fp else
                            f" (published plan {plan.fingerprint} != expected "
                            f"{expected_fp})", blocked)
        busy = _consumers_or_none(client, node_name)
        if busy != 0:
            # a new layout re-IDs every unit; never yank them from under a
            # running consumer. None (the pod list failed) defers too: a
            # node not provably drained is not safe to repartition
            if state != STATE_PENDING:
                set_state(STATE_PENDING)
            log.warning("partition %s on %s: %s; repartition deferred until the node is "
                        "provably drained", desired, node_name,
                        "consumer check unavailable" if busy is None
                        else f"{busy} GPU-consuming pod(s) running")
            return STATE_PENDING
        if journal is not None:
            from ..provenance import episode_id

            eid = (deep_get(node, "metadata", "annotations",
                            consts.PROVENANCE_EPISODE_ANNOTATION)
                   or episode_id("retile", node_name, desired,
                                 ",".join(str(c) for c in blocked)))
            journal.record_decision(
                "partitioner", "re-tile" if blocked else "partition-apply", eid,
                trigger={"type": "layout", "partition": desired, "blocked": blocked},
                decision={"node": node_name, "groups": len(groups), "blocked": blocked},
                actuations=[{"verb": "force-retile" if blocked else "apply",
                             "kind": "Node", "name": node_name}],
                outcome=None if blocked else "applied",
                node=node_name)
        set_state(STATE_PENDING)
        write_handoff(groups, desired, handoff_dir, blocked=blocked)
        set_state(target_state)
        if blocked:
            log.info("partition %s re-tiled on %s around gated GPU(s) %s: %d group(s)",
                     desired, node_name, blocked, len(groups))
        else:
            log.info("partition %s applied on %s: %d group(s)", desired, node_name,
                     len(groups))
        return target_state
    except (PartitionError, OSError, ValueError) as e:
        log.error("partition %s failed on %s: %s", desired, node_name, e)
        set_state(STATE_FAILED)
        return STATE_FAILED


def run(client, config_path: Optional[str], node_name: Optional[str] = None,
        handoff_dir: str = DEFAULT_HANDOFF_DIR, sleep_interval: float = 15.0,
        iterations: Optional[int] = None, status_dir: Optional[str] = None,
        nvml_lib=None) -> int:
    node_name = node_name or os.environ.get("NODE_NAME", "")
    if not node_name:
        log.error("slice partitioner: NODE_NAME unset")
        return 1
    count = 0
    while True:
        try:
            sync_once(client, node_name, config_path, handoff_dir, status_dir=status_dir,
                      nvml_lib=nvml_lib)
        except Exception:
            log.exception("slice partitioner pass failed")
        count += 1
        if iterations is not None and count >= iterations:
            return 0
        time.sleep(sleep_interval)
