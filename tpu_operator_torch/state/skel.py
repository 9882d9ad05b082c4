"""Common state implementation: apply rendered objects, walk readiness
(copy of tpu_operator/state/skel.py).

NVIDIA's stateSkel (internal/state/state_skel.go): every
state renders manifests to unstructured objects, then create-or-updates them
with owner references, a state label, and DaemonSet hash-skip; sync state is
derived by walking the readiness of what was applied
(state_skel.go:223-285,383-444).
"""

from __future__ import annotations

import copy
import enum
import logging
import os
from typing import List, Optional

from .. import consts, events
from ..client.errors import ApiError, ConflictError, KindNotServedError, NotFoundError
from ..client.interface import Client
from ..utils import deep_get, object_hash

log = logging.getLogger(__name__)


class SyncState(str, enum.Enum):
    READY = "ready"
    NOT_READY = "notReady"
    IGNORE = "ignore"
    ERROR = "error"


def owner_reference(owner: dict, controller: bool = True) -> dict:
    return {
        "apiVersion": owner["apiVersion"],
        "kind": owner["kind"],
        "name": owner["metadata"]["name"],
        "uid": owner["metadata"].get("uid", ""),
        "controller": controller,
        "blockOwnerDeletion": True,
    }


# -- readiness predicates (state_skel.go:414-444, object_controls.go:3525) ----

def is_daemonset_ready(ds: dict, expected_nodes: Optional[int] = None) -> bool:
    """DS readiness (reference state_skel.go:414-444) hardened against the
    fresh-DS race: a just-created DaemonSet reports desired=0 before the DS
    controller sweeps, which must not read as "ready" when nodes should match.

    Freshness signal: ``status.observedGeneration`` — the DS controller has
    seen this spec. Only when that is absent (controller hasn't written status
    at all yet) fall back to comparing desired against a nodeSelector label
    count; the DS controller's own desired is authoritative otherwise (it also
    accounts for taints/affinity, which a label count cannot)."""
    status = ds.get("status", {})
    desired = status.get("desiredNumberScheduled", 0)
    observed = status.get("observedGeneration")
    generation = deep_get(ds, "metadata", "generation", default=1)
    if observed is not None:
        if observed < generation:
            return False  # stale status for an updated spec
    elif expected_nodes is not None and desired != expected_nodes:
        return False  # fresh DS: no status yet but nodes should match
    if desired == 0:
        return True  # genuinely no eligible nodes
    return (
        status.get("numberAvailable", 0) == desired
        and status.get("updatedNumberScheduled", 0) == desired
    )


def node_matches_selector(node: dict, selector: dict) -> bool:
    labels = deep_get(node, "metadata", "labels", default={}) or {}
    return all(labels.get(k) == v for k, v in (selector or {}).items())


def is_deployment_ready(dep: dict) -> bool:
    want = deep_get(dep, "spec", "replicas", default=1)
    return dep.get("status", {}).get("readyReplicas", 0) >= want


def is_pod_ready(pod: dict) -> bool:
    phase = deep_get(pod, "status", "phase")
    if phase == "Succeeded":
        return True
    if phase != "Running":
        return False
    for cond in deep_get(pod, "status", "conditions", default=[]) or []:
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return False


_READINESS = {
    "DaemonSet": is_daemonset_ready,
    "Deployment": is_deployment_ready,
    "Pod": is_pod_ready,
}

def _covers(live, desired) -> bool:
    """True when every field of ``desired`` is present and equal in
    ``live`` — dicts recursively, lists pairwise with equal length. Extra
    live-only fields are apiserver defaults (clusterIP, protocol,
    SA-managed secrets), not drift; a rendered field that was changed or
    removed out-of-band IS drift and fails the check. One traversal with
    ``_first_divergence`` so the drift decision and the reported culprit
    path can never disagree."""
    return _first_divergence(live, desired) is None


def _first_divergence(live, desired, path="$") -> Optional[str]:
    """Dotted path of the first field where ``_covers`` fails — names the
    culprit in the damping Event so an admin can find the webhook/controller
    fighting the render without diffing YAML by hand."""
    if isinstance(desired, dict):
        if not isinstance(live, dict):
            return path
        for key, value in desired.items():
            if key not in live:
                return f"{path}.{key}"
            sub = _first_divergence(live[key], value, f"{path}.{key}")
            if sub:
                return sub
        return None
    if isinstance(desired, list):
        if not isinstance(live, list) or len(live) != len(desired):
            have = len(live) if isinstance(live, list) else type(live).__name__
            return f"{path} (live length {have} != rendered {len(desired)})"
        for i, (l, d) in enumerate(zip(live, desired)):
            sub = _first_divergence(l, d, f"{path}[{i}]")
            if sub:
                return sub
        return None
    return None if live == desired else path


#: consecutive heals of one object before the sweep stops re-applying and
#: degrades to hash-only skip (the reference never loops here because its
#: skip is hash-only, object_controls.go:4316; our drift check needs the
#: damper to coexist with normalizing admission webhooks)
DRIFT_HEAL_LIMIT = 3

#: (mergeObjects analog, state_skel.go:344)
_PRESERVE_ON_UPDATE = {
    "Service": [("spec", "clusterIP"), ("spec", "clusterIPs")],
    "ServiceAccount": [("secrets",), ("imagePullSecrets",)],
}


# API groups that may legitimately be unserved (their CRDs are optional
# add-ons): objects in them are applied best-effort and skipped when the
# cluster has no such resource, rather than failing the whole state.
OPTIONAL_API_GROUPS = ("monitoring.coreos.com",)


def _is_optional_group(api_version: str) -> bool:
    return api_version.split("/")[0] in OPTIONAL_API_GROUPS


class StateSkel:
    """Create-or-update a batch of unstructured objects and report readiness."""

    def __init__(self, name: str, client: Client):
        self.name = name
        self.client = client
        #: objects whose DriftHealSuspended event already fired from this
        #: process — second guard behind the annotation marker, so a
        #: persistently failing bookkeeping patch (however unlikely: RBAC
        #: grants * on operand kinds) cannot re-fire an Event per sweep
        self._suspension_reported: set = set()

    # -- apply ----------------------------------------------------------------
    def create_or_update_objs(self, objs: List[dict], owner: Optional[dict] = None) -> List[dict]:
        applied = []
        for obj in objs:
            try:
                applied.append(self._apply_one(copy.deepcopy(obj), owner))
            except (NotFoundError, KindNotServedError):
                # a create bouncing 404 (server-side) or an unregistered kind
                # (scheme-side) means the resource kind itself is not served
                # (e.g. no prometheus-operator CRDs) — tolerable only for
                # optional groups
                if not _is_optional_group(obj.get("apiVersion", "")):
                    raise
                log.info("state %s: skipping %s/%s (API group not served)",
                         self.name, obj.get("kind"),
                         deep_get(obj, "metadata", "name"))
        return applied

    @staticmethod
    def _desired_fingerprint(desired: dict) -> str:
        """Order-insensitive hash of everything the operator renders for an
        object: full doc minus status and server-managed metadata. The
        DaemonSet-only spec hash generalized to every kind — without it a
        reconcile sweep re-UPDATEs ~25 unchanged SAs/Services/RBAC objects
        per trigger, so steady-state write load scales O(sweeps), not
        O(changes) (apiserver audit-log spam at fleet size)."""
        doc = copy.deepcopy(desired)
        doc.pop("status", None)
        meta = doc.get("metadata", {})
        for server_managed in ("resourceVersion", "uid", "creationTimestamp",
                               "generation", "managedFields"):
            meta.pop(server_managed, None)
        for bookkeeping in (consts.SPEC_HASH_ANNOTATION,
                            consts.DRIFT_HEALS_ANNOTATION):
            (meta.get("annotations") or {}).pop(bookkeeping, None)
        return object_hash(doc)

    @staticmethod
    def _heal_count(live: dict) -> int:
        raw = deep_get(live, "metadata", "annotations",
                       consts.DRIFT_HEALS_ANNOTATION)
        try:
            return int(raw) if raw else 0
        except (TypeError, ValueError):
            return 0

    def _set_heal_count(self, live: dict, count: Optional[int]) -> None:
        """Annotation-persisted counter (not instance state: skels are
        rebuilt per sweep and reconcilers fail over between replicas —
        the same crash-safety argument as the upgrade machine's labels).
        Best-effort: bookkeeping must never fail a reconcile."""
        meta = live["metadata"]
        try:
            self.client.patch(
                live["apiVersion"], live["kind"], meta["name"],
                {"metadata": {"annotations": {
                    consts.DRIFT_HEALS_ANNOTATION:
                        str(count) if count is not None else None}}},
                meta.get("namespace"))
        except ApiError as e:
            log.info("state %s: drift-heal bookkeeping patch failed on "
                     "%s/%s: %s", self.name, live.get("kind"),
                     meta.get("name"), e)

    def _apply_one(self, desired: dict, owner: Optional[dict]) -> dict:
        meta = desired.setdefault("metadata", {})
        meta.setdefault("labels", {})[consts.STATE_LABEL] = self.name
        if owner is not None:
            meta["ownerReferences"] = [owner_reference(owner)]
        meta.setdefault("annotations", {})[consts.SPEC_HASH_ANNOTATION] = \
            self._desired_fingerprint(desired)

        api_version, kind = desired["apiVersion"], desired["kind"]
        name, namespace = meta["name"], meta.get("namespace")
        try:
            current = self.client.get(api_version, kind, name, namespace)
        except NotFoundError:
            log.info("state %s: creating %s/%s", self.name, kind, name)
            return self.client.create(desired)

        current_hash = deep_get(current, "metadata", "annotations", consts.SPEC_HASH_ANNOTATION)
        if current_hash == meta["annotations"][consts.SPEC_HASH_ANNOTATION]:
            heals = self._heal_count(current)
            obj_key = (api_version, kind, name, namespace)
            if _covers(current, desired):
                if heals:
                    # drift settled (webhook gone / edit reverted): clear
                    # the counter — and the reported-flag, so a RETURNING
                    # fight re-announces itself instead of being silently
                    # re-suspended — so an unrelated future drift gets a
                    # fresh heal budget
                    self._set_heal_count(current, None)
                    self._suspension_reported.discard(obj_key)
                # unchanged AND undrifted: the stored fingerprint only
                # proves the operator's last write matched — an out-of-band
                # kubectl edit leaves it intact, so the live object must
                # still carry every rendered field (extra live fields are
                # server defaults, not drift) or the sweep re-applies
                # (object_controls.go:4316 confines the skip to
                # DaemonSets; we extend it to every kind, so the drift
                # check comes along)
                return current
            if heals >= DRIFT_HEAL_LIMIT:
                # the same object needed healing DRIFT_HEAL_LIMIT sweeps
                # running: something (mutating admission webhook, another
                # controller) rewrites the rendered value right back every
                # time. Re-applying forever is an unbounded UPDATE/warn
                # loop — exactly the write amplification the fingerprint
                # skip exists to prevent — so degrade THIS object to
                # hash-only skip, once, loudly
                if heals == DRIFT_HEAL_LIMIT:
                    # always try to persist the damped marker (so the NEXT
                    # sweep reads heals > LIMIT and skips silently); the
                    # loud report itself additionally dedupes in-process in
                    # case that bookkeeping patch keeps failing
                    self._set_heal_count(current, heals + 1)
                    if obj_key not in self._suspension_reported:
                        self._suspension_reported.add(obj_key)
                        where = _first_divergence(current, desired) or "?"
                        message = (f"{kind}/{name} is rewritten out-of-band "
                                   f"at {where} after every re-apply "
                                   f"({DRIFT_HEAL_LIMIT} consecutive heals); "
                                   f"suspending drift healing for this "
                                   f"object (hash-only skip) — find the "
                                   f"mutating webhook/controller fighting "
                                   f"the render")
                        log.error("state %s: %s", self.name, message)
                        events.record(self.client, namespace
                                      or os.environ.get(consts.NAMESPACE_ENV,
                                                        consts.DEFAULT_NAMESPACE),
                                      current, events.WARNING,
                                      "DriftHealSuspended", message)
                return current
            # drift heal is loud: an edited operator-rendered object (RBAC
            # verb dropped, Service port rewritten) is tampering or a
            # broken controller fight, and a server that NORMALIZES a
            # rendered value would re-trigger this every sweep — either
            # way the log must show it, not bury it in a silent update
            log.warning("state %s: %s/%s drifted from rendered spec "
                        "(out-of-band edit?); re-applying (heal %d/%d)",
                        self.name, kind, name, heals + 1, DRIFT_HEAL_LIMIT)
            meta["annotations"][consts.DRIFT_HEALS_ANNOTATION] = str(heals + 1)

        for path in _PRESERVE_ON_UPDATE.get(kind, []):
            value = deep_get(current, *path)
            if value is not None:
                node = desired
                for step in path[:-1]:
                    node = node.setdefault(step, {})
                node.setdefault(path[-1], value)

        desired["metadata"]["resourceVersion"] = current["metadata"].get("resourceVersion")
        if "status" in current:
            desired.setdefault("status", current["status"])
        log.info("state %s: updating %s/%s", self.name, kind, name)
        try:
            return self.client.update(desired)
        except ConflictError:
            # lost a write race; the next reconcile sweep re-applies
            return current

    # -- readiness ------------------------------------------------------------
    def get_sync_state(self, objs: List[dict], nodes: Optional[List[dict]] = None) -> SyncState:
        """Walk readiness of applied objects. ``nodes`` lets the caller share
        one per-sweep Node snapshot instead of one LIST per DS-bearing state."""
        for obj in objs:
            check = _READINESS.get(obj.get("kind"))
            if check is None:
                continue
            meta = obj.get("metadata", {})
            try:
                live = self.client.get(obj["apiVersion"], obj["kind"], meta["name"], meta.get("namespace"))
            except NotFoundError:
                return SyncState.NOT_READY
            if obj["kind"] == "DaemonSet":
                if nodes is None:
                    nodes = self.client.list("v1", "Node")
                selector = deep_get(live, "spec", "template", "spec", "nodeSelector", default={})
                expected = sum(1 for n in nodes if node_matches_selector(n, selector))
                ok = is_daemonset_ready(live, expected_nodes=expected)
            else:
                ok = check(live)
            if not ok:
                log.info("state %s: %s/%s not ready", self.name, obj.get("kind"), meta.get("name"))
                return SyncState.NOT_READY
        return SyncState.READY

    # -- deletion (state disabled) -------------------------------------------
    def delete_objs(self, objs: List[dict]) -> None:
        for obj in objs:
            meta = obj.get("metadata", {})
            try:
                self.client.delete(obj["apiVersion"], obj["kind"], meta["name"], meta.get("namespace"))
            except NotFoundError:
                pass
            except KindNotServedError:
                if not _is_optional_group(obj.get("apiVersion", "")):
                    raise

    def list_owned(self, api_version: str, kind: str, namespace: Optional[str] = None) -> List[dict]:
        try:
            return self.client.list(api_version, kind, namespace,
                                    label_selector={consts.STATE_LABEL: self.name})
        except (NotFoundError, KindNotServedError):
            if _is_optional_group(api_version):
                return []  # resource kind not served: nothing owned
            raise
