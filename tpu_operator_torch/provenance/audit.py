"""Causality audit: every audited actuation must be reachable from a
complete decision chain (copy of tpu_operator/provenance/audit.py).

An :class:`ActuationObserver` sits at the bottom of a client chain (below
the batcher and the fence, or around the apiserver's own backend, so it
sees final merged writes as they land) and classifies the wire-visible
actuations: node deletes, re-tile plan publishes, snapshot requests,
restore intents. :func:`causality_audit` then checks each observed
actuation against the decision journal: it must be claimed by a record's
``actuations`` list AND its episode must be complete (root decision +
terminal outcome). Unclaimed actuations are **orphans**.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .. import consts
from .journal import DecisionJournal

#: annotation keys whose wire-visible SET classifies a patch as an audited
#: actuation (clearing a key is bookkeeping, not actuation)
_PATCH_CLASSES = (
    (consts.RETILE_PLAN_ANNOTATION, "plan"),
    (consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION, "snapshot"),
    (consts.MIGRATION_INBOUND_ANNOTATION, "restore"),
)


@dataclasses.dataclass(frozen=True)
class ObservedActuation:
    """One wire-visible actuation, as landed on the apiserver."""

    verb: str   # delete | plan | snapshot | restore
    kind: str
    name: str
    namespace: str = ""

    def key(self) -> Tuple[str, str, str]:
        return (self.verb, self.kind, self.name)


class ActuationObserver:
    """Pass-through client wrapper that records audited actuations.

    Wrap the INNERMOST client (the apiserver's backend) so deferred writes
    are observed post-flush with their final merged bodies — an actuation
    swallowed by the batcher was never actuated and must not be audited.
    """

    def __init__(self, inner):
        self.inner = inner
        self.observed: List[ObservedActuation] = []

    # -- interception ---------------------------------------------------------

    def _observe_patch(self, kind: str, name: str, patch: dict,
                       namespace: Optional[str]) -> None:
        annotations = ((patch.get("metadata") or {}).get("annotations")
                       or {}) if isinstance(patch, dict) else {}
        for key, verb in _PATCH_CLASSES:
            if annotations.get(key) is not None:
                self.observed.append(ObservedActuation(
                    verb=verb, kind=kind, name=name,
                    namespace=namespace or ""))

    def delete(self, api_version, kind, name, namespace=None):
        if kind == "Node":
            self.observed.append(ObservedActuation(
                verb="delete", kind=kind, name=name,
                namespace=namespace or ""))
        return self.inner.delete(api_version, kind, name, namespace)

    def patch(self, api_version, kind, name, patch, namespace=None):
        self._observe_patch(kind, name, patch, namespace)
        return self.inner.patch(api_version, kind, name, patch, namespace)

    def update(self, obj):
        meta = (obj or {}).get("metadata", {}) or {}
        self._observe_patch(obj.get("kind", ""), meta.get("name", ""),
                            obj, meta.get("namespace"))
        return self.inner.update(obj)

    # -- pass-through ---------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self.inner, name)


def causality_audit(journal: DecisionJournal,
                    observed: List[ObservedActuation]) -> dict:
    """Check every observed actuation against the journal.

    Returns a report::

        {"observed": N, "covered": N, "orphans": [...],
         "incomplete": [...], "episodes": N, "complete_episodes": N,
         "ok": bool}

    * **orphan** — no decision record claims the actuation at all (the
      actuation happened with no recorded "why").
    * **incomplete** — claimed, but the claiming episode has no terminal
      outcome record or lost its root: the chain does not explain the
      actuation end to end.

    Feeds orphan counts into the journal's metric hook
    (``tpu_operator_provenance_orphans_total``).
    """
    index: Dict[Tuple[str, str, str], List] = {}
    for rec in journal.records():
        for act in rec.actuations:
            key = (str(act.get("verb", "")), str(act.get("kind", "")),
                   str(act.get("name", "")))
            index.setdefault(key, []).append(rec)

    orphans: List[dict] = []
    incomplete: List[dict] = []
    covered = 0
    for act in observed:
        claims = index.get(act.key())
        if not claims:
            orphans.append(dataclasses.asdict(act))
            continue
        if not any(journal.episode_complete(rec.episode) for rec in claims):
            incomplete.append({**dataclasses.asdict(act),
                               "episodes": sorted({r.episode
                                                   for r in claims})})
            continue
        covered += 1

    episodes = journal.episodes()
    report = {
        "observed": len(observed),
        "covered": covered,
        "orphans": orphans,
        "incomplete": incomplete,
        "episodes": len(episodes),
        "complete_episodes": sum(
            1 for e in episodes if journal.episode_complete(e["episode"])),
        "ok": not orphans and not incomplete,
    }
    journal.note_orphans(len(orphans))
    return report
