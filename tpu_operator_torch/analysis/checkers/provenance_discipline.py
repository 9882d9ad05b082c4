"""provenance-discipline: actuating verbs in reconcile paths must be
reachable from a function that records a decision record.

The decision-provenance journal (``provenance/journal.py``) is the fleet's black box: every
node delete, pod evict, and force-retile plan publish must trace back to
a ``DecisionJournal.record_decision`` call so the causality audit in the
benches can walk from actuation to the decision that licensed it. The
bench audit proves this dynamically for the episodes the bench happens
to produce; this rule proves the shape statically for every actuating
path in the actuating subsystems, including paths no bench reaches.

Approximation (the reference documents it in docs/static-analysis.md): a function is a
*recorder* when any of its raw calls ends in ``.record_decision``; the
*covered* set is the recorders plus everything reachable from them
through resolved call edges (a delete helper invoked by a recorder is
licensed by the caller's record, written ahead of the actuation per the
journal's write-ahead contract). An *actuation* is a primitive
``.delete(`` / ``.evict(`` call (unresolvable as a project function,
i.e. a client verb; ``events``-module receivers exempt — Event deletion
is garbage collection, not fleet actuation) or any call to a
``_publish_plan`` helper (the force-retile plan annotation is the drain
protocol's actuating edge). Scope is the actuating reconciler dirs —
note ``health`` deliberately ON TOP of the configured reconcile dirs:
the health machine actuates but its dir is not in the durable-state
rule's default scope.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from ..core import Checker, FileContext, Finding, register

#: subsystems whose reconcile paths actuate against the fleet; the
#: provenance contract applies to all of them regardless of the
#: configured ``reconcile_dirs`` (which omits ``health``)
ACTUATING_DIRS = ("autoscale", "migrate", "health", "upgrade")

#: client verbs that mutate the fleet when left unresolved (a resolved
#: project function merely *named* delete is summarized, not a verb)
ACTUATION_TAILS = ("delete", "evict")

#: helpers whose invocation IS an actuation even when resolved — the
#: published plan annotation starts a drain the workload must obey
ACTUATING_HELPER_TAILS = ("_publish_plan",)

#: module-name tails whose receivers never count as actuation
EXEMPT_MODULE_TAILS = ("events",)

RECORD_TAIL = "record_decision"

_CACHE_KEY = "provenance-discipline"


def _module_in_dirs(relpath: str, dirnames) -> bool:
    parts = relpath.split("/")[:-1]
    wanted = set(dirnames)
    return any(p in wanted for p in parts)


def _is_primitive_actuation(dotted: str) -> bool:
    head, _, tail = dotted.rpartition(".")
    if tail not in ACTUATION_TAILS:
        return False
    return not head.endswith(EXEMPT_MODULE_TAILS)


def _is_recorder(fn) -> bool:
    return any(dotted.rpartition(".")[2] == RECORD_TAIL
               for dotted, _ in fn.raw_calls)


def _actuations(project, fn) -> List[Tuple[str, object]]:
    """(description, call node) actuating events inside ``fn``."""
    out = []
    for dotted, call in fn.raw_calls:
        tail = dotted.rpartition(".")[2]
        if tail in ACTUATING_HELPER_TAILS:
            out.append((f"{dotted}()", call))
            continue
        if project.resolve_call(fn, call) is not None:
            # resolved project function: its own body is checked on its
            # own merits; the call itself is not a client verb
            continue
        if _is_primitive_actuation(dotted):
            out.append((f"{dotted}()", call))
    return out


def _analyze(project) -> Dict[str, List[Tuple]]:
    recorders = {fid for fid, fn in project.functions.items()
                 if _is_recorder(fn)}
    covered = recorders | project.reachable_from(sorted(recorders))
    violations: Dict[str, List[Tuple]] = {}
    for fid, fn in sorted(project.functions.items()):
        if fid in covered:
            continue
        if not _module_in_dirs(fn.relpath, ACTUATING_DIRS):
            continue
        for described, node in _actuations(project, fn):
            violations.setdefault(fn.relpath, []).append(
                (fn, node, described))
    return violations


@register
class ProvenanceDiscipline(Checker):
    name = "provenance-discipline"
    description = ("actuation (delete/evict/plan publish) in an "
                   "actuating subsystem unreachable from any "
                   "decision-record site")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        if _CACHE_KEY not in project.cache:
            project.cache[_CACHE_KEY] = _analyze(project)
        for fn, node, described in project.cache[_CACHE_KEY].get(
                ctx.relpath, []):
            yield ctx.finding(
                node, self,
                f"{fn.qualname} actuates ({described}) but is not "
                f"reachable from any function that records a decision "
                f"record: the causality audit will report this as an "
                f"orphan actuation — record the licensing decision via "
                f"DecisionJournal.record_decision on the path to this "
                f"call")
