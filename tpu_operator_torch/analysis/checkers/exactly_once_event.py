"""exactly-once-event: Event emission on drain/migrate/autoscale protocol
paths must route through ``events.record_once``.

Protocol episodes survive operator crashes by re-entering the same code
path after restart; a plain ``events.record`` there emits a duplicate
announcement per re-entry, which downstream tooling (and the paper's
exactly-once Event semantics) cannot distinguish from a second episode.
``events.record_once`` names the Event by a content hash of its token so
a replay collides with AlreadyExists and stands down.

Scope — where duplicate emission is protocol-visible rather than merely
noisy: a function is *on a protocol path* when it transitively writes one
of the protocol coordination annotations (retile plan, drain ack,
migrate request/state/snapshot/inbound/restore, autoscale state) while
referencing its registry constant, or directly calls such a writer (the
episode functions themselves). Direct ``events.record(...)`` call sites
in those functions are flagged. Aggregated *informational* events
(counters folded into one Event) are a deliberate pattern — suppress
with rationale at the site.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Set, Tuple

from ..core import Checker, FileContext, Finding, register

#: registry constant names whose annotations carry protocol state; writing
#: one of these marks the enclosing function as an episode step
PROTOCOL_CONST_NAMES = frozenset({
    "RETILE_PLAN_ANNOTATION",
    "DRAIN_ACK_ANNOTATION",
    "AUTOSCALE_STATE_ANNOTATION",
    "MIGRATE_REQUEST_ANNOTATION",
    "MIGRATION_STATE_ANNOTATION",
    "MIGRATE_SNAPSHOT_REQUEST_ANNOTATION",
    "MIGRATE_SNAPSHOT_RESULT_ANNOTATION",
    "MIGRATION_INBOUND_ANNOTATION",
    "MIGRATION_RESTORE_ANNOTATION",
})

#: call-name tails that persist object state (the patch paths; dict-style
#: ``.update`` deliberately excluded — far too common as a builtin)
WRITE_TAILS = ("preconditioned_patch", "coalesced_patch", "defer_patch",
               "patch", "replace")

_CACHE_KEY = "exactly-once-event"


def _is_write_call(dotted: str) -> bool:
    tail = dotted.rsplit(".", 1)[-1]
    return tail in WRITE_TAILS


def _is_record_call(project, fn, dotted: str, call) -> bool:
    """Direct events.record emission: resolved to the events module's
    ``record``, or textually ``events.record`` / ``<x>.record`` where the
    receiver is an import alias of the events module."""
    callee = project.resolve_call(fn, call)
    if callee is not None:
        target = project.functions.get(callee)
        if (target is not None and target.qualname == "record"
                and target.modname.rsplit(".", 1)[-1] == "events"):
            return True
        return False
    return dotted == "events.record"


def _protocol_scope(project) -> Tuple[Set[str], Set[str]]:
    """(writers, scope): writers transitively persist a protocol
    annotation they reference by constant; scope adds their direct
    callers — the episode functions where emission discipline applies."""
    writes: Set[str] = set()
    for fid, fn in project.functions.items():
        if any(_is_write_call(d) for d, _c in fn.raw_calls):
            writes.add(fid)
    # propagate "writes" backwards over call edges to a fixpoint
    changed = True
    while changed:
        changed = False
        for fid, fn in project.functions.items():
            if fid in writes:
                continue
            if any(callee in writes for callee, _c in fn.calls):
                writes.add(fid)
                changed = True
    writers = {fid for fid in writes
               if project.functions[fid].consts_used & PROTOCOL_CONST_NAMES}
    scope = set(writers)
    for fid, fn in project.functions.items():
        if any(callee in writers for callee, _c in fn.calls):
            scope.add(fid)
    return writers, scope


@register
class ExactlyOnceEvent(Checker):
    name = "exactly-once-event"
    description = ("events.record on a drain/migrate/autoscale protocol "
                   "path: use events.record_once (content-addressed)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        if _CACHE_KEY not in project.cache:
            _writers, scope = _protocol_scope(project)
            sites: Dict[str, List] = {}
            for fid in sorted(scope):
                fn = project.functions[fid]
                for dotted, call in fn.raw_calls:
                    if _is_record_call(project, fn, dotted, call):
                        sites.setdefault(fn.relpath, []).append((fn, call))
            project.cache[_CACHE_KEY] = sites
        for fn, call in project.cache[_CACHE_KEY].get(ctx.relpath, []):
            yield ctx.finding(
                call, self,
                f"events.record in {fn.qualname} on a protocol path "
                f"(function transitively writes a protocol annotation): "
                f"crash re-entry duplicates this Event — use "
                f"events.record_once with a content token, or suppress "
                f"with rationale if aggregation is intended")
