"""state-before-actuation: the durable-state patch must dominate any
actuation call in autoscale/migrate reconcile episodes.

The durable-state protocol (``autoscale/``, ``migrate/``): before an episode creates,
deletes, or evicts anything, its intent is persisted in a
resource-version-preconditioned annotation patch
(``tpu.ai/autoscale-state`` / ``tpu.ai/migration-state``), so a crash
between decision and actuation replays the *persisted* decision instead
of recomputing a possibly different one. The crash-point matrix proves
this dynamically for the paths it kills; this rule proves the shape
statically for every path, including ones the matrix doesn't reach.

Approximation (the reference documents it in docs/static-analysis.md): domination is
checked per function in source order, transitively through helpers via
per-function summaries — branch-sensitive dominator analysis over Python
ASTs buys little here and costs a lot. Scope is bounded to modules in
reconcile dirs that reference a durable-state registry constant; the
*anchor* set is every function referencing such a constant (persisting
the intent or loading the persisted copy both establish the durable
decision), and *actuation* is any ``.create(`` / ``.delete(`` /
``.evict(`` call outside the exempt modules (``events`` — Event creation
is an announcement, not actuation).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..core import Checker, FileContext, Finding, register

#: registry constants whose annotations hold durable episode state
STATE_CONST_NAMES = frozenset({
    "AUTOSCALE_STATE_ANNOTATION",
    "MIGRATION_STATE_ANNOTATION",
})

ACTUATION_TAILS = ("create", "delete", "evict")

#: module-name tails whose calls never count as actuation even though
#: they .create() objects (Events are announcements)
EXEMPT_MODULE_TAILS = ("events",)

_CACHE_KEY = "state-before-actuation"

# per-function summaries
CLEAN = "clean"                      # neither anchors nor actuates
ANCHORS = "anchors"                  # establishes durable state, no unsafe act
SAFE = "safe"                        # anchors strictly before any actuation
UNSAFE = "unsafe"                    # actuates before any anchor


def _module_in_dirs(relpath: str, dirnames) -> bool:
    parts = relpath.split("/")[:-1]
    wanted = set(dirnames)
    return any(p in wanted for p in parts)


def _is_actuation(dotted: str) -> bool:
    head, _, tail = dotted.rpartition(".")
    if tail not in ACTUATION_TAILS:
        return False
    # events.create-style exemptions resolve at the callee level; the raw
    # textual form only needs the receiver not to be the events module
    return not head.endswith(EXEMPT_MODULE_TAILS)


def _exempt_callee(project, callee: str) -> bool:
    fn = project.functions.get(callee)
    return (fn is not None
            and fn.modname.rsplit(".", 1)[-1] in EXEMPT_MODULE_TAILS)


class _Analysis:
    def __init__(self, project, config):
        self.project = project
        self.config = config
        self.anchors: Set[str] = {
            fid for fid, fn in project.functions.items()
            if fn.consts_used & STATE_CONST_NAMES}
        self.summary: Dict[str, str] = {}
        #: violations: relpath -> [(fn, call node, described chain)]
        self.violations: Dict[str, List[Tuple]] = {}

    def events_in_order(self, fn):
        """(kind, payload, node) events of interest in source order."""
        out = []
        for dotted, call in fn.raw_calls:
            callee = self.project.resolve_call(fn, call)
            if callee is not None:
                # resolved project function: summarized, never a primitive
                # (a helper merely *named* create is not client.create)
                if _exempt_callee(self.project, callee):
                    continue
                if callee in self.anchors:
                    out.append(("anchor", callee, call))
                else:
                    out.append(("call", callee, call))
            elif _is_actuation(dotted):
                out.append(("primitive", dotted, call))
        out.sort(key=lambda e: (e[2].lineno, e[2].col_offset))
        return out

    def summarize(self, fid: str, stack: Set[str]) -> str:
        if fid in self.summary:
            return self.summary[fid]
        if fid in stack:
            return CLEAN                      # cycle tolerance: fail open
        fn = self.project.functions.get(fid)
        if fn is None:
            return CLEAN
        stack = stack | {fid}
        anchored = False
        actuated = False
        first_unsafe: Optional[Tuple] = None
        for kind, payload, node in self.events_in_order(fn):
            if kind == "anchor":
                anchored = True
            elif kind == "primitive":
                actuated = True
                if not anchored and first_unsafe is None:
                    first_unsafe = (payload, node)
            else:
                sub = self.summarize(payload, stack)
                if sub in (ANCHORS, SAFE):
                    anchored = True
                    actuated = actuated or sub == SAFE
                elif sub == UNSAFE:
                    actuated = True
                    if not anchored and first_unsafe is None:
                        callee_fn = self.project.functions[payload]
                        first_unsafe = (f"{payload} -> ... "
                                        f"({callee_fn.qualname} actuates "
                                        f"before persisting)", node)
        if first_unsafe is not None:
            result = UNSAFE
            self.violations.setdefault(fn.relpath, []).append(
                (fn, first_unsafe[1], first_unsafe[0]))
        elif actuated:
            result = SAFE
        elif anchored:
            result = ANCHORS
        else:
            result = CLEAN
        self.summary[fid] = result
        return result


def _analyze(project, config) -> Dict[str, List[Tuple]]:
    # scope: reconcile-dir modules that reference a durable-state constant
    scoped_mods = set()
    for modname, mod in project.modules.items():
        if not _module_in_dirs(mod.relpath, config.reconcile_dirs):
            continue
        fns = list(mod.functions.values())
        for cls in mod.classes.values():
            fns.extend(cls.methods.values())
        if any(f.consts_used & STATE_CONST_NAMES for f in fns):
            scoped_mods.add(modname)
    entrypoints = [
        fid for fid, fn in project.functions.items()
        if fn.modname in scoped_mods
        and fn.qualname.rsplit(".", 1)[-1] in ("reconcile", "_reconcile")]
    analysis = _Analysis(project, config)
    reachable = project.reachable_from(entrypoints)
    for fid in sorted(reachable):
        fn = project.functions.get(fid)
        if fn is None or fn.modname not in scoped_mods:
            continue
        analysis.summarize(fid, set())
    return analysis.violations


@register
class StateBeforeActuation(Checker):
    name = "state-before-actuation"
    description = ("actuation (create/delete/evict) before the durable "
                   "episode-state patch in autoscale/migrate reconcile "
                   "paths")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        if _CACHE_KEY not in project.cache:
            project.cache[_CACHE_KEY] = _analyze(project, ctx.config)
        for fn, node, chain in project.cache[_CACHE_KEY].get(ctx.relpath, []):
            yield ctx.finding(
                node, self,
                f"{fn.qualname} actuates ({chain}) before the durable "
                f"episode state is persisted or loaded: a crash here "
                f"replays with a recomputed decision — persist intent "
                f"via the preconditioned state annotation first")
