"""lock-order-inversion: cycles in the acquired-while-holding lock graph.

The file-local lock-discipline rule proves each *field* is guarded; it
cannot see that ``Pool.fill`` takes A then B while ``Pool.drain`` takes B
then A — or that ``Coordinator.step`` calls into ``Worker.poke`` while
holding its own lock and ``Worker.step`` calls back the other way. Either
shape deadlocks two threads, and neither is visible one file (or one
function) at a time.

The graph layer records an edge L1 -> L2 whenever L2 is acquired while L1
is held: directly (nested ``with``) or through any resolved call chain
(``self.method()`` and constructor-inferred ``self.peer.method()``
dispatch, transitively). This rule flags every edge that participates in
a cycle, at the acquisition site that creates the edge, naming one sample
cycle. Findings are emitted in the file that owns the acquisition site,
so inline suppressions and the baseline keep working per-file.

A deliberate total lock order (always A before B) produces an acyclic
graph and is never flagged; re-entrant acquisition of the *same* lock is
lock-discipline's business (RLock), not an inversion, and is skipped.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

from ..core import Checker, FileContext, Finding, register

_CACHE_KEY = "lock-order-inversion"


@register
class LockOrderInversion(Checker):
    name = "lock-order-inversion"
    description = ("cycle in the acquired-while-holding lock graph across "
                   "classes (static deadlock)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        if _CACHE_KEY not in project.cache:
            project.cache[_CACHE_KEY] = project.lock_cycle_edges()
        edges: List[Tuple] = project.cache[_CACHE_KEY]
        for edge, cycle in edges:
            if edge.relpath != ctx.relpath:
                continue
            path = " -> ".join(n.label() for n in [edge.src] + cycle)
            yield ctx.finding(
                edge.node, self,
                f"acquiring {edge.dst.label()} while holding "
                f"{edge.src.label()} (via {edge.via}) completes a "
                f"lock-order cycle: {path}; impose a single acquisition "
                f"order or drop to one lock")
