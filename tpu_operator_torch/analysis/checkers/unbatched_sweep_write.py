"""unbatched-sweep-write: per-node writes in a sweep must ride the batcher.

The event-driven scale contract (``docs/design.md`` §13) prices a sweep
at O(changed objects), not O(nodes): per-node label/annotation/condition
writes issued inside a loop are exactly the traffic the ``WriteBatcher``
exists to coalesce into one preconditioned PATCH per object per flush
window. A raw ``client.patch(...)`` (or ``update_status``) inside a
``for``/``while`` over the fleet bypasses the coalescer and reintroduces
O(nodes·sweeps) request complexity — the 183-requests-per-join regime
the scale envelope gates against.

Scope is the reconcile paths (``controllers/``, ``state/``,
``upgrade/``) plus the per-node decorators (``nodeinfo/``,
``health/``). The sanctioned routes are ``coalesced_patch(...)`` /
``preconditioned_patch(...)`` (plain-name calls, so the rule naturally
passes them) and ``batcher.defer_patch(...)``. Writes that are
deliberate ordering barriers (``evict``, ``create``, ``delete``) are out
of scope: the batcher flushes before them by design, so looping over
them is a throughput question, not a correctness one. A site that truly
must write unbatched inside a loop carries an inline suppression with
its reason.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import Checker, FileContext, Finding, register

#: mutating verbs the batcher can coalesce; a loop body calling them as a
#: method bypasses the flush window. ``evict``/``create``/``delete`` are
#: intentional barriers and excluded.
_COALESCABLE_VERBS = frozenset({"patch", "update_status"})

#: batcher entry points — attribute calls with these names are the
#: sanctioned route, not a bypass
_BATCHED_ROUTES = frozenset({"defer_patch"})


@register
class UnbatchedSweepWrite(Checker):
    name = "unbatched-sweep-write"
    description = ("per-node client writes inside a sweep loop must route "
                   "through the write batcher (coalesced_patch / "
                   "defer_patch): a raw per-iteration patch is "
                   "O(nodes*sweeps) apiserver traffic")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.is_client_code:
            return  # the batcher itself loops over deferred writes
        if not ctx.in_dirs(ctx.config.reconcile_dirs + ("nodeinfo", "health")):
            return

        seen = set()  # nested loops both walk the same call — report once
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for node in ast.walk(loop):
                if id(node) in seen:
                    continue
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                verb = node.func.attr
                if verb in _BATCHED_ROUTES:
                    continue
                if verb not in _COALESCABLE_VERBS:
                    continue
                seen.add(id(node))
                yield ctx.finding(
                    node, self,
                    f"per-object .{verb}(...) inside a sweep loop bypasses "
                    "the write batcher — each iteration is a separate "
                    "apiserver round-trip, O(nodes*sweeps) at fleet scale. "
                    "Route it through coalesced_patch(client, ...) (or "
                    "batcher.defer_patch) so the flush window merges it "
                    "into one preconditioned PATCH per object")
