"""span-discipline: span factories must be entered with ``with`` in
reconcile paths.

``tracing.span(...)`` and friends return context managers; the span only
finishes — records its duration, restores the parent contextvar, reaches
the flight recorder and the join profiler — when the ``with`` block exits.
A span obtained bare (assigned, returned, passed along) in a reconcile
path never finishes: it leaks an open child into every later span of the
same trace and silently corrupts phase attribution. Outside reconcile
paths a held context manager can be legitimate plumbing (fixtures,
helpers that return them for the caller to enter), so the rule scopes to
the directories where spans feed production telemetry.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from ..core import Checker, FileContext, Finding, dotted_name, register

#: attribute/function names that produce a span context manager
SPAN_FACTORIES = {"span", "phase_span", "api_span", "remote_trace"}


def _is_span_factory(call: ast.Call) -> bool:
    name = dotted_name(call.func)
    if not name:
        return False
    last = name.rsplit(".", 1)[-1]
    if last in SPAN_FACTORIES:
        return True
    # tracer.trace(...) / self._tracer.trace(...): the Tracer's root-span
    # factory — but only when the receiver is recognizably a tracer, so
    # unrelated .trace() methods don't false-positive
    if last == "trace" and "tracer" in name.lower().replace(".trace", ""):
        return True
    return False


@register
class SpanDiscipline(Checker):
    name = "span-discipline"
    description = ("span factories (tracing.span/phase_span/api_span/"
                   "remote_trace, tracer.trace) must be entered with "
                   "`with` in reconcile paths — a bare span never "
                   "finishes and corrupts trace attribution")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.is_reconcile_path:
            return
        entered: Set[int] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    entered.add(id(item.context_expr))
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call) and _is_span_factory(node)
                    and id(node) not in entered):
                yield ctx.finding(
                    node, self,
                    f"span obtained from {dotted_name(node.func)}(...) "
                    f"outside a `with` statement; enter it in place "
                    f"(`with {dotted_name(node.func)}(...):`) so the span "
                    f"finishes, or suppress with a reason if a caller "
                    f"provably enters it")
