"""unfenced-write: the operator's write path must route through the fence.

The split-brain guarantee (``docs/design.md`` §12) holds only if every
mutating apiserver call the operator makes passes ``FencedClient``
admission — a client chain assembled without the fence, or a fence that
is never bound to an elector, silently admits a deposed replica's stale
writes. Two invariants, both over the composition roots (``cmd/`` and
``controllers/``):

1. ``RetryingClient(...)`` must wrap a ``FencedClient`` (directly, or via
   a name assigned one in the same file). The resilience layer sits above
   the fence by design — retries of a fenced write are exactly the stale
   traffic the fence exists to stop, so a chain built the other way (or
   with no fence at all) voids the guarantee.
2. A constructed ``FencedClient`` must be bound — a ``fence=`` argument at
   construction or an ``.bind(...)`` call in the same file. An unbound
   fence is a deliberate passthrough for non-elected processes (the node
   validator agent); inside the operator's composition roots it is a bug.

Node-agent code (``validator/``) is out of scope: it holds no Lease, so
there is nothing to fence.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional

from ..core import Checker, FileContext, Finding, register


def _call_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Name):
            return func.id
        if isinstance(func, ast.Attribute):
            return func.attr
    return None


@register
class UnfencedWrite(Checker):
    name = "unfenced-write"
    description = ("operator client chains must include a bound "
                   "FencedClient: an unfenced chain admits a deposed "
                   "replica's stale writes")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.is_client_code:
            return  # the stack's own modules define these classes
        if not ctx.in_dirs(("controllers",) + ctx.config.entrypoint_dirs):
            return  # only the composition roots assemble operator chains

        # name -> constructor name, for simple `x = SomeClient(...)` forms;
        # enough to resolve the idiomatic one-wrapper-per-line chain build
        assigned: Dict[str, str] = {}
        #: FencedClient call node -> the name it was assigned to (if simple)
        fenced_target: Dict[ast.Call, str] = {}
        bound_names = set()
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                ctor = _call_name(node.value)
                if ctor:
                    assigned[node.targets[0].id] = ctor
                if ctor == "FencedClient":
                    fenced_target[node.value] = node.targets[0].id
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "bind"
                    and isinstance(node.func.value, ast.Name)):
                bound_names.add(node.func.value.id)

        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            ctor = _call_name(node)
            if ctor == "RetryingClient":
                inner = node.args[0] if node.args else None
                inner_ctor = _call_name(inner) if inner else None
                if inner_ctor is None and isinstance(inner, ast.Name):
                    inner_ctor = assigned.get(inner.id)
                if inner_ctor != "FencedClient":
                    yield ctx.finding(
                        node, self,
                        "RetryingClient wraps an unfenced transport: every "
                        "mutating call it carries skips leader-fence "
                        "admission (and a fenced write below it would be "
                        "retried as stale traffic) — build the chain as "
                        "RetryingClient(FencedClient(transport))")
            elif ctor == "FencedClient":
                if any(kw.arg == "fence" for kw in node.keywords):
                    continue
                # `x = FencedClient(...)`: is x later `.bind()`ed here?
                # Inline construction (no name) can't be traced — the
                # RetryingClient shape check above still applies to it.
                name = fenced_target.get(node)
                if name is not None and name not in bound_names:
                    yield ctx.finding(
                        node, self,
                        "FencedClient constructed but never bound to an "
                        "elector (no fence= argument, no .bind(...) in this "
                        "file): an unbound fence is a passthrough that "
                        "admits every write")
