"""breaker-swallow: reconcile paths must surface BreakerOpenError.

Degraded mode (``client/resilience.py``) only works end-to-end if
``BreakerOpenError`` travels from the client stack up to the runtime
worker, which requeues without counting an error or growing backoff
(``controllers/runtime.py``). A broad ``except Exception`` anywhere on
that path converts "apiserver known-down, operator patiently waiting" into
either a logged-and-lost event or a counted reconcile error that pages on
an outage the operator is already handling as designed.

A broad handler in a reconcile path passes only when the enclosing ``try``
also handles ``BreakerOpenError`` explicitly (sibling handler), the
handler re-raises, or its body references ``BreakerOpenError`` itself.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import Checker, FileContext, Finding, register
from .exception_hygiene import is_broad

EXC_NAME = "BreakerOpenError"


def _mentions_breaker(node: ast.AST) -> bool:
    for child in ast.walk(node):
        if isinstance(child, ast.Name) and child.id == EXC_NAME:
            return True
        if isinstance(child, ast.Attribute) and child.attr == EXC_NAME:
            return True
    return False


@register
class BreakerSwallow(Checker):
    name = "breaker-swallow"
    description = ("broad except in a reconcile path that can swallow "
                   "BreakerOpenError (degraded mode depends on it "
                   "propagating)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.is_reconcile_path:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            if any(h.type is not None and _mentions_breaker(h.type)
                   for h in node.handlers):
                continue  # a sibling handler deals with the breaker
            for handler in node.handlers:
                if not is_broad(handler):
                    continue
                body_ok = (_mentions_breaker(handler)
                           or any(isinstance(s, ast.Raise)
                                  for s in ast.walk(handler)))
                if not body_ok:
                    yield ctx.finding(
                        handler, self,
                        "broad except here can swallow BreakerOpenError — "
                        "an open-breaker call would be logged as a generic "
                        "failure instead of requeued as degraded mode; "
                        "handle BreakerOpenError explicitly (requeue/"
                        "re-raise) before the broad handler")
