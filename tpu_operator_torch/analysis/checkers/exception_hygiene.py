"""exception-hygiene: no bare excepts, no silent broad swallows.

A bare ``except:`` catches ``SystemExit``/``KeyboardInterrupt`` and turns a
requested shutdown into a hung process. A broad handler whose body is only
``pass``/``...``/``continue`` erases every failure class this codebase
cares about — ``BreakerOpenError``, ``ApiError``, programming errors —
with no log line for the support case that follows. Narrow handlers
(``except NotFoundError: pass``) are idiomatic here and stay legal; broad
handlers that log, re-raise, or actually handle stay legal too.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import Checker, FileContext, Finding, register

BROAD = {"Exception", "BaseException"}


def is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        if isinstance(n, ast.Name) and n.id in BROAD:
            return True
        if isinstance(n, ast.Attribute) and n.attr in BROAD:
            return True
    return False


def is_silent(handler: ast.ExceptHandler) -> bool:
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / `...`
        return False
    return True


@register
class ExceptionHygiene(Checker):
    name = "exception-hygiene"
    description = ("bare except, or broad except whose body silently "
                   "discards the exception")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield ctx.finding(
                    node, self,
                    "bare `except:` also catches SystemExit/"
                    "KeyboardInterrupt; catch Exception (or narrower)")
            elif is_broad(node) and is_silent(node):
                yield ctx.finding(
                    node, self,
                    "broad except with a silent body swallows every "
                    "failure (incl. BreakerOpenError/ApiError) without a "
                    "trace; narrow the type, log it, or re-raise")
