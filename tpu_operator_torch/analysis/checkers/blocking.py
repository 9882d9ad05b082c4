"""blocking-call: reconcile paths must never park a worker unboundedly.

Every controller runs MaxConcurrentReconciles=1 (``controllers/runtime.py``)
— one blocked worker wedges that controller for the whole cluster, which is
why the client layer grew per-call deadlines in the first place. Flagged in
reconcile paths (``controllers/``, ``state/``, ``upgrade/``):

* ``time.sleep(...)`` — scheduling belongs in the queue
  (``Result.requeue_after`` / ``queue.add(delay=...)``), not in a worker;
* zero-argument ``.join()`` / ``.wait()`` — unbounded; pass a timeout
  (``str.join(iterable)`` takes an argument, so it never matches);
* network calls without an explicit ``timeout=``: ``requests.*``
  verbs and ``urlopen`` (the client layer's default deadline does not
  cover sockets opened behind its back).
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import (
    Checker,
    FileContext,
    Finding,
    dotted_name,
    has_double_star,
    has_keyword,
    register,
)

HTTP_VERBS = {"get", "post", "put", "patch", "delete", "head", "options",
              "request"}
UNBOUNDED = {"join", "wait"}


@register
class BlockingCall(Checker):
    name = "blocking-call"
    description = ("time.sleep, unbounded join()/wait(), or timeout-less "
                   "network calls inside controller/reconcile paths")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.is_reconcile_path:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name == "time.sleep":
                yield ctx.finding(
                    node, self,
                    "time.sleep() parks the (single) reconcile worker; "
                    "requeue with Result(requeue_after=...) or "
                    "queue.add(delay=...) instead")
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in UNBOUNDED
                    and not node.args and not node.keywords):
                yield ctx.finding(
                    node, self,
                    f".{node.func.attr}() without a timeout can block the "
                    f"worker forever; pass an explicit bound")
                continue
            timeout_less = (
                (name.startswith("requests.")
                 and name.split(".", 1)[1] in HTTP_VERBS)
                or name.endswith("urlopen"))
            if timeout_less and not has_keyword(node, "timeout") \
                    and not has_double_star(node):
                yield ctx.finding(
                    node, self,
                    f"network call {name}() without timeout= can hang the "
                    f"reconcile worker on a dead peer; set an explicit "
                    f"timeout")
