"""api-bypass: every apiserver call routes through the client stack.

The resilience contract (deadlines, retry budget, token-bucket limiter,
circuit breaker — ``client/resilience.py``) only holds if nothing talks to
the apiserver behind the stack's back. A raw HTTP connection and
``RestClient`` construction outside the sanctioned layers are exactly the
bypass that voids it.

The port's client speaks ``http.client`` (``client/rest.py``), so its raw
transport is ``http.client.HTTPConnection`` / ``HTTPSConnection``; the
reference's ``requests.<verb>()`` calls are flagged too, so a module that
brings ``requests`` back is held to the same rule. A ``urlopen`` scrape
(a node's ``/metrics``, a runtime endpoint) is not apiserver traffic and
stays unflagged, as in the reference.

Allowed zones: ``client/`` (the stack itself) for everything; the ``cmd/``
composition roots may additionally construct ``RestClient`` (they build the
wrapper chain). Referencing exception types for handling
(``except http.client.HTTPException``) is fine anywhere — only *calls* are
flagged.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import Checker, FileContext, Finding, dotted_name, register

HTTP_VERBS = {"get", "post", "put", "patch", "delete", "head", "options",
              "request"}
#: the standard library's raw connections: ``http.client.<name>(...)`` or
#: the bare name imported from ``http.client``
RAW_CONNECTIONS = {"HTTPConnection", "HTTPSConnection"}


def _raw_connection_names(tree: ast.Module) -> set:
    """Local names bound to ``http.client``'s connection classes."""
    bound = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "http.client":
            for alias in node.names:
                if alias.name in RAW_CONNECTIONS:
                    bound.add(alias.asname or alias.name)
    return bound


@register
class ApiBypass(Checker):
    name = "api-bypass"
    description = ("direct http.client/requests/RestClient use outside "
                   "tpu_operator_torch/client/ bypasses the resilience stack")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.is_client_code:
            return
        allow_restclient = ctx.in_dirs(ctx.config.entrypoint_dirs)
        raw_names = _raw_connection_names(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if (isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "requests"):
                if func.attr in HTTP_VERBS or func.attr == "Session":
                    yield ctx.finding(
                        node, self,
                        f"direct requests.{func.attr}() bypasses "
                        f"RetryingClient (per-call deadline, retry budget, "
                        f"rate limiter, circuit breaker); route apiserver "
                        f"traffic through tpu_operator_torch.client")
            dotted = dotted_name(func)
            if dotted in raw_names or (
                    dotted.startswith("http.client.")
                    and dotted.rsplit(".", 1)[-1] in RAW_CONNECTIONS):
                yield ctx.finding(
                    node, self,
                    f"raw {dotted}() bypasses RetryingClient (per-call "
                    f"deadline, retry budget, rate limiter, circuit "
                    f"breaker); route apiserver traffic through "
                    f"tpu_operator_torch.client")
            if (isinstance(func, ast.Name) and func.id == "RestClient"
                    and not allow_restclient):
                yield ctx.finding(
                    node, self,
                    "RestClient constructed outside client//cmd/: the raw "
                    "client has no retry/limiter/breaker — build the stack "
                    "via the cmd/ composition root or wrap in RetryingClient")
