"""deadline-propagation: every call chain from a reconcile entrypoint to
a raw network verb must pass through the client stack (RetryingClient
budgets every request) or carry an explicit timeout at the verb.

The file-local blocking-call rule already bans timeout-less network verbs
*inside* reconcile dirs; what it cannot see is a reconcile loop calling a
helper module (validator, nodeinfo, tracing, ...) that performs a raw
``requests.get`` / ``urlopen`` with no deadline — one hung socket there
stalls the whole control loop, invisibly to per-file analysis.

Mechanics: find every raw network verb without ``timeout=`` (and without
``**kwargs``, which may forward one) in modules *outside* the client and
reconcile dirs; flag those whose enclosing function is reachable over the
call graph from a reconcile entrypoint (``reconcile``/``_reconcile`` in a
reconcile dir), where traversal prunes at client-dir modules — chains
routed through the client stack inherit its retry/deadline budget and are
the sanctioned shape. The finding carries one sample entrypoint chain so
the path is auditable.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from ..core import (Checker, FileContext, Finding, has_double_star,
                    has_keyword, register)

HTTP_VERBS = {"get", "post", "put", "patch", "delete", "head", "options",
              "request"}
NET_LIBS = {"requests", "httpx", "urllib3", "session", "http"}

_CACHE_KEY = "deadline-propagation"


def _module_in_dirs(relpath: str, dirnames) -> bool:
    parts = relpath.split("/")[:-1]
    wanted = set(dirnames)
    return any(p in wanted for p in parts)


def _is_raw_net_call(dotted: str) -> bool:
    if dotted.rsplit(".", 1)[-1] == "urlopen":
        return True
    head, _, tail = dotted.rpartition(".")
    return (tail in HTTP_VERBS
            and head.split(".")[-1].lower() in NET_LIBS)


def _analyze(project, config) -> Dict[str, List[Tuple]]:
    entrypoints = [
        fid for fid, fn in project.functions.items()
        if _module_in_dirs(fn.relpath, config.reconcile_dirs)
        and fn.qualname.rsplit(".", 1)[-1] in ("reconcile", "_reconcile")]

    def skip(modname: str) -> bool:
        mod = project.modules.get(modname)
        return (mod is not None
                and _module_in_dirs(mod.relpath, config.client_dirs))

    reachable = project.reachable_from(entrypoints, skip_module=skip)
    sites: Dict[str, List[Tuple]] = {}
    for fid in sorted(reachable):
        fn = project.functions.get(fid)
        if fn is None:
            continue
        if _module_in_dirs(fn.relpath, config.client_dirs):
            continue
        if _module_in_dirs(fn.relpath, config.reconcile_dirs):
            continue                      # blocking-call owns these sites
        for dotted, call in fn.raw_calls:
            if not _is_raw_net_call(dotted):
                continue
            if has_keyword(call, "timeout") or has_double_star(call):
                continue
            chain = project.sample_path(entrypoints, fid, skip_module=skip)
            via = " -> ".join(chain) if chain else fid
            sites.setdefault(fn.relpath, []).append((fn, call, dotted, via))
    return sites


@register
class DeadlinePropagation(Checker):
    name = "deadline-propagation"
    description = ("timeout-less network verb reachable from a reconcile "
                   "entrypoint outside the client stack")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        if _CACHE_KEY not in project.cache:
            project.cache[_CACHE_KEY] = _analyze(project, ctx.config)
        for fn, call, dotted, via in project.cache[_CACHE_KEY].get(
                ctx.relpath, []):
            yield ctx.finding(
                call, self,
                f"{dotted}(...) without timeout= is reachable from a "
                f"reconcile entrypoint ({via}): a hung socket stalls the "
                f"control loop — pass an explicit timeout or route "
                f"through the client stack")
