"""untracked-shared-state: shared mutable containers invisible to opsan.

The opsan dynamic race sanitizer (the reference's ``sanitizer/``) can
only prove the locking discipline on structures it *sees*: locks
constructed through the ``utils.locks`` factory and containers
registered with ``register_shared``. A mutable container that two
threads reach but that is neither lock-guarded nor registered is a hole
in the evidence — the lockset algorithm never hears about it, and the
static lock-discipline rule only fires once SOME access is guarded (it infers
the field→lock map from observed guards, so a container that is *never*
guarded slips through).

This rule closes the gap with the whole-program call graph: a module-level or
``self.``-assigned mutable container (dict/list/set/deque literal or
constructor) in a reconcile dir whose accessing functions are reachable
from **two or more thread entrypoints** — functions passed as
``target=`` to ``threading.Thread`` anywhere in the program, plus
``reconcile`` methods in reconcile dirs (dispatched onto worker threads
by ``controllers/runtime.py``, a hop the call graph cannot resolve) —
must either be accessed only under a lock-ish ``with`` guard, or be
passed through ``register_shared`` so opsan tracks it. Everything else
is a finding at the assignment site.

Single-entrypoint containers are deliberately silent: per-thread state
needs no guard, and flagging it would teach people to suppress the rule
rather than read it. Inline-suppressible like every rule
(``# opalint: disable=untracked-shared-state — <why this is safe>``).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..core import Checker, FileContext, Finding, register, self_attr

_CACHE_KEY = "untracked-shared-state"

#: container constructors whose result is shared-mutable
_CONTAINER_CTORS = {"dict", "list", "set", "deque", "defaultdict",
                    "OrderedDict", "Counter"}
_LOCKISH_NAMES = ("lock", "cond", "mutex", "sem")
_REGISTER_FN = "register_shared"


def _is_container_value(value: ast.AST) -> bool:
    """A literal or constructor producing a mutable container."""
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call):
        fn = value.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")
        return name in _CONTAINER_CTORS
    return False


def _is_registered_value(value: ast.AST) -> bool:
    """``register_shared(...)`` (possibly dotted) wrapping the value."""
    if not isinstance(value, ast.Call):
        return False
    fn = value.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else "")
    return name == _REGISTER_FN


def _lockish(attr: str) -> bool:
    low = attr.lower()
    return any(frag in low for frag in _LOCKISH_NAMES)


class _Candidate:
    __slots__ = ("relpath", "label", "node", "attr", "class_name",
                 "accessors", "unguarded")

    def __init__(self, relpath: str, label: str, node: ast.AST,
                 attr: str, class_name: Optional[str]):
        self.relpath = relpath
        self.label = label            # "Class.attr" or "module:NAME"
        self.node = node              # the assignment (finding anchor)
        self.attr = attr
        self.class_name = class_name  # None for module-level
        self.accessors: Set[str] = set()   # fids touching the container
        self.unguarded = False             # some access outside any guard


def _thread_entrypoints(project) -> Set[str]:
    """fids that run on their own thread: ``Thread(target=...)`` targets
    program-wide, plus reconcile-dir ``reconcile`` methods (dispatched by
    the controller runtime's worker threads — dynamic, so the call graph
    cannot connect them)."""
    roots: Set[str] = set()
    recon_dirs = set(project.config.reconcile_dirs)
    for fid, fn in project.functions.items():
        parts = fn.relpath.split("/")[:-1]
        if fn.name == "reconcile" and any(p in recon_dirs for p in parts):
            roots.add(fid)
        for dotted, call in fn.raw_calls:
            if dotted.rsplit(".", 1)[-1] != "Thread":
                continue
            for kw in call.keywords:
                if kw.arg != "target":
                    continue
                roots.update(_resolve_target(project, fn, kw.value))
    return roots


def _resolve_target(project, fn, value: ast.AST) -> List[str]:
    """Resolve a ``target=`` expression to candidate fids."""
    if isinstance(value, ast.Attribute):
        base = value.value
        if isinstance(base, ast.Name) and base.id == "self" and fn.class_name:
            cls = project.classes.get(f"{fn.modname}:{fn.class_name}")
            if cls and value.attr in cls.methods:
                return [cls.methods[value.attr].fid]
            return []
    parts: List[str] = []
    node = value
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        dotted = ".".join(reversed(parts))
        got = project.resolve_symbol(fn.modname, dotted.split(".")[0])
        for part in dotted.split(".")[1:]:
            if got is None:
                return []
            kind, ident = got
            if kind == "module":
                got = project.resolve_symbol(ident, part)
            elif kind == "class":
                cls = project.classes.get(ident)
                m = cls.methods.get(part) if cls else None
                got = ("func", m.fid) if m else None
            else:
                return []
        if got and got[0] == "func":
            return [got[1]]
    return []


def _collect_class_candidates(project, relpath: str, modname: str,
                              tree: ast.Module,
                              out: List[_Candidate]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        init = next((f for f in node.body
                     if isinstance(f, ast.FunctionDef)
                     and f.name == "__init__"), None)
        if init is None:
            continue
        for stmt in ast.walk(init):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            value = stmt.value
            if value is None:
                continue
            for t in targets:
                a = self_attr(t)
                if a is None or _lockish(a.attr):
                    continue
                if _is_registered_value(value):
                    continue
                if _is_container_value(value):
                    out.append(_Candidate(
                        relpath, f"{node.name}.{a.attr}", stmt,
                        a.attr, node.name))


def _collect_module_candidates(project, relpath: str, modname: str,
                               tree: ast.Module,
                               out: List[_Candidate]) -> None:
    for stmt in tree.body:
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            continue
        value = stmt.value
        if value is None or _is_registered_value(value):
            continue
        if not _is_container_value(value):
            continue
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for t in targets:
            if isinstance(t, ast.Name) and not _lockish(t.id):
                out.append(_Candidate(
                    relpath, f"{modname}:{t.id}", stmt, t.id, None))


def _scan_accesses(project, cand: _Candidate, modinfo) -> None:
    """Fill ``cand.accessors``/``cand.unguarded`` from every function in
    the owning module (class candidates: same-class methods only)."""
    for fid, fn in project.functions.items():
        if fn.modname != modinfo.modname:
            continue
        if cand.class_name is not None:
            if fn.class_name != cand.class_name:
                continue
            if fn.name in ("__init__", "__new__", "__post_init__"):
                continue  # construction happens-before publication
        caller_holds = fn.name.endswith("_locked")
        hits = _accesses_in(fn.node, cand, caller_holds)
        if hits is None:
            continue
        cand.accessors.add(fid)
        if hits:
            cand.unguarded = True


def _accesses_in(root: ast.AST, cand: _Candidate,
                 caller_holds: bool) -> Optional[bool]:
    """None = no access; False = all guarded; True = unguarded access."""
    found = [False, False]  # any access, any unguarded

    def matches(node: ast.AST) -> bool:
        if cand.class_name is not None:
            a = self_attr(node)
            return a is not None and a.attr == cand.attr
        return isinstance(node, ast.Name) and node.id == cand.attr

    def visit(node: ast.AST, guarded: bool) -> None:
        if isinstance(node, ast.With):
            entered = guarded
            for item in node.items:
                a = self_attr(item.context_expr)
                if a is not None and _lockish(a.attr):
                    entered = True
                elif (isinstance(item.context_expr, ast.Name)
                      and _lockish(item.context_expr.id)):
                    entered = True
            for child in node.body:
                visit(child, entered)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node is not root:
            return  # nested scope: analyzed via its own FunctionInfo
        if matches(node):
            found[0] = True
            if not guarded:
                found[1] = True
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    visit(root, caller_holds)
    if not found[0]:
        return None
    return found[1]


def _build(project) -> Dict[str, List[Tuple[_Candidate, List[str]]]]:
    """relpath -> [(candidate, sample entrypoint labels)] for every
    confirmed finding."""
    roots = _thread_entrypoints(project)
    reach: Dict[str, Set[str]] = {
        r: project.reachable_from([r]) for r in sorted(roots)}
    recon_dirs = set(project.config.reconcile_dirs)
    candidates: List[_Candidate] = []
    for relpath, modinfo in sorted(project.by_relpath.items()):
        parts = relpath.split("/")[:-1]
        if not any(p in recon_dirs for p in parts):
            continue
        _collect_class_candidates(project, relpath, modinfo.modname,
                                  modinfo.tree, candidates)
        _collect_module_candidates(project, relpath, modinfo.modname,
                                   modinfo.tree, candidates)
    out: Dict[str, List[Tuple[_Candidate, List[str]]]] = {}
    for cand in candidates:
        modinfo = project.by_relpath[cand.relpath]
        _scan_accesses(project, cand, modinfo)
        if not cand.unguarded or not cand.accessors:
            continue
        reaching = sorted(
            r for r, seen in reach.items() if seen & cand.accessors)
        if len(reaching) < 2:
            continue
        sample = [project.functions[r].qualname for r in reaching[:3]]
        out.setdefault(cand.relpath, []).append((cand, sample))
    return out


@register
class UntrackedSharedState(Checker):
    name = "untracked-shared-state"
    description = ("mutable container reachable from >=2 thread "
                   "entrypoints, neither lock-guarded nor "
                   "register_shared()-tracked (opsan blind spot)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        if _CACHE_KEY not in project.cache:
            project.cache[_CACHE_KEY] = _build(project)
        by_file = project.cache[_CACHE_KEY]
        for cand, entrypoints in by_file.get(ctx.relpath, []):
            yield ctx.finding(
                cand.node, self,
                f"{cand.label} is a mutable container reachable from "
                f"{len(entrypoints)}+ thread entrypoints (e.g. "
                f"{', '.join(entrypoints)}) with at least one access "
                f"outside any lock guard and no register_shared() "
                f"registration — guard every access, or register it so "
                f"opsan tracks it")
