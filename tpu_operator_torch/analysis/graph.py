"""gpuop-lint whole-program layer: symbol table, import graph, call graph,
and per-class lock graph built once per run from cached ASTs of the full
tree.

The graph is deliberately *mechanism only* — it resolves names and edges
but encodes no protocol policy; the interprocedural rules layer their
semantics on top via :class:`ProjectContext`. Resolution is best-effort
and fail-open: a name that cannot be resolved (dynamic dispatch, external
library, syntax error in the defining module) simply produces no edge, so
every rule built on the graph under-approximates rather than crashes.

Scope of resolution (enough for this codebase's idioms, documented in
the reference's docs/static-analysis.md):

* ``import a.b`` / ``from x import y as z`` / relative imports at any
  level; re-export chains (``from .core import Finding`` then
  ``from .analysis import Finding``) and top-level alias assignments
  (``NAME = other_mod.NAME``) are followed, with cycle tolerance.
* Calls to module-level functions, ``Class(...)`` constructors,
  ``mod.func(...)`` through import aliases, ``self.method(...)`` within a
  class, and ``self.attr.method(...)`` where ``attr``'s class is inferred
  from a ``self.attr = SomeClass(...)`` constructor assignment.
* ``with self.<lock>:`` acquisitions, where lock attributes are detected
  the same way the file-local lock-discipline rule does (threading
  factory assignment or a lock-ish name).

Everything is ordered deterministically: modules by relpath, functions by
(relpath, lineno), edges by source position — two builds over the same
sources produce identical graphs (asserted by the fuzz tests).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .core import LintConfig, dotted_name

#: threading factory callables whose result is a lock-ish object
LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore",
                  # the opsan-instrumentable factory seam
                  # (tpu_operator_torch.utils.locks)
                  "make_lock", "make_rlock"}
#: attribute-name fragments treated as locks even without a visible factory
LOCKISH_NAMES = ("lock", "cond", "mutex")


def module_name(relpath: str) -> str:
    """``tpu_operator_torch/a/b.py`` -> ``tpu_operator_torch.a.b``;
    ``tpu_operator_torch/a/__init__.py`` -> ``tpu_operator_torch.a``."""
    parts = relpath.replace("\\", "/").rsplit(".py", 1)[0].split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


@dataclasses.dataclass
class FunctionInfo:
    """One module-level function or class method (nested defs and lambdas
    are folded into their enclosing function for analysis purposes)."""

    fid: str                      # "pkg.mod:Class.meth" or "pkg.mod:func"
    modname: str
    relpath: str
    qualname: str                 # "Class.meth" or "func"
    node: ast.AST                 # FunctionDef / AsyncFunctionDef
    class_name: Optional[str] = None
    #: resolved call edges, ordered by call-site position
    calls: List[Tuple[str, ast.Call]] = dataclasses.field(default_factory=list)
    #: every call site as (dotted-name, node) — including unresolved ones,
    #: for textual-pattern rules (net verbs, actuation primitives)
    raw_calls: List[Tuple[str, ast.Call]] = dataclasses.field(
        default_factory=list)
    #: names from the registry module referenced by this function
    consts_used: Set[str] = dataclasses.field(default_factory=set)

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]


@dataclasses.dataclass
class ClassInfo:
    modname: str
    name: str
    node: ast.ClassDef
    methods: Dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    #: self.<attr> -> class id ("pkg.mod:Class") inferred from constructor
    #: assignments ``self.attr = SomeClass(...)``
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def cid(self) -> str:
        return f"{self.modname}:{self.name}"


@dataclasses.dataclass
class ModuleInfo:
    modname: str
    relpath: str
    tree: ast.Module
    #: local name -> absolute dotted target ("pkg.mod" or "pkg.mod.symbol")
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = dataclasses.field(
        default_factory=dict)
    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    #: top-level ``NAME = <dotted>`` aliases (re-export via assignment)
    assign_aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: top-level ``NAME = "literal"`` string constants
    str_consts: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class LockNode:
    cid: str                      # owning class id "pkg.mod:Class"
    attr: str                     # lock attribute name

    def label(self) -> str:
        return f"{self.cid.rsplit(':', 1)[1]}.{self.attr}"


@dataclasses.dataclass
class LockEdge:
    """``dst`` acquired while ``src`` is held, at ``node`` in ``relpath``;
    ``via`` names the function chain that creates the edge."""

    src: LockNode
    dst: LockNode
    relpath: str
    node: ast.AST
    via: str


class ProjectContext:
    """Whole-program view handed to every checker via ``ctx.project``.

    ``None`` when linting a bare string (unit-test ``lint()`` helper) —
    graph-backed rules must yield nothing in that case.
    """

    def __init__(self, config: LintConfig):
        self.config = config
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_relpath: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        #: registry-module string constants: NAME -> value and value -> NAMEs
        self.const_values: Dict[str, str] = {}
        self.const_names_by_value: Dict[str, List[str]] = {}
        self.lock_edges: List[LockEdge] = []
        #: scratch space for rules to memoize whole-program passes so the
        #: per-file check() calls only filter, never recompute
        self.cache: Dict[str, object] = {}

    # -- symbol resolution ----------------------------------------------------

    def _longest_module_prefix(self, dotted: str) -> Tuple[Optional[str], List[str]]:
        parts = dotted.split(".")
        for i in range(len(parts), 0, -1):
            cand = ".".join(parts[:i])
            if cand in self.modules:
                return cand, parts[i:]
        return None, parts

    def resolve_symbol(self, modname: str, name: str,
                       _seen: Optional[Set[Tuple[str, str]]] = None
                       ) -> Optional[Tuple[str, str]]:
        """Resolve ``name`` inside module ``modname`` through re-export
        chains. Returns ("func", fid) | ("class", cid) | ("module", modname)
        | None; cycles terminate via the ``_seen`` set."""
        seen = _seen if _seen is not None else set()
        if (modname, name) in seen:
            return None
        seen.add((modname, name))
        mod = self.modules.get(modname)
        if mod is None:
            return None
        if name in mod.functions:
            return ("func", mod.functions[name].fid)
        if name in mod.classes:
            return ("class", mod.classes[name].cid)
        target = mod.imports.get(name) or mod.assign_aliases.get(name)
        if target is None:
            # ``from . import x`` on a package: x may be a submodule
            sub = f"{modname}.{name}"
            if sub in self.modules:
                return ("module", sub)
            return None
        return self._resolve_absolute(target, seen)

    def _resolve_absolute(self, dotted: str,
                          seen: Optional[Set[Tuple[str, str]]] = None
                          ) -> Optional[Tuple[str, str]]:
        if dotted in self.modules:
            return ("module", dotted)
        prefix, rest = self._longest_module_prefix(dotted)
        if prefix is None:
            return None
        if len(rest) == 1:
            return self.resolve_symbol(prefix, rest[0],
                                       seen if seen is not None else set())
        if len(rest) == 2:
            got = self.resolve_symbol(prefix, rest[0],
                                      seen if seen is not None else set())
            if got and got[0] == "class":
                cls = self.classes.get(got[1])
                if cls and rest[1] in cls.methods:
                    return ("func", cls.methods[rest[1]].fid)
        return None

    def resolve_call(self, fn: FunctionInfo,
                     call: ast.Call) -> Optional[str]:
        """Best-effort callee fid for a call site inside ``fn``."""
        dotted = dotted_name(call.func)
        if not dotted:
            return None
        mod = self.modules[fn.modname]
        parts = dotted.split(".")
        if parts[0] == "self" and fn.class_name:
            cls = mod.classes.get(fn.class_name)
            if cls is None:
                return None
            if len(parts) == 2:                     # self.meth()
                m = cls.methods.get(parts[1])
                return m.fid if m else None
            if len(parts) == 3:                     # self.attr.meth()
                peer_cid = cls.attr_types.get(parts[1])
                peer = self.classes.get(peer_cid) if peer_cid else None
                if peer:
                    m = peer.methods.get(parts[2])
                    return m.fid if m else None
            return None
        got = self.resolve_symbol(fn.modname, parts[0])
        for part in parts[1:]:
            if got is None:
                return None
            kind, ident = got
            if kind == "module":
                got = self.resolve_symbol(ident, part)
            elif kind == "class":
                cls = self.classes.get(ident)
                m = cls.methods.get(part) if cls else None
                got = ("func", m.fid) if m else None
            else:
                return None                         # func has no attrs
        if got is None:
            return None
        kind, ident = got
        if kind == "func":
            return ident
        if kind == "class":                         # ClassName(...) -> __init__
            cls = self.classes.get(ident)
            if cls and "__init__" in cls.methods:
                return cls.methods["__init__"].fid
        return None

    # -- graph queries --------------------------------------------------------

    def reachable_from(self, roots: Iterable[str],
                       skip_module=None) -> Set[str]:
        """fids reachable over call edges, optionally pruning traversal at
        modules where ``skip_module(modname)`` is true (the roots
        themselves are always included)."""
        seen: Set[str] = set()
        stack = sorted(set(roots))
        while stack:
            fid = stack.pop()
            if fid in seen:
                continue
            seen.add(fid)
            fn = self.functions.get(fid)
            if fn is None:
                continue
            for callee, _site in fn.calls:
                if callee in seen:
                    continue
                target = self.functions.get(callee)
                if (target is not None and skip_module is not None
                        and skip_module(target.modname)):
                    continue
                stack.append(callee)
        return seen

    def sample_path(self, roots: Iterable[str], target: str,
                    skip_module=None) -> List[str]:
        """One shortest root->target chain of fids (BFS over sorted
        neighbours, so the sample is deterministic); [] if unreachable."""
        root_list = sorted(set(roots))
        if target in root_list:
            return [target]
        parent: Dict[str, Optional[str]] = {r: None for r in root_list}
        queue = list(root_list)
        while queue:
            fid = queue.pop(0)
            fn = self.functions.get(fid)
            if fn is None:
                continue
            for callee, _site in sorted(
                    fn.calls, key=lambda c: (c[0], c[1].lineno)):
                if callee in parent:
                    continue
                tfn = self.functions.get(callee)
                if (tfn is not None and skip_module is not None
                        and skip_module(tfn.modname)):
                    continue
                parent[callee] = fid
                if callee == target:
                    chain = [callee]
                    while parent[chain[-1]] is not None:
                        chain.append(parent[chain[-1]])
                    return list(reversed(chain))
                queue.append(callee)
        return []

    def lock_cycle_edges(self) -> List[Tuple[LockEdge, List[LockNode]]]:
        """Edges participating in a lock-order cycle, each with one sample
        cycle path (dst ... -> src) for the message."""
        adj: Dict[LockNode, Set[LockNode]] = {}
        for e in self.lock_edges:
            adj.setdefault(e.src, set()).add(e.dst)
        sccs = _tarjan_sccs(adj)
        in_cycle = [s for s in sccs if len(s) > 1]
        out: List[Tuple[LockEdge, List[LockNode]]] = []
        for scc in in_cycle:
            members = set(scc)
            for e in self.lock_edges:
                if e.src in members and e.dst in members and e.src != e.dst:
                    back = _bfs_lock_path(adj, e.dst, e.src, members)
                    out.append((e, back))
        return out


def _tarjan_sccs(adj: Dict[LockNode, Set[LockNode]]) -> List[List[LockNode]]:
    """Iterative Tarjan (no recursion limit risk on fuzzed inputs)."""
    nodes = sorted(set(adj) | {d for ds in adj.values() for d in ds},
                   key=lambda n: (n.cid, n.attr))
    index: Dict[LockNode, int] = {}
    low: Dict[LockNode, int] = {}
    on_stack: Set[LockNode] = set()
    stack: List[LockNode] = []
    sccs: List[List[LockNode]] = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work: List[Tuple[LockNode, List[LockNode], int]] = [
            (root, sorted(adj.get(root, ()), key=lambda n: (n.cid, n.attr)), 0)]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, kids, i = work.pop()
            advanced = False
            while i < len(kids):
                kid = kids[i]
                i += 1
                if kid not in index:
                    work.append((node, kids, i))
                    index[kid] = low[kid] = counter[0]
                    counter[0] += 1
                    stack.append(kid)
                    on_stack.add(kid)
                    work.append((kid, sorted(adj.get(kid, ()),
                                             key=lambda n: (n.cid, n.attr)), 0))
                    advanced = True
                    break
                if kid in on_stack:
                    low[node] = min(low[node], index[kid])
            if advanced:
                continue
            if low[node] == index[node]:
                comp: List[LockNode] = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(sorted(comp, key=lambda n: (n.cid, n.attr)))
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return sccs


def _bfs_lock_path(adj: Dict[LockNode, Set[LockNode]], start: LockNode,
                   goal: LockNode, members: Set[LockNode]) -> List[LockNode]:
    if start == goal:
        return [start]
    parent: Dict[LockNode, Optional[LockNode]] = {start: None}
    queue = [start]
    while queue:
        node = queue.pop(0)
        for kid in sorted(adj.get(node, ()), key=lambda n: (n.cid, n.attr)):
            if kid not in members or kid in parent:
                continue
            parent[kid] = node
            if kid == goal:
                chain = [kid]
                while parent[chain[-1]] is not None:
                    chain.append(parent[chain[-1]])
                return list(reversed(chain))
            queue.append(kid)
    return [start, goal]


# -- the build ----------------------------------------------------------------

def _is_lock_factory(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    name = dotted_name(value.func)
    return name.rsplit(".", 1)[-1] in LOCK_FACTORIES


def _lockish(attr: str) -> bool:
    low = attr.lower()
    return any(frag in low for frag in LOCKISH_NAMES)


def _collect_class(mod: ModuleInfo, node: ast.ClassDef) -> ClassInfo:
    cls = ClassInfo(modname=mod.modname, name=node.name, node=node)
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = f"{node.name}.{item.name}"
            cls.methods[item.name] = FunctionInfo(
                fid=f"{mod.modname}:{qual}", modname=mod.modname,
                relpath=mod.relpath, qualname=qual, node=item,
                class_name=node.name)
    # lock attrs + constructor-inferred attr types: scan every method for
    # ``self.x = ...``; lock attrs require a visible threading factory —
    # lock-ish *names* are additionally accepted at ``with self.x:`` sites
    # (see _lock_for), mirroring lock-discipline's two-way detection
    for meth in cls.methods.values():
        for sub in ast.walk(meth.node):
            if not isinstance(sub, ast.Assign):
                continue
            for tgt in sub.targets:
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                if _is_lock_factory(sub.value):
                    cls.lock_attrs.add(tgt.attr)
                if isinstance(sub.value, ast.Call):
                    cls.attr_types[tgt.attr] = dotted_name(sub.value.func)
    return cls


def _abs_import_base(modname: str, is_package: bool, level: int) -> str:
    """Base package for a relative import of the given level."""
    parts = modname.split(".")
    if not is_package:
        parts = parts[:-1]
    drop = level - 1
    if drop > 0:
        parts = parts[:-drop] if drop < len(parts) else []
    return ".".join(parts)


def _collect_module(relpath: str, tree: ast.Module) -> ModuleInfo:
    modname = module_name(relpath)
    is_package = relpath.replace("\\", "/").endswith("/__init__.py")
    mod = ModuleInfo(modname=modname, relpath=relpath.replace("\\", "/"),
                     tree=tree)
    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                target = alias.name if alias.asname else alias.name.split(".")[0]
                mod.imports[local] = target
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = _abs_import_base(modname, is_package, node.level)
                src = f"{base}.{node.module}" if node.module else base
            else:
                src = node.module or ""
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                mod.imports[local] = f"{src}.{alias.name}" if src else alias.name
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions[node.name] = FunctionInfo(
                fid=f"{modname}:{node.name}", modname=modname,
                relpath=mod.relpath, qualname=node.name, node=node)
        elif isinstance(node, ast.ClassDef):
            mod.classes[node.name] = _collect_class(mod, node)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                if (isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)):
                    mod.str_consts[tgt.id] = node.value.value
                else:
                    dotted = dotted_name(node.value)
                    if dotted and "." in dotted:
                        mod.assign_aliases[tgt.id] = dotted
    return mod


def _iter_fn_calls(fn_node: ast.AST):
    """Call nodes in a function, including nested defs/lambdas (folded into
    the enclosing function) but not nested ClassDef bodies."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, ast.ClassDef):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def _resolve_attr_types(project: ProjectContext) -> None:
    """Second pass: turn the textual constructor names recorded per class
    attribute into class ids, dropping everything unresolvable."""
    for cls in project.classes.values():
        resolved: Dict[str, str] = {}
        for attr, ctor in sorted(cls.attr_types.items()):
            got = None
            parts = ctor.split(".")
            got = project.resolve_symbol(cls.modname, parts[0])
            for part in parts[1:]:
                if got is None:
                    break
                kind, ident = got
                got = (project.resolve_symbol(ident, part)
                       if kind == "module" else None)
            if got and got[0] == "class":
                resolved[attr] = got[1]
        cls.attr_types = resolved


def _consts_module_alias(project: ProjectContext,
                         mod: ModuleInfo) -> Set[str]:
    """Local names in ``mod`` that refer to the registry module itself."""
    registry = project.config.consts_module
    out: Set[str] = set()
    for local, target in mod.imports.items():
        if target == registry:
            out.add(local)
            continue
        got = project._resolve_absolute(target)
        if got == ("module", registry):
            out.add(local)
    return out


def _collect_const_refs(project: ProjectContext, mod: ModuleInfo,
                        fn: FunctionInfo,
                        consts_aliases: Set[str],
                        direct_imports: Dict[str, str]) -> None:
    for sub in ast.walk(fn.node):
        if (isinstance(sub, ast.Attribute)
                and isinstance(sub.value, ast.Name)
                and sub.value.id in consts_aliases):
            fn.consts_used.add(sub.attr)
        elif isinstance(sub, ast.Name) and sub.id in direct_imports:
            fn.consts_used.add(direct_imports[sub.id])


def _collect_lock_graph(project: ProjectContext) -> None:
    """Build acquired-while-holding edges: direct ``with`` nesting plus
    interprocedural edges through resolved calls (a call made while
    holding L edges L to every lock the callee transitively acquires)."""
    # transitive acquires fixpoint over the call graph
    direct: Dict[str, Set[LockNode]] = {}
    for fid, fn in project.functions.items():
        acq: Set[LockNode] = set()
        if fn.class_name:
            cls = project.modules[fn.modname].classes.get(fn.class_name)
            if cls:
                for sub in _walk_no_nested_defs(fn.node):
                    if isinstance(sub, (ast.With, ast.AsyncWith)):
                        for item in sub.items:
                            lk = _lock_for(cls, item.context_expr)
                            if lk:
                                acq.add(lk)
        direct[fid] = acq
    trans: Dict[str, Set[LockNode]] = {f: set(s) for f, s in direct.items()}
    changed = True
    while changed:
        changed = False
        for fid, fn in project.functions.items():
            for callee, _site in fn.calls:
                extra = trans.get(callee)
                if extra and not extra <= trans[fid]:
                    trans[fid] |= extra
                    changed = True

    for fid in sorted(project.functions):
        fn = project.functions[fid]
        if not fn.class_name:
            continue
        cls = project.modules[fn.modname].classes.get(fn.class_name)
        if cls is None:
            continue
        _walk_held(project, fn, cls, trans)


def _walk_no_nested_defs(fn_node: ast.AST):
    """Walk a function body without descending into nested function or
    class definitions (their bodies don't run at the def site)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _lock_for(cls: ClassInfo, expr: ast.AST) -> Optional[LockNode]:
    """LockNode for a ``with self.<attr>:`` context expression — the attr
    is a known factory-assigned lock, or is lock-ish by name (a ``with``
    on a lock-named attribute is a lock even if we missed the factory)."""
    if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and (expr.attr in cls.lock_attrs or _lockish(expr.attr))):
        return LockNode(cid=cls.cid, attr=expr.attr)
    return None


def _walk_held(project: ProjectContext, fn: FunctionInfo, cls: ClassInfo,
               trans: Dict[str, Set[LockNode]]) -> None:
    resolved_at = {id(site): callee for callee, site in fn.calls}

    def visit(node: ast.AST, held: Tuple[LockNode, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: List[LockNode] = []
            for item in node.items:
                lk = _lock_for(cls, item.context_expr)
                if lk:
                    for h in held + tuple(acquired):
                        if h != lk:
                            project.lock_edges.append(LockEdge(
                                src=h, dst=lk, relpath=fn.relpath,
                                node=item.context_expr,
                                via=f"{module_name(fn.relpath)}:{fn.qualname}"))
                    acquired.append(lk)
            new_held = held + tuple(acquired)
            for child in node.body:
                visit(child, new_held)
            return
        if isinstance(node, ast.Call) and held:
            callee = resolved_at.get(id(node))
            if callee:
                for lk in sorted(trans.get(callee, ()),
                                 key=lambda n: (n.cid, n.attr)):
                    for h in held:
                        if h != lk:
                            project.lock_edges.append(LockEdge(
                                src=h, dst=lk, relpath=fn.relpath, node=node,
                                via=(f"{module_name(fn.relpath)}:"
                                     f"{fn.qualname} -> {callee}")))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in ast.iter_child_nodes(fn.node):
        visit(stmt, ())


def build_project(files: Dict[str, Tuple[str, ast.Module]],
                  config: LintConfig) -> ProjectContext:
    """Build the whole-program graph from already-parsed sources.

    ``files`` maps posix relpath -> (source, parsed tree); files that
    failed to parse are simply absent (syntax-error tolerance lives in the
    runner, which reports them as parse-error findings).
    """
    project = ProjectContext(config)
    for relpath in sorted(files):
        _src, tree = files[relpath]
        mod = _collect_module(relpath, tree)
        project.modules[mod.modname] = mod
        project.by_relpath[mod.relpath] = mod
    for mod in project.modules.values():
        for fn in mod.functions.values():
            project.functions[fn.fid] = fn
        for cls in mod.classes.values():
            project.classes[cls.cid] = cls
            for meth in cls.methods.values():
                project.functions[meth.fid] = meth

    _resolve_attr_types(project)

    registry = project.modules.get(config.consts_module)
    if registry is not None:
        project.const_values = dict(registry.str_consts)
        for name, value in sorted(project.const_values.items()):
            project.const_names_by_value.setdefault(value, []).append(name)

    for mod in project.modules.values():
        consts_aliases = _consts_module_alias(project, mod)
        direct_imports = {
            local: target.rsplit(".", 1)[1]
            for local, target in mod.imports.items()
            if target.startswith(config.consts_module + ".")
            and "." not in target[len(config.consts_module) + 1:]}
        all_fns = list(mod.functions.values())
        for cls in mod.classes.values():
            all_fns.extend(cls.methods.values())
        for fn in all_fns:
            calls = [c for c in _iter_fn_calls(fn.node)]
            calls.sort(key=lambda c: (c.lineno, c.col_offset))
            for call in calls:
                dotted = dotted_name(call.func)
                fn.raw_calls.append((dotted, call))
                callee = project.resolve_call(fn, call)
                if callee is not None:
                    fn.calls.append((callee, call))
            _collect_const_refs(project, mod, fn, consts_aliases,
                                direct_imports)

    _collect_lock_graph(project)
    return project


def build_from_sources(sources: Dict[str, str],
                       config: Optional[LintConfig] = None
                       ) -> ProjectContext:
    """Test helper: parse ``relpath -> source`` and build; sources with
    syntax errors are skipped (tolerated), like the runner does."""
    cfg = config or LintConfig()
    files: Dict[str, Tuple[str, ast.Module]] = {}
    for relpath, src in sources.items():
        try:
            files[relpath] = (src, ast.parse(src))
        except SyntaxError:
            continue
    return build_project(files, cfg)
