"""lock-discipline: infer a field→lock map per class, flag unguarded writes.

Go's race detector finds these at runtime; nothing in the Python toolchain
does. The inference is the convention this codebase already follows:

* a lock attribute is anything assigned from ``threading.Lock/RLock/
  Condition/Semaphore`` in ``__init__``, or used as ``with self.<attr>:``
  where the name contains "lock" or "cond";
* a field belongs to a lock when some non-``__init__`` method mutates it
  inside that lock's ``with`` block;
* methods named ``*_locked`` are callee-side lock-held by convention
  (``_refill_locked``, ``_transition_locked``) and are exempt;
* ``__init__`` is exempt — construction happens-before publication.

Mutations counted: ``self.f = …``, ``self.f += …``, ``self.f[k] = …``,
``del self.f[k]``, and mutator method calls (``self.f.append(…)`` etc.).
Reads are deliberately out of scope: this codebase tolerates racy reads of
monotonic scalars (e.g. queue latency readbacks) but never racy writes.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set

from ..core import Checker, FileContext, Finding, register, self_attr

LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore",
                  # the opsan-instrumentable factory seam
                  # (tpu_operator_torch.utils.locks, once it exists)
                  "make_lock", "make_rlock"}
LOCKISH_NAMES = ("lock", "cond", "mutex")
MUTATORS = {"append", "appendleft", "add", "extend", "insert", "remove",
            "discard", "pop", "popleft", "popitem", "clear", "update",
            "setdefault", "sort", "reverse"}


@dataclasses.dataclass
class _Mutation:
    field: str
    node: ast.AST
    lock: Optional[str]  # innermost held lock attr, None when unguarded
    method: str


def _lock_factory(func: ast.AST) -> bool:
    """threading.Lock / Lock / threading.RLock …"""
    if isinstance(func, ast.Attribute):
        return func.attr in LOCK_FACTORIES
    if isinstance(func, ast.Name):
        return func.id in LOCK_FACTORIES
    return False


def _mutated_field(node: ast.AST) -> Optional[str]:
    """The ``self.<field>`` a statement-level node mutates, if any."""
    if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            a = self_attr(t)
            if a is not None:
                return a.attr
            if isinstance(t, ast.Subscript):
                a = self_attr(t.value)
                if a is not None:
                    return a.attr
    if isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                a = self_attr(t.value)
                if a is not None:
                    return a.attr
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in MUTATORS:
            a = self_attr(node.func.value)
            if a is not None:
                return a.attr
    return None


@register
class LockDiscipline(Checker):
    name = "lock-discipline"
    description = ("fields mutated under `with self._lock:` somewhere must "
                   "be mutated under it everywhere (outside __init__)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(ctx, node)

    # -- per-class ------------------------------------------------------------
    def _check_class(self, ctx: FileContext,
                     cls: ast.ClassDef) -> Iterator[Finding]:
        lock_attrs = self._lock_attrs(cls)
        if not lock_attrs:
            return
        mutations: List[_Mutation] = []
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in ("__init__", "__new__", "__post_init__"):
                continue  # construction happens-before publication
            # *_locked methods: caller holds the lock; attribute the
            # mutations to an implied lock so they BUILD the map without
            # ever being flagged
            implied = "<caller>" if fn.name.endswith("_locked") else None
            self._collect(fn, fn.name, lock_attrs, implied, mutations)

        guard: Dict[str, Set[str]] = {}
        example: Dict[str, str] = {}
        for m in mutations:
            if m.lock is not None and m.field not in lock_attrs:
                guard.setdefault(m.field, set()).add(m.lock)
                example.setdefault(m.field, m.method)
        for m in mutations:
            if m.lock is None and m.field in guard:
                locks = ", ".join(f"self.{lk}" for lk in sorted(
                    lk for lk in guard[m.field] if lk != "<caller>"))
                locks = locks or "a caller-held lock"
                yield ctx.finding(
                    m.node, self,
                    f"{cls.name}.{m.field} is mutated under {locks} "
                    f"(e.g. in {example[m.field]}()) but written here in "
                    f"{m.method}() without holding it; guard the write or "
                    f"rename the method *_locked if the caller holds it")

    @staticmethod
    def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                    and _lock_factory(node.value.func):
                for t in node.targets:
                    a = self_attr(t)
                    if a is not None:
                        out.add(a.attr)
            if isinstance(node, ast.With):
                for item in node.items:
                    a = self_attr(item.context_expr)
                    if a is not None and any(
                            k in a.attr.lower() for k in LOCKISH_NAMES):
                        out.add(a.attr)
        return out

    def _collect(self, node: ast.AST, method: str, lock_attrs: Set[str],
                 held: Optional[str], out: List[_Mutation]) -> None:
        """Recursive walk tracking the innermost held lock attribute."""
        field = _mutated_field(node)
        if field is not None and field not in lock_attrs:
            out.append(_Mutation(field, node, held, method))
        if isinstance(node, ast.With):
            entered = held
            for item in node.items:
                a = self_attr(item.context_expr)
                if a is not None and a.attr in lock_attrs:
                    entered = a.attr
            for child in node.body:
                self._collect(child, method, lock_attrs, entered, out)
            return
        if isinstance(node, ast.ClassDef):
            return  # nested class: its own scope, checked separately
        for child in ast.iter_child_nodes(node):
            self._collect(child, method, lock_attrs, held, out)
