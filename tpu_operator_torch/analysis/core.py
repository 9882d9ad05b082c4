"""gpuop-lint framework core: findings, checker registry, per-file context,
and inline suppressions.

A checker is a class with a ``name``, a ``description``, and a
``check(ctx)`` generator yielding :class:`Finding`. Checkers operate on one
file at a time via :class:`FileContext` (parsed AST + source + path
classification helpers); cross-file state rides on :class:`LintConfig`
(doc/manifest texts, loaded once per run) and — since v2 — on
``ctx.project``, a :class:`tpu_operator_torch.analysis.graph.ProjectContext`
holding the whole-program symbol table, import/call graph, and lock graph
built once from the full tree. ``ctx.project`` is ``None`` when a file is
linted in isolation (unit-test helpers); graph-backed rules must then
yield nothing, so file-local rules stay usable without a project build.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple, Type

#: ``# opalint: disable=rule-a,rule-b`` — trailing prose after the rule
#: list is encouraged (say WHY the finding is wrong here)
_SUPPRESS_RE = re.compile(r"#\s*opalint:\s*disable=([A-Za-z0-9_,\- ]+)")


@dataclasses.dataclass
class Finding:
    rule: str
    path: str  # posix-style path relative to the lint root
    line: int
    col: int
    message: str
    #: stripped source text of the flagged line — the stable part of the
    #: baseline fingerprint (line NUMBERS drift on every edit above)
    line_text: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }


@dataclasses.dataclass
class LintConfig:
    """Per-run configuration shared by every file's context."""

    root: str = "."
    #: docs/gpu/operations.md content; None (file absent) disables only the
    #: documented-metric check — registration/cardinality still apply
    docs_text: Optional[str] = None
    #: manifest template texts keyed by posix relpath (e.g.
    #: ``tpu_operator_torch/manifests/state-telemetry/0500_daemonset.yaml``);
    #: None/{} disables the ``operand-dag`` cross-file check
    manifest_texts: Optional[Dict[str, str]] = None
    #: directory names that mark a file as part of a reconcile path
    reconcile_dirs: Tuple[str, ...] = ("controllers", "state", "upgrade",
                                       "autoscale", "migrate", "simulator",
                                       "capacity")
    #: directory names allowed to touch raw HTTP / RestClient
    client_dirs: Tuple[str, ...] = ("client",)
    #: composition roots additionally allowed to construct RestClient
    entrypoint_dirs: Tuple[str, ...] = ("cmd", "simulator")
    #: dotted module holding the annotation/label-key registry; the
    #: annotation-registry rule resolves raw ``tpu.ai/*`` literals to it
    consts_module: str = "tpu_operator_torch.consts"


class FileContext:
    def __init__(self, relpath: str, src: str, tree: ast.Module,
                 config: LintConfig, project=None):
        self.relpath = relpath.replace("\\", "/")
        self.src = src
        self.lines = src.splitlines()
        self.tree = tree
        self.config = config
        #: graph.ProjectContext for the full tree, or None when linting a
        #: lone string — interprocedural rules yield nothing without it
        self.project = project
        self._dir_parts = tuple(self.relpath.split("/")[:-1])

    def in_dirs(self, dirnames: Iterable[str]) -> bool:
        """True when any *directory* component of the path matches —
        ``controllers/runtime.py`` is a reconcile path, a file merely named
        ``controllers.py`` is not."""
        wanted = set(dirnames)
        return any(part in wanted for part in self._dir_parts)

    @property
    def is_reconcile_path(self) -> bool:
        return self.in_dirs(self.config.reconcile_dirs)

    @property
    def is_client_code(self) -> bool:
        return self.in_dirs(self.config.client_dirs)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, node: ast.AST, checker: "Checker", message: str) -> Finding:
        lineno = getattr(node, "lineno", 1)
        return Finding(
            rule=checker.name,
            path=self.relpath,
            line=lineno,
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
            line_text=self.line_text(lineno),
        )


class Checker:
    """Base class; subclasses set ``name``/``description`` and implement
    :meth:`check`. Register with the :func:`register` decorator."""

    name = "checker"
    description = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, Type[Checker]] = {}


def register(cls: Type[Checker]) -> Type[Checker]:
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate checker name {cls.name!r}")
    _REGISTRY[cls.name] = cls
    return cls


def all_checkers() -> Dict[str, Type[Checker]]:
    # importing the package populates the registry lazily so `import
    # tpu_operator_torch.analysis.core` alone (e.g. from a checker module) can't
    # recurse
    from . import checkers as _checkers  # noqa: F401

    return dict(_REGISTRY)


def suppressions(src: str) -> Dict[int, Set[str]]:
    """line number -> set of suppressed rule names (or ``{"all"}``).

    A suppression comment applies to findings reported on its own line;
    when the line holds nothing but the comment, it applies to the next
    line instead (for statements too long to carry a trailing comment).
    """
    out: Dict[int, Set[str]] = {}
    for lineno, line in enumerate(src.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for chunk in m.group(1).split(",")
                 for r in [chunk.split()[0] if chunk.split() else ""] if r}
        target = lineno + 1 if line.lstrip().startswith("#") else lineno
        out.setdefault(target, set()).update(rules)
    return out


def apply_suppressions(findings: Iterable[Finding],
                       suppressed: Dict[int, Set[str]]
                       ) -> Tuple[List[Finding], int]:
    """Drop findings whose line carries a matching suppression; returns
    (kept, dropped_count)."""
    kept: List[Finding] = []
    dropped = 0
    for f in findings:
        rules = suppressed.get(f.line, ())
        if f.rule in rules or "all" in rules:
            dropped += 1
        else:
            kept.append(f)
    return kept, dropped


# -- shared AST helpers used by several checkers ------------------------------

def self_attr(node: ast.AST) -> Optional[ast.Attribute]:
    """The ``self.<attr>`` Attribute node, if that's what this is."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node
    return None


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains; "" for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def has_keyword(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


def has_double_star(call: ast.Call) -> bool:
    return any(kw.arg is None for kw in call.keywords)
