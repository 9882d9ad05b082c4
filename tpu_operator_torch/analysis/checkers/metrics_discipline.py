"""metrics-discipline: registered, documented, bounded-cardinality metrics.

Subsumes (and extends to the AST level) the invariant behind the
reference's ``tests/test_metrics_docs.py``: a metric an operator cannot
look up in ``docs/gpu/operations.md`` is a metric they cannot act on. Three
checks per metric instantiation:

* **registered** — for a ``prometheus_client`` class, ``registry=`` must
  be explicit: a metric on the process-global ``REGISTRY`` collides across
  tests and double-exports when two components run in one process. The
  port has no ``prometheus_client``: its families are its own classes
  (``controllers/metrics.py``, ``validator/metrics.py``), kept and
  exposed by an owner object whose ``scrape()`` writes them (the
  operator's ``OperatorMetrics``, a node's ``NodeMetrics`` and
  ``TelemetryMetrics``). There the same failure mode is a family built
  outside any owner — at module level or in a free function, one object
  shared by every component and test of the process — so such a family
  must be constructed inside a class that defines ``scrape``.
* **documented** — the exposition name (counters get ``_total``) must
  appear in the operations doc. Only literal names are checkable;
  dynamically-named metrics (the telemetry exporter's per-refresh gauges)
  are skipped — their family tables are enforced by their own docs rows.
* **bounded cardinality** — label names that identify an unbounded
  population (uids, pods, requests, URLs, raw errors) explode Prometheus
  series; aggregate or move the detail into traces/logs.

Name resolution is import-aware: only names actually bound from
``prometheus_client`` or from the port's metrics modules (and the classes
those modules define) are treated as metric classes, so
``collections.Counter`` never false-positives.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from ..core import (
    Checker,
    FileContext,
    Finding,
    has_double_star,
    has_keyword,
    register,
)
from ..graph import _abs_import_base, module_name

METRIC_CLASSES = {"Counter", "Gauge", "Histogram", "Summary", "Info", "Enum"}

#: the port's own metric families: the modules that define them, and the
#: method an owner class defines to expose the families it keeps
PORT_METRIC_MODULES = ("tpu_operator_torch.controllers.metrics",
                       "tpu_operator_torch.validator.metrics")
OWNER_METHOD = "scrape"

#: label names whose value space grows with cluster activity, not cluster
#: shape — each unique value is a new series forever
UNBOUNDED_LABELS = {"uid", "pod", "pod_name", "pod_uid", "container_id",
                    "request", "request_id", "trace_id", "span_id",
                    "timestamp", "ts", "message", "error", "path", "url",
                    "ip", "address"}


def _prometheus_bindings(tree: ast.Module) -> Set[str]:
    """Local names bound to prometheus_client metric classes."""
    bound: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == "prometheus_client":
            for alias in node.names:
                if alias.name in METRIC_CLASSES:
                    bound.add(alias.asname or alias.name)
    return bound


def _port_bindings(relpath: str, tree: ast.Module) -> Set[str]:
    """Local names bound to the port's own metric classes: imported from
    one of :data:`PORT_METRIC_MODULES` (absolute or relative), or defined
    in such a module itself."""
    modname = module_name(relpath)
    is_package = relpath.endswith("/__init__.py")
    bound: Set[str] = set()
    if modname in PORT_METRIC_MODULES:
        bound.update(node.name for node in tree.body
                     if isinstance(node, ast.ClassDef)
                     and node.name in METRIC_CLASSES)
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        if node.level:
            base = _abs_import_base(modname, is_package, node.level)
            src = f"{base}.{node.module}" if node.module else base
        else:
            src = node.module or ""
        if src not in PORT_METRIC_MODULES:
            continue
        for alias in node.names:
            if alias.name in METRIC_CLASSES:
                bound.add(alias.asname or alias.name)
    return bound


def _owned_calls(tree: ast.Module) -> Set[int]:
    """ids of the Call nodes lexically inside a class that defines
    :data:`OWNER_METHOD` — the families such an owner keeps."""
    owned: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and any(
                isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                and item.name == OWNER_METHOD for item in node.body):
            owned.update(id(sub) for sub in ast.walk(node)
                         if isinstance(sub, ast.Call))
    return owned


def _metric_class(call: ast.Call, bound: Set[str]) -> Optional[str]:
    func = call.func
    if isinstance(func, ast.Name) and func.id in bound:
        return func.id
    if isinstance(func, ast.Attribute) and func.attr in METRIC_CLASSES \
            and isinstance(func.value, ast.Name) \
            and func.value.id == "prometheus_client":
        return func.attr
    return None


def _literal_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


@register
class MetricsDiscipline(Checker):
    name = "metrics-discipline"
    description = ("metrics must pass registry= (the port's: be built by "
                   "their owner), be documented in docs/gpu/operations.md, and "
                   "carry bounded-cardinality labels")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        bound = _prometheus_bindings(ctx.tree)
        port_bound = _port_bindings(ctx.relpath, ctx.tree)
        has_module_import = any(
            isinstance(n, ast.Import) and any(
                a.name == "prometheus_client" for a in n.names)
            for n in ast.walk(ctx.tree))
        if not bound and not port_bound and not has_module_import:
            return
        owned = _owned_calls(ctx.tree) if port_bound else set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            cls = _metric_class(node, bound)
            port_cls = None
            if cls is None:
                port_cls = _metric_class(node, port_bound)
                cls = port_cls
            if cls is None:
                continue
            name = _literal_str(node.args[0] if node.args else
                                _kwarg(node, "name"))
            label = f"{cls}({name!r})" if name else f"dynamically-named {cls}"

            if port_cls is not None:
                if id(node) not in owned:
                    yield ctx.finding(
                        node, self,
                        f"{label} is built outside any metrics owner (a "
                        f"class with {OWNER_METHOD}()): one family shared "
                        f"by every component and test of the process, "
                        f"exposed by none; construct it in the "
                        f"component's metrics class")
            elif not has_keyword(node, "registry") \
                    and not has_double_star(node):
                yield ctx.finding(
                    node, self,
                    f"{label} lands in the process-global REGISTRY; pass an "
                    f"explicit registry= (collides across tests and "
                    f"co-resident components otherwise)")
            if name is not None and ctx.config.docs_text is not None:
                exposition = name
                if cls == "Counter" and not name.endswith("_total"):
                    exposition += "_total"
                if exposition not in ctx.config.docs_text:
                    yield ctx.finding(
                        node, self,
                        f"metric {exposition!r} is not documented in "
                        f"docs/gpu/operations.md — add a row to the metrics "
                        f"reference table (an operator cannot act on an "
                        f"undocumented metric)")
            yield from self._check_labels(ctx, node, label)

    def _check_labels(self, ctx: FileContext, call: ast.Call,
                      label: str) -> Iterator[Finding]:
        labels_node = _kwarg(call, "labelnames")
        if labels_node is None and len(call.args) >= 3:
            labels_node = call.args[2]
        if not isinstance(labels_node, (ast.List, ast.Tuple)):
            return
        for elt in labels_node.elts:
            value = _literal_str(elt)
            if value is not None and value.lower() in UNBOUNDED_LABELS:
                yield ctx.finding(
                    elt, self,
                    f"{label} label {value!r} is unbounded-cardinality "
                    f"(one series per {value} forever); aggregate it or "
                    f"carry the detail in traces/logs instead")
