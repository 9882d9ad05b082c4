"""A minimal Helm-template renderer for the port's chart (counterpart of
tpu_operator/testing/helmlite.py).

No ``helm`` binary is needed: the chart's templates
(``deployments/gpu-operator/templates/``) use a small, stable subset of
Go-template syntax, and rendering that subset in process lets tests and the
card's smoke install the REAL chart output and validate it, such as the
rendered ClusterPolicy against the generated CRD schema.

Supported subset (everything the chart uses, as the reference's renderer):

- ``{{ .Values.a.b }}`` / ``{{ .Release.X }}`` / ``{{ .Chart.X }}``
  inline interpolation
- ``{{- toYaml EXPR | nindent N }}`` on its own line
- ``{{- include "name" . | nindent N }}`` with ``{{- define "name" -}}``
  blocks loaded from ``_helpers.tpl``
- ``{{- if EXPR }} ... {{- end }}`` and ``{{- with EXPR }} ... {{- end }}``
  occupying whole lines (``.`` inside a with-block is the scoped value)

Anything outside the subset raises, so a chart edit that outgrows the
renderer fails loudly instead of silently skipping validation.

The chart, its values and its output are read with
:mod:`~tpu_operator_torch.yamlsubset`, and ``toYaml`` writes with
:func:`~tpu_operator_torch.yamlsubset.dump`: no PyYAML. So the chart's files
stay inside the subset (block style, no flow mappings, no block scalars),
which a real ``helm`` reads as the same values.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional

from .. import yamlsubset
from ..client.errors import AlreadyExistsError
from ..utils.objects import deep_merge

_INLINE = re.compile(r"\{\{-?\s*(\.[A-Za-z0-9_.]*)\s*-?\}\}")
_CONTROL = re.compile(
    r"^(\s*)\{\{-?\s*(if|with)\s+(.+?)\s*-?\}\}\s*$")
_END = re.compile(r"^\s*\{\{-?\s*end\s*-?\}\}\s*$", re.MULTILINE)
_TOYAML = re.compile(
    r"^(\s*)\{\{-?\s*toYaml\s+"
    r"(?:\((\.[A-Za-z0-9_.]*|\.)\s*\|\s*default\s+dict\)|(\.[A-Za-z0-9_.]*|\.))"
    r"\s*\|\s*nindent\s+(\d+)\s*-?\}\}\s*$")
_INCLUDE = re.compile(
    r'^(\s*)\{\{-?\s*include\s+"([^"]+)"\s+\.\s*\|\s*nindent\s+(\d+)\s*-?\}\}\s*$')
_DEFINE = re.compile(r'\{\{-?\s*define\s+"([^"]+)"\s*-?\}\}')

#: the order ``helm install`` creates kinds in (its InstallOrder, for the
#: kinds this chart has); custom resources come last, after their CRDs
INSTALL_ORDER = ("CustomResourceDefinition", "Namespace", "ServiceAccount", "ClusterRole",
                 "ClusterRoleBinding", "Deployment")


def _read(path: str) -> Any:
    with open(path) as f:
        return yamlsubset.parse(f.read())


class HelmLite:
    def __init__(self, chart_dir: str, values: Optional[Dict[str, Any]] = None,
                 release_namespace: str = "tpu-operator",
                 release_name: str = "gpu-operator"):
        self.chart_dir = chart_dir
        chart = _read(os.path.join(chart_dir, "Chart.yaml"))
        base_values = _read(os.path.join(chart_dir, "values.yaml")) or {}
        # base_values is a fresh local load, so an in-place merge is fine;
        # the overrides are copied so the caller's dict is never aliased
        self.context = {
            "Values": deep_merge(base_values, copy.deepcopy(values or {})),
            "Release": {"Namespace": release_namespace,
                        "Name": release_name, "Service": "Helm"},
            "Chart": {"Name": chart.get("name", ""),
                      "Version": str(chart.get("version", "")),
                      "AppVersion": str(chart.get("appVersion", ""))},
        }
        self.defines = self._load_defines()

    def _load_defines(self) -> Dict[str, str]:
        defines: Dict[str, str] = {}
        helpers = os.path.join(self.chart_dir, "templates", "_helpers.tpl")
        if not os.path.exists(helpers):
            return defines
        with open(helpers) as f:
            text = f.read()
        for m in _DEFINE.finditer(text):
            name = m.group(1)
            rest = text[m.end():]
            end = _END.search(rest)
            if end is None:
                raise ValueError(f"define {name!r} has no end")
            defines[name] = rest[:end.start()].strip("\n")
        return defines

    # -- expression evaluation ----------------------------------------------
    def _lookup(self, expr: str, scope: Any) -> Any:
        expr = expr.strip()
        if expr == ".":
            return scope
        if not expr.startswith(".") or expr.split(".")[1] not in (
                "Values", "Release", "Chart"):
            # real Helm resolves bare .foo against the with-scope; this
            # renderer does not model scoped lookup, so it fails loudly
            # rather than silently resolving from the root context
            raise ValueError(f"unsupported expression {expr!r}")
        if scope is not None:
            # inside a with-block real Helm rebinds '.', so .Values would
            # resolve against the scoped value (nil) and error: accepting it
            # here would pass templates real helm rejects
            raise ValueError(
                f"{expr!r} inside a with-block: Helm rebinds '.'; "
                f"use '$' forms outside this renderer's subset")
        node: Any = self.context
        for part in expr.lstrip(".").split("."):
            if isinstance(node, dict):
                node = node.get(part)
            else:
                return None
            if node is None:
                return None
        return node

    def _interp(self, line: str, scope: Any) -> str:
        def sub(m):
            value = self._lookup(m.group(1), scope)
            if value is None:
                return ""
            if isinstance(value, bool):
                return "true" if value else "false"
            if isinstance(value, (dict, list)):
                # inline interpolation of a structure would emit Python
                # repr, not Helm's output: the template needs toYaml
                raise ValueError(
                    f"inline interpolation of non-scalar {m.group(1)!r}; "
                    f"use toYaml | nindent")
            return str(value)
        out = _INLINE.sub(sub, line)
        if "{{" in out:
            raise ValueError(f"unsupported template syntax: {line.strip()!r}")
        return out

    # -- block rendering -----------------------------------------------------
    def _render_lines(self, lines: List[str], scope: Any) -> List[str]:
        out: List[str] = []
        i = 0
        while i < len(lines):
            line = lines[i]
            ctl = _CONTROL.match(line)
            if ctl:
                _indent, keyword, expr = ctl.groups()
                block, i = self._collect_block(lines, i + 1)
                value = self._lookup(expr, scope)
                if value:
                    inner_scope = value if keyword == "with" else scope
                    out.extend(self._render_lines(block, inner_scope))
                continue
            ty = _TOYAML.match(line)
            if ty:
                _indent, defaulted_expr, plain_expr, n = ty.groups()
                value = self._lookup(defaulted_expr or plain_expr, scope)
                if value is None and defaulted_expr:
                    value = {}  # `| default dict`: nil renders as {}
                if value is not None:
                    out.extend(yamlsubset.dump(value, int(n)).splitlines())
                i += 1
                continue
            inc = _INCLUDE.match(line)
            if inc:
                _indent, name, n = inc.groups()
                body = self.defines.get(name)
                if body is None:
                    raise ValueError(f"include of undefined template {name!r}")
                rendered = self._render_lines(body.splitlines(), scope)
                pad = " " * int(n)
                out.extend(pad + l for l in rendered)
                i += 1
                continue
            if _END.match(line):
                raise ValueError("unbalanced {{ end }}")
            out.append(self._interp(line, scope))
            i += 1
        return out

    def _collect_block(self, lines: List[str], start: int):
        depth = 1
        block: List[str] = []
        i = start
        while i < len(lines):
            if _CONTROL.match(lines[i]):
                depth += 1
            elif _END.match(lines[i]):
                depth -= 1
                if depth == 0:
                    return block, i + 1
            block.append(lines[i])
            i += 1
        raise ValueError("unterminated control block")

    # -- public API ----------------------------------------------------------
    def render_template(self, name: str) -> str:
        path = os.path.join(self.chart_dir, "templates", name)
        with open(path) as f:
            lines = f.read().splitlines()
        return "\n".join(self._render_lines(lines, None)) + "\n"

    def render_all(self, create_namespace: bool = False) -> List[dict]:
        """Every template (skipping _helpers) + crds/, parsed to objects: the
        moral equivalent of ``helm template`` output. ``create_namespace``
        adds the release's Namespace first, as ``helm install
        --create-namespace`` creates it."""
        objs: List[dict] = []
        if create_namespace:
            objs.append(namespace_object(self.context["Release"]["Namespace"]))
        tdir = os.path.join(self.chart_dir, "templates")
        for fname in sorted(os.listdir(tdir)):
            if fname.startswith("_"):
                continue
            objs.extend(yamlsubset.parse_all(self.render_template(fname)))
        crds = os.path.join(self.chart_dir, "crds")
        if os.path.isdir(crds):
            for fname in sorted(os.listdir(crds)):
                with open(os.path.join(crds, fname)) as f:
                    objs.extend(yamlsubset.parse_all(f.read()))
        return objs


def namespace_object(name: str) -> dict:
    """The Namespace ``helm install --create-namespace`` creates."""
    return {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": name}}


def install_order(objs: List[dict]) -> List[dict]:
    """``objs`` in the order ``helm install`` creates them: CRDs first, the
    kinds of :data:`INSTALL_ORDER` in that order, everything else (the
    custom resources) last, each group in the render's order."""
    rank = {kind: i for i, kind in enumerate(INSTALL_ORDER)}
    return sorted(objs, key=lambda o: rank.get(o.get("kind"), len(INSTALL_ORDER)))


def apply(client, objs: List[dict], skip_kinds=()) -> None:
    """Create every object in install order, or update it over the live one
    where it exists (``helm upgrade``'s outcome, without its three-way
    merge). Kinds in ``skip_kinds`` are left alone."""
    for obj in install_order([o for o in objs if o.get("kind") not in skip_kinds]):
        obj = copy.deepcopy(obj)
        try:
            client.create(obj)
        except AlreadyExistsError:
            meta = obj["metadata"]
            live = client.get(obj["apiVersion"], obj["kind"], meta["name"],
                              meta.get("namespace"))
            meta["resourceVersion"] = live["metadata"]["resourceVersion"]
            client.update(obj)
