"""annotation-registry: every ``tpu.ai/*`` label/annotation-key literal
must resolve to the consts registry module and be documented.

Raw key literals scattered through controllers are how two subsystems end
up disagreeing about an annotation name — the drain/migrate/autoscale
protocols coordinate entirely through these keys, so the full set must
live in one reviewed registry (``tpu_operator_torch/consts.py``) and appear in
the operations doc's annotation-key registry table.

Classification: a string literal is a *key* only when the whole literal
matches the key grammar (``tpu.ai/<segment>``) — prose that merely
mentions a key inside a longer sentence is exempt by construction.
apiVersion strings (``tpu.ai/v1``, ``tpu.ai/v1alpha1``) are a separate
class (Kubernetes group/version, not a metadata key) and are exempt.

Inside the registry module itself the rule inverts: each registered value
must appear in docs/gpu/operations.md (the registry table), keeping code and
doc from drifting apart.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Checker, FileContext, Finding, register

KEY_RE = re.compile(r"^tpu\.ai/[A-Za-z0-9._/-]+$")
API_VERSION_RE = re.compile(r"^tpu\.ai/v\d+(?:(?:alpha|beta)\d+)?$")


@register
class AnnotationRegistry(Checker):
    name = "annotation-registry"
    description = ("raw tpu.ai/* key literals must resolve to consts.py "
                   "and be documented (apiVersion strings exempt)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        registry_mod = project.modules.get(ctx.config.consts_module)
        in_registry = (registry_mod is not None
                       and registry_mod.relpath == ctx.relpath)
        seen_values = set()
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            value = node.value
            if not KEY_RE.match(value) or API_VERSION_RE.match(value):
                continue
            if in_registry:
                docs = ctx.config.docs_text
                if docs is None or value in docs or value in seen_values:
                    continue
                seen_values.add(value)
                names = project.const_names_by_value.get(value, [])
                label = f"consts.{names[0]}" if names else f"{value!r}"
                yield ctx.finding(
                    node, self,
                    f"registered key {value!r} ({label}) is missing from "
                    f"the annotation-key registry table in "
                    f"docs/gpu/operations.md")
            else:
                names = project.const_names_by_value.get(value, [])
                if names:
                    hint = (f"use consts.{names[0]} instead of the raw "
                            f"literal")
                else:
                    hint = ("add a named constant to tpu_operator_torch/consts.py "
                            "and reference it")
                yield ctx.finding(
                    node, self,
                    f"raw annotation/label key {value!r} outside the "
                    f"consts registry: {hint}")
