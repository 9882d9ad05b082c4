"""Manifest renderer: template files -> unstructured objects (counterpart
of tpu_operator/render/render.py).

jinja2 with ``StrictUndefined``, as the reference has it (a missing value
fails the render). The rendered text is read with the port's own YAML
subset (:func:`~tpu_operator_torch.yamlsubset.parse_all`), not PyYAML, so
the templates are written to render into that subset: block mappings and
lists, one-line scalars and one-line flow sequences, documents split by
``---``. The ``toyaml`` filter writes the subset (:func:`yamlsubset.dump`);
``tojson`` writes a value as a JSON string, for ConfigMap payloads.
jinja2 is imported by the first :class:`Renderer`, never at package import.

Rendering is memoised on (template set, render data): level-driven sweeps
re-render only when the CR spec or cluster facts change.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List

from . import yamlsubset


class RenderError(Exception):
    pass


def _to_yaml(value: Any, indent: int = 0) -> str:
    return yamlsubset.dump(value, indent)


def _to_json(value: Any) -> str:
    return json.dumps(value, sort_keys=True)


class Renderer:
    """Renders every ``*.yaml``/``*.yaml.j2`` template in a directory, in
    lexical order (the NNNN_name.yaml ordering)."""

    TEMPLATE_SUFFIXES = (".yaml", ".yml", ".yaml.j2", ".yml.j2")

    def __init__(self, templates_dir: str, includes_dir: str | None = None):
        import jinja2

        if not os.path.isdir(templates_dir):
            raise RenderError(f"templates dir does not exist: {templates_dir}")
        self.templates_dir = templates_dir
        loaders = [jinja2.FileSystemLoader(templates_dir)]
        if includes_dir is None:
            candidate = os.path.join(os.path.dirname(templates_dir), "_includes")
            includes_dir = candidate if os.path.isdir(candidate) else None
        if includes_dir:
            loaders.append(jinja2.FileSystemLoader(includes_dir))
        self._jinja = jinja2
        self._env = jinja2.Environment(
            loader=jinja2.ChoiceLoader(loaders),
            undefined=jinja2.StrictUndefined,
            trim_blocks=True,
            lstrip_blocks=True,
            keep_trailing_newline=True,
        )
        self._env.filters["toyaml"] = _to_yaml
        self._env.filters["tojson"] = _to_json
        self._cache: Dict[str, List[dict]] = {}

    def template_files(self) -> List[str]:
        return sorted(
            f for f in os.listdir(self.templates_dir)
            if f.endswith(self.TEMPLATE_SUFFIXES) and not f.startswith(".")
        )

    def render_text(self, name: str, data: Dict[str, Any]) -> str:
        try:
            return self._env.get_template(name).render(**data)
        except self._jinja.UndefinedError as e:
            raise RenderError(f"{name}: missing template variable: {e}") from e
        except self._jinja.TemplateError as e:
            raise RenderError(f"{name}: {e}") from e

    def render_file(self, name: str, data: Dict[str, Any]) -> List[dict]:
        text = self.render_text(name, data)
        try:
            docs = yamlsubset.parse_all(text)
        except yamlsubset.SubsetError as e:
            raise RenderError(f"{name}: rendered text outside the YAML subset: {e}") from e
        for doc in docs:
            if not isinstance(doc, dict) or "kind" not in doc:
                raise RenderError(f"{name}: rendered doc is not a k8s object")
        return docs

    def render_objects(self, data: Dict[str, Any]) -> List[dict]:
        # the canonical JSON itself is the key: collision-free
        key = json.dumps(data, sort_keys=True, separators=(",", ":"), default=str)
        cached = self._cache.get(key)
        if cached is None:
            objs: List[dict] = []
            for name in self.template_files():
                objs.extend(self.render_file(name, data))
            if len(self._cache) > 64:  # bound memory across many pools
                self._cache.clear()
            self._cache[key] = objs
            cached = objs
        return copy.deepcopy(cached)
