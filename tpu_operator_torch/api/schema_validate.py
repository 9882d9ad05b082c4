"""Structural-schema validation for CRD objects (copy of
tpu_operator/api/schema_validate.py).

Implements the subset of OpenAPI v3 + Kubernetes structural-schema semantics
that ``schema_gen`` emits, so the generated CRD schemas are *executable*
in-repo: ``gpuop-cfg`` validates CRs client-side and the fake apiserver
enforces them server-side, the way a real kube-apiserver enforces
generated CRD schemas (apiextensions validation; NVIDIA's operator relies
on it for every field of config/crd/bases/nvidia.com_clusterpolicies.yaml).

Semantics follow kube-apiserver's strict field validation
(``--validate=strict`` / server-side apply): unknown fields are errors
unless the enclosing object carries ``x-kubernetes-preserve-unknown-fields``
or ``additionalProperties``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List


def validate(obj: Any, schema: Dict[str, Any], path: str = "") -> List[str]:
    """Validate ``obj`` against ``schema``; returns a list of error strings
    (empty = valid)."""
    errors: List[str] = []
    _validate(obj, schema, path or "$", errors)
    return errors


def validate_cr(obj: Dict[str, Any], crd: Dict[str, Any]) -> List[str]:
    """Validate a full CR against the served version schema of a generated
    CRD object (as returned by ``schema_gen.generate_crds``)."""
    version = obj.get("apiVersion", "").rpartition("/")[2]
    for v in crd["spec"]["versions"]:
        if v["name"] == version and v.get("served"):
            schema = v["schema"]["openAPIV3Schema"]
            return validate(obj, schema, obj.get("kind", "object"))
    group = crd["spec"]["group"]
    served = [v["name"] for v in crd["spec"]["versions"] if v.get("served")]
    return [f"apiVersion {obj.get('apiVersion')!r} not served; "
            f"expected {group}/{{{','.join(served)}}}"]


_TYPE_CHECKS = {
    "string": lambda v: isinstance(v, str),
    "boolean": lambda v: isinstance(v, bool),
    # bool is an int in Python; exclude it from integer/number
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "array": lambda v: isinstance(v, list),
    "object": lambda v: isinstance(v, dict),
}


def _validate(obj: Any, schema: Dict[str, Any], path: str,
              errors: List[str]) -> None:
    if "anyOf" in schema:
        branch_errs: List[List[str]] = []
        for branch in schema["anyOf"]:
            # merge sibling constraints (pattern etc.) into each branch
            merged = {**{k: v for k, v in schema.items() if k != "anyOf"},
                      **branch}
            errs: List[str] = []
            _validate(obj, merged, path, errs)
            if not errs:
                return
            branch_errs.append(errs)
        errors.append(f"{path}: does not match any allowed form "
                      f"({'; '.join(e[0] for e in branch_errs)})")
        return

    tp = schema.get("type")
    if tp is not None:
        check = _TYPE_CHECKS.get(tp)
        if check is None:
            errors.append(f"{path}: schema has unknown type {tp!r}")
            return
        if not check(obj):
            errors.append(
                f"{path}: expected {tp}, got {type(obj).__name__}")
            return

    if "enum" in schema and obj not in schema["enum"]:
        allowed = ", ".join(repr(e) for e in schema["enum"])
        errors.append(f"{path}: {obj!r} not one of [{allowed}]")

    if isinstance(obj, str) and "pattern" in schema:
        if not re.search(schema["pattern"], obj):
            errors.append(
                f"{path}: {obj!r} does not match {schema['pattern']!r}")

    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        if "minimum" in schema and obj < schema["minimum"]:
            errors.append(f"{path}: {obj} below minimum {schema['minimum']}")
        if "maximum" in schema and obj > schema["maximum"]:
            errors.append(f"{path}: {obj} above maximum {schema['maximum']}")

    if isinstance(obj, list):
        item_schema = schema.get("items")
        if item_schema:
            for i, item in enumerate(obj):
                _validate(item, item_schema, f"{path}[{i}]", errors)
        if "maxItems" in schema and len(obj) > schema["maxItems"]:
            errors.append(f"{path}: more than {schema['maxItems']} items")

    if isinstance(obj, dict):
        _validate_object(obj, schema, path, errors)


def _validate_object(obj: Dict[str, Any], schema: Dict[str, Any],
                     path: str, errors: List[str]) -> None:
    props = schema.get("properties", {})
    addl = schema.get("additionalProperties")
    preserve = schema.get("x-kubernetes-preserve-unknown-fields", False)
    for req in schema.get("required", []):
        if req not in obj:
            errors.append(f"{path}.{req}: required field missing")
    for key, value in obj.items():
        if key in props:
            _validate(value, props[key], f"{path}.{key}", errors)
        elif isinstance(addl, dict):
            _validate(value, addl, f"{path}.{key}", errors)
        elif addl is True or preserve:
            continue
        elif not props and addl is None:
            # schema without properties/additionalProperties (e.g. the
            # metadata stub, validated by ObjectMeta rules instead):
            # accept any content
            continue
        else:
            errors.append(f"{path}.{key}: unknown field")


def prune(obj: Any, schema: Dict[str, Any]) -> List[str]:
    """Structural-schema pruning (kube-apiserver semantics for CRDs with
    preserveUnknownFields: false): remove, in place, every field the schema
    does not know, except under ``x-kubernetes-preserve-unknown-fields`` or
    ``additionalProperties``. Returns the pruned paths.

    This is what keeps a CRD *upgrade* from wedging live objects: a CR
    stored under schema vN may carry a field vN+1 removed — the apiserver
    silently prunes it on the next write instead of rejecting every status
    update forever."""
    pruned: List[str] = []
    _prune(obj, schema, "$", pruned)
    return pruned


def _prune(obj: Any, schema: Dict[str, Any], path: str,
           pruned: List[str]) -> None:
    if isinstance(obj, list):
        item_schema = schema.get("items")
        if item_schema:
            for i, item in enumerate(obj):
                _prune(item, item_schema, f"{path}[{i}]", pruned)
        return
    if not isinstance(obj, dict):
        return
    props = schema.get("properties", {})
    addl = schema.get("additionalProperties")
    preserve = schema.get("x-kubernetes-preserve-unknown-fields", False)
    if preserve or addl is True:
        return
    if isinstance(addl, dict):
        for key, value in obj.items():
            _prune(value, addl, f"{path}.{key}", pruned)
        return
    if not props and addl is None:
        return  # schema stub (metadata): accept any content
    for key in [k for k in obj if k not in props]:
        del obj[key]
        pruned.append(f"{path}.{key}")
    for key, value in obj.items():
        _prune(value, props[key], f"{path}.{key}", pruned)
