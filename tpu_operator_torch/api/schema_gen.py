"""Compile the spec dataclasses into the CRDs' openAPIV3Schema (counterpart
of tpu_operator/api/schema_gen.py, and of hack/gen-crds.py for the port's
own CRD files).

NVIDIA's operator generates its CRD schemas with controller-gen from
kubebuilder markers on Go struct tags. Here the spec dataclasses are the one
source: each field's type hint gives the OpenAPI type, and ``spec_field(doc=,
enum=, minimum=, maximum=, pattern=, schema=)`` carries the validation facts
a marker would. :func:`generate_crds` emits apiextensions.k8s.io/v1
CustomResourceDefinitions for ``ClusterPolicy`` and ``GPUDriver``; the same
schemas drive ``gpuop-cfg validate`` and the fake apiserver's admission, so
types and schema cannot drift.

The schemas are structural: unknown fields are refused, except where a field
is free-form (``Dict[str, Any]`` maps to
``x-kubernetes-preserve-unknown-fields: true``).

    python -m tpu_operator_torch.api.schema_gen --write   # rewrite every copy
    python -m tpu_operator_torch.api.schema_gen --check   # exit 1 if one is stale

The generated CRDs land in four places (:func:`outputs`), as hack/gen-crds.py
ships the reference's:

  1. tpu_operator_torch/api/crds/   canonical, loaded by the operator
  2. deployments/gpu-operator/crds/ the chart's (Helm installs them)
  3. bundle-gpu/manifests/          the OLM bundle's, beside the CSV
  4. deploy/gpu-operator.yaml       the static install, between the
                                    GENERATED markers

``--repo`` names the checkout holding them (default: the one this module is
in). The files are written by :func:`~tpu_operator_torch.yamlsubset.dump`.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys
import typing
from typing import Any, Dict, get_args, get_origin, get_type_hints

from .specbase import to_camel
from .k8s_schemas import METAV1_CONDITION
from . import clusterpolicy as cp
from . import gpudriver as gd


def _unwrap_optional(tp):
    if get_origin(tp) is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _type_schema(tp) -> Dict[str, Any]:
    """Map a Python type hint to an OpenAPI v3 schema fragment."""
    tp = _unwrap_optional(tp)
    if dataclasses.is_dataclass(tp):
        return dataclass_schema(tp)
    if tp is str:
        return {"type": "string"}
    if tp is bool:
        return {"type": "boolean"}
    if tp is int:
        return {"type": "integer"}
    if tp is float:
        return {"type": "number"}
    origin = get_origin(tp)
    if origin in (list, typing.List):
        args = get_args(tp)
        item = _type_schema(args[0]) if args else \
            {"x-kubernetes-preserve-unknown-fields": True}
        return {"type": "array", "items": item}
    if origin in (dict, typing.Dict):
        args = get_args(tp)
        if args and args[1] is str:
            return {"type": "object", "additionalProperties": {"type": "string"}}
        return {"type": "object", "x-kubernetes-preserve-unknown-fields": True}
    if tp is Any or tp is object:
        return {"x-kubernetes-preserve-unknown-fields": True}
    raise TypeError(f"cannot map type {tp!r} to an OpenAPI schema")


def _first_doc_line(cls) -> str | None:
    doc = (cls.__doc__ or "").strip()
    # @dataclass synthesizes "Cls(field: type = ..., ...)" docstrings for
    # classes without one — never ship those in kubectl-explain output
    if not doc or doc.startswith(f"{cls.__name__}("):
        return None
    # collapse the first paragraph into one line
    para = doc.split("\n\n")[0]
    return " ".join(line.strip() for line in para.splitlines())


def dataclass_schema(cls) -> Dict[str, Any]:
    """Object schema for a SpecBase dataclass: one property per field."""
    hints = get_type_hints(cls)
    props: Dict[str, Any] = {}
    required: list[str] = []
    for f in dataclasses.fields(cls):
        if f.name == "extra" or not f.repr:
            continue
        key = f.metadata.get("key", to_camel(f.name))
        override = dict(f.metadata.get("schema", {}))
        # a raw schema override replaces the type mapping entirely when it
        # carries its own type/anyOf; otherwise it augments the mapped type
        if "type" in override or "anyOf" in override or \
                "x-kubernetes-preserve-unknown-fields" in override:
            sch = override
        else:
            sch = _type_schema(hints[f.name])
            sch.update(override)
        default = _schema_default(f)
        if default is not None and "default" not in sch and \
                sch.get("type") in ("string", "integer", "number", "boolean"):
            sch["default"] = default
        if f.metadata.get("required"):
            required.append(key)
        props[key] = sch
    out: Dict[str, Any] = {"type": "object", "properties": props}
    doc = _first_doc_line(cls)
    if doc:
        out["description"] = doc
    if required:
        out["required"] = sorted(required)
    return out


def _schema_default(f: dataclasses.Field):
    if f.default is dataclasses.MISSING or f.default is None:
        return None
    if f.default == "" or f.metadata.get("required"):
        return None
    if isinstance(f.default, (str, int, float, bool)):
        return f.default
    return None


def _crd(group: str, kind: str, plural: str, singular: str, version: str,
         spec_schema: Dict[str, Any], status_schema: Dict[str, Any],
         printer_columns: list, scope: str = "Cluster",
         short_names: list | None = None) -> Dict[str, Any]:
    names = {
        "kind": kind,
        "listKind": f"{kind}List",
        "plural": plural,
        "singular": singular,
    }
    if short_names:
        names["shortNames"] = short_names
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{group}"},
        "spec": {
            "group": group,
            "names": names,
            "scope": scope,
            "versions": [{
                "name": version,
                "served": True,
                "storage": True,
                "subresources": {"status": {}},
                "additionalPrinterColumns": printer_columns,
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "description": f"{kind} is the Schema for the "
                                   f"{plural} API",
                    "properties": {
                        "apiVersion": {"type": "string"},
                        "kind": {"type": "string"},
                        "metadata": {"type": "object"},
                        "spec": spec_schema,
                        "status": status_schema,
                    },
                }},
            }],
        },
    }


@functools.lru_cache(maxsize=None)
def clusterpolicy_crd() -> Dict[str, Any]:
    """ClusterPolicy CRD with the full generated validation schema
    (NVIDIA's config/crd/bases/nvidia.com_clusterpolicies.yaml)."""
    status = {
        "type": "object",
        "description": "Observed state of the ClusterPolicy.",
        "properties": {
            "state": {"type": "string",
                      "enum": [cp.State.IGNORED, cp.State.READY,
                               cp.State.NOT_READY]},
            "namespace": {"type": "string"},
            "observedGeneration": {"type": "integer", "format": "int64"},
            "conditions": {"type": "array", "items": METAV1_CONDITION},
        },
    }
    columns = [
        {"name": "Status", "type": "string", "jsonPath": ".status.state"},
        {"name": "Age", "type": "date",
         "jsonPath": ".metadata.creationTimestamp"},
    ]
    return _crd("tpu.ai", cp.CLUSTER_POLICY_KIND, "clusterpolicies",
                "clusterpolicy", "v1",
                dataclass_schema(cp.ClusterPolicySpec), status, columns)


@functools.lru_cache(maxsize=None)
def gpudriver_crd() -> Dict[str, Any]:
    """GPUDriver CRD with the full generated validation schema (NVIDIA's
    config/crd/bases/nvidia.com_nvidiadrivers.yaml)."""
    status = {
        "type": "object",
        "description": "Observed state of the GPUDriver.",
        "properties": {
            "state": {"type": "string",
                      "enum": [cp.State.IGNORED, cp.State.READY,
                               cp.State.NOT_READY]},
            "observedGeneration": {"type": "integer", "format": "int64"},
            "conditions": {"type": "array", "items": METAV1_CONDITION},
            "pools": {
                "type": "object",
                "description": "Node count per GPU-model pool this "
                               "instance manages.",
                "additionalProperties": {"type": "integer"},
            },
        },
    }
    columns = [
        {"name": "Status", "type": "string", "jsonPath": ".status.state"},
        {"name": "Version", "type": "string",
         "jsonPath": ".spec.driverVersion"},
        {"name": "Age", "type": "date",
         "jsonPath": ".metadata.creationTimestamp"},
    ]
    return _crd("tpu.ai", gd.GPU_DRIVER_KIND, "gpudrivers", "gpudriver",
                "v1alpha1", dataclass_schema(gd.GPUDriverSpec), status,
                columns, short_names=["gpudrv"])


def generate_crds() -> Dict[str, Dict[str, Any]]:
    """filename -> CRD object, for every CRD this operator serves."""
    return {
        "tpu.ai_clusterpolicies.yaml": clusterpolicy_crd(),
        "tpu.ai_gpudrivers.yaml": gpudriver_crd(),
    }


#: where the CRD files live, beside this module (package data)
CRD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "crds")
#: the checkout this module is in
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HEADER = ("# Generated by python -m tpu_operator_torch.api.schema_gen --write "
          "from the spec dataclasses. DO NOT EDIT.\n")

#: the static install's generated section lies between these two lines
BEGIN = "# --- BEGIN GENERATED CRDS (python -m tpu_operator_torch.api.schema_gen --write) ---\n"
END = "# --- END GENERATED CRDS ---\n"


def crd_yaml(crd: Dict[str, Any]) -> str:
    from ..yamlsubset import dump

    return HEADER + dump(crd) + "\n"


def splice_static_install(text: str, block: str) -> str:
    """``text`` with its generated CRD section replaced by ``block`` (or,
    without markers, inserted after the leading comment lines)."""
    if BEGIN in text and END in text:
        head, _, rest = text.partition(BEGIN)
        _, _, tail = rest.partition(END)
        return head + BEGIN + block + END + tail
    lines = text.splitlines(keepends=True)
    i = 0
    while i < len(lines) and (lines[i].startswith("#") or not lines[i].strip()):
        i += 1
    return "".join(lines[:i]) + BEGIN + block + END + "---\n" + "".join(lines[i:])


def outputs(repo: str = REPO) -> Dict[str, str]:
    """path -> the text each copy of the CRDs must hold, in ``repo`` (the
    canonical copy is :data:`CRD_DIR` in this checkout)."""
    crds = generate_crds()
    canonical = CRD_DIR if repo == REPO else os.path.join(repo, "tpu_operator_torch", "api",
                                                           "crds")
    out = {}
    for fname, crd in crds.items():
        text = crd_yaml(crd)
        for directory in (canonical, os.path.join(repo, "deployments", "gpu-operator", "crds"),
                          os.path.join(repo, "bundle-gpu", "manifests")):
            out[os.path.join(directory, fname)] = text
    static = os.path.join(repo, "deploy", "gpu-operator.yaml")
    try:
        with open(static) as f:
            current = f.read()
    except FileNotFoundError:
        current = ""
    block = "---\n".join(crd_yaml(crd) for crd in crds.values())
    out[static] = splice_static_install(current, block)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_operator_torch.api.schema_gen")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--write", action="store_true",
                      help="write every copy of the CRDs (api/crds/, the chart's, the "
                           "bundle's and the static install's)")
    mode.add_argument("--check", action="store_true",
                      help="exit 1 if a copy differs from what the dataclasses generate")
    ap.add_argument("--repo", default=REPO,
                    help="the checkout holding the copies (default: %(default)s)")
    args = ap.parse_args(argv)
    stale = []
    for path, text in outputs(args.repo).items():
        try:
            with open(path) as f:
                current = f.read()
        except FileNotFoundError:
            current = None
        if current == text:
            continue
        if args.write:  # only what changed: a reader never sees a half-written copy
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(text)
            print(f"wrote {path}")
        else:
            stale.append(path)
    for path in stale:
        print(f"STALE: {path} (run python -m tpu_operator_torch.api.schema_gen "
              f"--write)", file=sys.stderr)
    return 1 if stale else 0


if __name__ == "__main__":
    sys.exit(main())
