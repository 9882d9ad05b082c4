"""Generic dataclass <-> camelCase-dict serde for CRD spec types (copy of
tpu_operator/api/specbase.py).

The reference generates this layer (deepcopy funcs, JSON tags) with
kubebuilder; here one reflective base class covers every spec type:
snake_case attributes map to camelCase keys, nested dataclasses and
List[dataclass] fields recurse, and unknown keys are preserved round-trip so
the operator never destroys fields written by a newer client.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, get_args, get_origin, get_type_hints


def to_camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part[:1].upper() + part[1:] for part in rest)


def _resolve_hints(cls) -> Dict[str, Any]:
    return get_type_hints(cls)


def _unwrap_optional(tp):
    if get_origin(tp) is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


@dataclasses.dataclass
class SpecBase:
    @classmethod
    def from_dict(cls, data: Dict[str, Any] | None):
        data = dict(data or {})
        hints = _resolve_hints(cls)
        kwargs = {}
        consumed = set()
        for f in dataclasses.fields(cls):
            if f.name == "extra" or not f.repr:
                continue
            key = f.metadata.get("key", to_camel(f.name))
            if key not in data:
                continue
            consumed.add(key)
            value = data[key]
            tp = _unwrap_optional(hints[f.name])
            kwargs[f.name] = _decode(tp, value)
        extra = {k: v for k, v in data.items() if k not in consumed}
        obj = cls(**kwargs)
        if extra and hasattr(obj, "extra"):
            obj.extra = extra
        return obj

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            # repr=False marks internal fields (e.g. DEFAULT_IMAGE_ENV) that
            # must never be serialized into the CR or counted in the schema
            if f.name == "extra" or not f.repr:
                continue
            value = getattr(self, f.name)
            if value is None:
                continue
            key = f.metadata.get("key", to_camel(f.name))
            out[key] = _encode(value)
        extra = getattr(self, "extra", None)
        if extra:
            for k, v in extra.items():
                out.setdefault(k, v)
        return out


def _decode(tp, value):
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return tp.from_dict(value)
    origin = get_origin(tp)
    if origin in (list, typing.List) and isinstance(value, list):
        (item_tp,) = get_args(tp) or (Any,)
        if dataclasses.is_dataclass(item_tp):
            return [item_tp.from_dict(v) if isinstance(v, dict) else v for v in value]
        return list(value)
    return value


def _encode(value):
    if isinstance(value, SpecBase):
        return value.to_dict()
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return dataclasses.asdict(value)
    if isinstance(value, list):
        return [_encode(v) for v in value]
    if isinstance(value, dict):
        return {k: _encode(v) for k, v in value.items()}
    return value


def spec_field(default=None, key: str | None = None, doc: str | None = None,
               enum=None, minimum=None, maximum=None, pattern: str | None = None,
               schema: Dict[str, Any] | None = None, required: bool = False,
               **kw):
    """Declare a CRD spec field.

    Beyond serde (``key`` overrides the camelCase name), fields carry their
    OpenAPI validation facts — description, enum, bounds, pattern, or a raw
    ``schema`` override — the way the reference carries kubebuilder markers
    on Go struct tags (api/nvidia/v1/clusterpolicy_types.go:129-130). The
    schema generator (schema_gen.py) compiles these plus the Python type
    into the CRD's openAPIV3Schema, so types and schema cannot drift (the
    port's generator comes with its CRD; the facts ride along meanwhile).
    """
    metadata: Dict[str, Any] = {"key": key} if key else {}
    if required:
        metadata["required"] = True
    sch: Dict[str, Any] = dict(schema or {})
    if doc is not None:
        sch["description"] = doc
    if enum is not None:
        sch["enum"] = list(enum)
    if minimum is not None:
        sch["minimum"] = minimum
    if maximum is not None:
        sch["maximum"] = maximum
    if pattern is not None:
        sch["pattern"] = pattern
    if sch:
        metadata["schema"] = sch
    if callable(default):
        return dataclasses.field(default_factory=default, metadata=metadata, **kw)
    return dataclasses.field(default=default, metadata=metadata, **kw)
