"""The twin of tests/test_schema_fuzz.py: specs drawn from the port's
generated CRD schemas (``tpu_operator_torch/api/schema_gen.py``) with the
reference's ``strategy_for`` must validate clean, round-trip through the
port's typed ``ClusterPolicySpec`` and ``GPUDriverSpec`` schema-valid, and
keep every schema-known key; 40 examples each, no deadline, as the
reference's.

One parity case beside them: a fixed-seed (derandomized) draw from each
port schema, and a copy of it with one constrained field given a value of
the wrong type, mapped to the reference's names (``driverVersion`` is the
reference's ``libtpuVersion``, ``driverInstallDir`` its
``libtpuInstallDir``; tests/test_torch_operator_mapping.py:map_spec is the
other direction), must get the same verdict and the same number of errors
from both packages' ``schema_validate`` against their own schemas.
"""

import copy

import pytest

pytest.importorskip("hypothesis")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from test_schema_fuzz import strategy_for  # noqa: E402
from test_torch_operator_mapping import map_spec  # noqa: E402
from tpu_operator.api import schema_gen as ref_gen  # noqa: E402
from tpu_operator.api import schema_validate as ref_validate  # noqa: E402
from tpu_operator_torch.api import schema_gen, schema_validate  # noqa: E402
from tpu_operator_torch.api.clusterpolicy import ClusterPolicySpec  # noqa: E402
from tpu_operator_torch.api.gpudriver import GPUDriverSpec  # noqa: E402


def _spec_schema(crd):
    return crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]["spec"]


CP_SPEC_SCHEMA = _spec_schema(schema_gen.clusterpolicy_crd())
GD_SPEC_SCHEMA = _spec_schema(schema_gen.gpudriver_crd())
REF_CP_SPEC_SCHEMA = _spec_schema(ref_gen.clusterpolicy_crd())
REF_TD_SPEC_SCHEMA = _spec_schema(ref_gen.tpudriver_crd())

FUZZ_SETTINGS = settings(max_examples=40, deadline=None,
                         suppress_health_check=[HealthCheck.too_slow])


@given(spec=strategy_for(CP_SPEC_SCHEMA))
@FUZZ_SETTINGS
def test_clusterpolicy_spec_roundtrip(spec):
    assert schema_validate.validate(spec, CP_SPEC_SCHEMA, "spec") == []
    rendered = ClusterPolicySpec.from_dict(spec).to_dict()
    errors = schema_validate.validate(rendered, CP_SPEC_SCHEMA, "spec")
    assert errors == [], (spec, rendered, errors)
    for section, content in spec.items():
        assert section in rendered or content in (None, {}, []), section


@given(spec=strategy_for(GD_SPEC_SCHEMA))
@FUZZ_SETTINGS
def test_gpudriver_spec_roundtrip(spec):
    assert schema_validate.validate(spec, GD_SPEC_SCHEMA, "spec") == []
    rendered = GPUDriverSpec.from_dict(spec).to_dict()
    errors = schema_validate.validate(rendered, GD_SPEC_SCHEMA, "spec")
    assert errors == [], (spec, rendered, errors)
    for section, content in spec.items():
        assert section in rendered or content in (None, {}, []), section


#: the port's field names -> the reference's (the inverse of map_spec's)
TO_REFERENCE_KEYS = {"driverVersion": "libtpuVersion", "driverInstallDir": "libtpuInstallDir"}


def to_reference(value):
    """A port spec with the reference's field names."""
    if isinstance(value, dict):
        return {TO_REFERENCE_KEYS.get(k, k): to_reference(v) for k, v in value.items()}
    if isinstance(value, list):
        return [to_reference(v) for v in value]
    return value


def _constrained_leaves(value, schema, path=()):
    """Paths in ``value`` whose schema fixes a type, an enum or a union."""
    out = []
    if path and ("type" in schema or "enum" in schema or "anyOf" in schema):
        out.append((path, schema))
    if isinstance(value, dict):
        props = schema.get("properties") or {}
        for key, sub in value.items():
            if key in props:
                out += _constrained_leaves(sub, props[key], path + (key,))
    return out


def corrupt(spec, schema, rnd):
    """A copy of ``spec`` with one constrained field of the wrong type: a
    mapping where a scalar belongs, a string where an object or an array
    does; an empty spec gets a string for its first section."""
    out = copy.deepcopy(spec)
    leaves = _constrained_leaves(out, schema)
    if not leaves:
        out[sorted(schema["properties"])[0]] = "x"
        return out
    path, sub = rnd.choice(leaves)
    target = out
    for key in path[:-1]:
        target = target[key]
    target[path[-1]] = "x" if sub.get("type") in ("object", "array") else {"wrong": 1}
    return out


@given(cp=strategy_for(CP_SPEC_SCHEMA), gd=strategy_for(GD_SPEC_SCHEMA),
       rnd=st.randoms(use_true_random=False))
@settings(max_examples=40, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
def test_a_fixed_seed_draw_gets_the_same_verdict_from_both_packages(cp, gd, rnd):
    assert map_spec(to_reference(cp)) == cp
    for spec, port_schema, ref_schema in ((cp, CP_SPEC_SCHEMA, REF_CP_SPEC_SCHEMA),
                                          (gd, GD_SPEC_SCHEMA, REF_TD_SPEC_SCHEMA)):
        for candidate, valid in ((spec, True), (corrupt(spec, port_schema, rnd), False)):
            port_errors = schema_validate.validate(candidate, port_schema, "spec")
            ref_errors = ref_validate.validate(to_reference(candidate), ref_schema, "spec")
            assert (port_errors == []) is valid, (candidate, port_errors)
            assert (ref_errors == []) is valid, (candidate, ref_errors)
            assert len(port_errors) == len(ref_errors), (candidate, port_errors, ref_errors)
