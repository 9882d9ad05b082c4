"""The port's generated CRDs and their validator against the reference's.

After the one mapping (tests/test_torch_operator_mapping.py: the driver
kind, ``driverVersion`` and the GPU defaults; ``autoscale`` and ``migrate``
are typed as the reference's are) the port's CRDs are the
reference's, descriptions aside; every rejection case of the reference's
tests/test_schema.py gets the same verdict from both validators; the
committed CRD files are what the generator writes, read back by PyYAML and
by the port's own YAML reader; and the fake apiserver enforces them.
"""

import copy
import json
import os
import subprocess
import sys

import pytest
import yaml

from test_torch_operator_mapping import map_crd, map_driver, map_spec, strip_descriptions
from tpu_operator.api import schema_gen as ref_gen
from tpu_operator.api import schema_validate as ref_validate
from tpu_operator.api.clusterpolicy import new_cluster_policy as ref_policy
from tpu_operator.api.tpudriver import new_tpu_driver as ref_driver
from tpu_operator_torch import yamlsubset
from tpu_operator_torch.api import schema_gen, schema_validate
from tpu_operator_torch.api.clusterpolicy import ClusterPolicySpec
from tpu_operator_torch.api.gpudriver import GPUDriverSpec
from tpu_operator_torch.client import FakeClient, InvalidError
from tpu_operator_torch.testing.apiserver import MiniApiServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRD_DIR = os.path.join(REPO, "tpu_operator_torch", "api", "crds")
PAIRS = [("tpu.ai_clusterpolicies.yaml", "tpu.ai_clusterpolicies.yaml"),
         ("tpu.ai_tpudrivers.yaml", "tpu.ai_gpudrivers.yaml")]


@pytest.mark.parametrize("ref_name,port_name", PAIRS)
def test_the_crds_are_the_references_after_the_mapping(ref_name, port_name):
    ref = ref_gen.generate_crds()[ref_name]
    port = schema_gen.generate_crds()[port_name]
    assert strip_descriptions(port) == strip_descriptions(map_crd(ref))


def _described(node, path="$"):
    """Paths of every schema node that carries a description."""
    out = set()
    if isinstance(node, dict):
        if isinstance(node.get("description"), str):
            out.add(path)
        for k, v in node.items():
            out |= _described(v, f"{path}.{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            out |= _described(v, f"{path}[{i}]")
    return out


@pytest.mark.parametrize("ref_name,port_name", PAIRS)
def test_every_field_the_reference_describes_is_described(ref_name, port_name):
    """Descriptions are prose rewritten for GPUs, so they are held for
    presence: the port describes every field the reference describes."""
    ref = map_crd(ref_gen.generate_crds()[ref_name])
    port = schema_gen.generate_crds()[port_name]
    assert _described(ref) <= _described(port)


def _ref_cp(spec=None):
    return ref_policy(spec=spec)


def _port_cp(spec=None):
    obj = _ref_cp(spec)
    obj["spec"] = map_spec(obj["spec"])
    return obj


#: every rejection (and acceptance) case of tests/test_schema.py, as
#: (label, reference CR, a substring each error list must hold or None for
#: "valid"); the port's CR is the mapped reference CR
def _driver(spec):
    return ref_driver("d", spec=spec)


CASES = [
    ("typo'd field", _ref_cp({"driver": {"libtpuVerion": "x"}}), "unknown field"),
    ("bad enum", _ref_cp({"driver": {"imagePullPolicy": "Sometimes"}}), "imagePullPolicy"),
    ("bad type", _ref_cp({"driver": {"enabled": "yes"}}), "expected boolean"),
    ("minimum", _ref_cp({"telemetry": {"metricsPort": 0}}), "below minimum"),
    ("negative maxParallelUpgrades", _driver({"upgradePolicy": {"maxParallelUpgrades": -1}}),
     "below minimum"),
    ("bad quantity", _ref_cp({"driver": {"resources": {"limits": {"cpu": "not-a-quantity!"}}}}),
     "resources"),
    ("int quantity", _ref_cp({"driver": {"resources": {"limits": {"cpu": 2}}}}), None),
    ("milli quantity", _ref_cp({"driver": {"resources": {"limits": {"cpu": "500m"}}}}), None),
    ("decimal quantity", _ref_cp({"driver": {"resources": {"limits": {"cpu": "1.5"}}}}), None),
    ("bad driverType", _driver({"driverType": "vgpu"}), "driverType"),
    ("env without name", _ref_cp({"driver": {"env": [{"value": "v"}]}}), "required field missing"),
    ("unserved version", dict(_ref_cp(), apiVersion="tpu.ai/v999"), "not served"),
    ("status enum", dict(_ref_cp(), status={"state": "sort-of-ready"}), "state"),
    ("default", _ref_cp(), None),
    ("driver typo", _driver({"libtpuVerion": "x"}), "unknown field"),
    ("driver selector", _driver({"nodeSelector": {
        "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"}}), None),
    # the typed autoscale and migrate sub-specs
    ("autoscale", _ref_cp({"autoscale": {"enabled": True, "minNodes": {"default": 1},
                                         "maxNodes": {"default": 3}, "cooldownS": 15,
                                         "preemptiblePools": ["p"]}}), None),
    ("autoscale typo", _ref_cp({"autoscale": {"minNode": {"default": 1}}}), "unknown field"),
    ("autoscale negative bound", _ref_cp({"autoscale": {"maxNodes": {"default": -1}}}),
     "below minimum"),
    ("autoscale short window", _ref_cp({"autoscale": {"windowS": 5}}), "below minimum"),
    ("autoscale attainment", _ref_cp({"autoscale": {"targetSloAttainment": 2}}), "maximum"),
    ("migrate", _ref_cp({"migrate": {"enabled": True, "snapshotWaitS": 0}}), None),
    ("migrate restore wait", _ref_cp({"migrate": {"restoreWaitS": 0}}), "below minimum"),
    ("migrate bad type", _ref_cp({"migrate": {"enabled": "yes"}}), "expected boolean"),
]


def _port_cr(ref):
    if ref["kind"] == "TPUDriver":
        return map_driver(ref)
    out = copy.deepcopy(ref)
    out["spec"] = map_spec(ref.get("spec") or {})
    return out


def _crd(kind, gen):
    crds = gen.generate_crds()
    return next(c for c in crds.values() if c["spec"]["names"]["kind"] == kind)


@pytest.mark.parametrize("label,ref,needle", CASES, ids=[c[0] for c in CASES])
def test_each_case_gets_the_references_verdict(label, ref, needle):
    want = ref_validate.validate_cr(ref, _crd(ref["kind"], ref_gen))
    port = _port_cr(ref)
    got = schema_validate.validate_cr(port, _crd(port["kind"], schema_gen))
    assert bool(got) == bool(want)
    if needle is None:
        assert got == []
    else:
        assert any(needle in e for e in got), got
        assert any(needle in e for e in want), want


def test_every_spec_field_has_a_schema_and_the_defaults_validate():
    for cls, crd in ((ClusterPolicySpec, schema_gen.clusterpolicy_crd()),
                     (GPUDriverSpec, schema_gen.gpudriver_crd())):
        spec_schema = crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]["spec"]
        assert schema_validate.validate(cls().to_dict(), spec_schema, "spec") == []
        for key in cls().to_dict():
            assert key in spec_schema["properties"], key


def test_only_the_waiting_sub_specs_are_free_form():
    spec = (schema_gen.clusterpolicy_crd()["spec"]["versions"][0]["schema"]
            ["openAPIV3Schema"]["properties"]["spec"])
    shells = {name for name, sub in spec["properties"].items()
              if sub.get("x-kubernetes-preserve-unknown-fields")}
    assert shells == set()  # autoscale and migrate are typed since their controllers
    assert all(sub.get("properties") for name, sub in spec["properties"].items()
               if name not in shells)


@pytest.mark.parametrize("autoscale", [
    {"enabled": True, "minNodes": {"default": 1}, "maxNodes": {"default": 3}},
    {"minNodes": {"p": 4}, "maxNodes": {"p": 2}},
    {"minNodes": {"p": -1}},
    {"maxNodes": {"default": True}},
], ids=["bounds", "min-above-max", "negative", "boolean"])
def test_typed_autoscale_spec_validates_as_the_reference(autoscale):
    """The typed sub-specs' own checks (``ClusterPolicySpec.validate``) and
    their serde are the reference's: the same errors, the same round trip,
    the same pool bounds."""
    from tpu_operator.api.clusterpolicy import ClusterPolicySpec as RefSpec

    ref = RefSpec.from_dict({"autoscale": autoscale, "migrate": {"enabled": True}})
    port = ClusterPolicySpec.from_dict({"autoscale": autoscale, "migrate": {"enabled": True}})
    assert port.validate() == ref.validate()
    assert port.autoscale.to_dict() == ref.autoscale.to_dict()
    assert port.migrate.to_dict() == ref.migrate.to_dict()
    for pool in ("p", "q"):
        assert (port.autoscale.pool_min(pool), port.autoscale.pool_max(pool)) == \
            (ref.autoscale.pool_min(pool), ref.autoscale.pool_max(pool))


def test_schema_gen_check_passes():
    result = subprocess.run([sys.executable, "-m", "tpu_operator_torch.api.schema_gen",
                             "--check"], cwd=REPO, capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stderr


@pytest.mark.parametrize("fname", sorted(schema_gen.generate_crds()))
def test_the_committed_crds_are_the_generators_output(fname):
    with open(os.path.join(CRD_DIR, fname)) as f:
        text = f.read()
    crd = schema_gen.generate_crds()[fname]
    assert text == schema_gen.crd_yaml(crd)
    assert yaml.safe_load(text) == crd
    assert yamlsubset.parse(text) == crd


def test_check_fails_on_a_stale_file(tmp_path, monkeypatch):
    for fname, crd in schema_gen.generate_crds().items():
        (tmp_path / fname).write_text(schema_gen.crd_yaml(crd))
    monkeypatch.setattr(schema_gen, "CRD_DIR", str(tmp_path))
    assert schema_gen.main(["--check"]) == 0
    (tmp_path / "tpu.ai_gpudrivers.yaml").write_text("stale\n")
    assert schema_gen.main(["--check"]) == 1
    assert schema_gen.main(["--write"]) == 0
    assert schema_gen.main(["--check"]) == 0


# -- the fake apiserver enforces the schemas ---------------------------------------

@pytest.mark.parametrize("spec,needle", [
    ({"driverVerison": "1"}, "unknown field"),
    ({"driverType": "vgpu"}, "driverType"),
])
def test_the_fake_refuses_an_invalid_gpudriver_as_the_reference_does(spec, needle):
    ref_spec = {"libtpuVerion": "1"} if "driverVerison" in spec else spec
    from tpu_operator.client import FakeClient as RefFake
    from tpu_operator.client.errors import InvalidError as RefInvalid

    with pytest.raises(RefInvalid):
        RefFake().create(ref_driver("bad", ref_spec))
    fake = FakeClient()
    with pytest.raises(InvalidError, match=needle):
        fake.create({"apiVersion": "tpu.ai/v1alpha1", "kind": "GPUDriver",
                     "metadata": {"name": "bad"}, "spec": spec})
    assert fake.list("tpu.ai/v1alpha1", "GPUDriver") == []


def test_an_update_is_pruned_then_validated():
    fake = FakeClient()
    cr = fake.create({"apiVersion": "tpu.ai/v1", "kind": "ClusterPolicy",
                      "metadata": {"name": "cp"}, "spec": {}})
    cr["spec"]["gone"] = {"x": 1}
    cr["status"] = {"state": "ready"}
    stored = fake.update(cr)
    assert "gone" not in stored["spec"]
    stored["status"] = {"state": "sort-of-ready"}
    with pytest.raises(InvalidError, match="state"):
        fake.update_status(stored)


def test_the_mini_apiserver_answers_422_and_stores_nothing():
    import urllib.error
    import urllib.request

    srv = MiniApiServer()
    base = srv.start()
    try:
        body = json.dumps({"apiVersion": "tpu.ai/v1alpha1", "kind": "GPUDriver",
                           "metadata": {"name": "typo"},
                           "spec": {"nodeSelectr": {}}}).encode()
        req = urllib.request.Request(f"{base}/apis/tpu.ai/v1alpha1/gpudrivers", data=body,
                                     method="POST",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 422
        assert "nodeSelectr" in json.loads(e.value.read())["message"]
        assert srv.backend.list("tpu.ai/v1alpha1", "GPUDriver") == []
        assert srv.requests[("POST", "GPUDriver")] == 1
    finally:
        srv.stop()


@pytest.mark.parametrize("text", ["^(\\+|-)?[0-9]+$", "a\\b", "\\", 'q"\\n', "tab\tnl\n"])
def test_the_yaml_writer_keeps_backslashes(text):
    """The CRDs' quantity patterns hold backslashes: the subset's writer
    escapes them so that both readers read the string back (it refused
    them before, taking an escaped backslash for one it cannot read)."""
    dumped = yamlsubset.dump({"pattern": text})
    assert yamlsubset.parse(dumped) == {"pattern": text} == yaml.safe_load(dumped)


@pytest.mark.parametrize("text", ["\x01", "a\rb", "\b"])
def test_the_yaml_writer_still_refuses_what_the_reader_cannot_read(text):
    with pytest.raises(yamlsubset.SubsetError):
        yamlsubset.dump({"k": text})
