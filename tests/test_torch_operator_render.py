"""The port's operand manifests against the reference's.

Every operand state renders, with the reference's golden ``SPEC`` mapped
to the port's CR, the objects the reference renders with ``SPEC`` after
the one mapping (tests/test_torch_operator_mapping.py): the same objects,
kinds, order, selectors, volumes, probes, security contexts and
init-container chain. The port's own byte-exact goldens live in
tests/golden_torch/states/ (``UPDATE_GOLDEN=1`` regenerates them). The
port reads its rendered text with its own YAML subset, which must read
every manifest as ``yaml.safe_load`` does, and refuse what lies outside.
"""

import copy
import os

import pytest
import yaml

from test_golden_states import SPEC
from test_torch_operator_mapping import map_object, map_spec
from tpu_operator.api.clusterpolicy import ClusterPolicy as RefPolicy
from tpu_operator.api.clusterpolicy import new_cluster_policy as ref_new_policy
from tpu_operator.state.operands import cluster_policy_states as ref_states
from tpu_operator_torch import consts, yamlsubset
from tpu_operator_torch.api.clusterpolicy import ClusterPolicy, new_cluster_policy
from tpu_operator_torch.render import Renderer, RenderError
from tpu_operator_torch.state.operands import OPERAND_DAG, cluster_policy_states

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden_torch", "states")
NS = "tpu-operator"


def _states(factory):
    return [s for s in factory(client=None) if hasattr(s, "render_data")]


def _render(state, policy):
    if state.name == "pre-requisites":
        return state.renderer.render_objects({"namespace": NS})
    return state.render_objects(policy, NS)


def _port_policy(spec=None):
    return ClusterPolicy.from_obj(new_cluster_policy(spec=map_spec(spec or SPEC)))


def _ref_policy(spec=None):
    return RefPolicy.from_obj(ref_new_policy(spec=copy.deepcopy(spec or SPEC)))


PORT_STATES = {s.name: s for s in _states(cluster_policy_states)}
REF_STATES = {s.name: s for s in _states(ref_states)}


def test_the_port_renders_every_state_the_reference_renders():
    assert list(PORT_STATES) == list(REF_STATES)
    assert [s.name for s in cluster_policy_states(client=None)] == \
        [s.name for s in ref_states(client=None)]


@pytest.mark.parametrize("name", list(REF_STATES))
def test_render_matches_reference_after_mapping(name):
    ref = _render(REF_STATES[name], _ref_policy())
    port = _render(PORT_STATES[name], _port_policy())
    assert [(o["kind"], o["metadata"]["name"]) for o in port] == \
        [(o["kind"], o["metadata"]["name"]) for o in map(map_object, ref)]
    for want, got in zip(map(map_object, ref), port):
        assert got == want


@pytest.mark.parametrize("name", list(REF_STATES))
def test_golden_state_render(name):
    """Byte-exact goldens of the port's own renders."""
    text = yaml.safe_dump_all(_render(PORT_STATES[name], _port_policy()), sort_keys=True)
    path = os.path.join(GOLDEN_DIR, f"{name}.yaml")
    if os.environ.get("UPDATE_GOLDEN"):
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    with open(path) as f:
        assert text == f.read(), f"golden mismatch for {name}; UPDATE_GOLDEN=1 to regenerate"


VARIANTS = {
    "bare-metal host paths": {"hostPaths": {"validationStatusDir": "/srv/gpu/validations",
                                            "libtpuInstallDir": "/srv/driver",
                                            "partitionHandoffDir": "/srv/gpu/handoff"}},
    "driver owned by the platform": {"driver": {"enabled": False}},
    "revalidation off, serving continuous": {
        "validator": {"revalidateIntervalS": 0},
        "serving": {"enabled": True, "probeIntervalS": 60, "batchSizes": [1, 2]}},
    "tolerations, pod metadata, resources": {
        "daemonsets": {"tolerations": [{"key": "dedicated", "operator": "Equal",
                                        "value": "gpu", "effect": "NoSchedule"}],
                       "labels": {"team": "ml"}, "annotations": {"a": "b"},
                       "updateStrategy": "OnDelete"},
        "validator": {"resources": {"limits": {"memory": "1Gi"}},
                      "env": [{"name": "X", "value": "1"}]},
        "operator": {"runtimeClass": "nvidia",
                     "initContainer": {"image": "waiter", "version": "2"}}},
    "plugin and telemetry configs": {
        "devicePlugin": {"config": {"name": "plugin-cfg", "default": "a.yaml"},
                         "builtinPlugin": True},
        "telemetry": {"config": {"name": "metrics-cfg"},
                      "serviceMonitor": {"interval": "15s"}},
        "slicePartitioner": {"config": {"name": "parts"}}},
    "cdi and a driver version": {"cdi": {"enabled": True, "default": True},
                                 "driver": {"libtpuVersion": "550.1"}},
}


def _variant(overlay):
    spec = copy.deepcopy(SPEC)
    for key, value in overlay.items():
        spec[key] = {**spec.get(key, {}), **value}
    return spec


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variants_match_reference_after_mapping(variant):
    """The spec's knobs reach the port's objects as the reference's."""
    spec = _variant(VARIANTS[variant])
    for name in REF_STATES:
        ref = [map_object(o) for o in _render(REF_STATES[name], _ref_policy(spec))]
        port = _render(PORT_STATES[name], _port_policy(spec))
        assert port == ref, f"{variant}: {name}"


def _rendered_texts(spec=None):
    policy = _port_policy(spec)
    for name, state in PORT_STATES.items():
        data = {"namespace": NS} if name == "pre-requisites" else state.render_data(policy, NS)
        for template in state.renderer.template_files():
            yield f"{name}/{template}", state.renderer.render_text(template, data)


@pytest.mark.parametrize("variant", [None] + list(VARIANTS))
def test_the_subset_reads_every_manifest_as_pyyaml_does(variant):
    spec = None if variant is None else _variant(VARIANTS[variant])
    for label, text in _rendered_texts(spec):
        assert yamlsubset.parse_all(text) == \
            [d for d in yaml.safe_load_all(text) if d is not None], label


@pytest.mark.parametrize("text", [
    "a: {b: c}\n",                 # a flow mapping
    "a: [b, [c]]\n",               # a nested flow sequence
    "a: [b, {c: d}]\n",
    "a: |\n  text\n",              # block scalars
    "a: >-\n  folded\n",
    "a: &x 1\nb: *x\n",            # anchors and aliases
    "a: !!str 1\n",                # tags
    "a: [b, c\n",                  # an unclosed flow sequence
    "a: 0x1F\n",                   # a scalar PyYAML reads otherwise
    "%YAML 1.1\n---\na: 1\n",      # directives
])
def test_text_outside_the_subset_raises(text):
    with pytest.raises(yamlsubset.SubsetError):
        yamlsubset.parse_all(text)


@pytest.mark.parametrize("text", [
    "args: [-c, driver, '--x=a b', 5]\n",
    "exclude: [a, \"b c\", yes, 1.5, null]  # trailing comment\ninclude: [] # none\n",
    "- [x, y]\n- z\n",
])
def test_one_document_reads_flow_sequences_as_a_manifest_does(text):
    """A ConfigMap's text (:func:`parse`) and a rendered manifest
    (:func:`parse_all`) go through the one reader, as PyYAML reads both."""
    assert yamlsubset.parse(text) == yaml.safe_load(text)
    assert yamlsubset.parse_all(text) == [yaml.safe_load(text)]


@pytest.mark.parametrize("value", [
    {"a": [1, 2.5, None, True, "x: y", "#z", ""], "b": {}, "c": [], "d": 1e20},
    [{"name": "X", "valueFrom": {"fieldRef": {"fieldPath": "spec.nodeName"}}}],
    {"true": "yes", "0x1": "on", "k/v.w": "-c"},
])
def test_toyaml_writes_what_both_readers_read_back(value):
    for indent in (0, 4):
        text = yamlsubset.dump(value, indent)
        assert yamlsubset.parse(text) == value == yaml.safe_load(text)


def test_a_missing_template_value_fails_the_render():
    state = PORT_STATES["state-driver"]
    data = state.render_data(_port_policy(), NS)
    del data["driver"]["driver_version"]
    with pytest.raises(RenderError, match="driver_version"):
        state.renderer.render_file("0500_daemonset.yaml", data)


def test_text_outside_the_subset_fails_the_render(tmp_path):
    (tmp_path / "0100_x.yaml").write_text("apiVersion: v1\nkind: ConfigMap\ndata: |\n  x\n")
    with pytest.raises(RenderError, match="outside the YAML subset"):
        Renderer(str(tmp_path)).render_objects({})


def test_every_template_wait_is_a_declared_dag_parent():
    """The init-container waits a template renders are exactly the state's
    OPERAND_DAG parents, which are the reference's."""
    from tpu_operator.state.operands import OPERAND_DAG as REF_DAG

    assert OPERAND_DAG == REF_DAG
    policy = _port_policy()
    for name, state in PORT_STATES.items():
        if name == "pre-requisites":
            continue
        waits = [c["args"][2].split("=", 1)[1]
                 for o in _render(state, policy) if o["kind"] == "DaemonSet"
                 for c in o["spec"]["template"]["spec"].get("initContainers", [])
                 if c["args"][:2] == ["-c", "wait"]]
        assert tuple(waits) == OPERAND_DAG.get(name, ()), name


def test_the_manifests_state_no_tpu_numbers_and_run_the_port():
    """Every container runs the port's validator, every DaemonSet tolerates
    and every limit names nvidia.com/gpu, and the validator's comments
    carry the card's prewarm numbers, not a TPU's."""
    policy = _port_policy()
    for name, state in PORT_STATES.items():
        for obj in _render(state, policy):
            if obj["kind"] != "DaemonSet":
                continue
            pod = obj["spec"]["template"]["spec"]
            assert pod["tolerations"][0]["key"] == consts.GPU_RESOURCE_NAME
            for c in pod.get("initContainers", []) + pod["containers"]:
                assert c["command"] == ["gpu-validator"], (name, c["name"])
    template = os.path.join(os.path.dirname(consts.__file__), "manifests",
                            "state-operator-validation", "0500_daemonset.yaml")
    text = open(template).read()
    assert "0.61 s" not in text and "2.04 s cold, 0.0041 s warm" in text
    assert "NVIDIA H100 80GB HBM3" in text


def test_revalidation_off_reaches_the_validator(monkeypatch):
    """Deliberate difference: with ``revalidateIntervalS: 0`` the reference
    renders no interval env, and its CLI's default of 300 turns the sweep
    back on; the port renders 0, which its CLI reads as off."""
    from tpu_operator.validator.main import build_parser as ref_cli
    from tpu_operator_torch.validator.main import build_parser as port_cli

    spec = _variant({"validator": {"revalidateIntervalS": 0}})
    [ref_ds] = [o for o in _render(REF_STATES["state-operator-validation"], _ref_policy(spec))
                if o["kind"] == "DaemonSet"]
    [port_ds] = [o for o in _render(PORT_STATES["state-operator-validation"],
                                    _port_policy(spec)) if o["kind"] == "DaemonSet"]
    ref_env = {e["name"]: e.get("value")
               for e in ref_ds["spec"]["template"]["spec"]["containers"][0]["env"]}
    port_env = {e["name"]: e.get("value")
                for e in port_ds["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert "TPU_REVALIDATE_INTERVAL" not in ref_env
    assert port_env["GPU_REVALIDATE_INTERVAL"] == "0"
    monkeypatch.delenv("TPU_REVALIDATE_INTERVAL", raising=False)
    assert ref_cli().parse_args(["-c", "sleep"]).revalidate_interval == 300.0
    monkeypatch.setenv("GPU_REVALIDATE_INTERVAL", port_env["GPU_REVALIDATE_INTERVAL"])
    assert port_cli().parse_args(["-c", "sleep"]).revalidate_interval == 0.0
