"""The port's shipped samples, ``config/gpu/samples/``: the counterparts of
the reference's ``config/samples/`` (its ``make validate-samples``).

Each sample reads with the port's own YAML reader (PyYAML blocked) as PyYAML
reads it, passes ``gpuop-cfg validate`` and the port's schema admission; the
default and the GPUDriver samples are the package's JSON samples
(``tpu_operator_torch/manifests/samples/``, which phases 12-13, the chart and
cfgtool tests and the shell e2e read), so the two cannot drift; each reference
sample maps onto its port sample through tests/test_torch_operator_mapping.py
(``map_config_sample``); and the bare-metal sample's host paths reach every
DaemonSet the port renders, as tests/test_torch_host_paths.py checks for a CR
built in code.
"""

import copy
import json
import os
import subprocess
import sys

import pytest
import yaml

from test_torch_operator_mapping import CONFIG_SAMPLES, map_config_sample
from tpu_operator_torch import consts, yamlsubset
from tpu_operator_torch.api.clusterpolicy import ClusterPolicy
from tpu_operator_torch.cfgtool.main import run
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.client.errors import InvalidError
from tpu_operator_torch.state.operands import cluster_policy_states

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SAMPLES = os.path.join(REPO, "config", "gpu", "samples")
REF_SAMPLES = os.path.join(REPO, "config", "samples")
PACKAGE_SAMPLES = os.path.join(REPO, "tpu_operator_torch", "manifests", "samples")
#: a YAML sample -> the package's JSON sample it must equal
PACKAGE_TWINS = {"v1_clusterpolicy.yaml": "v1_clusterpolicy.json",
                 "v1alpha1_gpudriver.yaml": "v1alpha1_gpudriver.json"}
BAREMETAL = "v1_clusterpolicy_baremetal.yaml"
NS = consts.DEFAULT_NAMESPACE


def _text(name: str) -> str:
    with open(os.path.join(PORT_SAMPLES, name)) as f:
        return f.read()


def _sample(name: str) -> dict:
    return yamlsubset.parse(_text(name))


def test_the_samples_are_the_reference_s_three():
    assert sorted(os.listdir(PORT_SAMPLES)) == sorted(CONFIG_SAMPLES.values())
    assert sorted(os.listdir(REF_SAMPLES)) == sorted(CONFIG_SAMPLES)


def test_the_samples_read_with_pyyaml_blocked():
    script = ("import json, os, sys\n"
              "sys.modules['yaml'] = None\n"
              "from tpu_operator_torch import yamlsubset\n"
              "d = sys.argv[1]\n"
              "print(json.dumps({n: yamlsubset.parse(open(os.path.join(d, n)).read())\n"
              "                  for n in sorted(os.listdir(d))}))\n")
    out = subprocess.run([sys.executable, "-c", script, PORT_SAMPLES], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    read = json.loads(out.stdout)
    assert read == {n: yaml.safe_load(_text(n)) for n in CONFIG_SAMPLES.values()}


@pytest.mark.parametrize("name", sorted(CONFIG_SAMPLES.values()))
def test_a_sample_validates_and_is_admitted(name, capsys):
    path = os.path.join(PORT_SAMPLES, name)
    assert run(["validate", path]) == 0
    assert capsys.readouterr().out.strip().endswith(": OK")
    client = FakeClient()
    doc = _sample(name)
    stored = client.create(copy.deepcopy(doc))
    assert stored["spec"] == client.get(doc["apiVersion"], doc["kind"],
                                        doc["metadata"]["name"])["spec"]
    # the admission that took it is live: a typo'd key is refused
    typo = copy.deepcopy(doc)
    typo["metadata"]["name"] += "-typo"
    typo["spec"]["repositry"] = "registry.example.com"
    with pytest.raises(InvalidError):
        client.create(typo)


@pytest.mark.parametrize("name", sorted(PACKAGE_TWINS))
def test_a_yaml_sample_is_the_package_s_json_sample(name):
    with open(os.path.join(PACKAGE_SAMPLES, PACKAGE_TWINS[name])) as f:
        assert _sample(name) == json.load(f)


@pytest.mark.parametrize("ref", sorted(CONFIG_SAMPLES))
def test_each_reference_sample_maps_onto_the_port_s(ref):
    with open(os.path.join(REF_SAMPLES, ref)) as f:
        want = map_config_sample(yaml.safe_load(f))
    assert _sample(CONFIG_SAMPLES[ref]) == want


def test_the_bare_metal_sample_keeps_the_reference_s_comment_in_gpu_terms():
    with open(os.path.join(REF_SAMPLES, BAREMETAL)) as f:
        ref = [line for line in f.read().splitlines() if line.startswith("#")]
    port = [line for line in _text(BAREMETAL).splitlines() if line.startswith("#")]
    assert len(port) == len(ref)
    assert [line.replace("GPU", "chip") for line in port] == ref


def _render(policy: ClusterPolicy) -> list:
    objs = []
    for state in cluster_policy_states(client=None):
        if hasattr(state, "render_objects"):
            objs += state.render_objects(policy, NS)
    return objs


def test_the_bare_metal_sample_s_host_paths_reach_every_daemonset(monkeypatch):
    # the opt-in partitioner and serving probe render too; their images
    # come from the operator's env, as the chart's Deployment sets it
    for env in ("SLICE_PARTITIONER_IMAGE", "VALIDATOR_IMAGE"):
        monkeypatch.setenv(env, "registry.example.com/gpu-operator/gpu-validator:0.1.0")
    cp = _sample(BAREMETAL)
    host = cp["spec"]["hostPaths"]
    policy = ClusterPolicy.from_obj(cp)
    objs = _render(policy)
    text = yaml.dump_all(objs)
    assert consts.VALIDATION_STATUS_DIR not in text
    assert consts.DEFAULT_DRIVER_LIB_DIR + "\n" not in text
    daemonsets = {o["metadata"]["name"]: o for o in objs if o.get("kind") == "DaemonSet"}
    consumers = 0
    for name, ds in daemonsets.items():
        spec = ds["spec"]["template"]["spec"]
        for ctr in spec.get("initContainers", []) + spec["containers"]:
            mounts = {m["mountPath"] for m in ctr.get("volumeMounts", [])}
            if not any("/validations" in m for m in mounts):
                continue
            consumers += 1
            assert host["validationStatusDir"] in mounts, (name, ctr["name"])
            env = {e["name"]: e.get("value") for e in ctr.get("env", [])}
            assert (env.get("STATUS_DIR") == host["validationStatusDir"]
                    or f"--status-dir={host['validationStatusDir']}"
                    in " ".join(ctr.get("args", []))), (name, ctr["name"])
            if "STATUS_DIR" in env:
                assert env.get(consts.GPU_DEV_GLOBS_ENV) == ",".join(host["devGlobs"])
    assert consumers >= len(daemonsets)
    driver = daemonsets["gpu-driver"]
    assert f"--install-dir={host['driverInstallDir']}" in yaml.dump(driver)
    volumes = {v["name"]: v for v in driver["spec"]["template"]["spec"]["volumes"]}
    assert volumes["install-dir"]["hostPath"]["path"] == host["driverInstallDir"]
    validator = daemonsets["gpu-operator-validator"]["spec"]["template"]["spec"]["containers"]
    env = {e["name"]: e.get("value") for c in validator for e in c.get("env", [])}
    assert env["GPU_REVALIDATE_INTERVAL"] == str(cp["spec"]["validator"]["revalidateIntervalS"])
    assert policy.spec.psa.enabled
