"""Static checks of tests/e2e-kind-gpu.sh (the twin of
tests/test_e2e_kind_script.py): it runs only where kind, docker and kubectl
exist, but its embedded manifests are checked here against the port's
generated schema, and its stub node against the port's driver paths and
device globs, so CI does not find a typo at cluster start-up cost.
"""

import fnmatch
import json
import os
import re
import shlex
import subprocess

import yaml

from tpu_operator_torch import consts
from tpu_operator_torch.api import schema_gen, schema_validate
from tpu_operator_torch.validator.driver import HOST_DRIVER_PATHS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "e2e-kind-gpu.sh")

HEREDOC = re.compile(r"<<'EOF'[^\n]*\n(.*?)\nEOF", re.DOTALL)


def heredocs():
    with open(SCRIPT) as f:
        return HEREDOC.findall(f.read())


def docs():
    out = []
    for block in heredocs():
        out.extend(d for d in yaml.safe_load_all(block) if isinstance(d, dict))
    return out


def _policy(name):
    [cp] = [d for d in docs() if d.get("kind") == "ClusterPolicy"
            and d["metadata"]["name"] == name]
    return cp


def _prep_paths():
    ds = next(d for d in docs() if d.get("kind") == "DaemonSet")
    ctr = ds["spec"]["template"]["spec"]["containers"][0]
    assert ctr["securityContext"]["privileged"] is True
    words = shlex.split(" ".join(ctr["args"]).replace("&&", " "))
    return {w[len("/host"):] for w in words if w.startswith("/host/")}


def test_embedded_yaml_parses():
    kinds = [d.get("kind") for d in docs()]
    assert kinds.count("ClusterPolicy") == 2
    assert "DaemonSet" in kinds  # node-prep


def test_good_clusterpolicy_passes_schema():
    assert schema_validate.validate_cr(_policy("cluster-policy"),
                                       schema_gen.clusterpolicy_crd()) == []


def test_typo_clusterpolicy_fails_schema():
    """The negative case must be schema-invalid, or the step that expects
    the apiserver's refusal tests nothing."""
    errors = schema_validate.validate_cr(_policy("typo-policy"), schema_gen.clusterpolicy_crd())
    assert any("unknown field" in e for e in errors), errors


def test_the_stub_driver_libraries_land_where_the_driver_looks():
    paths = _prep_paths()
    libcuda = HOST_DRIVER_PATHS[0]
    assert libcuda in paths
    assert os.path.join(os.path.dirname(libcuda), "libnvidia-ml.so.1") in paths
    with open(SCRIPT) as f:
        text = f.read()
    # ELF magic: the driver's host check reads the first four bytes
    assert text.count("printf '\\177ELF") == 2


def test_the_stub_devices_match_the_policy_s_device_globs():
    devices = sorted(p for p in _prep_paths() if p.startswith("/dev/"))
    globs = _policy("cluster-policy")["spec"]["hostPaths"]["devGlobs"]
    assert globs == list(consts.GPU_DEV_GLOBS)
    matched = [d for d in devices if any(fnmatch.fnmatch(d, g) for g in globs)]
    assert matched == ["/dev/nvidia0", "/dev/nvidia1"]  # nvidiactl is no GPU


def test_the_stub_adopts_the_host_driver_and_plugin():
    """driver off (the fake libcuda adopted), the device plugin left to the
    operator's auto-adoption of the capacity the script advertises, and the
    components that need NVML or CUDA off."""
    spec = _policy("cluster-policy")["spec"]
    assert spec["driver"] == {"enabled": False}
    assert "devicePlugin" not in spec
    for component in ("featureDiscovery", "telemetry", "validator"):
        assert spec[component] == {"enabled": False}
    with open(SCRIPT) as f:
        text = f.read()
    assert '"path":"/status/capacity/nvidia.com~1gpu"' in text
    assert text.index("--subresource=status") < text.index("name: cluster-policy")


def test_status_is_the_port_s_tool_and_the_names_are_the_port_s():
    with open(SCRIPT) as f:
        text = f.read()
    assert "python3 -m tpu_operator_torch.cmd.cfg status" in text
    assert "deploy/gpu-operator.yaml" in text and "deployment/gpu-operator" in text
    assert "ds gpu-node-status-exporter" in text
    for word in ("tpu_operator.", "tpu_operator/", "tpuop-", "google.com/tpu"):
        assert word not in text


def test_the_script_skips_without_its_tools(tmp_path):
    record = tmp_path / "skip.json"
    env = dict(os.environ, PATH="/usr/bin:/bin", KIND_SKIP_RECORD=str(record))
    proc = subprocess.run(["bash", SCRIPT], env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 77, proc.stdout + proc.stderr
    assert json.loads(record.read_text())["skipped"] is True


def test_script_syntax():
    assert subprocess.run(["bash", "-n", SCRIPT]).returncode == 0
