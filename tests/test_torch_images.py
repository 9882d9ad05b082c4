"""The port's images, their multi-arch build and its CI workflow, checked
statically (no docker, no network here): docker/gpu-operator.Dockerfile,
docker/gpu-validator.Dockerfile, multi-arch-gpu.mk and
.github/workflows/ci-gpu.yaml (the counterparts of docker/Dockerfile,
docker/validator.Dockerfile, multi-arch.mk and the lanes of ci.yaml).
"""

import os
import pathlib
import re
import shlex
import subprocess
import tomllib

import pytest
import yaml

from tpu_operator_torch import yamlsubset

REPO = pathlib.Path(__file__).resolve().parent.parent
DOCKERFILES = {"gpu-operator": REPO / "docker" / "gpu-operator.Dockerfile",
               "gpu-validator": REPO / "docker" / "gpu-validator.Dockerfile"}
WORKFLOW = REPO / ".github" / "workflows" / "ci-gpu.yaml"


def _instructions(path):
    """(instruction, arguments) per logical line of a Dockerfile."""
    text = re.sub(r"\\\n", " ", path.read_text())
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            word, _, rest = line.partition(" ")
            out.append((word.upper(), rest.strip()))
    return out


def _scripts():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


@pytest.mark.parametrize("image", DOCKERFILES)
def test_every_copy_source_exists(image):
    copies = [shlex.split(args)[:-1] for word, args in _instructions(DOCKERFILES[image])
              if word == "COPY"]
    assert copies
    for sources in copies:
        for src in sources:
            assert (REPO / src).exists(), f"{image}: COPY {src} does not exist"


@pytest.mark.parametrize("image", DOCKERFILES)
def test_the_entrypoint_is_the_port_s_console_script(image):
    [entry] = [args for word, args in _instructions(DOCKERFILES[image]) if word == "ENTRYPOINT"]
    assert entry == f'["{image}"]'
    assert _scripts()[image].startswith("tpu_operator_torch.")


@pytest.mark.parametrize("image", DOCKERFILES)
def test_no_image_copies_the_reference(image):
    text = DOCKERFILES[image].read_text()
    assert not re.search(r"\btpu_operator/", text)
    assert "tpu_operator." not in text and "tpuop-" not in text


@pytest.mark.parametrize("image", DOCKERFILES)
def test_every_base_image_is_tagged(image):
    args = dict(a.split("=", 1) for word, a in _instructions(DOCKERFILES[image])
                if word == "ARG" and "=" in a)
    for word, base in _instructions(DOCKERFILES[image]):
        if word == "FROM":
            base = re.sub(r"\$\{(\w+)\}", lambda m: args[m[1]], base.split()[0])
            name, _, tag = base.rpartition(":")
            assert name and tag and tag != "latest", base


def test_the_operator_image_is_control_plane_only():
    runs = [args for word, args in _instructions(DOCKERFILES["gpu-operator"]) if word == "RUN"]
    assert runs[0] == "pip install --no-cache-dir jinja2"
    assert not any("torch" in run or "cuda" in run for run in runs)
    assert "COPY hack/gpu-must-gather.sh /usr/bin/gather" in DOCKERFILES["gpu-operator"].read_text()


def test_the_validator_image_builds_nvcc_and_the_native_binaries_in():
    text = DOCKERFILES["gpu-validator"].read_text()
    assert re.search(r"nvidia/cuda:[\d.]+-devel-", text)  # nvcc for the kernels
    assert '"torch==${TORCH_VERSION}"' in text
    assert "make -C tpu_operator_torch/native BUILD=" in text
    for binary in ("gpu-probe", "gpu-exporter"):
        assert f"/usr/local/bin/{binary}" in text


def test_the_image_names_agree_with_the_chart_and_the_static_install():
    values = yamlsubset.parse((REPO / "deployments" / "gpu-operator" / "values.yaml").read_text())
    operator_image = values["operator"]["image"]
    repository, operand = values["driver"]["repository"], values["driver"]["image"]
    assert operator_image == f"{repository}/gpu-operator"
    assert operand == "gpu-validator"
    version = values["operator"]["version"]
    static = (REPO / "deploy" / "gpu-operator.yaml").read_text()
    assert f"image: {operator_image}:{version}" in static
    out = _make("build-all-multiarch")
    assert f"-t {operator_image}:{version} ." in out
    assert f"-t {repository}/{operand}:{version} ." in out


def _make(target):
    result = subprocess.run(["make", "-n", "-f", "multi-arch-gpu.mk", target], cwd=REPO,
                            capture_output=True, text=True)
    assert result.returncode == 0, result.stderr
    return result.stdout


def test_multi_arch_gpu_mk():
    """The operator image for amd64 and arm64 (a mixed cluster's control
    plane), the validator for amd64 only (its CUDA payload)."""
    out = _make("build-all-multiarch")
    assert out.count("docker buildx build") == 2
    operator, validator = out.split("docker buildx build")[1:]
    assert "--platform=linux/amd64,linux/arm64" in operator
    assert "-f docker/gpu-operator.Dockerfile" in operator
    assert re.search(r"--platform=linux/amd64\s", validator)
    assert "arm64" not in validator
    assert "-f docker/gpu-validator.Dockerfile" in validator


def _workflow():
    return yaml.safe_load(WORKFLOW.read_text())


def _runs():
    return [step["run"] for job in _workflow()["jobs"].values()
            for step in job["steps"] if "run" in step]


def test_the_workflow_has_the_port_s_lanes():
    assert set(_workflow()["jobs"]) == {"unit-test", "validate-samples", "native", "helm-lint",
                                        "image-build", "kind-e2e", "envtest-e2e"}
    runs = "\n".join(_runs())
    assert "tests/test_torch_*.py" in runs
    assert "bash tests/e2e-kind-gpu.sh || [ $? -eq 77 ]" in runs
    assert "bash tests/e2e-envtest-gpu.sh || [ $? -eq 77 ]" in runs
    unit = _workflow()["jobs"]["unit-test"]["steps"]
    assert all(s.get("env", {}).get("JAX_PLATFORMS") == "cpu"
               for s in unit if s.get("run", "").startswith("python -m pytest")
               or "end-to-end" in s.get("run", ""))


def test_every_file_the_workflow_runs_exists():
    runs = "\n".join(_runs())
    paths = set(re.findall(r"\bbash (\S+\.sh)", runs))
    paths |= set(re.findall(r"-f (docker/\S+)", runs))
    paths |= set(re.findall(r"make -C (\S+)", runs))
    paths |= set(re.findall(r"helm lint (\S+)", runs))
    paths |= {p for p in re.findall(r"(\S+\.(?:json|yaml))\b", runs) if "*" not in p
              and not p.startswith("/")}
    assert len(paths) >= 8
    for path in paths:
        assert (REPO / path).exists(), path
    for module in re.findall(r"python -m (tpu_operator_torch[\w.]*)", runs):
        assert (REPO / (module.replace(".", os.sep) + ".py")).exists(), module
    for pattern in re.findall(r"(\S*\*\S*\.(?:py|json))", runs):
        assert list(REPO.glob(pattern)), pattern


def test_the_workflow_runs_the_port_only():
    runs = "\n".join(_runs())
    assert "tpu_operator." not in runs and "tpuop-" not in runs
    assert "docker/Dockerfile" not in runs and "tests/e2e-kind.sh" not in runs


# -- the real-hardware lane (checked statically only) ---------------------------------

HARDWARE_SCRIPTS = [REPO / "tests" / "ci-run-e2e-gpu.sh",
                    REPO / "tests" / "scripts" / "torch" / "verify-real-cluster.sh"]


@pytest.mark.parametrize("path", HARDWARE_SCRIPTS, ids=lambda p: p.name)
def test_the_hardware_lane_parses(path):
    assert subprocess.run(["bash", "-n", str(path)]).returncode == 0


def test_the_hardware_environment_is_one_h100_pool():
    env = yaml.safe_load((REPO / "tests" / "gpu-ci.yaml").read_text())
    [pool] = env["spec"]["gpuPools"]
    assert (pool["accelerator"], pool["count"], pool["nodes"]) == ("nvidia-h100-80gb", 1, 1)
    script = HARDWARE_SCRIPTS[0].read_text()
    assert f"--machine-type {pool['machineType']}" in script
    assert f"type={pool['accelerator']},count={pool['count']}" in script
    assert env["metadata"]["name"] == env["spec"]["cluster"]["name"]
    assert f"CLUSTER={env['spec']['cluster']['name']}" in script


def test_every_job_of_the_hardware_environment_runs_a_file_that_exists():
    env = yaml.safe_load((REPO / "tests" / "gpu-ci.yaml").read_text())
    for job in env["spec"]["jobs"]:
        words = shlex.split(job["command"])
        if words[:2] == ["python", "-m"] and words[2].startswith("tpu_operator_torch"):
            assert (REPO / (words[2].replace(".", os.sep) + ".py")).exists(), job
        else:
            assert any((REPO / w).exists() for w in words[1:]), job


def test_the_helm_sets_name_the_chart_s_values():
    values = yamlsubset.parse((REPO / "deployments" / "gpu-operator" / "values.yaml").read_text())
    script = HARDWARE_SCRIPTS[0].read_text()
    assert 'helm install gpu-operator "${REPO_ROOT}/deployments/gpu-operator"' in script
    keys = set(re.findall(r'--set "(\w+)\.(\w+)=', script))
    [loop] = re.findall(r"for component in ([\w ]+); do", script)
    keys |= {(c, k) for c in loop.split() for k in ("repository", "image", "version")}
    assert len(keys) > 10
    for section, key in keys:
        assert key in values[section], f"{section}.{key} is not in values.yaml"


def test_the_verification_waits_for_the_port_s_daemonsets_and_barriers():
    from test_torch_operator_mapping import LANE_DAEMONSETS

    text = HARDWARE_SCRIPTS[1].read_text()
    [names] = re.findall(r"for ds in ([\w\s\\-]+); do", text)
    assert names.replace("\\", " ").split() == list(LANE_DAEMONSETS.values())
    assert "-l app=gpu-operator-validator" in text
    assert "for barrier in driver-ready plugin-ready workload-ready" in text
    for path in HARDWARE_SCRIPTS:
        body = path.read_text()
        assert "tpuop-" not in body and "google.com/tpu" not in body
        assert "tpu_operator." not in body and "tpu_operator/" not in body
