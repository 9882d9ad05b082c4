"""The last validator components on the card: NVML's link topology and
driver version, a partition of the card's GPUs advertised and allocated
through the real device plugin, the native probe on the real driver, and
an install of the host's own driver libraries. Every test here needs a
CUDA device and skips without one; run them on the card with ``python -m
pytest tests/test_torch_partition_gpu.py -m gpu --noconftest``
(``--noconftest`` because tests/conftest.py imports jax, which that
machine lacks; this file imports only the port)."""

import copy
import os
import re
import subprocess

import pytest
import torch

from tpu_operator_torch import consts, nvml
from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin
from tpu_operator_torch.partitioner import partitioner
from tpu_operator_torch.validator import driver, native
from tpu_operator_torch.validator.status import StatusFiles


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and its driver's NVML")
    return torch.device("cuda", 0)


@pytest.fixture
def own_nodes(cuda_device, monkeypatch):
    """The device nodes of this machine's GPUs only: the machine may show
    other GPUs' nodes too."""
    with nvml.session() as s:
        minors = [g.minor for g in s.gpus()]
    monkeypatch.setenv(consts.GPU_DEV_GLOBS_ENV, ",".join(f"/dev/nvidia{m}" for m in minors))
    return minors


def _smi(*args):
    out = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    return out.stdout


class NodeClient:
    """An in-memory apiserver holding one Node and no Pods."""

    def __init__(self, labels):
        self.node = {"metadata": {"name": "n1", "labels": dict(labels),
                                  "resourceVersion": "1"}}

    def get(self, api_version, kind, name, namespace=None):
        return copy.deepcopy(self.node)

    def list(self, api_version, kind, namespace=None, field_selector=None):
        return []

    def patch(self, api_version, kind, name, patch, namespace=None):
        labels = patch.get("metadata", {}).get("labels", {})
        for key, value in labels.items():
            if value is None:
                self.node["metadata"]["labels"].pop(key, None)
            else:
                self.node["metadata"]["labels"][key] = value
        return copy.deepcopy(self.node)


@pytest.mark.gpu
def test_links_and_driver_version_from_nvml(cuda_device):
    with nvml.session() as s:
        gpus = s.gpus()
        links = s.links(gpus)
        version = s.driver_version()
    assert len(links) == len(gpus) == torch.cuda.device_count()
    assert all(links[i][i] is None for i in range(len(gpus)))
    assert all(links[i][j] in nvml.LINK_CLASSES
               for i in range(len(gpus)) for j in range(len(gpus)) if i != j)
    assert version == _smi("--query-gpu=driver_version", "--format=csv,noheader").split()[0]


@pytest.mark.gpu
def test_a_partition_is_advertised_and_allocated(cuda_device, own_nodes, tmp_path):
    client = NodeClient({consts.TPU_SLICE_CONFIG_LABEL: "single-gpu",
                         consts.TPU_CHIP_TYPE_LABEL: "nvidia-h100-80gb"})
    handoff = str(tmp_path / "handoff")
    state = partitioner.sync_once(client, "n1", None, handoff, status_dir=str(tmp_path / "st"))
    assert state == "success"
    assert client.node["metadata"]["labels"][consts.TPU_SLICE_STATE_LABEL] == "success"
    groups = partitioner.read_handoff(handoff)["groups"]
    assert groups == [{"topology": "single", "chips": [i]} for i in range(len(own_nodes))]
    plugin = GPUDevicePlugin(plugin_dir=str(tmp_path / "kubelet"),
                             status_dir=str(tmp_path / "st"), handoff_dir=handoff)
    plugin.refresh_units()
    units = [u.id for u in plugin._snapshot()]
    assert units == [f"gpu-part-{i}" for i in range(len(own_nodes))]
    plan = plugin.allocation_plan(["gpu-part-0"])
    with nvml.session() as s:
        first = s.gpus()[0]
    assert plan.devices[0][1] == f"/dev/nvidia{first.minor}"
    assert plan.envs["CUDA_VISIBLE_DEVICES"] == first.uuid
    assert plan.envs["GPU_TOPOLOGY"] == "single"


@pytest.mark.gpu
def test_the_native_probe_on_the_real_driver(cuda_device, own_nodes, tmp_path):
    native.build(["gpu-probe"])
    probe = str(native.binary_path("gpu-probe"))
    lib_dir = os.path.dirname(driver.find_host_driver())
    assert subprocess.run([probe, f"--install-dir={lib_dir}"], timeout=30).returncode == 0
    assert subprocess.run([probe, f"--install-dir={tmp_path}"], timeout=30).returncode == 1


@pytest.mark.gpu
def test_an_install_of_the_host_driver(cuda_device, own_nodes, tmp_path, monkeypatch):
    host = os.path.dirname(driver.find_host_driver())
    bundle = tmp_path / "bundle"
    bundle.mkdir()
    for name in consts.DRIVER_LIB_FILES:
        os.symlink(os.path.realpath(os.path.join(host, name)), bundle / name)
    monkeypatch.setenv(consts.DRIVER_SRC_ENV, str(bundle))
    monkeypatch.delenv(consts.DRIVER_VERSION_ENV, raising=False)
    status = StatusFiles(str(tmp_path / "st"))
    assert driver.install(str(tmp_path / "lib"), status=status)
    for name in consts.DRIVER_LIB_FILES:
        with open(tmp_path / "lib" / name, "rb") as a, \
                open(os.path.realpath(os.path.join(host, name)), "rb") as b:
            assert a.read() == b.read()
    version = status.read("driver")["libtpu_version"]
    assert re.fullmatch(r"\d+\.\d+(\.\d+)?", version)
    assert version == _smi("--query-gpu=driver_version", "--format=csv,noheader").split()[0]
    assert driver.probe(str(tmp_path / "lib"))


@pytest.mark.gpu
def test_the_bound_enum_values_are_the_toolkit_headers(cuda_device):
    """The NVML values the port binds, against the ``nvml.h`` the CUDA
    toolkit on the machine ships."""
    header = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "include", "nvml.h")
    text = open(header).read()

    def value(name):
        return int(re.search(rf"\b{name}\b\s*=?\s*(\d+)", text).group(1))

    assert [value(f"NVML_TOPOLOGY_{n}") for n in (
        "INTERNAL", "SINGLE", "MULTIPLE", "HOSTBRIDGE", "NODE", "SYSTEM")] == [
        nvml.TOPOLOGY_INTERNAL, nvml.TOPOLOGY_SINGLE, nvml.TOPOLOGY_MULTIPLE,
        nvml.TOPOLOGY_HOSTBRIDGE, nvml.TOPOLOGY_NODE, nvml.TOPOLOGY_SYSTEM]
    assert value("NVML_P2P_CAPS_INDEX_NVLINK") == nvml.P2P_CAPS_INDEX_NVLINK
    assert value("NVML_P2P_STATUS_OK") == nvml.P2P_STATUS_OK
    assert value("NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE") == nvml.DRIVER_VERSION_BUFFER
    for call in ("nvmlDeviceGetTopologyCommonAncestor", "nvmlDeviceGetP2PStatus",
                 "nvmlSystemGetDriverVersion"):
        assert re.search(rf"nvmlReturn_t DECLDIR {call}\(", text), call
