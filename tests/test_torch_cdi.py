"""The port's CDI spec against the reference's, for the same fake node
(the port's GPUs from a fake NVML), and the ``cdi`` component."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from tpu_operator.validator import cdi as ref_cdi
from tpu_operator_torch import consts, nvml
from tpu_operator_torch.deviceplugin import plugin as port_plugin
from tpu_operator_torch.testing.fake_nvml import FakeNvml, random_gpus
from tpu_operator_torch.validator import cdi

SEED = 20261017
N_GPUS = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def node(tmp_path, monkeypatch):
    dev = tmp_path / "dev"
    dev.mkdir()
    for i in range(N_GPUS):
        (dev / f"accel{i}").touch()
    monkeypatch.setenv("TPU_DEV_GLOBS", str(dev / "accel*"))
    fake = FakeNvml(random_gpus(N_GPUS, SEED))
    for g in fake.gpus:
        (dev / f"nvidia{g.minor}").touch()
    for name in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"):
        (dev / name).touch()
    libtpu = tmp_path / "libtpu"
    libtpu.mkdir()
    (libtpu / "libtpu.so").write_bytes(b"\x7fELF" + b"\x00" * 8)
    libs = tmp_path / "lib"
    libs.mkdir()
    (libs / "libcuda.so.580.1.2").write_bytes(b"\x7fELF")
    os.symlink("libcuda.so.580.1.2", libs / "libcuda.so.1")
    (libs / "libnvidia-ml.so.1").write_bytes(b"\x7fELF")
    return {"dev": dev, "fake": fake, "libtpu": libtpu, "libs": libs, "tmp": tmp_path}


def _specs(node):
    ref = ref_cdi.generate_spec(str(node["libtpu"]))
    port = cdi.generate_spec(str(node["libs"]), gpus=nvml.gpus(node["fake"]),
                             dev_dir=str(node["dev"]))
    return ref, port


def test_spec_matches_reference_after_mapping(node):
    ref, port = _specs(node)
    pci = sorted(node["fake"].gpus, key=lambda g: g.pci_bus_id)
    assert port["cdiVersion"] == ref["cdiVersion"] == "0.6.0"
    assert (ref["kind"], port["kind"]) == ("google.com/tpu", "nvidia.com/gpu")
    assert [d["name"] for d in port["devices"]] == [
        d["name"].replace("tpu", "gpu") for d in ref["devices"]] == [
        "gpu0", "gpu1", "gpu2", "gpu3", "all"]
    for i, (r, p) in enumerate(zip(ref["devices"][:-1], port["devices"][:-1])):
        # its own node, by minor number, where the reference has the i-th node
        assert r["containerEdits"]["deviceNodes"] == [
            {"path": str(node["dev"] / f"accel{i}"), "permissions": "rw"}]
        assert p["containerEdits"]["deviceNodes"] == [
            {"path": str(node["dev"] / f"nvidia{pci[i].minor}"), "permissions": "rw"}]
        # visibility by index there, by UUID here
        assert r["containerEdits"]["env"] == [f"TPU_VISIBLE_CHIPS={i}"]
        assert p["containerEdits"]["env"] == [f"NVIDIA_VISIBLE_DEVICES={pci[i].uuid}",
                                              f"CUDA_VISIBLE_DEVICES={pci[i].uuid}"]
    every = ",".join(g.uuid for g in pci)
    assert port["devices"][-1]["containerEdits"] == {
        "deviceNodes": [{"path": str(node["dev"] / f"nvidia{g.minor}"), "permissions": "rw"}
                        for g in pci],
        "env": [f"NVIDIA_VISIBLE_DEVICES={every}", f"CUDA_VISIBLE_DEVICES={every}"]}
    assert len(ref["devices"][-1]["containerEdits"]["deviceNodes"]) == N_GPUS
    # common edits: the library's directory there; the driver's files and
    # the control nodes here (kept different on purpose)
    assert ref["containerEdits"] == {"mounts": [{
        "hostPath": str(node["libtpu"]), "containerPath": str(node["libtpu"]),
        "options": ["ro", "rbind"]}]}
    files = [str(node["libs"] / n)
             for n in ("libcuda.so.1", "libnvidia-ml.so.1", "libcuda.so.580.1.2")]
    assert port["containerEdits"] == {
        "deviceNodes": [{"path": str(node["dev"] / n), "permissions": "rw"}
                        for n in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")],
        "mounts": [{"hostPath": f, "containerPath": f, "options": ["ro", "rbind"]}
                   for f in files]}


def test_names_are_what_allocate_returns_in_cdi_mode(node, monkeypatch):
    monkeypatch.setenv(consts.USE_CDI_ENV, "1")
    _, spec = _specs(node)
    plugin = port_plugin.GPUDevicePlugin(plugin_dir=str(node["tmp"] / "kubelet"),
                                         handoff_dir=str(node["tmp"] / "handoff"),
                                         status_dir=str(node["tmp"] / "status"),
                                         dev_dir=str(node["dev"]), nvml_lib=node["fake"])
    plugin.refresh_units()
    for i in range(N_GPUS):
        assert plugin.allocation_plan([f"gpu-{i}"]).cdi_devices == [
            f"{spec['kind']}={spec['devices'][i]['name']}"] == [cdi.qualified_name(i)]
    assert plugin.allocation_plan(["gpu-2", "gpu-0"]).cdi_devices == [
        "nvidia.com/gpu=gpu0", "nvidia.com/gpu=gpu2"]


def test_write_is_atomic(node, monkeypatch):
    """A write that dies half-way leaves the spec a runtime reads as it was,
    and no temporary file behind."""
    _, spec = _specs(node)
    cdi_dir = node["tmp"] / "cdi"
    path = cdi.write_spec(spec, str(cdi_dir))
    assert json.load(open(path)) == spec
    before = open(path, "rb").read()

    def torn(obj, f, **kw):
        f.write(json.dumps(obj)[:20])
        raise OSError("disk full")

    monkeypatch.setattr(cdi.json, "dump", torn)
    with pytest.raises(OSError, match="disk full"):
        cdi.write_spec({**spec, "devices": []}, str(cdi_dir))
    assert open(path, "rb").read() == before
    assert os.listdir(cdi_dir) == ["nvidia.com-gpu.json"]


def _cli(args, fake_gpus, cwd):
    """The validator CLI in a fresh process whose NVML is a fake (None: the
    process's own, absent here)."""
    install = ("from tpu_operator_torch.testing import fake_nvml as f\n"
               f"f.install(f.FakeNvml([f.FakeGpu(**g) for g in {fake_gpus!r}]))\n"
               if fake_gpus is not None else "")
    script = (install +
              "import sys\n"
              "from tpu_operator_torch.validator.main import main\n"
              f"rc = main({args!r})\n"
              "print('TORCH', 'torch' in sys.modules, 'JAX', 'jax' in sys.modules)\n"
              "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=cwd, env=env)


def test_cdi_cli_writes_the_spec(node):
    gpus = [dataclasses.asdict(g) for g in node["fake"].gpus]
    cdi_dir = node["tmp"] / "cdi"
    result = _cli(["-c", "cdi", "--device=cpu", f"--install-dir={node['libs']}",
                   f"--cdi-dir={cdi_dir}"], gpus, str(node["tmp"]))
    assert result.returncode == 0, result.stderr[-2000:]
    spec = json.load(open(cdi_dir / "nvidia.com-gpu.json"))
    assert [d["name"] for d in spec["devices"]] == ["gpu0", "gpu1", "gpu2", "gpu3", "all"]
    # the real /dev here: the nodes named are the GPUs' own, by minor
    pci = sorted(node["fake"].gpus, key=lambda g: g.pci_bus_id)
    assert [d["containerEdits"]["deviceNodes"][0]["path"] for d in spec["devices"][:-1]] == [
        f"/dev/nvidia{g.minor}" for g in pci]
    assert "TORCH False JAX False" in result.stdout


@pytest.mark.parametrize("gpus", [None, []], ids=["no-nvml", "no-gpu"])
def test_cdi_cli_fails_without_gpus(node, gpus):
    """No NVML (a host without NVIDIA's driver) and an NVML with no GPU
    both exit non-zero and write no spec."""
    cdi_dir = node["tmp"] / "cdi"
    result = _cli(["-c", "cdi", f"--cdi-dir={cdi_dir}"], gpus, str(node["tmp"]))
    assert result.returncode == 1
    assert not cdi_dir.exists() or os.listdir(cdi_dir) == []
