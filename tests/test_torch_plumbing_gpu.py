"""The device plumbing on the card: NVML against ``nvidia-smi``, a child
that sees exactly the GPU Allocate handed it, and the exporter's memory
reading under a hold. Every test here needs a CUDA device and skips
without one; run them on the card with ``python -m pytest
tests/test_torch_plumbing_gpu.py -m gpu --noconftest`` (``--noconftest``
because tests/conftest.py imports jax, which that machine lacks; this file
imports only the port)."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from tpu_operator_torch import nvml
from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin
from tpu_operator_torch.validator import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and its driver's NVML")
    return torch.device("cuda", 0)


def _smi(*args):
    out = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.gpu
def test_nvml_matches_nvidia_smi(cuda_device):
    text = _smi("-q")
    want = list(zip(re.findall(r"GPU UUID\s*:\s*(\S+)", text),
                    [int(m) for m in re.findall(r"Minor Number\s*:\s*(\d+)", text)],
                    [None if b == "N/A" else b
                     for b in re.findall(r"\n\s*Bus Id\s*:\s*(\S+)", text)]))
    with nvml.session() as s:
        got = [(g.uuid, g.minor, g.pci_bus_id) for g in (s.gpu(i) for i in range(s.count()))]
    assert got == want
    assert len(got) == torch.cuda.device_count()


@pytest.mark.gpu
def test_the_cuda_driver_names_each_ordinal_without_a_context(cuda_device):
    """``cuda_driver.uuids_by_ordinal`` in a fresh process: NVML's UUIDs,
    in the order torch numbers the GPUs there (PCI order), and no primary
    context before torch."""
    script = ("import json, os, sys\n"
              "from tpu_operator_torch import cuda_driver, nvml\n"
              "driver = cuda_driver.uuids_by_ordinal()\n"
              "contexts = cuda_driver.primary_contexts_active()\n"
              "before = 'torch' in sys.modules\n"
              "import torch\n"
              "print(json.dumps({'driver': driver, 'contexts': contexts, 'torch': before,\n"
              "    'order': os.environ['CUDA_DEVICE_ORDER'],\n"
              "    'nvml': sorted(g.uuid for g in nvml.gpus()),\n"
              "    'torch_uuids': ['GPU-' + str(torch.cuda.get_device_properties(i).uuid)\n"
              "                    for i in range(torch.cuda.device_count())]}))\n")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_DEVICE_ORDER"}
    child = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                           timeout=300, cwd=REPO, env=env)
    assert child.returncode == 0, child.stderr[-2000:]
    got = json.loads(child.stdout.strip().splitlines()[-1])
    assert got["driver"] == got["torch_uuids"] and sorted(got["driver"]) == got["nvml"]
    assert got["contexts"] == [False] * torch.cuda.device_count()
    assert (got["torch"], got["order"]) == (False, "PCI_BUS_ID")


@pytest.mark.gpu
def test_a_child_with_the_allocate_env_sees_only_its_gpu(cuda_device, tmp_path):
    plugin = GPUDevicePlugin(plugin_dir=str(tmp_path / "k"), status_dir=str(tmp_path / "s"),
                             handoff_dir=str(tmp_path / "h"))
    plugin.refresh_units()
    unit = plugin._snapshot()[-1]
    plan = plugin.allocation_plan([unit.id])
    script = ("import json, torch\n"
              "print(json.dumps({'count': torch.cuda.device_count(),\n"
              "                  'uuid': 'GPU-' + str(torch.cuda.get_device_properties(0).uuid)}))\n")
    child = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                           timeout=300, env=dict(plan.envs, PATH=os.environ["PATH"],
                                                 PYTHONPATH=REPO))
    assert child.returncode == 0, child.stderr[-2000:]
    assert json.loads(child.stdout.strip().splitlines()[-1]) == {
        "count": 1, "uuid": plan.envs["CUDA_VISIBLE_DEVICES"]}
    assert os.path.exists(plan.devices[0][1])


@pytest.mark.gpu
def test_telemetry_memory_within_5_percent_of_nvidia_smi_under_a_hold(cuda_device):
    hold = torch.empty(8 * 2 ** 30, dtype=torch.uint8, device=cuda_device)
    torch.cuda.synchronize()
    metrics = telemetry.TelemetryMetrics(sources=[telemetry.NvmlSource()])
    metrics.refresh()
    used_mib = {uuid: float(mib) for uuid, mib in (
        line.split(", ") for line in _smi("--query-gpu=uuid,memory.used",
                                          "--format=csv,noheader,nounits").splitlines())}
    samples = dict(line.rsplit(" ", 1) for line in metrics.scrape().decode().splitlines()
                   if line.startswith("tpu_hbm_used_bytes"))
    # the exporter's chip label is the GPU's position in NVML's order
    mine = "GPU-" + str(torch.cuda.get_device_properties(cuda_device).uuid)
    chip = [g.uuid for g in nvml.gpus()].index(mine)
    used = float(samples[f'tpu_hbm_used_bytes{{chip="{chip}"}}'])
    del hold
    want = used_mib[mine] * 2 ** 20
    assert used >= 8 * 2 ** 30
    assert abs(used - want) <= 0.05 * want
