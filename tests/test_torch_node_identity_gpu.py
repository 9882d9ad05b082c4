"""The validator's steady state and node identity on the card: revalidation
on a full card skips without touching the barrier, re-probes hold their
memory flat, and feature discovery enumerates without a CUDA context.
Every test here needs a CUDA device and skips without one; run them on the
card with ``python -m pytest tests/test_torch_node_identity_gpu.py -m gpu
--noconftest`` (``--noconftest`` because tests/conftest.py imports jax,
which that machine lacks; this file imports only the port)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from tpu_operator_torch.cuda_driver import primary_contexts_active
from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.validator import feature_discovery, info, main as vmain
from tpu_operator_torch.validator.serving import run_serving
from tpu_operator_torch.validator.status import StatusFiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these are the card's own behaviours")
    return resolve_device("cuda")


@pytest.mark.gpu
def test_feature_discovery_creates_no_context(cuda_device):
    script = (
        "import json, sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        "from test_torch_node_identity_gpu import primary_contexts_active\n"
        "from tpu_operator_torch.validator.feature_discovery import discover\n"
        "labels = discover()\n"
        "print(json.dumps({'labels': labels, 'active': primary_contexts_active()}))\n")
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                            text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    out = json.loads(result.stdout.strip().splitlines()[-1])
    assert out["active"] == [False] * torch.cuda.device_count()
    props = torch.cuda.get_device_properties(0)
    assert out["labels"]["tpu.ai/tpu.chip-type"] == \
        feature_discovery.chip_type_from_kind(props.name)
    assert out["labels"]["tpu.ai/tpu.memory"] == f"{round(props.total_memory / 2**30)}Gi"
    torch.zeros(1, device=cuda_device)
    assert primary_contexts_active()[0] is True  # the check sees a real context


@pytest.mark.gpu
def test_info_reports_the_cards_memory(cuda_device, tmp_path):
    collected = info.collect(status=StatusFiles(str(tmp_path)))
    assert len(collected["chips"]) == torch.cuda.device_count()
    chip = collected["chips"][0]
    assert chip["kind"] == torch.cuda.get_device_name(0)
    assert chip["hbm_total_bytes"] == torch.cuda.get_device_properties(0).total_memory
    assert 0 < chip["hbm_used_bytes"] < chip["hbm_total_bytes"]


@pytest.mark.gpu
def test_revalidation_on_a_full_card_leaves_the_barrier(cuda_device, tmp_path):
    status = StatusFiles(str(tmp_path))
    status.write("workload", {"passed": True, "platform": "gpu"})
    before = open(status.path("workload"), "rb").read()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    hold = torch.empty(free - 256 * 2**20, dtype=torch.uint8, device=cuda_device)
    try:
        assert vmain.revalidate_local(status, 512, timeout=120) is None
        assert open(status.path("workload"), "rb").read() == before
    finally:
        del hold
        torch.cuda.empty_cache()
    assert vmain.revalidate_local(status, 512, timeout=120) is True
    assert status.read("workload")["platform"] == "gpu"


@pytest.mark.gpu
def test_reprobes_hold_reserved_memory_flat(cuda_device, tmp_path):
    status = StatusFiles(str(tmp_path))
    reserved = []
    for _ in range(5):
        assert run_serving(status, device=cuda_device) == 0
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert reserved[1:] == [reserved[0]] * 4, reserved
