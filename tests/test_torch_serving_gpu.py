"""The serving probe's decode step on the card (tpu_operator_torch/serving/
probe.py): the captured CUDA graph replays the eager step bit for bit, and
the probe passes at its defaults. Every test here needs a CUDA device and
skips without one; run them on the card with
``python -m pytest tests/test_torch_serving_gpu.py -m gpu --noconftest``
(``--noconftest`` because tests/conftest.py imports jax, which that
machine lacks; this file imports only the port).

The inputs are integer-valued, so every fp32 sum of both products is exact
whatever order cuBLAS sums in: the tolerance is zero.
"""

import numpy as np
import pytest
import torch

from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.serving import probe

SLOTS, DIM = 8, 256  # the deepest rung and the width of the CLI defaults


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's CUDA graph has no CPU mode")
    return resolve_device("cuda")  # also sets the exact GEMM numerics


def _inputs(seed):
    rng = np.random.default_rng(seed)
    n_pages = SLOTS + 1
    active = rng.integers(0, 2, SLOTS).astype(np.float32)
    active[rng.integers(0, SLOTS)] = 0.0
    return dict(
        tokens=rng.integers(-2, 3, (SLOTS, DIM)).astype(np.float32),
        w=rng.integers(-2, 3, (DIM, DIM)).astype(np.float32),
        pages=rng.integers(-8, 9, (n_pages, probe.PAGE_SIZE, DIM)).astype(np.float32),
        page_table=rng.permutation(n_pages)[:SLOTS].astype(np.int64),
        active=active,
        admit=rng.integers(0, 2, SLOTS).astype(np.float32))


def _eager(x, device):
    pages = torch.from_numpy(x["pages"]).to(device)
    out, _ = probe.engine_step(
        torch.from_numpy(x["tokens"]).to(device, torch.bfloat16), pages,
        torch.from_numpy(x["page_table"]).to(device), torch.from_numpy(x["active"]).to(device),
        torch.from_numpy(x["admit"]).to(device),
        torch.from_numpy(x["w"]).to(device, torch.bfloat16))
    return out.cpu().numpy(), pages.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(3))
def test_gpu_graph_replay_equals_eager_step(cuda_device, seed):
    x = _inputs(seed)
    eager_out, eager_pages = _eager(x, cuda_device)
    engine = probe.DecodeEngine(SLOTS, DIM, cuda_device)
    engine.w.copy_(torch.from_numpy(x["w"]))
    engine.tokens.copy_(torch.from_numpy(x["tokens"]))
    engine.capture()
    for name in ("pages", "page_table", "active", "admit"):
        getattr(engine, name).copy_(torch.from_numpy(x[name]))
    out = engine.step()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out.cpu().numpy(), eager_out)
    np.testing.assert_array_equal(engine.pages.cpu().numpy().view(np.int32),
                                  eager_pages.view(np.int32))
    # a second replay reads the cache the first one wrote, as the probe's
    # steps do
    again_out, again_pages = _eager(dict(x, pages=eager_pages), cuda_device)
    out = engine.step()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out.cpu().numpy(), again_out)
    np.testing.assert_array_equal(engine.pages.cpu().numpy().view(np.int32),
                                  again_pages.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(2))
def test_gpu_eager_step_equals_cpu_step(cuda_device, seed):
    x = _inputs(seed)
    gpu_out, gpu_pages = _eager(x, cuda_device)
    cpu_out, cpu_pages = _eager(x, torch.device("cpu"))
    np.testing.assert_array_equal(gpu_out, cpu_out)
    np.testing.assert_array_equal(gpu_pages.view(np.int32), cpu_pages.view(np.int32))


@pytest.mark.gpu
def test_gpu_probe_passes_at_the_defaults(cuda_device):
    report = probe.run_probe()
    assert report.passed, report.failures
    assert report.platform == "gpu" and report.compile_s > 0
    assert [r["batch"] for r in report.batches] == [1, 4, 8]
    assert all(r["samples"] >= probe.MIN_FRONTIER_SAMPLES for r in report.batches)
    assert report.n_devices == torch.cuda.device_count()
