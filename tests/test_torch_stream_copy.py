"""K1, the streaming-copy kernel (tpu_operator_torch/kernels/stream_copy.py),
its plain version and the whole-block rule it shares with the Pallas kernel
(tpu_operator/validator/perf.py:measure_hbm_pallas_gbps).

The tests marked ``gpu`` launch the CUDA kernel and skip without a card;
run them on one with ``python -m pytest tests/test_torch_stream_copy.py -m gpu``."""

import numpy as np
import pytest
import torch

from tpu_operator.validator import perf as ref_perf
from tpu_operator_torch.kernels import _build
from tpu_operator_torch.kernels import stream_copy as k1
from tpu_operator_torch.validator import perf


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _seeded(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape,
                                                                        dtype=np.float32))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape", [(7, 1024), (1_000_003,), (3,), (2, 3, 5)])
def test_cpu_copy_is_bitwise_equal_and_fresh(shape):
    x = _seeded(shape)
    before = k1.launches
    y = k1.stream_copy(x)
    assert torch.equal(_bits(y), _bits(x))
    assert y.data_ptr() != x.data_ptr()
    assert k1.launches == before  # the plain version is not a launch


def test_cpu_copy_of_misaligned_view():
    base = _seeded((1001,))
    view = base[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert torch.equal(_bits(k1.stream_copy(view)), _bits(view))


def _reference_rows(mib):
    # tpu_operator/validator/perf.py:286-295, verbatim arithmetic
    lanes = 1024
    rows = mib * 1024 * 1024 // 4 // lanes
    block_rows = min(512, max(rows, 1))
    rows -= rows % block_rows
    return rows


@pytest.mark.parametrize("mib", [0, 1, 2, 3, 5, 64, 513, 512, 1024])
def test_whole_block_rows_rule_matches_pallas(mib):
    rows = perf.stream_rows(mib)
    assert rows == _reference_rows(mib)
    if rows:
        # a whole number of 2 MiB blocks once the array reaches one block
        assert rows % min(perf.STREAM_BLOCK_ROWS, rows) == 0


def test_main_path_shape():
    assert perf.stream_rows(512) * perf.STREAM_LANES == 131072 * 1024
    assert perf.stream_rows(1024) == 262144


@pytest.mark.parametrize("bad, error", [
    (torch.zeros(16, dtype=torch.float64), TypeError),
    (torch.zeros(16, dtype=torch.bfloat16), TypeError),
    (torch.zeros(16, dtype=torch.int32), TypeError),
    (torch.zeros((8, 8)).t(), ValueError),
    (torch.zeros(16)[::2], ValueError),
    (torch.zeros(0), ValueError),
    (torch.zeros(16, device="meta"), ValueError),
])
def test_wrapper_rejects(bad, error):
    with pytest.raises(error):
        k1.stream_copy(bad)


def test_launch_takes_cuda_tensors_only():
    x = torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA"):
        k1.launch(x, torch.empty_like(x))


def test_kernel_measure_absent_on_cpu_like_pallas_off_tpu():
    assert perf.measure_hbm_kernel_gbps(mib=4, device="cpu") == (0.0, False)
    assert ref_perf.measure_hbm_pallas_gbps(mib=4) == (0.0, False)


def test_kernel_measure_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default measures it")
    with pytest.raises(RuntimeError, match="CUDA"):
        perf.measure_hbm_kernel_gbps(mib=4)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_cache_key_follows_the_source():
    assert _build.sources() == ["stream_copy"]
    path = _build.library_path("stream_copy")
    assert path == _build.library_path("stream_copy")
    # under build/, which .gitignore lists
    assert path.parent.parent.name == "build"
    assert path.name.startswith("libstream_copy-") and path.suffix == ".so"


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(131072, 1024), (1_000_003,), (3,)])
def test_gpu_kernel_bit_exact(cuda_device, shape):
    x = _seeded(shape).to(cuda_device)
    before = k1.launches
    y = k1.stream_copy(x)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert torch.equal(_bits(y), _bits(k1.stream_copy_reference(x)))


@pytest.mark.gpu
@pytest.mark.parametrize("src_offset, dst_offset", [(1, 0), (1, 1), (2, 2), (3, 1)])
def test_gpu_kernel_misaligned(cuda_device, src_offset, dst_offset):
    n = 100_003
    src = _seeded((n + 4,)).to(cuda_device)
    dst = torch.zeros(n + 4, device=cuda_device)
    k1.launch(src[src_offset:src_offset + n], dst[dst_offset:dst_offset + n])
    torch.cuda.synchronize()
    assert torch.equal(_bits(dst[dst_offset:dst_offset + n]),
                       _bits(src[src_offset:src_offset + n]))
    # nothing written outside the destination view
    assert not dst[:dst_offset].any() and not dst[dst_offset + n:].any()


@pytest.mark.gpu
def test_gpu_kernel_measure(cuda_device):
    gbps, ok = perf.measure_hbm_kernel_gbps(mib=64, device=cuda_device)
    assert gbps > 0
