"""K1, the streaming-copy kernel (tpu_operator_torch/kernels/stream_copy.py),
its launch plan, its plain version and the whole-block rule it shares with
the Pallas kernel (tpu_operator/validator/perf.py:measure_hbm_pallas_gbps);
and the HBM probe it is checked against (``perf.scale_add``).

The tests marked ``gpu`` launch the CUDA kernel and skip without a card;
run them on one with
``python -m pytest tests/test_torch_stream_copy.py -m gpu --noconftest``."""

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


CHUNK = k1.CHUNK_BYTES // 4  # elements of one bulk chunk
#: element counts: tiny, one chunk and one chunk +- 16 B, many chunks + ragged
PLAN_LENGTHS = [1, 3, 4, 5, CHUNK - 4, CHUNK, CHUNK + 4, 37 * CHUNK + 7]


def _plan_intervals(plan, src, dst, n):
    """Element intervals [start, end) of the plan's ops, checking each bulk op
    on the way: 16-byte-aligned on both ends, a positive multiple of 16 B, at
    most one chunk."""
    if plan.n_chunks == 0:
        assert (plan.head, plan.last_bytes, plan.tail) == (n, 0, 0)
        return [(0, n)]
    assert 0 <= plan.head < 4 and 0 <= plan.tail < 4
    intervals = [(0, plan.head)]
    offset = 4 * plan.head
    for i in range(plan.n_chunks):
        size = plan.last_bytes if i == plan.n_chunks - 1 else plan.chunk_bytes
        assert 0 < size <= plan.chunk_bytes and size % 16 == 0
        assert (src + offset) % 16 == 0 and (dst + offset) % 16 == 0
        intervals.append((offset // 4, (offset + size) // 4))
        offset += size
    intervals.append((n - plan.tail, n))
    return intervals


def _assert_exact_cover(intervals, n):
    end = 0
    for start, stop in intervals:
        assert start == end, f"gap or overlap at element {start} (covered to {end})"
        assert stop >= start
        end = stop
    assert end == n


@pytest.mark.parametrize("n", PLAN_LENGTHS)
@pytest.mark.parametrize("src_off", range(4))
@pytest.mark.parametrize("dst_off", range(4))
def test_launch_plan_covers_every_element_once(n, src_off, dst_off):
    base = 0x7F00_0000_0000  # a 512-byte-aligned allocation, as the caching allocator's
    src, dst = base + 4 * src_off, base + (1 << 30) + 4 * dst_off
    plan = k1.launch_plan(src, dst, n)
    _assert_exact_cover(_plan_intervals(plan, src, dst, n), n)
    if src_off != dst_off:  # misaligned relative to each other: whole range scalar
        assert plan == (n, k1.CHUNK_BYTES, 0, 0, 0)
    elif n - (-src_off % 4) >= 4:  # a 16-byte group past the head: bulk body
        assert plan.n_chunks == -(-(n - plan.head - plan.tail) * 4 // k1.CHUNK_BYTES)


@pytest.mark.parametrize("n", [(1 << 20) + 3, 2 * CHUNK + 1, 131 * CHUNK, 5 * CHUNK + 9])
def test_launch_plan_honours_the_chunk(n):
    plan = k1.launch_plan(64, 128, n)
    assert plan.chunk_bytes == k1.CHUNK_BYTES
    assert plan.n_chunks == -(-(n - plan.tail) * 4 // k1.CHUNK_BYTES)
    _assert_exact_cover(_plan_intervals(plan, 64, 128, n), n)


def test_chunk_bytes_matches_the_kernel_source():
    """The plan's chunk is the one the C entry accepts (it refuses others)."""
    import re
    from pathlib import Path
    src = Path(k1.__file__).resolve().parent.parent / "csrc" / "stream_copy.cu"
    m = re.search(r"constexpr int64_t kChunkBytes = (\d+) \* (\d+);", src.read_text())
    assert m and int(m[1]) * int(m[2]) == k1.CHUNK_BYTES


@pytest.mark.parametrize("src, dst, n", [
    (2, 0, 16), (0, 6, 16), (0, 0, 0), (0, 0, -4), (1, 1, 4),
])
def test_launch_plan_rejects(src, dst, n):
    with pytest.raises(ValueError):
        k1.launch_plan(src, dst, n)


def test_main_path_plan_is_all_bulk():
    n = perf.stream_rows(512) * perf.STREAM_LANES
    plan = k1.launch_plan(0x7F00_0000_0000, 0x7F20_0000_0000, n)
    assert (plan.head, plan.tail, plan.last_bytes) == (0, 0, k1.CHUNK_BYTES)
    assert plan.n_chunks * k1.CHUNK_BYTES == n * 4


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_probe_matches_numpy_and_the_jax_touch(monkeypatch):
    """The probe's step against ``x * 1.0001 + 1.0`` on seeded data. XLA
    and PyTorch both contract it into one fused multiply-add (one rounding
    of the exact value), so the two agree bit for bit. numpy computes it in
    float64, where the product of two fp32 values is exact, and rounds once
    to fp32: at most 1 ulp apart (the float64 sum may itself round once).
    Two fp32 roundings would differ from both frameworks by up to half an
    ulp of the product, which near the zero crossing is thousands of ulps
    of the result."""
    x = np.random.default_rng(7).standard_normal(1_000_003, dtype=np.float32)
    got = perf.scale_add(torch.from_numpy(x)).numpy()
    exact = (x.astype(np.float64) * np.float64(np.float32(1.0001)) + 1.0).astype(np.float32)
    assert got.dtype == np.float32 and _ulps(got, exact).max() <= 1

    # the reference's own jitted touch (tpu_operator/validator/perf.py:253-255),
    # captured where its chain timing receives it
    import jax.numpy as jnp
    captured = {}

    def capture(fn, x, iters):
        captured["touch"] = fn
        return 1.0, True, iters, None

    monkeypatch.setattr(ref_perf, "_chain_time", capture)
    ref_perf.measure_hbm_gbps(mib=1, iters=1)
    ref = np.asarray(captured["touch"](jnp.asarray(x)))
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def test_probe_is_one_elementwise_op():
    """One aten op, its addend lifted as a CPU scalar: one read and one write."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append((func, [a.device.type for a in args
                                     if isinstance(a, torch.Tensor)]))
            return func(*args, **(kwargs or {}))

    x = torch.ones(64)
    with Ops() as ops:
        perf.scale_add(x)
    assert len(ops.seen) == 1
    func, devices = ops.seen[0]
    assert func is torch.ops.aten.add.Tensor
    assert devices == ["cpu", "cpu"]
    assert perf._PROBE_ONE.dim() == 0 and perf._PROBE_ONE.device.type == "cpu"


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


def _placed_copy(device, n, src_offset, dst_offset):
    """Copy n elements between views at the given element offsets; assert
    bit-exact and that nothing outside the destination view was written."""
    src = _seeded((n + 4,)).to(device)
    dst = torch.zeros(n + 4, device=device)
    k1.launch(src[src_offset:src_offset + n], dst[dst_offset:dst_offset + n])
    torch.cuda.synchronize()
    assert torch.equal(_bits(dst[dst_offset:dst_offset + n]),
                       _bits(src[src_offset:src_offset + n]))
    assert not dst[:dst_offset].any() and not dst[dst_offset + n:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("src_offset", range(4))
@pytest.mark.parametrize("dst_offset", range(4))
def test_gpu_kernel_misaligned(cuda_device, src_offset, dst_offset):
    _placed_copy(cuda_device, 100_003, src_offset, dst_offset)


@pytest.mark.gpu
@pytest.mark.parametrize("n", PLAN_LENGTHS[4:] + [3 * 132 * CHUNK + 31])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_gpu_kernel_chunk_boundaries(cuda_device, n, offset):
    _placed_copy(cuda_device, n, offset, offset)


@pytest.mark.gpu
def test_gpu_kernel_over_4_gib(cuda_device):
    """Byte offsets past 2^32: 4 GiB + 64 KiB + 12 B, with a scalar head."""
    n = (1 << 30) + (1 << 14) + 3
    src = torch.empty(n + 1, device=cuda_device)
    src.copy_(torch.arange(n + 1, device=cuda_device, dtype=torch.int32).view(torch.float32))
    dst = torch.zeros(n + 1, device=cuda_device)
    k1.launch(src[1:], dst[1:])
    torch.cuda.synchronize()
    assert torch.equal(_bits(dst[1:]), _bits(src[1:])) and dst[0].item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("field, delta", [("tail", 1), ("head", 1), ("n_chunks", 1),
                                          ("last_bytes", -16), ("chunk_bytes", 8)])
def test_gpu_kernel_refuses_an_inconsistent_plan(cuda_device, field, delta):
    x = _seeded((1 << 20,)).to(cuda_device)
    out = torch.empty_like(x)
    plan = k1.launch_plan(x.data_ptr(), out.data_ptr(), x.numel())
    bad = plan._replace(**{field: getattr(plan, field) + delta})
    before = k1.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        k1.run_plan(x, out, bad)
    assert k1.launches == before


@pytest.mark.gpu
def test_gpu_kernel_measure(cuda_device):
    gbps, ok = perf.measure_hbm_kernel_gbps(mib=64, device=cuda_device)
    assert gbps > 0
