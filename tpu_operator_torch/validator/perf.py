"""Performance validation: measured tensor-core / HBM / NVLink throughput per
node (counterpart of tpu_operator/validator/perf.py).

Three microbenchmarks map onto the card's throughput axes:

- **GEMM**: bf16 matmul chain with fp32 accumulation -> TFLOP/s
  (reported as ``mxu_tflops``: the report schema is shared with the TPU
  operator, so bench, info and metrics readers parse either)
- **HBM**: one elementwise pass over a tensor far larger than L2, one read
  and one write -> GB/s; its twin, the hand-written streaming-copy kernel
  (``kernels/stream_copy.py``), must agree with it
- **NVLink**: NCCL all_reduce across the local GPUs; per-GPU bus bandwidth
  uses the ring factor 2*(n-1)/n -> GB/s

Timing runs a chain of dependent calls closed by a one-element host fetch
(``.item()``), minus the fetch round-trip (see ``_chain_time``).

Each chain measurement is one span (``perf.gemm``, ``perf.hbm``, ``perf.k1``)
whose attributes say where its time went, and adds to the process's
counters: ``perf.chain.kept_s`` (the timed runs a reading is built from),
``perf.chain.discarded_s`` (timed runs thrown away), ``perf.chain.probes``
(probes under the floor thrown away), ``perf.prep_s`` (the rest of its
wall time) and ``perf.gemm.iters``. The all-reduce, timed in
its ranks' own processes, is a plain span ``perf.allreduce`` with
``ranks``, opened only where there is more than one GPU. A chain's steps
are marks on the profiler's timeline (``perf.operands``,
``perf.chain.warmup``, ``perf.chain.probe``, ``perf.chain.sample``), each
opened outside the timed run it names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from .. import tracing
from ..device import DeviceLike, device_kind, platform_of, resolve_device, synchronize
from ..kernels.stream_copy import stream_copy
from ..ranks import run_ranks

#: Published per-card peaks: device-name substring -> (name, bf16 dense
#: TFLOP/s, HBM GB/s). First match wins, so the specific variants come
#: before the bare "h100" of the SXM5 part ("NVIDIA H100 80GB HBM3").
#: Source: NVIDIA H100 Tensor Core GPU data sheet.
PEAK_TABLE: Tuple[Tuple[str, str, float, float], ...] = (
    ("h100 nvl", "h100-nvl", 835.0, 3900.0),
    ("h100 pcie", "h100-pcie", 756.0, 2000.0),
    ("h100", "h100-sxm5", 989.0, 3350.0),
)

#: Highest measured/published-peak fraction that is physically plausible;
#: above this the measurement, not the card, is wrong.
MAX_PEAK_FRACTION = 1.05

#: Acceptable band for the fetch-closed vs block-closed timing ratio.
CROSS_CHECK_BAND = (0.9, 1.1)

#: Probe / streaming-kernel agreement band: the two move identical bytes,
#: so an honest card reports them within noise of each other.
HBM_STREAMING_BAND = (0.8, 1.25)

#: a chain sized from its first probe (:func:`_sized_length`) times the
#: step below the predicted length first when that step is predicted
#: within this share of the floor, so that a per-call time read a little
#: high never settles the chain past where the x4 climb would
SIZING_MARGIN = 0.2

#: fp32 lanes per row of the streaming kernel's array, and rows per block
#: in the whole-block rule (2 MiB blocks, as the TPU kernel's)
STREAM_LANES = 1024
STREAM_BLOCK_ROWS = 512


def lookup_peaks(device_kind: str) -> Optional[Tuple[str, float, float]]:
    """(card name, bf16 TFLOP/s peak, HBM GB/s peak) or None if unknown."""
    lowered = device_kind.lower()
    for pattern, name, tflops, gbps in PEAK_TABLE:
        if pattern in lowered:
            return name, tflops, gbps
    return None


@dataclasses.dataclass
class PerfReport:
    platform: str = "unknown"
    n_devices: int = 0
    #: raw device name (e.g. "NVIDIA H100 80GB HBM3"); "unknown" if unread
    device_kind: str = "unknown"
    #: canonical card name from PEAK_TABLE ("h100-sxm5", ...), "" if unmapped
    chip: str = ""
    #: matmul accumulation mode used for mxu_tflops
    accumulation: str = "fp32"
    #: bf16 GEMM TFLOP/s on the tensor cores (name shared with the TPU schema)
    mxu_tflops: float = 0.0
    hbm_gbps: float = 0.0
    #: None when unmeasured (single GPU: no fabric exists)
    ici_allreduce_gbps: Optional[float] = None
    #: True when the all-reduce sweep was skipped rather than measured
    ici_skipped: bool = False
    #: measured / published-peak; None when the card has no PEAK_TABLE row
    mxu_peak_fraction: Optional[float] = None
    hbm_peak_fraction: Optional[float] = None
    #: chain-timing result over an independently closed timing of the same op
    mxu_cross_check_ratio: Optional[float] = None
    #: the hand-written Hopper streaming-copy kernel's GB/s (the field keeps
    #: the TPU schema's name; 0.0 on the CPU) and the probe/kernel ratio
    hbm_pallas_gbps: float = 0.0
    hbm_streaming_cross_check_ratio: Optional[float] = None
    #: False when any timing hit its noise floor
    measurement_valid: bool = True
    elapsed_s: float = 0.0
    passed: bool = False
    failures: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _fetch_one(out: torch.Tensor):
    """Force completion by pulling ONE element to the host (a CUDA ``.item()``
    waits for the stream)."""
    return out.reshape(-1)[0].item()


@dataclasses.dataclass
class ChainTimes:
    """Where one measurement's timed runs went (:func:`_chain_time`)."""
    #: seconds of the timed runs the reading is built from
    kept_s: float = 0.0
    #: seconds of timed runs thrown away: probes under the floor, samples at
    #: a length the chain then grew past, a first attempt that was retried
    discarded_s: float = 0.0
    #: the fetch round trip subtracted from the reading
    rtt_s: float = 0.0
    #: the chain's settled length, calls a timed run
    iters: int = 0
    #: probes under the floor thrown away
    probes: int = 0
    retried: bool = False

    def retry(self) -> None:
        """The reading is taken again: the runs it was built from are thrown away."""
        self.discarded_s += self.kept_s
        self.kept_s = 0.0
        self.retried = True


@contextlib.contextmanager
def _measurement(name: str) -> Iterator[ChainTimes]:
    """One measurement's span and counters; its wall time outside the
    timed runs (operands, warm-up, round-trip probe) is its ``prep_s``."""
    times = ChainTimes()
    t0 = time.perf_counter()
    with tracing.span(name) as sp:
        yield times
        prep_s = max(time.perf_counter() - t0 - times.kept_s - times.discarded_s, 0.0)
        sp.set_attributes(iters=times.iters, kept_s=round(times.kept_s, 6),
                          discarded_s=round(times.discarded_s, 6), prep_s=round(prep_s, 6),
                          rtt_s=round(times.rtt_s, 9), retried=times.retried)
        tracing.count("perf.chain.kept_s", times.kept_s)
        tracing.count("perf.chain.discarded_s", times.discarded_s)
        tracing.count("perf.chain.probes", times.probes)
        tracing.count("perf.prep_s", prep_s)


def _sized_length(probe: float, rtt: float, floor: float, iters: int, max_iters: int) -> int:
    """The length, ``iters`` times a power of 4, that a chain whose probe
    of ``iters`` calls took ``probe`` s (under ``floor``) is timed at next.

    The x4 climb settles at the first length whose run clears the floor;
    the probe's per-call time predicts it, the smallest length predicted
    to clear, as far as ``max_iters`` allows. Where the step below it is
    predicted within :data:`SIZING_MARGIN` of the floor, that step is
    timed first, as the climb would."""
    per_call = max(probe - rtt, 1e-9) / iters
    length = iters
    while length * 4 <= max_iters:
        length *= 4
        if length * per_call + rtt >= floor:
            break
    below = length // 4
    if below > iters and below * per_call + rtt >= (1.0 - SIZING_MARGIN) * floor:
        return below
    return length


def _chain_time(fn, x, iters: int, device: torch.device, cross_check: bool = False,
                max_iters: int = 4096, times: Optional[ChainTimes] = None
                ) -> Tuple[float, bool, int, Optional[float]]:
    """(wall time per call, trustworthy?, final iters, cross-check ratio)
    for shape-preserving ``fn``.

    A chain of dependent calls closed by one one-element fetch, minus the
    minimum fetch round-trip; grown until the total clears
    max(20*RTT, 50 ms), median of three at the settled size. A first
    probe under the floor sizes the chain (:func:`_sized_length`); past
    that it grows x4, as the reference's does from the start. With
    ``cross_check`` the same chain is also closed by
    ``torch.cuda.synchronize``, samples interleaved, and the raw totals
    compared. ``times`` gains the timed runs' seconds, kept and thrown
    away, the round trip and the settled length."""
    times = times if times is not None else ChainTimes()
    with tracing.mark("perf.chain.warmup"):
        out = fn(x)
        # warmup: first execution complete, and two calls chained on from
        # it hold every buffer a timed run holds, so that the first probe,
        # which sizes the chain, pays for no allocation
        _fetch_one(fn(fn(out)))

        samples = []
        for _ in range(5):
            t0 = time.perf_counter()
            _fetch_one(out)  # round-trip on an already-materialised result
            samples.append(time.perf_counter() - t0)
    rtt = min(samples)
    floor = max(20.0 * rtt, 0.05)

    def block(_o) -> None:
        synchronize(device)

    def timed_chain(closer, step: str) -> float:
        with tracing.mark(step):
            t0 = time.perf_counter()
            o = out
            for _ in range(iters):
                o = fn(o)
            closer(o)
            return time.perf_counter() - t0

    first = True
    while True:
        probe = timed_chain(_fetch_one, "perf.chain.probe")
        sizing, first = first, False
        if probe < floor and iters * 4 <= max_iters:
            times.discarded_s += probe
            times.probes += 1
            iters = _sized_length(probe, rtt, floor, iters, max_iters) if sizing else iters * 4
            continue
        fetch_samples, block_samples = [probe], []
        for _ in range(2):
            if cross_check:
                block_samples.append(timed_chain(block, "perf.chain.sample"))
            fetch_samples.append(timed_chain(_fetch_one, "perf.chain.sample"))
        if cross_check:
            block_samples.append(timed_chain(block, "perf.chain.sample"))
        total = statistics.median(fetch_samples)
        timed_s = sum(fetch_samples) + sum(block_samples)
        if total >= floor or iters * 4 > max_iters:
            times.kept_s += timed_s
            break
        times.discarded_s += timed_s
        iters *= 4
    times.rtt_s, times.iters = rtt, iters
    ratio = None
    if cross_check:
        block_total = max(statistics.median(block_samples), 1e-9)
        ratio = round(total / block_total, 3)
    return max(total - rtt, 1e-9) / iters, total >= floor, iters, ratio


def measure_mxu_tflops(dim: int = 4096, iters: int = 5, device: DeviceLike = None
                       ) -> Tuple[float, bool, Optional[float]]:
    """bf16 matmul chain with fp32 accumulation -> (TFLOP/s, trustworthy?,
    cross_check_ratio)."""
    dev = resolve_device(device)
    chain = 8
    with _measurement("perf.gemm") as times:
        with tracing.mark("perf.operands"):
            gen = torch.Generator(device=dev).manual_seed(0)
            # ~unit spectral scale keeps 8*iters repeated contractions in bf16 range
            b = torch.randn((dim, dim), generator=gen, device=dev,
                            dtype=torch.bfloat16) / (dim ** 0.5)
            a = torch.randn((dim, dim), generator=gen, device=dev, dtype=torch.bfloat16)

        def chained(x):
            for _ in range(chain):
                x = torch.matmul(x, b)
            return x

        t, ok, grown, ratio = _chain_time(chained, a, iters, dev, cross_check=True,
                                          times=times)
        if ratio is not None and not (CROSS_CHECK_BAND[0] <= ratio <= CROSS_CHECK_BAND[1]):
            # one retry from the settled size before distrusting the timing
            times.retry()
            t, ok, _, ratio = _chain_time(chained, a, grown, dev, cross_check=True,
                                          times=times)
        tracing.count("perf.gemm.iters", times.iters)
    flops = 2.0 * dim * dim * dim * chain
    return flops / t / 1e12, ok, ratio


#: the probe's addend as a 0-dim CPU tensor: on a CUDA input TensorIterator
#: lifts it into the kernel as a scalar argument, so the kernel sees one
#: contiguous input and takes its vectorised path. A 0-dim CUDA tensor is
#: instead an operand broadcast with stride 0, which keeps the kernel off
#: that path (about 16% slower than a copy on an H100, PERF.md).
_PROBE_ONE = torch.ones((), dtype=torch.float32)


def scale_add(x: torch.Tensor) -> torch.Tensor:
    """The HBM probe's step, the reference's ``x * 1.0001 + 1.0``, as ONE
    elementwise kernel with one read and one write: ``1 + 1.0001 * x``,
    contracted to one fused multiply-add in fp32, as XLA computes it.
    Written as ``x * 1.0001 + 1.0``, eager PyTorch would launch two
    kernels and move twice the bytes, halving the reading."""
    return torch.add(_PROBE_ONE, x, alpha=1.0001)


def measure_hbm_gbps(mib: int = 512, iters: int = 5, device: DeviceLike = None
                     ) -> Tuple[float, bool]:
    """Memory-bound scale-add (:func:`scale_add`): reads + writes `mib` MiB."""
    dev = resolve_device(device)
    n = mib * 1024 * 1024 // 4  # fp32 elements
    with _measurement("perf.hbm") as times:
        with tracing.mark("perf.operands"):
            x = torch.ones((n,), dtype=torch.float32, device=dev)
        t, ok, _, _ = _chain_time(scale_add, x, iters, dev, times=times)
    bytes_moved = 2.0 * n * 4  # one read + one write of the array
    return bytes_moved / t / 1e9, ok


def stream_rows(mib: int) -> int:
    """Rows of the streaming kernel's (rows, 1024) fp32 array: `mib` MiB cut
    to whole 512-row blocks, as the TPU kernel's grid must be — the byte
    count the GB/s is computed from stays the reference's."""
    rows = mib * 1024 * 1024 // 4 // STREAM_LANES
    block_rows = min(STREAM_BLOCK_ROWS, max(rows, 1))
    return rows - rows % block_rows


def measure_hbm_kernel_gbps(mib: int = 512, iters: int = 5, device: DeviceLike = None
                            ) -> Tuple[float, bool]:
    """Streaming-copy twin of :func:`measure_hbm_gbps`: the hand-written
    Hopper kernel streams `mib` MiB (one read + one write, the same bytes
    the probe moves) through the same chain timing. (0.0, False) on the
    CPU, where there is no kernel to time; on CUDA it builds and launches
    the kernel, and any error propagates."""
    dev = resolve_device(device)
    rows = stream_rows(mib)
    with _measurement("perf.k1") as times:
        if dev.type != "cuda" or rows == 0:
            return 0.0, False
        with tracing.mark("perf.operands"):
            x = torch.ones((rows, STREAM_LANES), dtype=torch.float32, device=dev)
        t, ok, _, _ = _chain_time(stream_copy, x, iters, dev, times=times)
    bytes_moved = 2.0 * rows * STREAM_LANES * 4
    return bytes_moved / t / 1e9, ok


#: longest chain of all-reduces per timed sample, once the buffer is at its cap
ALLREDUCE_MAX_ITERS = 320


def _allreduce_rank(rank: int, n: int, device: torch.device, t0: float,
                    mib: int, iters: int, growth_budget_s: float):
    """One rank's all-reduce bus bandwidth (GB/s, trustworthy?).

    The buffer grows first, as on the TPU, until the time clears the noise
    floor. NVLink moves even the largest buffer too fast for 5 calls to
    clear 50 ms (4 H100s at ~325 GB/s: ~6 ms at 256 MiB), so past the
    buffer cap the chain grows too — the TPU sweep could not, since deep
    chains of pmap collectives wedge XLA's in-process rendezvous; NCCL has
    no such limit. Every decision is taken on the slowest rank's reading so all ranks
    issue the same collectives."""
    def agreed(*values: float) -> list:
        t = torch.tensor(values, dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.tolist()

    elems = mib * 1024 * 1024 // 4
    # the TPU sweep's cap, kept as it behaves: it holds the buffer's bytes
    # against 512 MiB's fp32 element count, so growth stops once the buffer
    # passes 128 MiB (from the default 64 MiB: 64, then 256 MiB)
    cap_bytes = 512 * 1024 * 1024 // 4
    grow_start = time.monotonic()
    while True:
        # zeros stay zeros under repeated sums: no overflow at any depth
        x = torch.zeros((elems,), dtype=torch.float32, device=device)
        dist.all_reduce(x)
        _fetch_one(x)
        samples = []
        for _ in range(5):
            s = time.perf_counter()
            _fetch_one(x)
            samples.append(time.perf_counter() - s)
        rtt = min(samples)
        totals = []
        for _ in range(3):
            s = time.perf_counter()
            for _ in range(iters):
                dist.all_reduce(x)
            _fetch_one(x)
            totals.append(time.perf_counter() - s)
        total, rtt, spent = agreed(statistics.median(totals), rtt,
                                   time.monotonic() - grow_start)
        ok = total >= max(20.0 * rtt, 0.05)
        if ok or spent > growth_budget_s:
            break
        if elems * 4 <= cap_bytes:
            elems *= 4
        elif iters * 4 <= ALLREDUCE_MAX_ITERS:
            iters *= 4
        else:
            break
    t = max(total - rtt, 1e-9) / iters
    bytes_on_bus = 2.0 * (n - 1) / n * elems * 4
    return bytes_on_bus / t / 1e9, ok


def measure_ici_allreduce_gbps(mib: int = 64, iters: int = 5, growth_budget_s: float = 15.0,
                               device: DeviceLike = None) -> Tuple[Optional[float], bool]:
    """Ring all-reduce bus bandwidth across all local GPUs over NCCL, one
    rank per GPU; (None, True) when there is nothing to measure (one GPU,
    or the host CPU): "no fabric" is not "fabric at 0 GB/s"."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n < 2:
        return None, True
    with tracing.span("perf.allreduce", ranks=n):
        results = run_ranks(_allreduce_rank, n, dev.type,
                            args=(mib, iters, growth_budget_s))
    return results[0]


def run_perf(matrix_dim: int = 4096, hbm_mib: int = 512, ici_mib: int = 64,
             thresholds: Optional[Dict[str, float]] = None,
             iters: int = 5, device: DeviceLike = None) -> PerfReport:
    """Run all sweeps; apply optional floor thresholds (keys: mxu_tflops,
    hbm_gbps, ici_allreduce_gbps; 0/absent = skip)."""
    dev = resolve_device(device)
    thresholds = thresholds or {}
    report = PerfReport()
    t0 = time.perf_counter()
    try:
        with tracing.mark("perf.devices"):
            report.platform = platform_of(dev)
            report.n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
            report.device_kind = device_kind(dev)
        mxu, mxu_ok, ratio = measure_mxu_tflops(matrix_dim, iters, device=dev)
        hbm, hbm_ok = measure_hbm_gbps(hbm_mib, iters, device=dev)
        ici, ici_ok = measure_ici_allreduce_gbps(ici_mib, iters, device=dev)
        report.mxu_tflops = round(mxu, 3)
        report.hbm_gbps = round(hbm, 3)
        if ici is None:
            report.ici_skipped = True  # single GPU: no fabric to measure
        else:
            report.ici_allreduce_gbps = round(ici, 3)
        report.mxu_cross_check_ratio = ratio
        kernel_hbm, kernel_ok = measure_hbm_kernel_gbps(hbm_mib, iters, device=dev)
        if kernel_ok and kernel_hbm > 0:
            report.hbm_pallas_gbps = round(kernel_hbm, 3)
            report.hbm_streaming_cross_check_ratio = round(hbm / kernel_hbm, 3)
            if not (HBM_STREAMING_BAND[0] <= report.hbm_streaming_cross_check_ratio
                    <= HBM_STREAMING_BAND[1]):
                report.failures.append(
                    f"hbm_streaming_cross_check_ratio="
                    f"{report.hbm_streaming_cross_check_ratio} outside "
                    f"{HBM_STREAMING_BAND}: scale-add probe and streaming-copy "
                    f"kernel disagree — HBM fraction not attributable to the "
                    f"card's streaming limit")
        timing_ok = (mxu_ok and hbm_ok and ici_ok
                     and (ratio is None
                          or CROSS_CHECK_BAND[0] <= ratio <= CROSS_CHECK_BAND[1]))
        report.measurement_valid = timing_ok
    except Exception as e:
        report.failures.append(f"perf sweep failed: {e}")
        report.measurement_valid = False  # nothing measured, nothing trusted
        report.elapsed_s = round(time.perf_counter() - t0, 3)
        return report
    report.elapsed_s = round(time.perf_counter() - t0, 3)

    peaks = lookup_peaks(report.device_kind)
    if peaks:
        report.chip, mxu_peak, hbm_peak = peaks
        report.mxu_peak_fraction = round(report.mxu_tflops / mxu_peak, 4)
        report.hbm_peak_fraction = round(report.hbm_gbps / hbm_peak, 4)
        # >105% of a published peak is physically impossible: the
        # measurement, not the card, is wrong
        for frac_key in ("mxu_peak_fraction", "hbm_peak_fraction"):
            frac = getattr(report, frac_key)
            if frac > MAX_PEAK_FRACTION:
                report.failures.append(
                    f"{frac_key}={frac} exceeds chip peak — "
                    f"measurement untrustworthy")
                report.measurement_valid = False

    if not timing_ok:
        report.failures.append(
            "timing noise floor reached or completion signals disagree — "
            "throughput numbers untrustworthy")

    for key in ("mxu_tflops", "hbm_gbps", "ici_allreduce_gbps"):
        floor = thresholds.get(key, 0.0)
        measured = getattr(report, key)
        if floor > 0 and measured is None:
            report.failures.append(
                f"{key} not measured (skipped) but floor {floor} required")
        elif floor > 0 and measured < floor:
            report.failures.append(
                f"{key}={measured} below required floor {floor}")
    report.passed = not report.failures
    return report
