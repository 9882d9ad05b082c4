"""Plain reference for node certification (``gpu-validator -c perf``), and
the comparison that decides a run's ``correct``.

It measures, with plain PyTorch on operands it makes from the seed and
with CUDA events around a chain of launches, what a certification reports:

- ``gemm_tflops``: bf16 ``dim x dim`` products (``torch.matmul``), TFLOP/s;
- ``hbm_gbps``: one elementwise pass (``torch.mul(out=)``) over ``hbm_mib``
  MiB of fp32, one read and one write, GB/s;
- ``copy_gbps``: K1's plain version, ``copy_`` of the fp32 ``(rows, 1024)``
  array the certification streams, GB/s;
- ``allreduce_gbps`` (more than one GPU): NCCL sum over every GPU, one
  spawned rank each, at the buffer the certification settles on, bus GB/s
  (ring factor ``2 (n - 1) / n``); None on one GPU, which has no fabric.

With ``lower=True`` each is computed one precision below the
configuration's (fp8 for the bf16 GEMM, bf16 for the fp32 arrays and the
all-reduce) while the configuration's operations and bytes are counted:
that is the control, which the comparison has to refuse.

It imports nothing of the program and takes nothing the program made.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import queue as queue_mod
import shutil
import statistics
import tempfile
import traceback
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from .. import sizes as sizes_mod
from ..counts import k1

MiB = 1024 * 1024
#: device time one timed chain of launches should span at least
CHAIN_MS = 100.0
ROUNDS = 5
#: the highest reading over a data-sheet peak that a sound measurement gives
MAX_PEAK_FRACTION = 1.05
#: the certification's all-reduce buffer grows 4x while it is at most this
#: many bytes (``perf._allreduce_rank``: 512 MiB of fp32 elements), so its
#: 64 MiB start settles at 256 MiB on a fabric that moves it in under 50 ms
ALLREDUCE_GROW_WHILE_BYTES = 128 * MiB
ALLREDUCE_REPS = 40
RANK_TIMEOUT_S = 180.0

#: each number compared and its limit, set on the card (NVIDIA H100 80GB
#: HBM3, 700 W) between the widest gap that sound runs read over a dozen
#: seeds and the least that the control or a planted fault reads (PERF.md
#: gives both readings). A gap is |program's reading / reference's - 1|,
#: the widest over the run's passes. ``allreduce_gap`` is read only where
#: the node has more than one GPU.
LIMITS = {
    "gemm_gap": 0.15,  # sound 0.0443, control 0.6862, GEMM reading x1.3 0.2533
    "hbm_gap": 0.10,  # sound 0.0047, control 0.9797, half the probe's array 0.9733
    "k1_gap": 0.15,  # sound 0.0095, control 0.9920
    "allreduce_gap": 0.25,  # sound 0.0471, control 0.8615, exchange left out 3904
    "verdict_mismatches": 0,  # exact
}
#: the report's reading that each gap judges, and the reference's
READINGS = (
    ("gemm_gap", "mxu_tflops", "gemm_tflops"),
    ("hbm_gap", "hbm_gbps", "hbm_gbps"),
    ("k1_gap", "hbm_pallas_gbps", "copy_gbps"),
    ("allreduce_gap", "ici_allreduce_gbps", "allreduce_gbps"),
)


def _events_ms(step: Callable[[], object], reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def ms_per_call(step: Callable[[], object]) -> float:
    """Device milliseconds per ``step``: the chain grown until it spans
    ``CHAIN_MS``, then the median of ``ROUNDS`` chains."""
    step()
    torch.cuda.synchronize()
    reps = 1
    while True:
        ms = _events_ms(step, reps)
        if ms >= CHAIN_MS:
            break
        reps = max(2 * reps, math.ceil(reps * 1.2 * CHAIN_MS / max(ms, 1e-3)))
    samples = [ms] + [_events_ms(step, reps) for _ in range(ROUNDS - 1)]
    return statistics.median(samples) / reps


def allreduce_bytes(mib: int) -> int:
    size = mib * MiB
    while size <= ALLREDUCE_GROW_WHILE_BYTES:
        size *= 4
    return size


def gemm_tflops(dim: int, gen: torch.Generator, dev: torch.device, lower: bool) -> float:
    if lower:
        fp8 = torch.float8_e4m3fn
        a = torch.randn((dim, dim), generator=gen, device=dev).to(fp8)
        # the second operand column-major, as the fp8 product takes it
        b = torch.randn((dim, dim), generator=gen, device=dev).to(fp8).t()
        one = torch.ones((), device=dev, dtype=torch.float32)

        def step():
            return torch._scaled_mm(a, b, scale_a=one, scale_b=one, out_dtype=torch.bfloat16)
    else:
        a = torch.randn((dim, dim), generator=gen, device=dev, dtype=torch.bfloat16)
        b = torch.randn((dim, dim), generator=gen, device=dev, dtype=torch.bfloat16)
        c = torch.empty((dim, dim), device=dev, dtype=torch.bfloat16)

        def step():
            return torch.matmul(a, b, out=c)
    ms = ms_per_call(step)
    return 2.0 * dim ** 3 / (ms * 1e-3) / 1e12


def hbm_gbps(mib: int, gen: torch.Generator, dev: torch.device, lower: bool) -> float:
    n = mib * MiB // 4  # fp32 elements
    dtype = torch.bfloat16 if lower else torch.float32
    x = torch.rand((n,), generator=gen, device=dev, dtype=dtype)
    y = torch.empty_like(x)
    ms = ms_per_call(lambda: torch.mul(x, 1.0001, out=y))
    return 2.0 * n * 4 / (ms * 1e-3) / 1e9


def copy_gbps(mib: int, gen: torch.Generator, dev: torch.device, lower: bool) -> float:
    rows = k1.rows(mib)
    dtype = torch.bfloat16 if lower else torch.float32
    x = torch.rand((rows, 1024), generator=gen, device=dev, dtype=dtype)
    y = torch.empty_like(x)
    ms = ms_per_call(lambda: y.copy_(x))
    return 2.0 * rows * 1024 * 4 / (ms * 1e-3) / 1e9


def _allreduce_rank(rank: int, n: int, store_path: str, nbytes: int, lower: bool,
                    seed: int, results) -> None:
    try:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=dist.FileStore(store_path, n),
                                rank=rank, world_size=n)
        try:
            gen = torch.Generator(device=dev).manual_seed(seed + rank)
            dtype = torch.bfloat16 if lower else torch.float32
            # positive values: repeated sums grow, and at worst reach inf,
            # never NaN; the time does not depend on them
            x = torch.rand((nbytes // 4,), generator=gen, device=dev, dtype=dtype)
            for _ in range(5):
                dist.all_reduce(x)
            torch.cuda.synchronize()
            samples = [_events_ms(lambda: dist.all_reduce(x), ALLREDUCE_REPS)
                       for _ in range(ROUNDS)]
        finally:
            dist.destroy_process_group()
        results.put((rank, statistics.median(samples) / ALLREDUCE_REPS, None))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, None, traceback.format_exc()))


def allreduce_gbps(mib: int, n: int, seed: int, lower: bool) -> float:
    """Bus GB/s of the slowest rank's all-reduce, one spawned rank per GPU."""
    nbytes = allreduce_bytes(mib)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    where = tempfile.mkdtemp(prefix="bench-gpu-ref-")
    procs = [ctx.Process(target=_allreduce_rank, daemon=True,
                         args=(r, n, os.path.join(where, "store"), nbytes, lower, seed,
                               results))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        got: Dict[int, float] = {}
        while len(got) < n:
            try:
                rank, ms, err = results.get(timeout=RANK_TIMEOUT_S)
            except queue_mod.Empty:
                raise TimeoutError(f"reference ranks silent for {RANK_TIMEOUT_S} s") from None
            if err is not None:
                raise RuntimeError(f"reference rank {rank} failed:\n{err}")
            got[rank] = ms
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(where, ignore_errors=True)
    ms = max(got.values())
    return 2.0 * (n - 1) / n * nbytes / (ms * 1e-3) / 1e9


def measure(config: dict, seed: int, lower: bool = False) -> Dict[str, Optional[float]]:
    """The reference's readings for the configuration, on ``cuda:0`` (and
    every GPU for the all-reduce)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sizes = sizes_mod.perf_sizes(config["validator_flags"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: Dict[str, Optional[float]] = {
        "gemm_tflops": gemm_tflops(sizes["matrix_dim"], gen, dev, lower),
        "hbm_gbps": hbm_gbps(sizes["hbm_mib"], gen, dev, lower),
        "copy_gbps": copy_gbps(sizes["hbm_mib"], gen, dev, lower),
        "allreduce_gbps": None,
    }
    torch.cuda.empty_cache()
    if config["gpus"] > 1:
        out["allreduce_gbps"] = allreduce_gbps(sizes["ici_mib"], config["gpus"], seed, lower)
    return out


def healthy(ref: Dict[str, Optional[float]], peaks: Optional[dict]) -> bool:
    """The reference's verdict on the card: no reading above a sound share
    of its peak (the configuration's floors are 0, so none is too low)."""
    if not peaks:
        return True
    return (ref["gemm_tflops"] * 1e12 <= MAX_PEAK_FRACTION * peaks["bf16_flops_per_s"]
            and ref["hbm_gbps"] * 1e9 <= MAX_PEAK_FRACTION * peaks["hbm_bytes_per_s"]
            and ref["copy_gbps"] * 1e9 <= MAX_PEAK_FRACTION * peaks["hbm_bytes_per_s"])


def gap(reading, ref: float) -> float:
    """|reading / ref - 1|; a reading that is missing or 0 reads 1."""
    if not reading:
        return 1.0
    return abs(reading / ref - 1.0)


def verdict_ok(p, expect_pass: bool, gpus: int) -> bool:
    """The pass's verdict and what it wrote agree with the reference's: it
    passes exactly when the card is healthy, exits 0 exactly then, leaves
    the barrier exactly then, and measured the fabric exactly when the
    node has one, over every GPU."""
    report = p.report or {}
    passed = bool(report.get("passed"))
    wrote = p.barrier is not None and bool(p.barrier.get("passed"))
    return (passed == expect_pass and (p.rc == 0) == expect_pass and wrote == expect_pass
            and report.get("n_devices") == gpus
            and bool(report.get("ici_skipped")) == (gpus == 1))


def checks(passes: List, ref: Dict[str, Optional[float]], config: dict,
           peaks: Optional[dict]) -> Dict[str, Dict[str, float]]:
    """Each number compared beside its limit."""
    out: Dict[str, Dict[str, float]] = {}
    for name, key, ref_key in READINGS:
        if ref[ref_key] is None:
            continue
        out[name] = {"value": max(gap((p.report or {}).get(key), ref[ref_key])
                                  for p in passes),
                     "limit": LIMITS[name]}
    expect = healthy(ref, peaks)
    out["verdict_mismatches"] = {
        "value": sum(not verdict_ok(p, expect, config["gpus"]) for p in passes),
        "limit": LIMITS["verdict_mismatches"]}
    return out


def correct(compared: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())
