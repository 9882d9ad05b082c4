#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_operator_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. environment: the card's name and power limit (nvidia-smi), torch, CUDA
2. build every CUDA source of the port with nvcc (timed)
3. each kernel against its plain PyTorch version on the card, bit-exact
   (K1: the main shape, ragged lengths, chunk boundaries, every relative
   alignment of the two ends with their neighbours untouched, and a plan
   the C entry must refuse)
4. each kernel's time beside its plain version, its library call and its
   bound, at the shapes the main path gives it; K1 also beside the HBM
   probe's one op, which must run as one device kernel
5. main path: the validator's ``workload-local`` sweep (matrix 512), then
   ``perf`` at the CLI defaults (4096 / 512 MiB); kernel launch counts are
   zeroed before and read after, and every kernel must have launched
6. the graft entry points (single-GPU check, 1-rank mesh dry run)

Then one ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Needs a CUDA device and the rest of the repository beside this file.
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time

import torch


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, x, reps: int) -> float:
    """Mean milliseconds of ``fn(x)`` over ``reps`` launches, CUDA events."""
    fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs an NVIDIA GPU")
    try:
        from tpu_operator_torch.kernels import _build
        from tpu_operator_torch.kernels import stream_copy as k1
        from tpu_operator_torch.validator import main as vmain
        from tpu_operator_torch.validator.perf import (HBM_STREAMING_BAND, lookup_peaks,
                                                       scale_add, stream_rows)
        from tpu_operator_torch.validator.status import StatusFiles
        from tpu_operator_torch import graft_entry
    except ImportError as e:
        fail(f"tpu_operator_torch not importable ({e}): run from the repository root")

    phase("environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}")
    peaks = lookup_peaks(kind)
    check(peaks is not None, f"no peak-table row for {kind!r}")
    chip, _, hbm_peak_gbps = peaks
    print(f"peaks: {chip} HBM {hbm_peak_gbps} GB/s (data sheet)")

    phase("build")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3), "per_source_s": built}))
    for name, log in _build.build_logs.items():
        print(f"-- ptxas {name}:\n{log.strip()}")
    print(f"K1: bulk copies of {k1.CHUNK_BYTES} B, two per CTA, dynamic shared memory "
          f"raised to cap residency at two CTAs per SM (csrc/stream_copy.cu)")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    phase("K1 stream_copy against its plain version")
    rows = stream_rows(512)  # the perf component's default 512 MiB
    x_main = torch.randn((rows, 1024), generator=gen, device=dev)
    ragged = torch.randn((1_000_003,), generator=gen, device=dev)
    base = torch.randn((1_000_005,), generator=gen, device=dev)
    cases = {
        "main (131072, 1024)": x_main,
        "ragged 1000003": ragged,
        "view at element 1": base[1:],
    }
    before = k1.launches
    max_err = 0.0
    for label, x in cases.items():
        y = k1.stream_copy(x)
        ref = k1.stream_copy_reference(x)
        torch.cuda.synchronize()
        check(bits_equal(y, ref), f"stream_copy differs from its plain version: {label}")
        max_err = max(max_err, (y - ref).abs().max().item())
        print(f"{label}: bit-exact")
    # chunk boundaries: a body of one chunk, one chunk +- 16 B, two chunks,
    # and more chunks than CTAs with a ragged tail, each at element offsets
    # 0 and 1 of both ends (scalar head, bulk body, scalar tail)
    chunk = k1.CHUNK_BYTES // 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lengths = [chunk, chunk - 4, chunk + 4, chunk + 3, 2 * chunk,
               3 * sms * chunk + 4 * 7 + 3]
    pool = torch.randn((max(lengths) + 8,), generator=gen, device=dev)
    sentinel = -12345.0
    expected = len(cases)

    def placed(n: int, src_off: int, dst_off: int, label: str) -> None:
        dst = torch.full((n + 8,), sentinel, device=dev)
        k1.launch(pool[src_off:src_off + n], dst[dst_off:dst_off + n])
        torch.cuda.synchronize()
        check(bits_equal(dst[dst_off:dst_off + n], pool[src_off:src_off + n]),
              f"stream_copy differs from its plain version: {label}")
        check(bool((dst[:dst_off] == sentinel).all()) and
              bool((dst[dst_off + n:] == sentinel).all()),
              f"stream_copy wrote outside its destination: {label}")

    for n in lengths:
        for off in (0, 1):
            placed(n, off, off, f"n={n} at element {off}")
            expected += 1
    print(f"chunk boundaries {lengths} at element offsets 0 and 1: bit-exact, "
          f"neighbours untouched")
    # every relative alignment of the two ends (element offsets 0-3 each)
    for src_off in range(4):
        for dst_off in range(4):
            placed(1_000_003, src_off, dst_off, f"offsets src {src_off} dst {dst_off}")
            expected += 1
    print("every relative alignment (offsets 0-3 x 0-3): bit-exact, neighbours untouched")
    bad = k1.launch_plan(x_main.data_ptr(), x_main.data_ptr(), x_main.numel())
    try:
        k1.run_plan(x_main, torch.empty_like(x_main), bad._replace(tail=bad.tail + 1))
        fail("stream_copy accepted a plan that does not cover the tensor")
    except RuntimeError as e:
        print(f"inconsistent plan refused: {e}")
    check(k1.launches == before + expected,
          f"launch count {k1.launches - before}, expected {expected}")

    phase("K1 timing")
    out = torch.empty_like(x_main)
    bytes_moved = 2 * x_main.numel() * 4
    fns = {"kernel": k1.stream_copy, "plain": k1.stream_copy_reference,
           "library": lambda t: out.copy_(t), "probe": scale_add}
    samples = {name: [] for name in fns}
    order = list(fns)
    for name in order + order[::-1]:
        samples[name].append(cuda_ms(fns[name], x_main, reps=50))
    timing = {name: statistics.median(v) for name, v in samples.items()}
    gbps = {name: bytes_moved / ms / 1e6 for name, ms in timing.items()}
    bound_ms = bytes_moved / (hbm_peak_gbps * 1e9) * 1e3
    print(json.dumps({"kernel": "stream_copy", "shape": list(x_main.shape),
                      "kernel_ms": timing["kernel"], "plain_ms": timing["plain"],
                      "library_ms": timing["library"], "probe_ms": timing["probe"],
                      "bound_ms": bound_ms, "gbps": gbps, "card": card}))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scale_add(x_main)
        torch.cuda.synchronize()
    probe_kernels = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    print(f"probe device kernels (torch.profiler): {probe_kernels}")
    check(len(probe_kernels) == 1, f"the HBM probe ran {len(probe_kernels)} device kernels")
    del x_main, out, fns

    phase("main path: workload-local, then perf")
    status_dir = tempfile.mkdtemp(prefix="chip-smoke-status-")
    k1.launches = 0
    rc = vmain.run(["-c", "workload-local", "--matrix-dim=512",
                    f"--status-dir={status_dir}"])
    check(rc == 0, f"workload-local exited {rc}")
    status = StatusFiles(status_dir)
    barrier = status.read("workload")
    check(status.is_ready("workload"), f"workload barrier not ready: {barrier}")
    check(barrier.get("platform") == "gpu", f"workload platform {barrier.get('platform')}")
    perf_before = k1.launches
    rc = vmain.run(["-c", "perf", f"--status-dir={status_dir}"])
    k1_main_launches = k1.launches
    check(rc == 0, f"perf exited {rc}")
    report = status.read("perf")
    check(report is not None and report.get("hbm_pallas_gbps", 0) > 0,
          f"perf barrier without a streaming-kernel reading: {report}")
    check(k1_main_launches > perf_before, "stream_copy was not launched by perf")
    print(json.dumps({"perf_report": report, "card": card}))
    ratio = report.get("hbm_streaming_cross_check_ratio")
    check(ratio is not None and HBM_STREAMING_BAND[0] <= ratio <= HBM_STREAMING_BAND[1],
          f"probe/K1 ratio {ratio} outside {HBM_STREAMING_BAND}")
    probe_vs_copy = report["hbm_gbps"] / gbps["library"]
    print(f"perf hbm_gbps {report['hbm_gbps']} / copy_ {gbps['library']:.3f} GB/s "
          f"= {probe_vs_copy:.4f}")
    check(abs(probe_vs_copy - 1.0) <= 0.05,
          f"the HBM probe streams at {probe_vs_copy:.4f} of copy_'s rate, not within 5%")

    phase("graft entry")
    fn, args = graft_entry.entry()
    c, checks = fn(*args)
    check(bool(checks.all()) and tuple(c.shape) == (512, 512), f"entry checks {checks}")
    graft_entry.dryrun_multichip(1)
    print("entry ok, dryrun_multichip(1) ok")

    print(json.dumps({"kernels": [{
        "name": "stream_copy",
        "route": "cuda",
        "source": "tpu_operator_torch/csrc/stream_copy.cu",
        "replaces": "tpu_operator/validator/perf.py:302",
        "launches": k1_main_launches,
        "max_abs_err": max_err,
        "ms": timing["kernel"],
        "plain_ms": timing["plain"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": timing["library"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
