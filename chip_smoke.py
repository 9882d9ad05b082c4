#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_operator_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. environment: the card's name and power limit (nvidia-smi), torch, CUDA
2. build every CUDA source of the port with nvcc (timed)
3. each kernel against its plain PyTorch version on the card, bit-exact
4. each kernel's time beside its plain version, its library call and its
   bound, at the shapes the main path gives it
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
        from tpu_operator_torch.validator.perf import lookup_peaks, stream_rows
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
    # both ends at element 1: scalar head, float4 body, scalar tail
    dst = torch.zeros((1_000_005,), device=dev)
    k1.launch(base[1:], dst[1:])
    torch.cuda.synchronize()
    check(bits_equal(dst[1:], base[1:]) and dst[0].item() == 0.0,
          "stream_copy differs from its plain version: both ends at element 1")
    print("both ends at element 1: bit-exact, neighbour untouched")
    check(k1.launches == before + len(cases) + 1,
          f"launch count {k1.launches - before}, expected {len(cases) + 1}")

    phase("K1 timing")
    out = torch.empty_like(x_main)
    fns = {"kernel": k1.stream_copy, "plain": k1.stream_copy_reference,
           "library": lambda t: out.copy_(t)}
    samples = {name: [] for name in fns}
    for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
        samples[name].append(cuda_ms(fns[name], x_main, reps=50))
    bytes_moved = 2 * x_main.numel() * 4
    timing = {name: statistics.median(v) for name, v in samples.items()}
    bound_ms = bytes_moved / (hbm_peak_gbps * 1e9) * 1e3
    print(json.dumps({"kernel": "stream_copy", "shape": list(x_main.shape),
                      "kernel_ms": timing["kernel"], "plain_ms": timing["plain"],
                      "library_ms": timing["library"], "bound_ms": bound_ms,
                      "kernel_gbps": bytes_moved / timing["kernel"] / 1e6,
                      "card": card}))
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
