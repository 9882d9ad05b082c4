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
7. serving: the decode step's CUDA graph replay against the eager step,
   bit-equal on seeded integer inputs at batch 8, dim 256; both steps
   timed; then ``serving`` at the CLI defaults (ladder 1, 4, 8, 32 steps,
   dim 256) must pass with a three-point frontier on platform ``gpu``.
   The serving path launches no hand-written kernel: its two products are
   cuBLAS, as the reference's are XLA dots
8. prewarm: in subprocesses (so the earlier phases' K1 stays the one built
   in phase 2), ``prewarm`` builds K1 into a fresh
   ``$GPU_COMPILATION_CACHE_DIR``; a second process with no ``nvcc``
   reachable loads it from there and runs it bit-exact

``workload`` spawns a pod through an apiserver, which this machine lacks:
the CPU tests (``tests/test_torch_join_chain.py``) cover it.

Then one ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Needs a CUDA device and the rest of the repository beside this file.
"""

import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

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


def step_wall_ms(step, load, n: int) -> list:
    """Per-step wall milliseconds as the probe times a step: the buffers
    are written and the card idle before the clock starts, and the window
    ends with a synchronize."""
    out = []
    for i in range(n):
        load(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def serving_phase(dev, gen, card) -> None:
    from tpu_operator_torch.device import set_numerics
    from tpu_operator_torch.kernels import stream_copy as k1
    from tpu_operator_torch.serving import probe
    from tpu_operator_torch.validator import main as vmain
    from tpu_operator_torch.validator.status import StatusFiles

    set_numerics()
    batch, dim = 8, 256  # the deepest rung and the width of the CLI defaults
    engine = probe.DecodeEngine(batch, dim, dev)
    engine.w.copy_(torch.randint(-2, 3, (dim, dim), generator=gen, device=dev))
    engine.tokens.copy_(torch.randint(-2, 3, (batch, dim), generator=gen, device=dev))
    t0 = time.perf_counter()
    engine.capture()
    capture_s = time.perf_counter() - t0
    # the eager step, run under the sync debugger: any op that waits on the
    # host would also have refused capture
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            probe.engine_step(*engine.args())
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sorted({str(w.message).splitlines()[0] for w in caught
                    if "called a synchronizing" in str(w.message)})
    print(json.dumps({"capture_s": capture_s, "host_syncs_in_eager_step": syncs}))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.graph.replay()
        torch.cuda.synchronize()
    print(json.dumps({"graph_replay_kernels_us": [
        (e.key[:80], round(e.device_time_total, 3))
        for e in prof.key_averages() if e.device_time_total > 0]}))

    n_pages = batch + 1
    for trial in range(4):
        pages = torch.randint(-8, 9, (n_pages, probe.PAGE_SIZE, dim), generator=gen,
                              device=dev).float()
        table = torch.randperm(n_pages, generator=gen, device=dev)[:batch]
        active = torch.randint(0, 2, (batch,), generator=gen, device=dev).float()
        active[trial] = 0.0
        admit = torch.randint(0, 2, (batch,), generator=gen, device=dev).float()
        eager_pages = pages.clone()
        eager_out, _ = probe.engine_step(engine.tokens, eager_pages, table, active, admit,
                                         engine.w)
        engine.pages.copy_(pages)
        engine.page_table.copy_(table)
        engine.active.copy_(active)
        engine.admit.copy_(admit)
        out = engine.step()
        torch.cuda.synchronize()
        check(torch.equal(out, eager_out), f"graph argmax differs from the eager step ({trial})")
        check(bits_equal(engine.pages, eager_pages),
              f"graph cache differs from the eager step ({trial})")
    print("graph replay == eager step: argmax and cache bit-equal on 4 seeded integer inputs")

    # time both at batch 8: the probe's per-step window, in turns (eager,
    # graph, graph, eager), and back-to-back device time by CUDA events
    engine.pages.zero_()
    engine.set_depth(batch)
    host_gen = torch.Generator().manual_seed(0)
    tables = [torch.randperm(n_pages, generator=host_gen)[:batch].tolist() for _ in range(64)]

    def load(i):
        engine.load(tables[i % 64], admit_slot=i % batch)

    eager = lambda: probe.engine_step(*engine.args())  # noqa: E731
    wall = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        wall[name] += step_wall_ms(eager if name == "eager" else engine.step, load, 200)
    device_ms = {"eager": cuda_ms(lambda _: eager(), None, reps=500),
                 "graph": cuda_ms(lambda _: engine.graph.replay(), None, reps=500)}
    steps = {name: {"wall_p50_ms": statistics.median(v),
                    "wall_p99_ms": probe._percentile(sorted(v), 0.99),
                    "device_ms": device_ms[name], "samples": len(v)}
             for name, v in wall.items()}
    print(json.dumps({"serving_step": steps, "batch": batch, "dim": dim, "card": card}))
    del engine

    status_dir = tempfile.mkdtemp(prefix="chip-smoke-serving-")
    k1.launches = 0
    rc = vmain.run(["-c", "serving", f"--status-dir={status_dir}"])
    check(k1.launches == 0, f"the serving path launched K1 {k1.launches} times")
    report = StatusFiles(status_dir).read("serving")
    check(rc == 0, f"serving exited {rc}: {report and report.get('failures')}")
    check(report.get("passed") is True and report.get("platform") == "gpu",
          f"serving barrier {report}")
    check(report["failures"] == [], f"serving failures {report['failures']}")
    points = report["frontier"]["points"]
    check([p["batch"] for p in points] == [1, 4, 8] and
          all(p["samples"] >= probe.MIN_FRONTIER_SAMPLES for p in points),
          f"frontier {points}")
    check(report["frontier"]["model_dim"] == 256, "probe width")
    print(json.dumps({"serving": {k: report[k] for k in (
        "compile_s", "elapsed_s", "decode_p50_ms", "decode_p99_ms",
        "throughput_tokens_per_s", "slo_attainment", "n_devices")},
        "rungs": [{k: r[k] for k in ("batch", "samples", "p50_ms", "p99_ms", "mean_ms",
                                     "tokens_per_s")} for r in report["batches"]],
        "card": card}))


def prewarm_phase(card) -> None:
    """``prewarm`` in a fresh cache dir, then a process that cannot reach
    ``nvcc`` loads and runs K1 from it."""
    with tempfile.TemporaryDirectory(prefix="chip-smoke-kernel-cache-") as cache:
        env = dict(os.environ, GPU_COMPILATION_CACHE_DIR=cache)
        cold = subprocess.run([sys.executable, "-m", "tpu_operator_torch.cmd.validator",
                               "-c", "prewarm"], env=env, capture_output=True, text=True,
                              timeout=300)
        check(cold.returncode == 0, f"prewarm exited {cold.returncode}: {cold.stderr[-2000:]}")
        lines = [ln for ln in cold.stdout.splitlines() if ln.startswith("{")]
        check(bool(lines), f"prewarm printed no result: {cold.stderr[-2000:]}")
        cold_result = json.loads(lines[-1])
        built = glob.glob(os.path.join(cache, "libstream_copy-*.so"))
        check(len(built) == 1, f"K1 not built into the cache dir: {os.listdir(cache)}")

        no_nvcc = [d for d in os.environ.get("PATH", "").split(os.pathsep)
                   if d and not os.access(os.path.join(d, "nvcc"), os.X_OK)]
        env.update(PATH=os.pathsep.join(no_nvcc), CUDA_HOME=os.path.join(cache, "no-cuda"))
        script = (
            "import json, torch\n"
            "from tpu_operator_torch.kernels import _build, stream_copy as k1\n"
            "from tpu_operator_torch.validator.workload import prewarm_compile_cache\n"
            "try:\n"
            "    _build.find_nvcc()\n"
            "    reachable = True\n"
            "except RuntimeError:\n"
            "    reachable = False\n"
            "warm = prewarm_compile_cache()\n"
            "x = torch.randn(1_000_003, device='cuda')\n"
            "y = k1.stream_copy(x)\n"
            "torch.cuda.synchronize()\n"
            "print(json.dumps({'nvcc_reachable': reachable, 'warm': warm,\n"
            "                  'lib': str(_build.library_path('stream_copy')),\n"
            "                  'launches': k1.launches, 'equal': torch.equal(x, y)}))\n")
        warm = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                              text=True, timeout=300)
        check(warm.returncode == 0, f"warm load failed: {warm.stderr[-2000:]}")
        warm_result = json.loads(warm.stdout.strip().splitlines()[-1])
        check(warm_result["nvcc_reachable"] is False, "nvcc was reachable in the warm process")
        check(warm_result["lib"] == built[0], f"warm process loaded {warm_result['lib']}")
        check(warm_result["equal"] and warm_result["launches"] == 1,
              f"K1 from the cache: {warm_result}")
        print(json.dumps({"prewarm_cold": cold_result, "prewarm_warm": warm_result["warm"],
                          "card": card}))


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

    phase("serving: the decode step as a CUDA graph")
    serving_phase(dev, gen, card)

    phase("prewarm: K1 into a fresh build cache, then loaded without nvcc")
    prewarm_phase(card)

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
