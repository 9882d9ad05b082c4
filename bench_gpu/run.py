"""Run one cell of the benchmark on the GPUs of this machine.

    python3 -m bench_gpu.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Set-up imports
torch and the program (``tpu_operator_torch``, from this checkout), with
every build and kernel cache inside the checkout (``build/bench_gpu/``),
creates the CUDA context and hands over to the mix's driver, which does
the set-up its passes need (for certification: K1 from the build cache,
built only in a checkout's first run, and one launch of each shape). The
window then runs the driver's passes for ``--seconds``; with ``--trace 1``
under the profiler, with the benchmark's spans around the program's
layers. After the window the mix's plain reference measures the card and
its comparison decides ``correct``. The last line of standard output is
the result, one JSON object, the numbers compared under its last key;
the last lines of standard error are those numbers, each beside its
limit.

Exit codes: 0 with a result; otherwise no result: 1 a module of JAX or of
the JAX package was loaded, 2 the cell is not described, 3 fewer GPUs than
the cell needs, 4 the program is not in this checkout.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import spec as spec_mod
from . import traffic

PROGRAM = "tpu_operator_torch"
#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_operator")
#: build and kernel caches, at fixed paths inside the checkout (gitignored)
CACHE_DIR = Path("build") / "bench_gpu"
CACHE_ENV = {
    "GPU_COMPILATION_CACHE_DIR": "kernels",  # the program's nvcc builds
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TRITON_CACHE_DIR": "triton",
    "CUDA_CACHE_PATH": "cuda",
}
#: the program's span context; a pass must not join a caller's trace
TRACE_PARENT_ENV = "GPU_TRACE_PARENT"


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    config: dict
    passes: List[traffic.Pass]
    setup_s: float
    #: the driver's set-up, seconds by name (certification: ``kernel_load_s``)
    setup_parts: Dict[str, float]
    spans: Any
    trace: Any
    peaks: Optional[dict]


def process_age_s() -> float:
    """Seconds since this process started (``/proc``, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``tpu_operator_torch`` is not
    ``tpu_operator``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def set_cache_env(root: Path) -> None:
    for key, sub in CACHE_ENV.items():
        os.environ[key] = str(root.resolve() / CACHE_DIR / sub)
    os.environ.pop(TRACE_PARENT_ENV, None)


def program_in(root: Path) -> bool:
    found = importlib.util.find_spec(PROGRAM)
    return (found is not None and found.origin is not None
            and Path(found.origin).resolve().is_relative_to(root.resolve()))


def load_peaks(kind: str) -> Optional[dict]:
    table = json.loads((spec_mod.HERE / "peaks.json").read_text())
    return table["cards"].get(kind)


def span_targets(cell: spec_mod.Cell) -> dict:
    targets = {}
    for metric in cell.per_layer:
        targets.update(getattr(metric.module, "SPANS", {}))
    return targets


def log(msg: str) -> None:
    print(f"bench_gpu: {msg}", file=sys.stderr, flush=True)


def execute(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool) -> Optional[dict]:
    """Set-up, window, metrics and comparison on this machine's GPUs; the
    result, or None when a forbidden module was loaded."""
    from tpu_operator_torch.utils import pin_device_order

    pin_device_order(os.environ)  # before the first CUDA call, as the CLI does
    import torch

    from .spans import Spans
    from .trace import Profiler

    spans = Spans()
    if trace:
        spans.wrap_all(span_targets(cell))
    status_dir = tempfile.mkdtemp(prefix="bench-gpu-status-")
    device_trace = None
    try:
        log(f"set-up: imports done at {process_age_s():.2f} s")
        torch.cuda.init()
        log(f"set-up: CUDA initialised at {process_age_s():.2f} s")
        driver = cell.driver.prepare(cell.config, cell.mix, status_dir, log)
        log(f"set-up: the driver's set-up done at {process_age_s():.2f} s")
        profiler = Profiler() if trace else None
        if profiler:
            profiler.start()
        setup_s = process_age_s()
        passes = traffic.closed_loop(cell.mix, seconds,
                                     lambda i: driver.run_pass(i, spans))
        if profiler:
            t = time.perf_counter()
            device_trace = profiler.stop("pass")
            log(f"trace: {len(device_trace.device_ops)} device ops, "
                f"{len(device_trace.host_ops)} host ops, read in {time.perf_counter() - t:.2f} s")
    finally:
        spans.restore()
        shutil.rmtree(status_dir, ignore_errors=True)

    kind = torch.cuda.get_device_name(0)
    peaks = load_peaks(kind)
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    run = Run(cell.config, passes, setup_s, dict(driver.setup_parts), spans, device_trace,
              peaks)
    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = metric.module.read(run)
        if value is not None:
            metrics[metric.name] = {"value": value, "unit": metric.unit}
    breakdown = None
    if device_trace is not None:
        device["busy_s"] = sum(device_trace.busy_s(d) for d in range(cell.chips)) / cell.chips
        device["window_s"] = device_trace.window_s
        breakdown = device_trace.breakdown(0)
    run.trace = device_trace = None
    gc.collect()
    torch.cuda.empty_cache()

    for p in passes:
        log(f"pass {p.index}: {p.t1 - p.t0:.4f} s rc={p.rc} report={json.dumps(p.report)}")
    ref = cell.reference.measure(cell.config, seed)
    log(f"reference: {json.dumps(ref)}")
    compared = cell.reference.checks(passes, ref, cell.config, peaks)
    correct = cell.reference.correct(compared)
    found = forbidden_modules()  # the window has closed: what the run loaded
    if found:
        log(f"forbidden modules loaded: {found}")
        return None
    for name, c in compared.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    return result_line(correct, passes, metrics, device, breakdown, compared)


def result_line(correct: bool, passes: List[traffic.Pass], metrics: dict, device: dict,
                breakdown: Optional[dict], compared: dict) -> dict:
    """The result, its keys in the order printed: the numbers compared last."""
    result = {"correct": correct, "attempted": len(passes),
              "failed": sum(not p.passed for p in passes),
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench_gpu.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    root = Path.cwd()
    try:
        cell = spec_mod.load_cell(root, args.workload)
    except (spec_mod.SpecError, KeyError, OSError) as e:
        log(f"cannot load the cell: {e}")
        return 2
    set_cache_env(root)
    if not program_in(root):
        log(f"{PROGRAM} is not in {root}: run from the root of a checkout")
        return 4
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"available={torch.cuda.is_available()} count={torch.cuda.device_count()}")
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
