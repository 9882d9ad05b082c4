"""gemm_roofline: the certification GEMM's share of its roofline, in %:
2 dim^3 FLOPs over the card's bf16 peak (FLOPs bound it at dim 4096), over
the mean device time of the kernels that one product of
``measure_mxu_tflops`` launches (device trace). The profiler links each
kernel to the host op that launched it, ``aten::mm`` under ``aten::matmul``."""

from bench_gpu.counts import gemm
from bench_gpu.readers import PERF, roofline_percent, within
from bench_gpu.sizes import perf_sizes

SPANS = {"perf.measure_mxu_tflops": f"{PERF}:measure_mxu_tflops"}


def read(run):
    if run.trace is None or not run.peaks:
        return None
    windows = run.trace.annotations("perf.measure_mxu_tflops")
    products = [h for h in within(run.trace.host_ops, windows)
                if not h.annotation and h.name in ("aten::mm", "aten::matmul")]
    ids = {h.correlation for h in products}
    kernels = [o for o in run.trace.device_ops if o.linked in ids]
    launched = {o.linked for o in kernels}
    if not launched:
        return None
    mean_s = sum(o.end_ns - o.start_ns for o in kernels) / len(launched) / 1e9
    dim = perf_sizes(run.config["validator_flags"])["matrix_dim"]
    least_s, _ = gemm.least_seconds(dim, run.peaks["bf16_flops_per_s"],
                                    run.peaks["hbm_bytes_per_s"])
    return roofline_percent(least_s, mean_s)
