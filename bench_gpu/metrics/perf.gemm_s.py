"""perf.gemm_s: wall seconds per pass in ``measure_mxu_tflops``, the GEMM
chain grown to 50 ms and timed six times."""

from bench_gpu.readers import PERF, per_pass_mean

SPANS = {"perf.measure_mxu_tflops": f"{PERF}:measure_mxu_tflops"}


def read(run):
    return per_pass_mean(run, SPANS)
