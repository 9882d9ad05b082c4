"""perf.gemm_iters: the GEMM chain's settled length, calls of eight
products a timed run, per pass (the program's counter ``perf.gemm.iters``,
the final attempt's length in each certification)."""

from bench_gpu.program_counters import per_pass


def read(run):
    return per_pass(run, "perf.gemm.iters")
