"""perf.chain_kept_s: seconds per pass of the timed chain runs that the
certification's readings are built from, the settled runs of the GEMM, the
HBM probe and K1 (the program's counter ``perf.chain.kept_s``)."""

from bench_gpu.program_counters import per_pass


def read(run):
    return per_pass(run, "perf.chain.kept_s")
