"""perf.chain_discarded_s: seconds per pass of timed chain runs thrown
away: probes under the noise floor, samples at a length the chain then
grew past, and a GEMM attempt whose cross-check was retried (the
program's counter ``perf.chain.discarded_s``)."""

from bench_gpu.program_counters import per_pass


def read(run):
    return per_pass(run, "perf.chain.discarded_s")
