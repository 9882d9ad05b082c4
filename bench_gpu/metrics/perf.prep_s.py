"""perf.prep_s: seconds per pass of the measurements' wall time outside
their timed runs: operands, the warm-up call, the round-trip probe (the
program's counter ``perf.prep_s``). It is read in traced runs, under
``torch.profiler``, and so includes the profiler's own host overhead: on
an H100 about half of it (0.0104-0.0117 s traced against 0.0048-0.0066 s
untraced)."""

from bench_gpu.program_counters import per_pass


def read(run):
    return per_pass(run, "perf.prep_s")
