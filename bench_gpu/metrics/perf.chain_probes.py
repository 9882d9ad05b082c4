"""perf.chain_probes: probes under the noise floor thrown away per pass,
over the certification's three chain measurements (the program's counter
``perf.chain.probes``). A chain sized from its first probe throws one
away; each further one is a step of the x4 climb."""

from bench_gpu.program_counters import per_pass


def read(run):
    return per_pass(run, "perf.chain.probes")
