"""perf.hbm_s: wall seconds per pass in ``measure_hbm_gbps`` and
``measure_hbm_kernel_gbps``, the HBM probe's and K1's chains."""

from bench_gpu.readers import PERF, per_pass_mean

SPANS = {"perf.measure_hbm_gbps": f"{PERF}:measure_hbm_gbps",
         "perf.measure_hbm_kernel_gbps": f"{PERF}:measure_hbm_kernel_gbps"}


def read(run):
    return per_pass_mean(run, SPANS)
