"""k1_roofline: K1's share of its roofline, in %: the fp32 array read once
and written once over the card's HBM peak (bytes bound a copy), over the
mean device time of one launch of ``stream_copy_f32_bulk_kernel`` (with any
scalar head or tail kernel of the same launch) in
``measure_hbm_kernel_gbps`` (device trace)."""

from bench_gpu.counts import k1
from bench_gpu.readers import PERF, roofline_percent, within
from bench_gpu.sizes import perf_sizes

SPANS = {"perf.measure_hbm_kernel_gbps": f"{PERF}:measure_hbm_kernel_gbps"}
BULK = "stream_copy_f32_bulk_kernel"
FAMILY = "stream_copy_f32_"


def read(run):
    if run.trace is None or not run.peaks:
        return None
    ops = within([o for o in run.trace.device_ops if FAMILY in o.name],
                 run.trace.annotations("perf.measure_hbm_kernel_gbps"))
    launches = sum(BULK in o.name for o in ops)
    if not launches:
        return None
    mean_s = sum(o.end_ns - o.start_ns for o in ops) / launches / 1e9
    mib = perf_sizes(run.config["validator_flags"])["hbm_mib"]
    least_s, _ = k1.least_seconds(mib, run.peaks["bf16_flops_per_s"],
                                  run.peaks["hbm_bytes_per_s"])
    return roofline_percent(least_s, mean_s)
