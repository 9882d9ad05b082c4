"""cli.overhead_s: a pass's wall time less its ``run_perf`` time, per pass:
the CLI's parse, trace root, JSON report and barrier write."""

from bench_gpu.readers import PERF

SPANS = {"perf.run_perf": f"{PERF}:run_perf"}


def read(run):
    inside = run.spans.per_pass("perf.run_perf")
    if not inside:
        return None
    return sum(p.t1 - p.t0 - inside.get(p.index, 0.0) for p in run.passes) / len(run.passes)
