"""What the metric readers (``metrics/<name>.py``) share: per-pass means of
spans, and a kernel's mean device time within spans of the trace."""

from __future__ import annotations

from typing import Iterable, List, Optional

PERF = "tpu_operator_torch.validator.perf"


def per_pass_mean(run, names: Iterable[str]) -> Optional[float]:
    """Seconds per pass spent in the spans ``names``, or None when none ran."""
    total, seen = 0.0, False
    for name in names:
        for seconds in run.spans.per_pass(name).values():
            total, seen = total + seconds, True
    return total / len(run.passes) if seen else None


def within(ops, windows) -> List:
    """The ops that start inside one of the host spans ``windows``."""
    bounds = sorted((w.start_ns, w.end_ns) for w in windows)
    out, i = [], 0
    for op in sorted(ops, key=lambda o: o.start_ns):
        while i < len(bounds) and bounds[i][1] <= op.start_ns:
            i += 1
        if i < len(bounds) and bounds[i][0] <= op.start_ns:
            out.append(op)
    return out


def roofline_percent(least_s: float, mean_s: Optional[float]) -> Optional[float]:
    """The least time the card could take over the time taken, in %."""
    if not mean_s or least_s <= 0:
        return None
    return 100.0 * least_s / mean_s
