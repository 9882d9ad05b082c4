"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over whole
passes, reduced to plain tuples that the metric readers take.

The raw events of the profiler's result are read directly (not through
``prof.events()``, whose per-event objects take longer than the window
for a run of many thousand launches). Host and device events share the
profiler's nanosecond clock.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

#: at most this many entries in each list of the result's ``breakdown``
BREAKDOWN_ENTRIES = 10
#: a device op's name in the breakdown is cut to this many characters
#: (a templated kernel's name runs to thousands)
NAME_CHARS = 160


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    """A kernel, copy or fill on a device."""
    name: str
    device: int
    start_ns: int
    end_ns: int
    linked: int  # correlation id of the host op that launched it, 0 if none


@dataclasses.dataclass(frozen=True)
class HostOp:
    """A host op or a benchmark span (``record_function``)."""
    name: str
    start_ns: int
    end_ns: int
    correlation: int
    annotation: bool


@dataclasses.dataclass
class DeviceTrace:
    device_ops: List[DeviceOp]
    host_ops: List[HostOp]
    #: the traced window on the profiler's clock: first pass start, last pass end
    start_ns: int
    end_ns: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def annotations(self, name: str) -> List[HostOp]:
        return [h for h in self.host_ops if h.annotation and h.name == name]

    def busy_intervals(self, device: int) -> List[Tuple[int, int]]:
        """The union of the device's op intervals, clipped to the window."""
        spans = sorted((max(o.start_ns, self.start_ns), min(o.end_ns, self.end_ns))
                       for o in self.device_ops if o.device == device)
        merged: List[List[int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self, device: int) -> float:
        return sum(e - s for s, e in self.busy_intervals(device)) / 1e9

    def idle_gaps(self, device: int) -> List[Tuple[int, int]]:
        gaps, at = [], self.start_ns
        for s, e in self.busy_intervals(device):
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.end_ns > at:
            gaps.append((at, self.end_ns))
        return gaps

    def host_span_at(self, t_ns: int) -> str:
        """The innermost benchmark span the host was in at ``t_ns``."""
        best: Optional[HostOp] = None
        for h in self.host_ops:
            if h.annotation and h.start_ns <= t_ns < h.end_ns:
                if best is None or h.start_ns >= best.start_ns:
                    best = h
        return best.name if best else "outside a pass"

    def breakdown(self, device: int = 0) -> dict:
        """The device ops that took most time (summed by name) and the
        longest idle gaps on ``device``, each named by the span the host
        was in at the gap's midpoint (at its start the host is most often
        still closing the work that ran before it)."""
        by_name: Dict[str, int] = {}
        for o in self.device_ops:
            by_name[o.name] = by_name.get(o.name, 0) + (o.end_ns - o.start_ns)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        gaps = sorted(self.idle_gaps(device), key=lambda g: g[0] - g[1])[:BREAKDOWN_ENTRIES]
        return {"device_ops": [[name[:NAME_CHARS], ns / 1e9] for name, ns in top],
                "idle_gaps": [[self.host_span_at((s + e) // 2), (e - s) / 1e9]
                              for s, e in gaps]}


class Profiler:
    """``torch.profiler`` over the window, host and device activity."""

    def __init__(self) -> None:
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self, window_name: str) -> DeviceTrace:
        """Stop and reduce; the window is the union of the ``window_name``
        spans (the passes)."""
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        device_ops, host_ops = [], []
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    device_ops.append(DeviceOp(e.name(), e.device_index(), start, end,
                                               e.linked_correlation_id()))
            else:
                host_ops.append(HostOp(e.name(), start, end, e.correlation_id(),
                                       e.is_user_annotation()))
        self._prof = None  # free the profiler's buffers
        windows = [h for h in host_ops if h.annotation and h.name == window_name]
        if not windows:
            raise RuntimeError(f"the trace holds no {window_name!r} span")
        return DeviceTrace(device_ops, host_ops, min(h.start_ns for h in windows),
                           max(h.end_ns for h in windows))
