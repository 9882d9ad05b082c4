"""The simulator's virtual clock (copy of tpu_operator/simulator/clock.py).

One clock drives everything (Podracer, arXiv 2104.06272: a single
deterministic event loop is what makes large-scale interleavings
reproducible): reconciler deadlines, journal timestamps, injection
schedules, and — via :mod:`tpu_operator_torch.utils.clock` pinning — the stamp
sites that historically read wall time. Time only moves when the engine
says so, so a scenario's timeline is a pure function of its ticks, never
of host speed.
"""

from __future__ import annotations


class VirtualClock:
    """Discrete simulated time: ``tick`` counts engine iterations,
    ``now()`` is simulated seconds (``tick * tick_s``)."""

    def __init__(self, tick_s: float = 1.0):
        self.tick_s = float(tick_s)
        self.tick = 0

    def now(self) -> float:
        return self.tick * self.tick_s

    def advance(self, ticks: int = 1) -> float:
        self.tick += ticks
        return self.now()
