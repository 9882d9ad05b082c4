"""Predictive headroom model: EWMA level + linear trend over a sliding window
(copy of tpu_operator/autoscale/predictor.py).

The autoscaler must act on where demand is *going*, not where it was — a
node join costs tens of seconds (the whole operand DAG), so reacting to a
p99 breach after the fact leaves the breach window open for exactly that
long. The model here is deliberately small: an exponentially-weighted
moving average absorbs per-tick noise, and a least-squares slope over the
retained window extrapolates the diurnal ramp, so the forecast leads the
curve by the join latency instead of trailing it.

Pure and clock-free: callers supply every timestamp (the bench feeds
simulated time), so forecasts are reproducible under a pinned seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class TrendPredictor:
    """Sliding-window forecaster for one scalar signal.

    ``observe(t, value)`` ingests a sample; ``forecast(horizon_s)``
    returns the EWMA level projected ``horizon_s`` past the newest sample
    along the window's least-squares slope. With fewer than two samples
    the forecast degenerates to the level (no trend evidence), and with
    none it is 0.0 — an empty fleet signal must never invent demand.
    """

    window_s: float = 600.0
    #: EWMA smoothing weight for the newest sample; 1.0 = raw last value
    alpha: float = 0.3
    samples: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)
    _level: Optional[float] = dataclasses.field(default=None, repr=False)

    def observe(self, t: float, value: float) -> None:
        t, value = float(t), float(value)
        if self.samples and t < self.samples[-1][0]:
            return  # out-of-order sample (restarted feeder): ignore
        self.samples.append((t, value))
        self._level = value if self._level is None else (
            self.alpha * value + (1.0 - self.alpha) * self._level)
        horizon = t - self.window_s
        while self.samples and self.samples[0][0] < horizon:
            self.samples.pop(0)

    @property
    def level(self) -> float:
        return 0.0 if self._level is None else self._level

    def slope(self) -> float:
        """Least-squares slope (units/second) over the retained window."""
        n = len(self.samples)
        if n < 2:
            return 0.0
        t0 = self.samples[0][0]
        xs = [t - t0 for t, _ in self.samples]
        ys = [v for _, v in self.samples]
        mean_x = sum(xs) / n
        mean_y = sum(ys) / n
        var_x = sum((x - mean_x) ** 2 for x in xs)
        if var_x <= 0.0:
            return 0.0
        cov = sum((x - mean_x) * (y - mean_y) for x, y in zip(xs, ys))
        return cov / var_x

    def forecast(self, horizon_s: float) -> float:
        """Projected value ``horizon_s`` seconds after the newest sample.
        Floored at 0: demand signals (queue depth, backlog chips) are
        non-negative, and a steep down-trend extrapolated through zero
        must not read as negative capacity need."""
        if not self.samples:
            return 0.0
        return max(0.0, self.level + self.slope() * float(horizon_s))
