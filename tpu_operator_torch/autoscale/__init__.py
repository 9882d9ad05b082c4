"""SLO-driven fleet autoscaler: close the traffic -> capacity loop
(counterpart of tpu_operator/autoscale/).

The reference operator reconciles a *fixed* node set; a production serving
fleet must change its capacity as load moves (Gemma-on-TPU, arXiv
2605.25645: SLO attainment at minimum node-hours is the serving-economics
objective). This package adds the controller that closes the loop:

- ``predictor``: EWMA level + linear trend over a sliding window of
  traffic samples, so the fleet scales *before* p99 breaches.
- ``engine``: the pure decision function — demand + headroom ->
  per-pool node targets, clamped to spec bounds, rate-limited by
  cooldowns and the one-in-flight-resize-per-pool rule.
- ``controller``: the reconciler that actuates decisions through the
  *existing* machinery — scale-up registers nodes onto the event-driven
  join path, scale-down publishes a drain plan and executes a planned
  re-tile through the drain protocol, or a migration when ``spec.migrate``
  is on (never a bare delete).
"""

from .controller import AutoscaleReconciler, setup_autoscale_controller
from .engine import PoolDecision, decide
from .predictor import TrendPredictor

__all__ = [
    "AutoscaleReconciler",
    "setup_autoscale_controller",
    "PoolDecision",
    "decide",
    "TrendPredictor",
]
