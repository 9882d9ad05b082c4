"""Serving validation (counterpart of tpu_operator/serving/): the SLO probe,
a continuous-batching decode step run as one CUDA graph, and the frontier
schema it publishes through the validation barrier.

The reference's ``traffic`` module, a host-side traffic simulator, is not
ported yet.
"""

from .probe import ServingReport, run_probe  # noqa: F401
