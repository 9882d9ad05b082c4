"""Fleet capacity observatory: per-node serving frontiers -> pool curves.

The :class:`~tpu_operator_torch.capacity.collector.CapacityCollector`
(counterpart of tpu_operator/capacity/) aggregates
the ``tpu.ai/serving-frontier`` node annotations (mirrored from the
serving barrier by feature discovery) into per-pool capacity curves,
detects staleness (template changed since the curve was measured → a
re-probe request) and drift (a node's curve departing its pool's
envelope → one ``FrontierDrift`` Event per episode), and answers the
autoscaler's question: how many measured tokens/s does one node of this
fleet serve inside the SLO?
"""

from .collector import CapacityCollector

__all__ = ["CapacityCollector"]
