"""The slice partitioner: GPU groups over the node's link topology
(counterpart of tpu_operator/partitioner/)."""

from .partitioner import PartitionError, compute_partition, load_config, run, sync_once

__all__ = ["PartitionError", "compute_partition", "load_config", "run", "sync_once"]
