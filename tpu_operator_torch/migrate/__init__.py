"""Cross-node workload migration, the node side (counterpart of
tpu_operator/migrate/{agent,checkpoint}.py; the operator's
MigrationReconciler waits for the control plane).

- ``checkpoint``: the versioned drain-checkpoint schema (v2 adds
  optimizer-state pointers and a sharded-array manifest keyed by the layout
  fingerprint) and the corrupt-checkpoint reporter.
- ``agent``: the migrate agent: a transparent snapshot on the operator's
  request, and the restore of a transferred checkpoint on the destination.
"""

from .checkpoint import (CHECKPOINT_VERSION, build_manifest, checkpoint_version,
                         corrupt_reporter, remap_manifest, save_checkpoint_v2)

__all__ = ["CHECKPOINT_VERSION", "build_manifest", "checkpoint_version", "corrupt_reporter",
           "remap_manifest", "save_checkpoint_v2"]
