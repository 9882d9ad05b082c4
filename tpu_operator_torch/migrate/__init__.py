"""Cross-node workload migration (counterpart of tpu_operator/migrate/).

- ``checkpoint``: the versioned drain-checkpoint schema (v2 adds
  optimizer-state pointers and a sharded-array manifest keyed by the layout
  fingerprint) and the corrupt-checkpoint reporter.
- ``agent``: the migrate agent: a transparent snapshot on the operator's
  request, and the restore of a transferred checkpoint on the destination.
- ``controller``: the MigrationReconciler: drain node A, transfer the
  manifest, restore the tenant on node B, its state in preconditioned node
  annotations so that an operator killed mid-migration resumes exactly once.
  Its names load with their first use, so the node agent's process never
  imports the operator's controllers.
"""

from .checkpoint import (CHECKPOINT_VERSION, build_manifest, checkpoint_version,
                         corrupt_reporter, remap_manifest, save_checkpoint_v2)
from .controller import MigrationReconciler, migration_state, setup_migration_controller

__all__ = ["CHECKPOINT_VERSION", "MigrationReconciler", "build_manifest", "checkpoint_version",
           "corrupt_reporter", "migration_state", "remap_manifest", "save_checkpoint_v2",
           "setup_migration_controller"]
