"""The rolling driver upgrade (counterpart of tpu_operator/upgrade/)."""

from .machine import (
    STATES,
    UpgradeStateCounts,
    UpgradeStateMachine,
    node_upgrade_state,
)

__all__ = ["STATES", "UpgradeStateCounts", "UpgradeStateMachine", "node_upgrade_state"]
