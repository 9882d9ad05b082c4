"""The operator's GPU-health loop and its node agents' side (counterpart of
tpu_operator/health/): the per-node degraded-state machine the
ClusterPolicy sweep drives (:mod:`.machine`), and the coordinated-drain
protocol both sides speak (:mod:`.drain`)."""

from .drain import (  # noqa: F401
    RetilePlan,
    load_checkpoint,
    maybe_ack_plan,
    node_acked_plan,
    node_plan,
    plan_fingerprint,
    read_drain_ack,
    save_checkpoint,
    write_drain_ack,
)
from .machine import (  # noqa: F401
    DEGRADED,
    FAILED,
    HEALTHY,
    HealthCounts,
    HealthStateMachine,
    QUARANTINED,
    RECOVERED,
    REMEDIATING,
    STATES,
    node_health_state,
    parse_workload_health,
)
