"""Checker registry population: importing this package registers every
shipped rule. Add new checkers here."""

from . import (  # noqa: F401
    annotation_registry,
    api_bypass,
    blocking,
    breaker_swallow,
    deadline_propagation,
    exactly_once_event,
    exception_hygiene,
    lock_discipline,
    lock_order,
    metrics_discipline,
    operand_dag,
    provenance_discipline,
    span_discipline,
    state_before_actuation,
    unbatched_sweep_write,
    unfenced_write,
    untracked_shared_state,
)
