"""State manager: CRD kind -> ordered states; sync all, aggregate results
(copy of tpu_operator/state/manager.py; NVIDIA's internal/state/manager.go:31-109). States implement
``sync(catalog) -> StateResult``; the catalog is the typed blackboard the
reference calls InfoCatalog (internal/state/info_source.go).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Protocol

from .. import tracing
from .skel import SyncState

log = logging.getLogger(__name__)

# InfoCatalog keys
INFO_CLUSTER_POLICY = "cluster-policy"
INFO_CLUSTER_INFO = "cluster-info"
INFO_NAMESPACE = "namespace"
#: per-sweep Node snapshot, shared so states don't each re-LIST the cluster
INFO_NODES = "nodes"
#: per-sweep List[nodepool.NodePool] computed once from INFO_NODES, the
#: single sharding source for pool-parallel sweeps and per-pool fan-out
INFO_NODE_POOLS = "node-pools"


class InfoCatalog(dict):
    """Blackboard passed to every state; plain dict with a typed veneer."""

    def require(self, key: str):
        if key not in self:
            raise KeyError(f"InfoCatalog missing required entry {key!r}")
        return self[key]


@dataclasses.dataclass
class StateResult:
    state_name: str
    status: SyncState
    message: str = ""


class State(Protocol):
    name: str

    def sync(self, catalog: InfoCatalog) -> StateResult: ...


@dataclasses.dataclass
class Results:
    results: List[StateResult]

    @property
    def ready(self) -> bool:
        return all(r.status in (SyncState.READY, SyncState.IGNORE) for r in self.results)

    def first_not_ready(self) -> Optional[StateResult]:
        for r in self.results:
            if r.status not in (SyncState.READY, SyncState.IGNORE):
                return r
        return None


class Manager:
    def __init__(self, states: List[State]):
        self.states = list(states)

    def sync_state(self, catalog: InfoCatalog) -> Results:
        results = []
        for state in self.states:
            with tracing.span(f"state.{state.name}", kind="state") as sp:
                try:
                    result = state.sync(catalog)
                except Exception as e:  # a state crash must not kill the sweep
                    log.exception("state %s errored", state.name)
                    result = StateResult(state.name, SyncState.ERROR, str(e))
                    sp.mark_error(f"{type(e).__name__}: {e}")
                sp.set_attribute("status", result.status.value)
            results.append(result)
        return Results(results)
