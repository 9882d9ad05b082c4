"""The autoscaler's decision function: demand -> bounded per-pool targets
(counterpart of tpu_operator/autoscale/engine.py).

Pure and deterministic by design — every input (forecast demand, pool
sizes, persisted per-pool state, the clock) arrives as an argument, so the
same cluster state always yields the same decision. The controller owns
all I/O; tests drive this module directly.

Safety bounds:

- targets clamp to spec.autoscale minNodes/maxNodes per pool;
- a pool in cooldown, or with a resize already in flight, holds;
- scale-down additionally requires the demand deficit to have been
  sustained for scaleDownDelayS (the diurnal-trough filter), and
  surrenders ONE node per decision — each removal is a full drain
  episode, and bounded actuation means never planning the second drain
  before the first converged;
- lost capacity in a preemptible pool (current < target) is replaced
  immediately, cooldown notwithstanding: revocation was not our resize,
  and waiting out a cooldown would stack the replacement window on it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from ..api.clusterpolicy import AutoscaleSpec


@dataclasses.dataclass
class PoolState:
    """Crash-durable per-pool decision state (persisted as JSON on the
    ClusterPolicy under ``tpu.ai/autoscale-state``)."""

    target: int = 0
    cooldown_until: float = 0.0
    #: when demand first dropped below the scale-down threshold; None
    #: while demand supports the current size
    below_since: Optional[float] = None
    #: monotonic counter naming autoscaler-registered nodes
    seq: int = 0
    #: the one in-flight resize: {"node", "fingerprint", "direction",
    #: "deadline"} for a scale-down mid-drain; None when idle
    resize: Optional[dict] = None
    #: the pool's node-selector labels, remembered so a fully revoked
    #: preemptible pool (zero members left) can still be re-capacitated
    template: Optional[dict] = None

    def to_dict(self) -> dict:
        out: dict = {"target": self.target, "seq": self.seq}
        if self.cooldown_until:
            out["cooldown_until"] = round(self.cooldown_until, 3)
        if self.below_since is not None:
            out["below_since"] = round(self.below_since, 3)
        if self.resize:
            out["resize"] = dict(self.resize)
        if self.template:
            out["template"] = dict(self.template)
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "PoolState":
        return cls(
            target=int(data.get("target", 0)),
            cooldown_until=float(data.get("cooldown_until", 0.0)),
            below_since=(float(data["below_since"])
                         if data.get("below_since") is not None else None),
            seq=int(data.get("seq", 0)),
            resize=(dict(data["resize"])
                    if isinstance(data.get("resize"), dict) else None),
            template=(dict(data["template"])
                      if isinstance(data.get("template"), dict) else None))


@dataclasses.dataclass(frozen=True)
class PoolDecision:
    """One pool's verdict for this sweep."""

    pool: str
    current: int
    target: int
    #: "up" (register target-current nodes), "down" (drain ONE node),
    #: or None (hold: in bounds, in cooldown, mid-resize, or delaying)
    action: Optional[str] = None
    #: why a demand-suggested action was withheld (debug surface)
    hold_reason: Optional[str] = None


def nodes_needed(spec: AutoscaleSpec, demand_chips: float,
                 chips_per_node: int, slo_breach: bool,
                 current_total: int,
                 demand_tokens_per_s: float = 0.0,
                 frontier_tokens_per_node: float = 0.0) -> int:
    """Fleet-wide node count the demand forecast asks for.

    **Measured-frontier path** (both a token-rate forecast and a measured
    at-SLO per-node throughput present): forecast tokens/s inflated by the
    headroom margin, divided by what one node *measurably* serves while
    holding p99 under the SLO — the probe already traded batch depth
    against latency when it picked the curve's at-SLO point, so the
    division needs no assumed per-chip constant and stops over-provisioning
    by whatever margin the assumption was conservative.

    **Constant fallback** (no frontier, or no token feed): forecast chips
    inflated by headroom over the per-slice chip constant — the original
    assumed-capacity path, retained so a fleet that never probed (or whose
    curves all went stale/cleared) keeps scaling.

    Either way an SLO breach (measured or forecast attainment under
    target) overrides a low demand reading: latency is already suffering,
    so the fleet must grow by at least one node regardless of what the
    queue says."""
    if demand_tokens_per_s > 0 and frontier_tokens_per_node > 0:
        need = math.ceil(
            demand_tokens_per_s * (1.0 + spec.headroom_pct / 100.0)
            / frontier_tokens_per_node)
    else:
        chips = max(1, int(chips_per_node))
        need = math.ceil(demand_chips * (1.0 + spec.headroom_pct / 100.0)
                         / chips) if demand_chips > 0 else 0
    if slo_breach:
        need = max(need, current_total + 1)
    return need


def spread_targets(spec: AutoscaleSpec, pool_sizes: Dict[str, int],
                   want_total: int) -> Dict[str, int]:
    """Distribute ``want_total`` nodes across pools: every pool gets its
    floor, then remaining demand waterfills in sorted-name order up to
    each pool's ceiling. Deterministic (no hash order, no randomness) so
    two replicas — or a replay after a crash — compute identical
    targets."""
    names = sorted(pool_sizes)
    targets = {name: spec.pool_min(name) for name in names}
    remaining = want_total - sum(targets.values())
    while remaining > 0:
        grew = False
        for name in names:
            if remaining <= 0:
                break
            if targets[name] < spec.pool_max(name):
                targets[name] += 1
                remaining -= 1
                grew = True
        if not grew:
            break  # every pool saturated at maxNodes: demand unmet
    return targets


def decide(spec: AutoscaleSpec, pool_sizes: Dict[str, int],
           demand_chips: float, chips_per_node: int, slo_breach: bool,
           states: Dict[str, PoolState], now: float,
           demand_tokens_per_s: float = 0.0,
           frontier_tokens_per_node: float = 0.0) -> List[PoolDecision]:
    """One decision sweep: per-pool targets + the bounded actions that
    move toward them. Mutates ``states`` (below_since bookkeeping,
    targets) — the caller persists it afterward."""
    want = nodes_needed(spec, demand_chips, chips_per_node, slo_breach,
                        sum(pool_sizes.values()),
                        demand_tokens_per_s=demand_tokens_per_s,
                        frontier_tokens_per_node=frontier_tokens_per_node)
    targets = spread_targets(spec, pool_sizes, want)
    decisions: List[PoolDecision] = []
    for pool in sorted(pool_sizes):
        current = pool_sizes[pool]
        target = targets[pool]
        state = states.setdefault(pool, PoolState(target=current))
        previous_target = state.target
        state.target = target

        if state.resize is not None:
            decisions.append(PoolDecision(pool, current, target,
                                          hold_reason="resize-in-flight"))
            continue

        preemptible = pool in (spec.preemptible_pools or [])
        revoked = preemptible and current < min(previous_target, target)
        if now < state.cooldown_until and not revoked:
            state.below_since = None if target >= current else (
                state.below_since if state.below_since is not None else now)
            decisions.append(PoolDecision(pool, current, target,
                                          hold_reason="cooldown"))
            continue

        if target > current:
            state.below_since = None
            decisions.append(PoolDecision(pool, current, target,
                                          action="up"))
        elif target < current:
            if state.below_since is None:
                state.below_since = now
            matured = now - state.below_since >= spec.scale_down_delay_s
            if matured:
                decisions.append(PoolDecision(pool, current, target,
                                              action="down"))
            else:
                decisions.append(PoolDecision(
                    pool, current, target, hold_reason="scale-down-delay"))
        else:
            state.below_since = None
            decisions.append(PoolDecision(pool, current, target))
    return decisions
