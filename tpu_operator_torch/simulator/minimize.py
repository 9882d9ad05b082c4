"""Delta-minimization of failing scenarios (copy of
tpu_operator/simulator/minimize.py).

A fuzzer-found failure usually carries freight it does not need: five
injections when one suffices, a 12-node fleet when 3 reproduce, a
128-tick timeline for a bug that bites by tick 20. :func:`minimize`
greedily shrinks along three axes — drop injections one at a time,
halve the fleet toward the floor, halve the timeline — keeping a
candidate change only when the failure still reproduces (same judgment:
any oracle red), and iterates to a fixpoint under a bounded run budget.

The result is what gets committed as a named regression case: the smallest scenario that still demonstrates the
violation, cheap enough to replay in tier-1 forever.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

from .scenario import Scenario

log = logging.getLogger(__name__)

#: Scenario.__post_init__ floors — candidates below these are not legal
MIN_FLEET = 2
MIN_TICKS = 4


def _default_failing(scenario: Scenario, seed: int) -> bool:
    from .engine import FleetSimulator
    return not FleetSimulator(scenario, seed=seed).run()["ok"]


def minimize(scenario: Scenario, seed: int,
             failing: Optional[Callable[[Scenario, int], bool]] = None,
             max_runs: int = 24) -> Tuple[Scenario, int]:
    """Shrink ``scenario`` while ``failing(candidate, seed)`` stays true.

    ``failing`` defaults to a full engine run judged on ``report["ok"]``;
    tests inject synthetic predicates. Returns ``(minimized, runs_used)``.
    The input scenario is assumed failing — it is never re-verified, so a
    flaky predicate can at worst return the original unshrunk."""
    failing = failing or _default_failing
    runs = 0
    current = scenario

    def try_candidate(candidate: Scenario) -> bool:
        nonlocal runs, current
        if runs >= max_runs:
            return False
        runs += 1
        try:
            if failing(candidate, seed):
                current = candidate
                return True
        # the minimizer probes candidates that may crash in arbitrary ways
        # (incl. an escaped BreakerOpenError); any non-reproduction is
        # equally discarded  # opalint: disable=breaker-swallow
        except Exception:
            # a candidate that errors out is not a *reproduction* — keep
            # the last known-failing scenario and move on
            log.debug("minimize: candidate errored", exc_info=True)
        return False

    progress = True
    while progress and runs < max_runs:
        progress = False
        # pass 1: drop injections, one at a time (last first: later
        # injections are more often the irrelevant tail of a compound)
        i = len(current.injections) - 1
        while i >= 0 and runs < max_runs:
            if len(current.injections) > 1:
                slimmer = current.replace(injections=(
                    current.injections[:i] + current.injections[i + 1:]))
                if try_candidate(slimmer):
                    progress = True
            i -= 1
        # pass 2: halve the fleet toward the floor
        while current.fleet > MIN_FLEET and runs < max_runs:
            smaller = current.replace(
                fleet=max(MIN_FLEET, current.fleet // 2))
            if not try_candidate(smaller):
                break
            progress = True
        # pass 3: halve the timeline (fixed-tick injections must still
        # fit inside it, or the candidate would change meaning)
        while current.ticks > MIN_TICKS and runs < max_runs:
            floor = max([MIN_TICKS] + [
                inj.at + 1 for inj in current.injections
                if inj.at is not None])
            shorter_ticks = max(floor, current.ticks // 2)
            if shorter_ticks >= current.ticks:
                break
            if not try_candidate(current.replace(ticks=shorter_ticks)):
                break
            progress = True
    log.info("minimize: %s -> fleet=%d ticks=%d injections=%d (%d runs)",
             scenario.name, current.fleet, current.ticks,
             len(current.injections), runs)
    return current, runs
