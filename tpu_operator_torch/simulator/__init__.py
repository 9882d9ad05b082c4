"""Adversarial fleet simulator: deterministic scenario DSL + fuzzing
(counterpart of tpu_operator/simulator/, on GPU nodes).

Composes the test doubles (MiniApiServer, KubeletSimulator, chaos
injectors, the serving-traffic generator) behind one virtual clock and one
seeded RNG, drives the REAL reconcilers through the production client
chain, and judges every run with universal oracles. A healthy node serves
the card's measured frontier (``engine.CARD_FRONTIER``).
"""

from .clock import VirtualClock
from .engine import FleetSimulator, canonical_log, run_scenario_obj
from .scenario import (
    Injection,
    Scenario,
    ScenarioError,
    parse,
    parse_file,
)
from .seeds import (
    DEFAULT_SCENARIO_SEED,
    SCENARIO_SEED_ENV,
    repro_command,
    resolve_seed,
    seed_for,
)

__all__ = [
    "DEFAULT_SCENARIO_SEED",
    "FleetSimulator",
    "Injection",
    "SCENARIO_SEED_ENV",
    "Scenario",
    "ScenarioError",
    "VirtualClock",
    "canonical_log",
    "parse",
    "parse_file",
    "repro_command",
    "resolve_seed",
    "run_scenario_obj",
    "seed_for",
]
