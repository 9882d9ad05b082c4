"""Unified scenario seeding (copy of tpu_operator/simulator/seeds.py).

One root seed — ``SCENARIO_SEED`` (env) or ``--seed`` (flag) — fans out to
every randomness consumer in a run through :func:`seed_for`, a stable
content-addressed derivation: ``seed_for(root, "node-chaos")`` is the same
integer on every machine, every Python, every run. Injectors therefore
never share an RNG (consuming an extra sample in one cannot perturb the
others), yet the whole composition replays from the single root printed in
every failure message.

Derived-seed names used by the engine (documented contract, stable across
releases so committed repro cases keep replaying):

==================  =====================================================
name                consumer
==================  =====================================================
``traffic``         ``serving/traffic.py`` demand generator
``pod-chaos``       ``testing/chaos.PodChaos``
``node-chaos``      ``testing/chaos.NodeChaos``
``client-chaos``    ``client/chaos.ChaosPolicy``
``brownout``        the apiserver-brownout fault coin flips
``injections``      injection-level victim choices (AZ pick, herd names)
``fuzz-<i>``        the fuzzer's sampler for sweep index ``i``
``scenario-<i>``    the root seed of sampled scenario ``i``'s run
==================  =====================================================
"""

from __future__ import annotations

from typing import Optional

# the mechanics live in utils.seeds (dependency-free); this module is
# the documented home of the derived-name contract
from ..utils.seeds import (  # noqa: F401  (re-exported contract)
    DEFAULT_SCENARIO_SEED,
    SCENARIO_SEED_ENV,
    resolve_seed,
    seed_for,
)


def repro_command(seed: int, budget: Optional[int] = None,
                  index: Optional[int] = None,
                  case: Optional[str] = None) -> str:
    """The exact command line that replays a failure — printed verbatim in
    every simulator failure message (satellite contract: no failure
    without its repro line)."""
    if case:
        return (f"{SCENARIO_SEED_ENV}={seed} python -m tpu_operator_torch.cmd.sim "
                f"run {case}")
    parts = [f"{SCENARIO_SEED_ENV}={seed}",
             "python -m tpu_operator_torch.cmd.sim", "fuzz", f"--seed {seed}"]
    if budget is not None:
        parts.append(f"--budget {budget}")
    if index is not None:
        parts.append(f"--index {index}")
    return " ".join(parts)
