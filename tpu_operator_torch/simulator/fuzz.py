"""Compound-failure fuzzing: seeded scenario sampling over the engine (copy
of tpu_operator/simulator/fuzz.py).

The fuzzer samples ``budget`` scenarios from the DSL's whole space —
operation, fleet shape, and 1–3 composed injections with randomized
parameters and placement — and runs each through the real reconcilers.
Every run is judged by the universal oracles; a red run is
delta-minimized (:mod:`.minimize`), dumped as a must-gather bundle with
its scenario YAML (:mod:`.artifacts`), and reported with the exact repro
command.

Sampling is a pure function of the root seed: scenario ``i`` of seed
``S`` is the same scenario on every machine (``seed_for(S, "fuzz")``
drives the sampler, ``seed_for(S, f"scenario-{i}")`` roots each run), so
``--index i`` replays one sampled scenario without rerunning the sweep.
"""

from __future__ import annotations

import logging
import random
from typing import List, Optional

from .scenario import INJECTION_KINDS, Injection, Scenario
from .seeds import seed_for

log = logging.getLogger(__name__)

#: (kind, condition-pool) — conditions an injection may sensibly wait on,
#: per operation; fixed ticks are always fair game
_CONDITIONS_BY_OP = {
    "autoscale": ("start", "drain_open", "scale_up"),
    "migrate": ("start", "migration.draining", "migration.restoring"),
    "upgrade": ("start", "upgrade", "upgrade.draining"),
}


def sample_scenario(root_seed: int, index: int) -> Scenario:
    """Deterministically sample scenario ``index`` of the sweep rooted at
    ``root_seed``. One fresh RNG per index: sampling scenario 7 never
    depends on whether 0–6 were sampled first."""
    rng = random.Random(seed_for(root_seed, f"fuzz-{index}"))
    operation = rng.choice(("autoscale", "autoscale", "migrate", "upgrade"))
    fleet = rng.randint(4, 8)
    ticks = rng.choice((24, 32, 48))
    injections: List[Injection] = []
    for _ in range(rng.randint(1, 3)):
        kind = rng.choice(sorted(INJECTION_KINDS))
        params = {}
        if kind in ("az_loss", "revocation_wave"):
            params["frac"] = rng.choice((0.2, 0.25, 0.34, 0.5))
        elif kind == "apiserver_brownout":
            params["p"] = rng.choice((0.2, 0.3, 0.4))
            params["dur"] = rng.choice((30, 60, 90))
        elif kind == "thundering_herd":
            params["join"] = rng.choice((4, 8, 16))
        elif kind == "pod_chaos":
            params["kills"] = rng.randint(1, 3)
        elif kind == "frontier_drift":
            params["frac"] = rng.choice((0.2, 0.25, 0.34, 0.5))
            params["factor"] = rng.choice((0.2, 0.25, 0.4))
        if rng.random() < 0.5:
            injections.append(Injection(kind=kind, params=params,
                                        at=rng.randint(1, ticks - 2)))
        else:
            injections.append(Injection(
                kind=kind, params=params,
                when=rng.choice(_CONDITIONS_BY_OP[operation])))
    return Scenario(
        name=f"fuzz-{root_seed}-{index}",
        operation=operation,
        fleet=fleet,
        preemptible=True,
        zones=rng.choice((2, 3)),
        ticks=ticks,
        tick_s=10.0,
        injections=injections,
    )


def run_fuzz(seed: int, budget: int, out_dir: str,
             index: Optional[int] = None,
             minimize_failures: bool = True,
             emit=print) -> dict:
    """Run the sweep (or one ``index`` of it); returns the summary dict
    with per-scenario verdicts and any failure bundles written."""
    from .artifacts import dump, failure_banner
    from .engine import FleetSimulator
    from .minimize import minimize

    indices = [index] if index is not None else list(range(budget))
    results = []
    failures = []
    for pos, i in enumerate(indices, 1):
        scenario = sample_scenario(seed, i)
        run_seed = seed_for(seed, f"scenario-{i}")
        sim = FleetSimulator(scenario, seed=run_seed)
        try:
            report = sim.run()
        # the fuzz harness deliberately captures EVERY crash (incl. an
        # escaped BreakerOpenError — itself a finding: the engine should
        # have absorbed it) as a red run  # opalint: disable=breaker-swallow
        except Exception as e:
            # an engine crash is a failure too — but not minimizable the
            # same way; record it with its repro line and keep sweeping
            emit(f"[{pos}/{len(indices)}] {scenario.name}: CRASH "
                 f"{type(e).__name__}: {e}")
            failures.append({"index": i, "scenario": scenario.to_dict(),
                             "crash": f"{type(e).__name__}: {e}"})
            continue
        verdict = "ok" if report["ok"] else "FAIL"
        emit(f"[{pos}/{len(indices)}] {scenario.name} "
             f"({scenario.operation}, fleet={scenario.fleet}, "
             f"{len(scenario.injections)} injections): {verdict}")
        results.append({"index": i, "name": scenario.name,
                        "operation": scenario.operation,
                        "ok": report["ok"],
                        "canonical": report["canonical"]})
        if report["ok"]:
            continue
        shrunk = scenario
        if minimize_failures:
            shrunk, runs = minimize(scenario, run_seed)
            emit(f"  minimized in {runs} runs: fleet={shrunk.fleet} "
                 f"ticks={shrunk.ticks} "
                 f"injections={len(shrunk.injections)}")
            # re-run the minimized form so the bundle's forensics match
            # the scenario that gets committed
            sim = FleetSimulator(shrunk, seed=run_seed)
            report = sim.run()
        bundle = dump(out_dir, shrunk, report, run_seed, sim=sim)
        emit(failure_banner(shrunk, report, run_seed, bundle=bundle))
        failures.append({"index": i, "scenario": shrunk.to_dict(),
                         "bundle": bundle,
                         "oracles": [o for o in report["oracles"]
                                     if not o["ok"]]})
    summary = {
        "seed": seed,
        "budget": budget,
        "ran": len(indices),
        "passed": sum(1 for r in results if r["ok"]),
        "failed": len(failures),
        "failures": failures,
        "results": results,
    }
    return summary
