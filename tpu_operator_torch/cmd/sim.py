"""``gpu-sim`` — the adversarial fleet simulator CLI (counterpart of
tpu_operator/cmd/sim.py, ``tpuop-sim``).

Two subcommands::

    gpu-sim run <scenario.yaml> [--seed S] [--double-run] [--json] [--out DIR]
    gpu-sim fuzz [--seed S] [--budget N] [--index I] [--out DIR]
                 [--no-minimize] [--double-run]

``run`` replays one committed scenario (the regression path); ``fuzz``
samples and sweeps the scenario space (the scenario-fuzz gate, 25
scenarios). The root seed resolves flag > $SCENARIO_SEED > pinned default, and
every failure prints the exact repro command. ``--double-run`` executes
everything twice and asserts the canonical event logs are byte-identical
— the determinism gate.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional

from ..simulator import (
    FleetSimulator,
    parse_file,
    repro_command,
    resolve_seed,
)
from ..simulator.artifacts import dump, failure_banner
from ..simulator.fuzz import run_fuzz

log = logging.getLogger(__name__)
DEFAULT_BUDGET = 25
#: where failure bundles land: the port's own, never the reference's cases
DEFAULT_OUT = "tests/cases/torch_scenarios"


def _cmd_run(args) -> int:
    seed = resolve_seed(args.seed)
    scenario = parse_file(args.scenario)
    report = FleetSimulator(scenario, seed=seed).run()
    if args.double_run:
        second = FleetSimulator(scenario, seed=seed).run()
        if report["canonical"] != second["canonical"]:
            print(f"DETERMINISM VIOLATION: two runs of "
                  f"{scenario.name!r} at seed {seed} diverged",
                  file=sys.stderr)
            print("  repro: " + repro_command(seed, case=args.scenario),
                  file=sys.stderr)
            return 2
    if args.json:
        json.dump(report, sys.stdout, indent=2, sort_keys=True, default=str)
        print()
    else:
        verdict = "ok" if report["ok"] else "FAIL"
        print(f"{scenario.name} ({scenario.operation}, "
              f"fleet={scenario.fleet}, ticks={scenario.ticks}): {verdict}")
        for o in report["oracles"]:
            print(f"  {'✓' if o['ok'] else '✗'} {o['name']}: {o['detail']}")
    if not report["ok"]:
        sim = FleetSimulator(scenario, seed=seed)
        report = sim.run()  # fresh engine so the bundle holds live surfaces
        bundle = dump(args.out, scenario, report, seed, sim=sim,
                      case_path=args.scenario)
        print(failure_banner(scenario, report, seed, bundle=bundle,
                             case_path=args.scenario), file=sys.stderr)
        return 1
    return 0


def _cmd_fuzz(args) -> int:
    seed = resolve_seed(args.seed)
    print(f"scenario fuzz: seed={seed} budget={args.budget}"
          + (f" index={args.index}" if args.index is not None else ""))
    summary = run_fuzz(seed, args.budget, args.out, index=args.index,
                       minimize_failures=not args.no_minimize)
    if args.double_run:
        print("double run (determinism gate)...")
        second = run_fuzz(seed, args.budget, args.out, index=args.index,
                          minimize_failures=False, emit=lambda *_: None)
        first_logs = {r["index"]: r["canonical"]
                      for r in summary["results"]}
        for r in second["results"]:
            if first_logs.get(r["index"]) != r["canonical"]:
                print(f"DETERMINISM VIOLATION: scenario index "
                      f"{r['index']} diverged between runs at seed {seed}",
                      file=sys.stderr)
                print("  repro: " + repro_command(
                    seed, budget=args.budget, index=r["index"]),
                    file=sys.stderr)
                return 2
        print(f"double run: {len(second['results'])} canonical logs "
              f"byte-identical")
    print(f"fuzz done: {summary['passed']}/{summary['ran']} passed, "
          f"{summary['failed']} failed")
    if summary["failed"]:
        print("  repro: " + repro_command(seed, budget=args.budget),
              file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="gpu-sim",
        description="deterministic adversarial fleet simulator")
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="replay one scenario YAML")
    p_run.add_argument("scenario", help="path to scenario YAML")
    p_run.add_argument("--seed", type=int, default=None)
    p_run.add_argument("--double-run", action="store_true",
                       help="run twice; fail unless canonical logs match")
    p_run.add_argument("--json", action="store_true",
                       help="emit the full report as JSON")
    p_run.add_argument("--out", default=DEFAULT_OUT,
                       help="where failure bundles land")

    p_fuzz = sub.add_parser("fuzz", help="sample and sweep scenarios")
    p_fuzz.add_argument("--seed", type=int, default=None)
    p_fuzz.add_argument("--budget", type=int, default=DEFAULT_BUDGET)
    p_fuzz.add_argument("--index", type=int, default=None,
                        help="replay only sampled scenario INDEX")
    p_fuzz.add_argument("--double-run", action="store_true",
                        help="sweep twice; fail unless canonical logs match")
    p_fuzz.add_argument("--no-minimize", action="store_true")
    p_fuzz.add_argument("--out", default=DEFAULT_OUT,
                        help="where failure bundles land")

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.command == "run":
        return _cmd_run(args)
    return _cmd_fuzz(args)


if __name__ == "__main__":
    sys.exit(main())
