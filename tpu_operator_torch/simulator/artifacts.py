"""Must-gather artifact dump for failed simulator runs (copy of
tpu_operator/simulator/artifacts.py).

A failing scenario is only useful if it arrives with its forensics: the
fuzzer (and the CLI `run` on failure) calls :func:`dump` to write the
same evidence set a live cluster's must-gather would collect —
the decision journal, the episode timeline, the terminal object state —
next to the minimized scenario YAML, so triage starts from a directory,
not from a rerun.

Layout under ``<out>/<scenario-name>/``::

    scenario.yaml        the (minimized) failing scenario, runnable as-is
    repro.txt            the exact command line that replays the failure
    report.json          full engine report (oracles, injections, errors)
    journal.jsonl        canonical decision-journal export, one record/line
    timeline.json        /debug/timeline image: episode summaries + records
    nodes.json           terminal Node objects (labels, annotations, spec)
    events.json          terminal protocol Events with counts
    canonical.log        the byte-stable canonical event log
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .scenario import Scenario
from .seeds import repro_command


def dump(out_dir: str, scenario: Scenario, report: dict, seed: int,
         sim=None, case_path: Optional[str] = None) -> str:
    """Write the must-gather bundle; returns the bundle directory."""
    bundle = os.path.join(out_dir, scenario.name)
    os.makedirs(bundle, exist_ok=True)

    case_file = os.path.join(bundle, "scenario.yaml")
    with open(case_file, "w") as f:
        f.write(scenario.to_yaml())

    with open(os.path.join(bundle, "repro.txt"), "w") as f:
        f.write(repro_command(seed, case=case_path or case_file) + "\n")

    with open(os.path.join(bundle, "report.json"), "w") as f:
        json.dump(report, f, indent=2, sort_keys=True, default=str)

    with open(os.path.join(bundle, "canonical.log"), "w") as f:
        f.write(report.get("canonical", "") + "\n")

    # live-simulator surfaces — present when the caller still holds the
    # engine (the fuzzer path); a bare report replay skips them
    if sim is not None:
        with open(os.path.join(bundle, "journal.jsonl"), "w") as f:
            for record in sim.journal.canonical_export():
                f.write(json.dumps(record, sort_keys=True) + "\n")
        with open(os.path.join(bundle, "timeline.json"), "w") as f:
            json.dump({"episodes": sim.journal.episodes(),
                       "records": sim.journal.timeline(),
                       "stats": sim.journal.debug_state()},
                      f, indent=2, sort_keys=True, default=str)
        backend = sim.srv.backend
        with open(os.path.join(bundle, "nodes.json"), "w") as f:
            json.dump(sorted(backend.list("v1", "Node"),
                             key=lambda n: n["metadata"]["name"]),
                      f, indent=2, sort_keys=True)
        from .. import consts
        with open(os.path.join(bundle, "events.json"), "w") as f:
            json.dump(backend.list("v1", "Event", consts.DEFAULT_NAMESPACE),
                      f, indent=2, sort_keys=True)
    return bundle


def failure_banner(scenario: Scenario, report: dict, seed: int,
                   bundle: Optional[str] = None,
                   case_path: Optional[str] = None) -> str:
    """The failure message: which oracles broke, where the evidence is,
    and the exact repro command (the satellite contract — no simulator
    failure ever prints without its repro line)."""
    failed = [o for o in report["oracles"] if not o["ok"]]
    lines = [f"scenario {scenario.name!r} FAILED "
             f"({len(failed)} oracle(s) violated):"]
    for o in failed:
        lines.append(f"  - {o['name']}: {o['detail']}")
    if bundle:
        lines.append(f"  must-gather: {bundle}")
    lines.append("  repro: " + repro_command(seed, case=case_path or (
        os.path.join(bundle, "scenario.yaml") if bundle else None)))
    return "\n".join(lines)
