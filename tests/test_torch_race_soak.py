"""The race-soak lane on the CPU: the port's soaks under its race sanitizer,
then the gate (the twin of the reference's ``make race-soak``, cut to the
port's split-brain twin, the leader fence tests and a three-scenario fuzz
slice so that it runs in tier-1).

Each soak runs in a fresh process with ``GPU_OPERATOR_OPSAN=1``,
``GPU_OPERATOR_OPSAN_PERTURB=1``, ``OPSAN_SEED=20260807`` and
``GPU_OPERATOR_OPSAN_REPORT`` at one directory (the switch must be set
before the process imports the port: module-level locks are built at
import), and dumps its report there at exit. Then ``python -m
tpu_operator_torch.cmd.opsan check`` over the reports, with the committed
fixtures (tests/cases/torch_opsan/dynamic_edges.json), must exit 0: no race
and no dynamic-only lock edge without a fixture. Each fixture names the
static blind spot that hides its edge from ``gpuop-lint``'s lock graph.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "cases", "torch_opsan", "dynamic_edges.json")
#: the lane's pinned root seed
OPSAN_SEED = 20260807
#: the soaks, each in its own process under the sanitizer, with its own bound
#: (s; with the gate's, 120 s in all)
SOAKS = (
    ([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
      "tests/test_torch_split_brain.py::test_split_brain_old_leader_fully_fenced[port]",
      "tests/test_torch_split_brain.py::test_lease_partition_blocks_only_coordination_api[port]",
      "tests/test_torch_leader.py", "-k", "port or fence or fenced"], 70),
    ([sys.executable, "-m", "tpu_operator_torch.cmd.sim", "fuzz", "--budget", "3"], 30),
)


def sanitized_env(report_dir: str) -> dict:
    """This process's environment with the sanitizer's three switches and
    the lane's seed, and the repository on the path (a worker's own pytest
    variables left out)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("GPU_OPERATOR_OPSAN", "TPU_OPERATOR_OPSAN", "PYTEST_"))}
    env.update(GPU_OPERATOR_OPSAN="1", GPU_OPERATOR_OPSAN_PERTURB="1",
               GPU_OPERATOR_OPSAN_REPORT=report_dir, OPSAN_SEED=str(OPSAN_SEED),
               PYTHONPATH=REPO)
    return env


def test_the_race_soak_lane_finds_no_race_and_no_unfixtured_edge(tmp_path):
    reports = str(tmp_path / "reports")
    env = sanitized_env(reports)
    for argv, bound in SOAKS:
        out = subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=bound)
        assert out.returncode == 0, f"{argv[2:]}:\n{out.stdout[-3000:]}{out.stderr[-3000:]}"
    dumped = sorted(os.listdir(reports))
    assert len(dumped) == len(SOAKS), dumped
    gate = subprocess.run(
        [sys.executable, "-m", "tpu_operator_torch.cmd.opsan", "check", "--reports", reports,
         "--root", REPO, "--fixtures", FIXTURES, "--json"],
        cwd=REPO, env={k: v for k, v in env.items() if not k.startswith("GPU_OPERATOR_OPSAN")},
        capture_output=True, text=True, timeout=20)
    result = json.loads(gate.stdout)
    assert gate.returncode == 0, json.dumps({k: result[k] for k in (
        "races", "unfixtured", "stale_fixtures")}, indent=1)
    assert result["ok"] and result["races"] == [] and result["unfixtured"] == []
    assert result["stale_fixtures"] == []
    # the evidence: the soaks tracked accesses and exercised lock edges
    accesses = 0
    for name in dumped:
        with open(os.path.join(reports, name)) as fh:
            report = json.load(fh)
        assert report["version"] == 1 and report["races"] == []
        accesses += report["accesses_total"]
    assert accesses > 1000 and result["dynamic_edges"]


def test_every_fixture_names_a_blind_spot_and_was_observed():
    """The committed fixtures: each a dynamic-only edge of the port (not in
    the static graph), with a rationale; none copied from the reference's
    file without the port's run showing it (each says where it was seen)."""
    from tpu_operator_torch.analysis import runner
    from tpu_operator_torch.analysis.core import LintConfig
    from tpu_operator_torch.sanitizer import crosscheck

    fixtures = crosscheck.load_fixtures(FIXTURES)
    assert fixtures
    project = runner._build_project(REPO, runner._AstCache(REPO), LintConfig())
    static = set(crosscheck.static_lock_edges(project))
    with open(FIXTURES) as fh:
        entries = json.load(fh)["edges"]
    assert len(entries) == len(fixtures)
    for entry in entries:
        edge = (entry["src"], entry["dst"])
        assert edge not in static, edge
        assert len(entry["rationale"]) > 80 and entry.get("observed_in"), edge
