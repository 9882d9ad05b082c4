"""gpu.mk, the port's developer entry points, against the Makefile's: every
target of the reference's but the benchmark ones (``bench``, ``*-bench``,
which come with the port's benchmark harness) has its counterpart, and
each dry-runs (``make -n``) on the port alone: no recipe names the JAX
package, a reference test file or another of the reference's entry points,
and every file, test and script a recipe names exists.
"""

import ast
import pathlib
import re
import subprocess

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = re.compile(r"^(bench|.+-bench)$")
#: the reference's own entry points, which no recipe of gpu.mk may run
REFERENCE_PATHS = ("__graft_entry__", "bench.py", "tests/scripts/end-to-end.sh",
                   "hack/gen-crds.py", "hack/must-gather.sh", "tests/e2e-kind.sh",
                   "tests/e2e-envtest.sh", "config/samples/", "bundle/manifests/",
                   "tests/cases/opsan/", "native/tpu-")


def targets(makefile: str) -> list:
    text = re.sub(r"\\\n", " ", (REPO / makefile).read_text())
    return [t for line in re.findall(r"^\.PHONY:(.*)$", text, re.M) for t in line.split()]


PORT_TARGETS = targets("gpu.mk")


def dry_run(target: str) -> str:
    out = subprocess.run(["make", "-n", "-f", "gpu.mk", target], cwd=REPO,
                         capture_output=True, text=True, timeout=30)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_every_reference_target_but_the_benchmarks_has_a_counterpart():
    reference = targets("Makefile")
    assert "test" in reference and "bench" in reference
    missing = [t for t in reference if not BENCH.match(t) and t not in PORT_TARGETS]
    assert missing == []
    assert [t for t in PORT_TARGETS if BENCH.match(t)] == []
    assert "multihost" in PORT_TARGETS


def _test_exists(path: pathlib.Path, name: str) -> bool:
    tree = ast.parse(path.read_text())
    return any(isinstance(node, ast.FunctionDef) and node.name == name for node in tree.body)


@pytest.mark.parametrize("target", PORT_TARGETS)
def test_the_target_runs_the_port_alone(target):
    recipe = dry_run(target)
    assert not re.search(r"\btpu_operator\.", recipe), recipe
    assert not re.search(r"tests/test_(?!torch_)\w+\.py", recipe), recipe
    for path in REFERENCE_PATHS:
        assert path not in recipe, (path, recipe)
    for path, name in re.findall(r"(tests/test_torch_\w+\.py)(?:::(\w+))?", recipe):
        assert (REPO / path).exists(), path
        assert not name or _test_exists(REPO / path, name), f"{path}::{name}"
    for path in re.findall(r"(?<![\w/.-])((?:tests|hack|bundle-gpu|config)/[\w/.-]+\.(?:sh|yaml|json))",
                           recipe):
        assert (REPO / path).exists(), path


def test_the_crash_soak_runs_both_matrices_and_the_race_soak_the_gate():
    crash = dry_run("crash-soak")
    tests = crash.split(" -m pytest ", 1)[1].split(" -q")[0].split()
    assert "tests/test_torch_crash_soak.py" in tests  # its matrix with it
    assert "tests/test_torch_migrate.py::test_migration_crash_point_matrix" in tests
    assert " -m " not in crash.split(" -m pytest ", 1)[1]  # slow tests not deselected
    race = dry_run("race-soak")
    assert "GPU_OPERATOR_OPSAN=1" in race and "--double-run" in race
    assert "--budget 10" in race
    assert "tpu_operator_torch.cmd.opsan check" in race
    assert "tests/cases/torch_opsan/dynamic_edges.json" in race
    assert all(test in race for test in tests)
