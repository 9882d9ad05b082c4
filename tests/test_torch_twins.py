"""Every test file of the reference has its twin among the port's tests, or
stands in :data:`NO_TWIN` with its reason.

A port test names a reference file as its twin when its module docstring
names it (``tests/test_x.py``), as in "The twin of tests/test_x.py". The
files still without a twin are ROADMAP.md's Queue 1, in the order later
slices take them; a file leaves the list in the change that adds its twin.
"""

import ast
import pathlib
import re

import pytest

TESTS = pathlib.Path(__file__).resolve().parent
QUEUED = "queued in ROADMAP.md Queue 1"
#: reference test file -> why no port test is its twin
NO_TWIN = {
    "test_bench.py": "bench.py is the reference's harness and is not ported; the port's "
                     "benchmark comes with its own harness",
}


def reference_files():
    return sorted(p.name for p in TESTS.glob("test_*.py") if not p.name.startswith("test_torch_"))


def twins() -> dict:
    """Reference file -> the port tests whose docstrings name it."""
    named: dict = {}
    for path in sorted(TESTS.glob("test_torch_*.py")):
        doc = ast.get_docstring(ast.parse(path.read_text())) or ""
        for ref in set(re.findall(r"tests/(test_[a-z0-9_]+\.py)", doc)):
            named.setdefault(ref, []).append(path.name)
    return named


def test_every_reference_file_has_a_twin_or_a_reason():
    named = twins()
    orphans = [f for f in reference_files() if f not in named and f not in NO_TWIN]
    assert orphans == [], f"reference tests with no twin and no reason: {orphans}"


def test_the_no_twin_list_holds_only_files_without_a_twin():
    named = twins()
    assert sorted(f for f in NO_TWIN if f in named) == []
    assert sorted(f for f in NO_TWIN if f not in reference_files()) == []
    assert all(reason.strip() for reason in NO_TWIN.values())


def test_every_queued_file_is_in_the_roadmap_s_queue_1():
    roadmap = (TESTS.parent / "ROADMAP.md").read_text()
    queue = roadmap.split("### Queue 1", 1)[1].split("\n### ", 1)[0]
    queued = [f for f, reason in NO_TWIN.items() if reason == QUEUED]
    assert [f for f in queued if f"tests/{f}" not in queue] == []
    # in the queue's order: the list here follows it
    assert sorted(queued, key=queue.index) == queued


@pytest.mark.parametrize("ref", ["test_e2e_scenarios.py", "test_soak.py",
                                 "test_chaos_convergence.py", "test_scale_envelope.py",
                                 "test_schema_fuzz.py", "test_runtime_queue.py",
                                 "test_runtime_metrics.py"])
def test_the_acceptance_suites_have_their_twins(ref):
    assert twins().get(ref) == [f"test_torch_{ref[len('test_'):]}"]
