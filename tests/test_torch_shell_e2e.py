"""The port's shell e2e layer: tests/scripts/torch/end-to-end.sh drives
``gpu-operator`` as a process against the port's cluster harness with curl,
through every case under tests/cases/torch/ (the counterpart of
tests/test_shell_e2e.py over tests/scripts/ and tests/cases/).

The whole run is ``slow``. Tier-1 holds the scripts statically: they parse,
each reference case has its port case, every helper a case calls is
defined, and no script names the reference's package, tools, resource or
the yaml module.
"""

import pathlib
import re
import shutil
import subprocess

import pytest

from test_torch_operator_mapping import SHELL_CASES

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = REPO_ROOT / "tests" / "scripts" / "torch"
CASES = REPO_ROOT / "tests" / "cases" / "torch"
SCRIPT = SCRIPTS / "end-to-end.sh"
PORT_FILES = sorted(SCRIPTS.glob("*.sh")) + sorted(CASES.glob("*.sh"))

#: commands a case may call that are no helper of the layer's
SHELL_COMMANDS = {"set", "echo", "exit", "return", "local", "cat", "grep", "true", "false",
                  "date", "sleep", "curl", "python3", "bash", "then", "else", "fi", "do",
                  "done", "for", "if", "while", "in"}


def _functions(text: str) -> set:
    return set(re.findall(r"^\s*([a-z_][a-z0-9_]*)\(\)\s*\{", text, re.M))


def _called(text: str) -> set:
    """Words in a command's position: a line's first, after ``;``, ``&&``,
    ``||``, ``|``, ``$(``, ``!``, ``if``, and the command ``wait_for`` polls."""
    text = re.sub(r"^\s*#.*", "", text, flags=re.M)
    text = re.sub(r"'[^']*'", "''", text)  # quoted JSON and Python
    text = re.sub(r"\$\{[^}]*\}", "X", text)
    text = re.sub(r'"[^"]*"', lambda m: m[0] if "$(" in m[0] else '""', text)  # prose
    words = set(re.findall(r"(?:^|[;|&]|\$\(|\bif\b|!)\s*([a-z_][a-z0-9_]*)\b(?!=)",
                           text, re.M))
    words |= set(re.findall(r"\bwait_for\s+\"[^\"]*\"\s+\d+\s+([a-z_][a-z0-9_]*)", text))
    return words


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO_ROOT)))
def test_every_port_script_parses(path):
    result = subprocess.run(["bash", "-n", str(path)], capture_output=True, text=True)
    assert result.returncode == 0, result.stderr


def test_one_port_case_per_reference_case():
    reference = sorted(p.name for p in (REPO_ROOT / "tests" / "cases").glob("*.sh"))
    port = sorted(p.name for p in CASES.glob("*.sh"))
    assert sorted(SHELL_CASES.get(name, name) for name in reference) == port


@pytest.mark.parametrize("path", sorted(CASES.glob("*.sh")), ids=lambda p: p.name)
def test_every_helper_a_case_calls_is_defined(path):
    text = path.read_text()
    helpers = _functions((SCRIPTS / "common.sh").read_text())
    exported = {"start_operator", "stop_operator"}  # by end-to-end.sh
    assert exported <= _functions(SCRIPT.read_text())
    missing = _called(text) - helpers - exported - _functions(text) - SHELL_COMMANDS
    assert not missing, f"{path.name} calls undefined helpers: {sorted(missing)}"


def test_the_orchestrator_s_helpers_are_the_reference_s_but_yaml2json():
    """The install reads the port's JSON samples, so ``yaml2json`` goes;
    every other helper of the reference's common.sh stays."""
    ref = _functions((REPO_ROOT / "tests" / "scripts" / "common.sh").read_text())
    port = _functions((SCRIPTS / "common.sh").read_text())
    assert port == ref - {"yaml2json"}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO_ROOT)))
def test_no_port_script_names_the_reference(path):
    text = path.read_text()
    for word in ("tpu_operator.", "tpuop-", "google.com/tpu", "yaml"):
        assert word not in text, f"{path.name} names {word!r}"


def test_the_reference_s_cases_glob_leaves_the_port_s_out():
    """The reference's orchestrator runs ``ls *.sh`` in tests/cases and its
    test asserts a PASS for each: the port's cases live one level down, so
    that glob still finds the reference's seven alone."""
    reference = sorted((REPO_ROOT / "tests" / "cases").glob("*.sh"))
    assert len(reference) == 7 and CASES.parent == reference[0].parent
    assert not {p.name for p in reference} & set(SHELL_CASES.values())


@pytest.mark.slow
@pytest.mark.skipif(shutil.which("curl") is None, reason="curl not available")
def test_shell_end_to_end():
    try:
        proc = subprocess.run(
            ["bash", str(SCRIPT)], cwd=REPO_ROOT,
            # the per-wait budgets inside cases are the primary failure
            # detectors; this outer bound is a backstop against a harness
            # hang and reports the partial output when it fires
            capture_output=True, text=True, timeout=1200,
        )
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        err = e.stderr.decode() if isinstance(e.stderr, bytes) else (e.stderr or "")
        pytest.fail(f"shell e2e exceeded the outer 1200s backstop\n"
                    f"--- stdout ---\n{out[-8000:]}\n--- stderr ---\n{err[-4000:]}")
    assert proc.returncode == 0, (
        f"shell e2e failed\n--- stdout ---\n{proc.stdout[-8000:]}"
        f"\n--- stderr ---\n{proc.stderr[-4000:]}"
    )
    for case in sorted(CASES.glob("*.sh")):
        assert f"PASS: {case.name} (" in proc.stdout, f"case {case.name} did not pass"
