"""``chip_smoke.py`` phase 19 (``lint_phase``) rehearsed on the CPU.

The smoke's own phase: ``gpuop-lint`` (its console script) in fresh
processes that must map neither torch nor libcuda, over this tree (exit 0,
nothing new, baselined or stale, under the reference's 30 s budget),
``--list-rules`` (the reference's rule names), ``--format sarif`` (the
port's tool), and a copy of the tree with one suppression taken out (exit
1, naming that rule and file). A seed that names no suppression fails the
phase.
"""

import os
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ctx(tmp_path):
    return types.SimpleNamespace(repo=REPO, card="cpu rehearsal", work=str(tmp_path),
                                 operator_env=dict(os.environ))


def test_phase_19_on_the_cpu(tmp_path):
    import chip_smoke

    numbers = chip_smoke.lint_phase(_ctx(tmp_path))
    full = numbers["full_tree"]
    assert (full["rc"], full["new"], full["baselined"], full["stale"]) == (0, 0, 0, 0)
    assert full["files"] > 150 and full["suppressed"] == 32
    assert full["wall_s"] < chip_smoke.LINT_BUDGET_S
    assert numbers["rules"] == len(chip_smoke.LINT_RULES) == 17
    assert numbers["sarif"] == {"version": "2.1.0", "tool": "gpuop-lint", "results": 0}
    path, rule = chip_smoke.LINT_SEED
    assert numbers["seeded"]["rc"] == 1
    [finding] = numbers["seeded"]["findings"]
    assert finding.startswith(f"{path}:") and finding.endswith(f"[{rule}]")


def test_the_phase_s_rule_names_are_the_reference_s():
    import chip_smoke
    from tpu_operator.analysis.core import all_checkers

    assert chip_smoke.LINT_RULES == tuple(sorted(all_checkers()))


def test_a_seed_without_its_suppression_fails_the_phase(tmp_path, monkeypatch):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "_FAILURES", [])
    monkeypatch.setattr(chip_smoke, "LINT_SEED",
                        ("tpu_operator_torch/state/manager.py", "breaker-swallow"))
    with pytest.raises(SystemExit) as e:
        chip_smoke.lint_phase(_ctx(tmp_path))
    assert e.value.code == 1
    assert "suppressions of breaker-swallow, not 1" in chip_smoke._FAILURES[-1]
