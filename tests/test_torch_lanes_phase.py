"""``chip_smoke.py`` phase 21 (``lanes_phase``) rehearsed on the CPU.

The smoke's own phase: the port's shell e2e with its seven cases, the
envtest driver against its own in-process apiserver (five steps and the
verdict), and the envtest and kind scripts' skip contract (exit 77, the
record in the phase's work dir). A missing tool or a case that does not
pass fails the phase.
"""

import os
import shutil
import sys
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ctx(tmp_path, env=None):
    return types.SimpleNamespace(repo=REPO, card="cpu rehearsal", work=str(tmp_path),
                                 operator_env=dict(env or os.environ))


@pytest.mark.skipif(shutil.which("curl") is None, reason="curl not available")
def test_phase_21_on_the_cpu(tmp_path):
    import chip_smoke

    # this interpreter's python3 first; no kind, docker, kubectl or kube-apiserver
    env = dict(os.environ, PATH=f"{os.path.dirname(sys.executable)}:/usr/bin:/bin")
    numbers = chip_smoke.lanes_phase(_ctx(tmp_path, env))
    cases = numbers["shell_e2e"]["case_s"]
    assert sorted(cases) == sorted(os.listdir(os.path.join(REPO, "tests", "cases", "torch")))
    assert all(s > 0 for s in cases.values())
    assert numbers["shell_e2e"]["total_s"] > sum(cases.values())
    assert numbers["envtest"]["steps"] == {s: "pass" for s in chip_smoke.LANES_ENVTEST_STEPS}
    assert numbers["e2e-envtest-gpu.sh"] == numbers["e2e-kind-gpu.sh"] == "skipped (77)"
    assert os.path.exists(tmp_path / "e2e-kind-gpu.sh.skip.json")
    assert not os.path.exists(os.path.join(REPO, "tests", "e2e-envtest-gpu-SKIPPED.json"))


def test_a_missing_tool_fails_the_phase(tmp_path, monkeypatch):
    import chip_smoke

    real = shutil.which
    monkeypatch.setattr(chip_smoke.shutil, "which",
                        lambda name, *a, **kw: None if name == "curl" else real(name, *a, **kw))
    with pytest.raises(SystemExit):
        chip_smoke.lanes_phase(_ctx(tmp_path))
    assert "missing: ['curl']" in chip_smoke._FAILURES[-1]
    chip_smoke._FAILURES.clear()
