"""The port's envtest driver, run in the default suite (the counterpart of
tests/test_envtest_driver.py).

``tests/e2e-envtest-gpu.sh`` points ``tests/torch_envtest_driver.py`` at a
real ``kube-apiserver``; no such binaries exist here, so the same driver runs
over the wire against the port's in-process ``MiniApiServer``: real HTTP, the
port's ``RestClient``, its operator and kubelet simulator. The script's skip
contract is held too: exit 77 and a record written where
``ENVTEST_SKIP_RECORD`` points, never into the tree.
"""

import json
import os
import pathlib
import subprocess
import sys

from torch_envtest_driver import Driver, load_crds
from tpu_operator_torch.client.rest import RestClient
from tpu_operator_torch.testing.apiserver import MiniApiServer

HERE = pathlib.Path(__file__).resolve().parent
SCRIPT = HERE / "e2e-envtest-gpu.sh"
STEPS = ["crd-install", "schema-422", "structural-pruning", "reconcile-to-ready",
         "ownerref-gc", "overall"]


def _steps(evidence):
    lines = [json.loads(line) for line in (evidence / "results.jsonl").read_text().splitlines()]
    return {line["step"]: line["status"] for line in lines}


def test_driver_full_suite_against_miniapiserver(tmp_path):
    srv = MiniApiServer()
    base = srv.start()
    try:
        rc = Driver(RestClient(base_url=base), str(tmp_path), expect_gc="yes",
                    timeout=60.0).run()
    finally:
        srv.stop()
    by_step = _steps(tmp_path)
    assert rc == 0, by_step
    assert by_step == {step: "pass" for step in STEPS}


def test_the_driver_as_a_process_boots_its_own_apiserver(tmp_path):
    """``--mini-apiserver``: the form the card's smoke runs."""
    proc = subprocess.run(
        [sys.executable, str(HERE / "torch_envtest_driver.py"), "--mini-apiserver",
         "--expect-gc", "yes", "--timeout", "60", "--evidence-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _steps(tmp_path) == {step: "pass" for step in STEPS}


def test_the_crds_are_the_chart_s():
    crds = load_crds()
    assert {c["spec"]["names"]["kind"] for c in crds} == {"ClusterPolicy", "GPUDriver"}
    assert {c["spec"]["group"] for c in crds} == {"tpu.ai"}


def test_script_skips_honestly_without_binaries(tmp_path):
    """With no kube-apiserver or etcd anywhere the script exits 77 and leaves
    a record of what it probed, where ENVTEST_SKIP_RECORD points."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("KUBEBUILDER_ASSETS", "TEST_ASSET_KUBE_APISERVER", "TEST_ASSET_ETCD")}
    env["PATH"] = "/usr/bin:/bin"  # no Kubernetes binaries here
    env["ENVTEST_SKIP_RECORD"] = str(tmp_path / "skip-record.json")
    env["TMPDIR"] = str(tmp_path)
    proc = subprocess.run(["bash", str(SCRIPT)], env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 77, proc.stdout + proc.stderr
    record = json.loads((tmp_path / "skip-record.json").read_text())
    assert record["skipped"] is True and record["exit"] == 77
    assert any("kubebuilder" in p for p in record["probed_locations"])
    assert "tests/test_torch_envtest_driver.py" in record["assertion_suite_still_executed_via"]
    assert not (HERE / "e2e-envtest-gpu-SKIPPED.json").exists()


def test_the_default_skip_record_is_the_port_s_own():
    """The reference's script writes its committed
    tests/e2e-envtest-SKIPPED.json by default; the port's must not."""
    text = SCRIPT.read_text()
    assert "e2e-envtest-SKIPPED.json" not in text
    assert "${ENVTEST_SKIP_RECORD:-$REPO/tests/e2e-envtest-gpu-SKIPPED.json}" in text
    ignored = (HERE.parent / ".gitignore").read_text().splitlines()
    assert "tests/e2e-envtest-gpu-SKIPPED.json" in ignored


def test_script_syntax():
    assert subprocess.run(["bash", "-n", str(SCRIPT)]).returncode == 0
