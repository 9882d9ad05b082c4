"""``chip_smoke.py`` phase 13 rehearsed on the CPU: the same function
(``chip_smoke.gpudriver_phase``) on a one-node cluster of the port's
MiniApiServer, ``gpu-operator`` processes and the process kubelet, with
the driver installer run from a fake driver bundle and the other
DaemonSets simulated. It drives the GPUDriver hand-over and hand-back, the
conflict, the 422 refusals, two ``--leader-elect`` replicas (a takeover and
the fence) and ``gpuop-cfg`` as the card's run does, and fails where the
smoke would."""

import json
import os
import subprocess
import sys
import time
import types

from tpu_operator_torch import consts
from tpu_operator_torch.testing.apiserver import MiniApiServer
from tpu_operator_torch.testing.kubelet import RUN, ProcessKubelet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "tpu_operator_torch", "manifests", "samples", "v1_clusterpolicy.json")
NS = "tpu-operator"


def _wait(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_phase_13_on_the_cpu(tmp_path):
    import chip_smoke

    bundle = tmp_path / "bundle"
    bundle.mkdir()
    for name in consts.DRIVER_LIB_FILES:
        (bundle / name).write_bytes(b"\x7fELF" + bytes(60))
    dev = tmp_path / "dev"
    dev.mkdir()
    (dev / "nvidia0").touch()
    srv = MiniApiServer()
    base = srv.start()
    srv.backend.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "gpu-node", "labels": {consts.NFD_NVIDIA_PCI_LABEL: "true",
                                       consts.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb"}}})
    cp = json.load(open(SAMPLE))
    cp["spec"]["hostPaths"] = {"validationStatusDir": str(tmp_path / "status"),
                               "partitionHandoffDir": str(tmp_path / "handoff"),
                               "driverInstallDir": str(tmp_path / "driver"),
                               "devGlobs": [str(dev / "nvidia0")]}
    operator_env = {k: v for k, v in os.environ.items()
                    if k != "PYTHONPATH" and not k.startswith("GPU_")}
    log = open(tmp_path / "operator.log", "w")
    operator = subprocess.Popen(
        [sys.executable, "-m", "tpu_operator_torch.cmd.operator", f"--api-server={base}",
         f"--namespace={NS}", "--metrics-port=0", "--health-port=0"],
        cwd=REPO, env=operator_env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)
    env = {k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ}
    env.update(PYTHONPATH=REPO, KUBE_API_URL=base)
    driver_env = {consts.DRIVER_SRC_ENV: str(bundle), consts.DRIVER_VERSION_ENV: "580.0"}
    kubelet = ProcessKubelet(
        srv.backend, "gpu-node", NS, str(tmp_path / "logs"), env,
        {"gpu-validator": [sys.executable, "-m", "tpu_operator_torch.cmd.validator",
                           "--device=cpu"]},
        modes={"gpu-driver": RUN}, image_env={"gpu-driver": driver_env}).start()
    try:
        srv.backend.create(cp)
        _wait(lambda: (srv.backend.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
                       .get("status") or {}).get("state") == "ready", 120, "ready")
        numbers = chip_smoke.gpudriver_phase(types.SimpleNamespace(
            srv=srv, base=base, kubelet=kubelet, namespace=NS, node_name="gpu-node",
            repo=REPO, work=str(tmp_path), card="cpu", operator=operator,
            operator_env=operator_env, driver_env=driver_env))
    finally:
        kubelet.stop()
        if operator.poll() is None:
            operator.kill()
        operator.wait(timeout=30)
        log.close()
        srv.stop()
    assert numbers["handover"]["pool"] == "nvidia-h100-80gb"
    assert numbers["handover"]["daemonset"] == "gpu-driver-default-nvidia-h100-80gb"
    assert numbers["conflict"]["warning_events"] == {"default": 1, "conflicting": 1}
    assert numbers["schema"] == {"typo": 422, "driverType": 422}
    assert numbers["leader"]["old_leader_exit"] == 1
    assert numbers["leader"]["fenced_writes"] > 0
    # the takeover as the Lease records it: the lease plus a retry period
    assert numbers["leader"]["takeover_lease_s"] <= 18.0
    assert numbers["leader"]["first_fenced_s"] <= 8.0
