"""``chip_smoke.py`` phase 15 rehearsed on the CPU.

The smoke's own ``upgrade_phase`` on a one-node cluster of the port's
MiniApiServer, a ``gpu-operator`` process and the process kubelet, which
runs the driver installer (from a fake bundle), the validator's init chain
with its spawned workload pod (``--device=cpu``), feature discovery, and
the user's consumer pod, here a process that holds no GPU. Both episodes
run as on the card: U1 past the PDB to ``upgrade-done`` with the admin's
cordon kept, U2's crash-looping installer to ``upgrade-failed`` and its
retry to ``upgrade-done``, uncordoned by the machine. For U1 and U2's
retry the validator pods the machine deleted and those Ready when it
certified the node are apart, and U2 is never certified while its driver
is broken.
"""

import json
import os
import sys
import types

from tpu_operator_torch import consts
from tpu_operator_torch.testing.apiserver import MiniApiServer
from tpu_operator_torch.testing.kubelet import INIT, RUN, ProcessKubelet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "tpu_operator_torch", "manifests", "samples", "v1_clusterpolicy.json")
NS = "tpu-operator"
#: the consumer on the CPU: it holds nothing, and runs until killed
CONSUMER = ("import time\n"
            "print('holding', 0, flush=True)\n"
            "while True:\n"
            "    time.sleep(0.1)\n")


def test_phase_15_on_the_cpu(tmp_path):
    import chip_smoke

    bundle = tmp_path / "bundle"
    bundle.mkdir()
    for name in consts.DRIVER_LIB_FILES:
        (bundle / name).write_bytes(b"\x7fELF" + bytes(60))
    dev = tmp_path / "dev"
    dev.mkdir()
    (dev / "nvidia0").touch()
    srv = MiniApiServer(watch_idle_timeout_s=1.0)
    base = srv.start()
    srv.backend.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "gpu-node", "labels": {consts.NFD_NVIDIA_PCI_LABEL: "true",
                                       consts.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb"}}})
    operator_env = {k: v for k, v in os.environ.items()
                    if k != "PYTHONPATH" and not k.startswith("GPU_")}
    env = {k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ}
    env.update(PYTHONPATH=REPO, KUBE_API_URL=base)
    driver_env = {consts.DRIVER_SRC_ENV: str(bundle), consts.DRIVER_VERSION_ENV: "580.0"}
    kubelet = ProcessKubelet(
        srv.backend, "gpu-node", NS, str(tmp_path / "logs"), env,
        {"gpu-validator": [sys.executable, "-m", "tpu_operator_torch.cmd.validator",
                           "--device=cpu", "--matrix-dim=64"]},
        modes={"gpu-driver": RUN, "gpu-operator-validator": RUN, "gpu-device-plugin": INIT},
        image_env={"gpu-driver": driver_env}, capacity_app="gpu-device-plugin",
        path_map={"/var/cache/gpu-kernels": str(tmp_path / "kernel-cache")}).start()
    cp = json.load(open(SAMPLE))
    cp["spec"]["hostPaths"] = {"validationStatusDir": str(tmp_path / "status"),
                               "partitionHandoffDir": str(tmp_path / "handoff"),
                               "driverInstallDir": str(tmp_path / "driver"),
                               "devGlobs": [str(dev / "nvidia0")]}
    cp["spec"]["validator"]["revalidateIntervalS"] = 0
    try:
        srv.backend.create(cp)
        numbers = chip_smoke.upgrade_phase(types.SimpleNamespace(
            srv=srv, base=base, kubelet=kubelet, namespace=NS, node_name="gpu-node",
            repo=REPO, work=str(tmp_path), card="cpu", operator_env=operator_env,
            consumer_script=CONSUMER))
    finally:
        kubelet.stop()
        srv.stop()
    u1, u2 = numbers["u1"], numbers["u2"]
    assert u1["pod-deletion-required_s"] < u1["consumer_killed_s"] < u1["driver_pod_deleted_s"]
    assert all(gap <= 10.0 for gap in u1["retry_gaps_s"])
    assert u1["upgrade-done_s"] < u1["cleared_s"]
    assert u2["driver_crashed_s"] < u2["upgrade-failed_s"]
    assert u2["gauges_failed"]["failed"] == 1 and u2["gauges"]["available"] == 1
    assert [kinds for _, kinds in numbers["episodes"]] == [
        [f"upgrade/{k}" for k in chip_smoke.EPISODE_U1],
        [f"upgrade/{k}" for k in chip_smoke.EPISODE_U2]]
    assert numbers["evictions"]["refused_429"] >= 2
    for seen in (u1["validators"], u2["retry_validators"]):
        deleted, ready = seen["deleted_validator_uids"], seen["certifying_validator_uids"]
        assert deleted and ready and not set(deleted) & set(ready), seen
    failed_at = u2["states"].index("upgrade-failed")
    assert not {"uncordon-required", "upgrade-done"} & set(u2["states"][:failed_at]), u2["states"]
