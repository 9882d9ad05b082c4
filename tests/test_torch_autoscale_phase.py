"""``chip_smoke.py`` phase 16 rehearsed on the CPU.

The smoke's own ``autoscale_phase`` on a one-node cluster of the port's
MiniApiServer and the process kubelet, which runs feature discovery
(``--device=cpu``) and the device plugin's init; the serving probe runs on
the CPU at a short ladder. The phase's operator runs in this process over
the chaos transport, as on the card, and its checks are the card's: the
collector's tokens per node against the node's measured frontier, two
registrations, one scale-down by migration with no step lost, every chaos
kind injected, no orphan actuation, the AUTOSCALE and MIGRATION columns,
and the operator's modules free of torch. A second run without chaos must
reach the same terminal state (``chip_smoke.AUTOSCALE_TERMINAL``). Every
time is the phase's own (the apiserver's watch stamps each change).
"""

import json
import os
import sys
import types

import pytest

from tpu_operator_torch import consts
from tpu_operator_torch.testing.apiserver import MiniApiServer
from tpu_operator_torch.testing.kubelet import INIT, RUN, ProcessKubelet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "tpu_operator_torch", "manifests", "samples", "v1_clusterpolicy.json")
NS = "tpu-operator"
#: the card's node as phase 12 leaves it, but named to sort after the pool's
#: registered nodes as the card machine's host name does
NODE = "runsc"


def _run_phase(tmp_path, chaos: bool) -> dict:
    import chip_smoke

    dev = tmp_path / "dev"
    dev.mkdir()
    (dev / "nvidia0").touch()
    srv = MiniApiServer()
    base = srv.start()
    srv.backend.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": NODE, "labels": {consts.NFD_NVIDIA_PCI_LABEL: "true",
                                 consts.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb"}}})
    operator_env = {k: v for k, v in os.environ.items()
                    if k != "PYTHONPATH" and not k.startswith("GPU_")}
    env = {k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ}
    env.update(PYTHONPATH=REPO, KUBE_API_URL=base)
    kubelet = ProcessKubelet(
        srv.backend, NODE, NS, str(tmp_path / "logs"), env,
        {"gpu-validator": [sys.executable, "-m", "tpu_operator_torch.cmd.validator",
                           "--device=cpu"]},
        modes={"gpu-feature-discovery": RUN, "gpu-device-plugin": INIT},
        capacity_app="gpu-device-plugin",
        path_map={"/var/cache/gpu-kernels": str(tmp_path / "kernel-cache")}).start()
    cp = json.load(open(SAMPLE))
    cp["spec"]["hostPaths"] = {"validationStatusDir": str(tmp_path / "status"),
                               "partitionHandoffDir": str(tmp_path / "handoff"),
                               "driverInstallDir": str(tmp_path / "driver"),
                               "devGlobs": [str(dev / "nvidia0")]}
    cp["spec"]["validator"]["revalidateIntervalS"] = 0
    cp["spec"]["featureDiscovery"]["sleepInterval"] = "1s"
    try:
        srv.backend.create(cp)
        return chip_smoke.autoscale_phase(types.SimpleNamespace(
            srv=srv, base=base, kubelet=kubelet, namespace=NS, node_name=NODE, repo=REPO,
            work=str(tmp_path), card="cpu", operator_env=operator_env, chaos=chaos,
            serving_args=("--device=cpu", "--serving-batch-sizes=1,2", "--serving-steps=8"),
            serving_env={"OMP_NUM_THREADS": "1"}))
    finally:
        kubelet.stop()
        srv.stop()


@pytest.mark.parametrize("chaos", [True, False], ids=["chaos", "no-chaos"])
def test_phase_16_on_the_cpu(tmp_path, chaos):
    import chip_smoke

    numbers = _run_phase(tmp_path, chaos)
    assert numbers["terminal"] == chip_smoke.AUTOSCALE_TERMINAL
    up, down = numbers["scale_up"], numbers["scale_down"]
    assert len(up["registered"]) == 2 and up["registered_s"] == sorted(up["registered_s"])
    assert down["victim"] in up["registered"] and down["destination"] != down["victim"]
    assert down["states"][0] == ["draining", 1] and down["states"][-1] == ["done", 4]
    assert down["ack_step"] == down["resume_step"]
    assert (down["requested_s"] <= down["plan_s"] <= down["ack_s"] <= down["transfer_s"]
            <= down["restored_s"] <= down["done_s"] <= down["deleted_s"])
    assert numbers["capacity"]["tokens_per_node"] == numbers["capacity"]["metric"] > 0
    assert numbers["metrics"]["migrations_total"] == {"completed": 1.0}
    assert numbers["operator_maps"] == "MAPS False False False"
    if chaos:
        assert all(numbers["chaos"].get(k, 0) > 0 for k in chip_smoke.CHAOS_KINDS)
    else:
        assert numbers["chaos"] is None
