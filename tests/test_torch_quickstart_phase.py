"""``chip_smoke.py`` phase 12's ClusterPolicy and its quickstart pass,
rehearsed on the CPU.

Phase 12 joins the card from the shipped bare-metal sample
(``config/gpu/samples/v1_clusterpolicy_baremetal.yaml``) with only the
overrides ``sample_policy`` prints; the first test holds its CR to exactly
that. The second runs the smoke's own ``quickstart_pass`` on phase 12's
one-node cluster (``join_cluster`` with that CR: the chart, a
MiniApiServer, the chart's ``gpu-operator`` as a process, the process
kubelet) with the validators on the CPU (``--device=cpu``), the driver
installer over a fake bundle and the node's other operands simulated: the
quickstart's telemetry patches, the per-node kill switch, its workload Pod
(requesting one ``nvidia.com/gpu``, allocated the node's one GPU id by the
kubelet, seeing no GPU here)
and ``gpuop-cfg status``.
"""

import contextlib
import copy
import os
import signal
import subprocess
import time
import types

from test_torch_opsan_phase import _node
from tpu_operator_torch import consts, yamlsubset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the CPU join's limit (the validators' processes each import torch)
JOIN_TIMEOUT_S = 240


def _flatten(value, prefix=""):
    if isinstance(value, dict) and value:
        out = {}
        for key, item in value.items():
            out.update(_flatten(item, f"{prefix}.{key}" if prefix else key))
        return out
    return {prefix: value}


def test_phase_12_joins_from_the_bare_metal_sample_with_only_its_overrides(
        tmp_path, monkeypatch):
    import chip_smoke

    monkeypatch.setenv(consts.GPU_DEV_GLOBS_ENV, "/dev/nvidia0,/dev/nvidia1")
    status_dir = str(tmp_path / "status")
    cp, overrides = chip_smoke.sample_policy(REPO, str(tmp_path), status_dir)
    with open(os.path.join(REPO, chip_smoke.BAREMETAL_SAMPLE)) as f:
        sample = yamlsubset.parse(f.read())
    got, want = _flatten(cp["spec"]), _flatten(sample["spec"])
    changed = {k for k in set(got) | set(want) if got.get(k) != want.get(k)}
    assert changed == set(overrides)
    assert {k: got[k] for k in changed} == {k: v for k, (v, _) in overrides.items()}
    assert {k for k in cp if k != "spec"} == {k for k in sample if k != "spec"}
    assert all(cp[k] == sample[k] for k in cp if k != "spec")
    assert cp["spec"]["hostPaths"]["validationStatusDir"] == status_dir
    assert cp["spec"]["hostPaths"]["devGlobs"] == ["/dev/nvidia0", "/dev/nvidia1"]
    assert all(why for _, why in overrides.values())
    # what the sample itself sets stays: its PSA labels and hourly revalidation
    assert cp["spec"]["psa"] == {"enabled": True}
    assert cp["spec"]["validator"]["revalidateIntervalS"] == 3600


def test_the_quickstart_pass_on_the_cpu(tmp_path, monkeypatch):
    import chip_smoke

    dev = tmp_path / "nvidia0"
    dev.touch()
    monkeypatch.setenv(consts.GPU_DEV_GLOBS_ENV, str(dev))
    work = str(tmp_path)
    cp, _ = chip_smoke.sample_policy(REPO, work, os.path.join(work, "status"))
    cluster = chip_smoke.join_cluster(REPO, work, _node(tmp_path), policy=copy.deepcopy(cp))
    operator_env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env = dict({k: v for k, v in operator_env.items() if not k.startswith("GPU_")},
               **cluster.env)
    log_path = tmp_path / "operator.log"
    operator = subprocess.Popen(
        [*cluster.argv, f"--api-server={cluster.base}",
         f"--metrics-port={chip_smoke.free_port()}", f"--health-port={chip_smoke.free_port()}"],
        cwd=REPO, stdout=open(log_path, "w"), stderr=subprocess.STDOUT,
        start_new_session=True, env=env)
    backend = cluster.srv.backend
    try:
        cluster.kubelet.start()
        backend.create(cp)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while (backend.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy").get("status")
               or {}).get("state") != "ready":
            assert time.monotonic() < deadline, log_path.read_text()[-4000:]
            time.sleep(0.2)
        numbers = chip_smoke.quickstart_pass(types.SimpleNamespace(
            srv=cluster.srv, base=cluster.base, kubelet=cluster.kubelet,
            namespace=consts.DEFAULT_NAMESPACE, node_name="gpu-node", repo=REPO,
            card="cpu rehearsal", operator_env=operator_env, device="cpu"))
    finally:
        cluster.kubelet.stop()
        with contextlib.suppress(ProcessLookupError):
            os.killpg(operator.pid, signal.SIGKILL)
        operator.wait(timeout=60)
        cluster.srv.stop()
    steps = ("a_telemetry_toggle_s", "b_kill_switch_s", "c_workload_pod_s",
             "d_gpuop_cfg_status_s")
    assert all(numbers[k] > 0 for k in steps)
    # each of the five is rounded to the millisecond: half of one each
    assert sum(numbers[k] for k in steps) <= numbers["pass_s"] + 0.0005 * (len(steps) + 1)
    assert numbers["workload_pod"] == {"device_count": 0, "uuids": [], "limit": 1,
                                       "allocated": ["0"]}
    # the Pod ran as the kubelet's process and is gone again
    assert cluster.kubelet.first("pod-exit", pod="gpu-job")["rc"] == 0
    assert backend.list("v1", "Pod", chip_smoke.WORKLOAD_NAMESPACE) == []
    node = backend.get("v1", "Node", "gpu-node")
    assert node["metadata"]["labels"][consts.deploy_label("telemetry")] == "true"
