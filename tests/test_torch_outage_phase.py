"""``chip_smoke.py`` phase 22 (``outage_phase``) rehearsed on the CPU.

The smoke's own phase on phase 12's one-node cluster (``join_cluster``: the
chart, a MiniApiServer, the process kubelet), with the validators on the CPU
(``--device=cpu``), the driver installer over a fake bundle and the node's
other operands simulated: the chart's ``gpu-operator --leader-elect`` takes
the Lease, the join starts, and once the chain runs (the driver barrier
written, the node's GPUs advertised, the ClusterPolicy not yet ``ready``)
the apiserver stops for 6 s while the device plugin's DaemonSet is deleted
from its store. On the same port again, the same operator process, still
holding the Lease under the same epoch, recreates the DaemonSet; its pod
runs, the GPUs come back, the workload barrier passes and the ClusterPolicy
is ``ready`` within the phase's 120 s.
"""

import os
import types

from test_torch_opsan_phase import _node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_22_on_the_cpu(tmp_path, monkeypatch):
    import chip_smoke
    from tpu_operator_torch import consts

    dev = tmp_path / "nvidia0"
    dev.touch()
    monkeypatch.setenv(consts.GPU_DEV_GLOBS_ENV, str(dev))
    numbers = chip_smoke.outage_phase(types.SimpleNamespace(
        repo=REPO, work=str(tmp_path), card="cpu rehearsal", node=_node(tmp_path),
        operator_env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"}))
    assert chip_smoke.OUTAGE_S <= numbers["outage_s"] < chip_smoke.OUTAGE_S + 2.0
    restart = numbers["restart_to_s"]
    assert restart["ds_recreated"] <= restart["plugin_pod_ready"]
    assert restart["capacity_back"] <= restart["ready"]
    assert numbers["operator"]["epoch"] is not None
    assert numbers["operator"]["counters_delta"]["reconcile_errors"] >= 0
    assert numbers["workload_elapsed_s"] > 0
    assert numbers["phase_s"] <= chip_smoke.OUTAGE_BUDGET_S + 10.0
