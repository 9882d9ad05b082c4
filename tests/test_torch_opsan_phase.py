"""``chip_smoke.py`` phase 20 (``opsan_phase``) rehearsed on the CPU.

The smoke's own phase on phase 12's one-node cluster (``join_cluster``:
the chart, a MiniApiServer, the process kubelet), with the validators on
the CPU (``--device=cpu``), the driver installer over a fake bundle and the
node's other operands simulated: the chart's ``gpu-operator`` under the race
sanitizer reaches ``ready``; ``/debug/opsan`` and ``/metrics`` show tracked
accesses and no race; SIGTERM ends it through its shutdown path with one
report; a sanitized fuzz slice adds its own; the gate over both exits 0 in a
process that maps neither torch nor libcuda, and exits 1 over a planted
race, naming it.
"""

import os
import sys
import types

from tpu_operator_torch import consts
from tpu_operator_torch.testing.kubelet import INIT, RUN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _node(tmp_path) -> dict:
    bundle = tmp_path / "bundle"
    bundle.mkdir()
    for name in consts.DRIVER_LIB_FILES:
        (bundle / name).write_bytes(b"\x7fELF" + bytes(60))
    return {"node_name": "gpu-node", "gpu_count": 1,
            "validator": [sys.executable, "-m", "tpu_operator_torch.cmd.validator",
                          "--device=cpu", "--matrix-dim=64"],
            "modes": {"gpu-driver": RUN, "gpu-operator-validator": RUN,
                      "gpu-device-plugin": INIT},
            "driver_env": {consts.DRIVER_SRC_ENV: str(bundle),
                           consts.DRIVER_VERSION_ENV: "580.0"}}


def test_phase_20_on_the_cpu(tmp_path, monkeypatch):
    import chip_smoke

    dev = tmp_path / "nvidia0"
    dev.touch()
    monkeypatch.setenv(consts.GPU_DEV_GLOBS_ENV, str(dev))
    numbers = chip_smoke.opsan_phase(types.SimpleNamespace(
        repo=REPO, work=str(tmp_path), card="cpu rehearsal", node=_node(tmp_path),
        operator_env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        phase12_ready_s=None, join_timeout_s=240))
    assert numbers["join"]["ready_s"] > 0
    live = numbers["live"]
    assert live["metric_accesses"] > 0 and live["metric_races"] == 0
    assert live["tracked_vars"] >= len(chip_smoke.OPSAN_JOIN_TRACKED)
    gate = numbers["gate"]
    assert (gate["rc"], gate["races"], gate["unfixtured"], gate["stale_fixtures"]) == (
        0, 0, [], 0)
    assert gate["dynamic_edges"] >= gate["dynamic_only"] > 0
    assert numbers["planted"] == {"rc": 1, "races": ["smoke.planted"]}
