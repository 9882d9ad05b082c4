"""``chip_smoke.py`` phase 17 rehearsed on the CPU.

The smoke's own ``simulator_phase`` with the engine's default curve (the
card's frontier the engine carries) and a fuzz budget of 2: the five
committed cases through ``gpu-sim run --double-run --json`` in fresh
processes that must map neither torch nor libcuda, the same cases in this
process with their canonical logs equal to the processes', the fuzz sweep
double-run, and the traffic mix twice over a one-GPU handoff as phase 11
leaves it on the card. Then step 1's read of the card's node.
"""

import os
import types

import pytest

from tpu_operator_torch import consts
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.serving import frontier as frontier_schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: phase 11's last handoff on a one-GPU card: ``single-gpu`` applied
HANDOFF = {"partition": "single-gpu", "groups": [{"topology": "single", "chips": [0]}],
           "applied_at": 1760000000.0}


def test_phase_17_on_the_cpu(tmp_path):
    import chip_smoke

    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "SCENARIO_SEED") and not k.startswith("GPU_")}
    ctx = types.SimpleNamespace(repo=REPO, operator_env=env, work=str(tmp_path), card="cpu")
    numbers = chip_smoke.simulator_phase(ctx, None, HANDOFF, budget=2)
    assert numbers["curve"]["measured"] is False and numbers["curve"]["tokens_per_gpu"] > 0
    assert sorted(numbers["cases"]) == ["az-loss-mid-drain", "brownout-mid-migration",
                                        "frontier-drift-mid-scale-up", "herd-join-mid-upgrade",
                                        "revocation-wave-mid-scale-up"]
    for case in numbers["cases"].values():
        assert case["ok"] and case["settled_at_tick"] is not None
        assert case["reconcile_errors"] == 0
    assert len(numbers["fuzz"]["verdicts"]) == 2
    assert all(v.endswith(": ok") for v in numbers["fuzz"]["verdicts"])
    traffic = numbers["traffic"]
    assert traffic["slices"] == [{"capacity": 1, "blocked": False}]
    assert traffic["arrivals"] == traffic["completed"] + traffic["incomplete"] > 0
    assert not os.path.exists(os.path.join(tmp_path, "sim-bundles"))


def test_phase_17_reads_the_curve_phase_16_checked():
    import chip_smoke

    points = [[1, 0.0612, 21011.5], [4, 0.0592, 84627.6], [8, 0.0533, 172108.0]]
    backend = FakeClient(objects=[{"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "runsc", "annotations": {
            consts.SERVING_FRONTIER_ANNOTATION: frontier_schema.encode_annotation(
                frontier_schema.Frontier(points=[frontier_schema.FrontierPoint(b, p, t, 32)
                                                 for b, p, t in points]))}}}])
    ctx = types.SimpleNamespace(srv=types.SimpleNamespace(backend=backend), node_name="runsc")
    assert chip_smoke.card_curve(ctx, points) == points
    with pytest.raises(SystemExit):
        chip_smoke.card_curve(ctx, points[:2])
