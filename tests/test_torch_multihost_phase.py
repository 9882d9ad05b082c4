"""``chip_smoke.py`` phase 24 (``multihost_phase``) rehearsed on the CPU.

The smoke's own phase with one gloo rank standing in for the card's GPU:
``workload-multihost`` as a world of one process through a TCP coordinator
on 127.0.0.1 (one device, ``local_chips`` [0], its barrier read as a full
sweep), a world of two whose process 1 never starts (a non-zero exit within
the 5 s rendezvous budget and no barrier), and ``make -f gpu.mk
graft-check`` (the dry run over 8 gloo ranks here).
"""

import os
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_24_on_the_cpu(tmp_path):
    import chip_smoke

    numbers = chip_smoke.multihost_phase(types.SimpleNamespace(
        repo=REPO, card="cpu rehearsal", work=str(tmp_path), device="cpu", n_gpus=1))
    one = numbers["world_of_one"]
    assert (one["n_devices"], one["local_chips"], one["platform"]) == (1, [0], "cpu")
    missing = numbers["missing_worker"]
    assert missing["rc"] == 1 and "timeout" in missing["error"]
    assert missing["s"] < chip_smoke.MULTIHOST_INIT_TIMEOUT_S + 60
    assert numbers["graft_check"]["out"] == ["entry ok: True (512, 512)",
                                             "dryrun_multichip(8) ok"]
