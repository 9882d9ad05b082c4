"""The twin of tests/test_conditions.py: the reference's three cases on the
port's conditions (``tpu_operator_torch/conditions.py``), and the same
sequence through both packages, whose conditions must agree field for
field but for the transition times.

The reference's ``Updater`` (a ``mark_*`` and one ``update_status``, used
nowhere in its operator) is not ported: the port's reconcilers write the
conditions with the rest of the status in one write, as the reference's
do. The cases here make that write themselves.
"""

import pytest

from tpu_operator import conditions as ref_conditions
from tpu_operator.api.clusterpolicy import new_cluster_policy as ref_new_cp
from tpu_operator.client import FakeClient as RefFake
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.conditions import (ERROR, READY, REASON_OPERAND_NOT_READY, get_condition,
                                           mark_error, mark_ready)

CP = ("tpu.ai/v1", "ClusterPolicy", "cluster-policy")


def set_ready(client, obj):
    mark_ready(obj)
    client.update_status(obj)


def set_error(client, obj, reason, message):
    mark_error(obj, reason, message)
    client.update_status(obj)


def test_ready_then_error_transition():
    client = FakeClient()
    set_ready(client, client.create(new_cluster_policy()))
    live = client.get(*CP)
    assert get_condition(live, READY)["status"] == "True"
    assert get_condition(live, ERROR)["status"] == "False"

    set_error(client, live, REASON_OPERAND_NOT_READY, "driver DS not ready")
    live = client.get(*CP)
    ready = get_condition(live, READY)
    assert ready["status"] == "False"
    assert ready["reason"] == REASON_OPERAND_NOT_READY
    assert get_condition(live, ERROR)["message"] == "driver DS not ready"
    assert len(live["status"]["conditions"]) == 2  # one condition per type


def test_last_transition_time_kept_when_status_unchanged():
    client = FakeClient()
    set_ready(client, client.create(new_cluster_policy()))
    first = get_condition(client.get(*CP), READY)["lastTransitionTime"]
    set_ready(client, client.get(*CP))
    assert get_condition(client.get(*CP), READY)["lastTransitionTime"] == first


def test_observed_generation_tracks_spec_revision():
    client = FakeClient()
    set_ready(client, client.create(new_cluster_policy()))
    live = client.get(*CP)
    assert live["status"]["observedGeneration"] == 1
    assert get_condition(live, READY)["observedGeneration"] == 1

    live["spec"]["driver"] = {"enabled": False}  # a generation bump
    client.update(live)
    live = client.get(*CP)
    assert live["metadata"]["generation"] == 2
    assert live["status"]["observedGeneration"] == 1  # the status lags...
    set_ready(client, live)
    assert client.get(*CP)["status"]["observedGeneration"] == 2  # ...until reconciled


def _strip(conditions):
    return [{k: v for k, v in c.items() if k != "lastTransitionTime"} for c in conditions]


@pytest.mark.parametrize("steps", [
    ["ready", "error", "ready"],
    ["error", "error", "bump", "ready"],
    ["ready", "bump", "ready", "error", "error"],
])
def test_both_packages_write_the_same_conditions(steps):
    port, ref = FakeClient(), RefFake()
    port.create(new_cluster_policy())
    ref.create(ref_new_cp())
    for step in steps:
        for client, mod in ((port, None), (ref, ref_conditions)):
            live = client.get(*CP)
            if step == "bump":
                live["spec"]["driver"] = {"enabled": live["metadata"]["generation"] % 2 == 0}
                client.update(live)
                continue
            if step == "ready":
                (mod.mark_ready if mod else mark_ready)(live)
            else:
                (mod.mark_error if mod else mark_error)(live, REASON_OPERAND_NOT_READY,
                                                        "driver DS not ready")
            client.update_status(live)
        mine, theirs = port.get(*CP)["status"], ref.get(*CP)["status"]
        assert _strip(mine["conditions"]) == _strip(theirs["conditions"])
        assert mine.get("observedGeneration") == theirs.get("observedGeneration")
