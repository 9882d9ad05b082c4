"""The twin of tests/test_predicates.py: the node-watch predicate of the
port (``tpu_operator_torch/controllers/predicates.py``) and its wiring into
the ClusterPolicy controller. A kubelet's status heartbeat triggers no
sweep; a meaningful transition triggers one. The reference's cases, with
the port's presence label and resource, and one seeded stream of node
events through both packages' filters, which must pass the same events.
"""

import numpy as np
import pytest

from tpu_operator.client.interface import WatchEvent as RefWatchEvent
from tpu_operator.controllers.predicates import NodeChangeFilter as RefFilter
from tpu_operator_torch.client import FakeClient

from tpu_operator_torch import consts
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.client.interface import WatchEvent
from tpu_operator_torch.controllers.clusterpolicy_controller import (
    ClusterPolicyReconciler,
    setup_clusterpolicy_controller,
)
from tpu_operator_torch.controllers.predicates import NodeChangeFilter


def mk_node(name="n1", labels=None, heartbeat="t0"):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels or {}},
            "spec": {},
            "status": {"conditions": [
                {"type": "Ready", "status": "True",
                 "lastHeartbeatTime": heartbeat}]}}


class TestNodeChangeFilter:
    def test_first_sight_is_significant(self):
        f = NodeChangeFilter()
        assert f.significant(WatchEvent("ADDED", mk_node()))

    def test_heartbeat_only_update_is_insignificant(self):
        f = NodeChangeFilter()
        f.significant(WatchEvent("ADDED", mk_node(heartbeat="t0")))
        assert not f.significant(
            WatchEvent("MODIFIED", mk_node(heartbeat="t1")))
        assert not f.significant(
            WatchEvent("MODIFIED", mk_node(heartbeat="t2")))

    def test_label_flip_is_significant_once(self):
        f = NodeChangeFilter()
        f.significant(WatchEvent("ADDED", mk_node()))
        labeled = mk_node(labels={consts.GPU_PRESENT_LABEL: "true"})
        assert f.significant(WatchEvent("MODIFIED", labeled))
        # replaying the same state (watch dedup/resync) is insignificant
        assert not f.significant(WatchEvent("MODIFIED", labeled))

    def test_capacity_change_is_significant(self):
        f = NodeChangeFilter()
        f.significant(WatchEvent("ADDED", mk_node()))
        node = mk_node()
        node["status"]["capacity"] = {consts.GPU_RESOURCE_NAME: "4"}
        assert f.significant(WatchEvent("MODIFIED", node))

    def test_cordon_is_significant(self):
        f = NodeChangeFilter()
        f.significant(WatchEvent("ADDED", mk_node()))
        node = mk_node()
        node["spec"]["unschedulable"] = True
        assert f.significant(WatchEvent("MODIFIED", node))

    def test_delete_is_significant_and_forgets(self):
        f = NodeChangeFilter()
        node = mk_node()
        f.significant(WatchEvent("ADDED", node))
        assert f.significant(WatchEvent("DELETED", node))
        # re-add after delete is a fresh node again
        assert f.significant(WatchEvent("ADDED", node))

    def test_relist_resync_replay_is_insignificant(self):
        f = NodeChangeFilter()
        node = mk_node()
        f.significant(WatchEvent("ADDED", node))
        assert not f.significant(WatchEvent("ADDED", node))


class TestControllerWiring:
    """The wired mapper: status-only node update enqueues nothing; a label
    flip enqueues exactly one request (one policy)."""

    @pytest.fixture
    def fake_client(self):
        return FakeClient()

    def _mapper(self, fake_client):
        fake_client.create(new_cluster_policy())
        controller = setup_clusterpolicy_controller(
            fake_client, ClusterPolicyReconciler(fake_client))
        for spec in controller.watch_specs:
            if spec.kind == "Node":
                return spec.mapper
        raise AssertionError("no Node watch registered")

    def test_status_only_update_enqueues_nothing(self, fake_client):
        mapper = self._mapper(fake_client)
        mapper(WatchEvent("ADDED", mk_node(heartbeat="t0")))  # prime
        reqs = mapper(WatchEvent("MODIFIED", mk_node(heartbeat="t1")))
        assert reqs == []

    def test_label_flip_enqueues_exactly_one_request(self, fake_client):
        mapper = self._mapper(fake_client)
        mapper(WatchEvent("ADDED", mk_node()))  # prime
        labeled = mk_node(labels={consts.GPU_PRESENT_LABEL: "true"})
        reqs = mapper(WatchEvent("MODIFIED", labeled))
        assert len(reqs) == 1
        assert reqs[0].name == "cluster-policy"


@pytest.mark.parametrize("seed", range(4))
def test_both_packages_filters_pass_the_same_events(seed):
    """Heartbeats, label flips, capacity, cordons, deletes and replays over
    a few nodes, drawn from a seed: the same verdict, event by event."""
    rng = np.random.default_rng(seed)
    port, ref = NodeChangeFilter(), RefFilter()
    state = {}
    for i in range(200):
        name = f"n{int(rng.integers(0, 4))}"
        node = state.get(name) or mk_node(name)
        roll = rng.random()
        kind = "MODIFIED" if name in state else "ADDED"
        if roll < 0.4:
            node = mk_node(name, node["metadata"]["labels"], heartbeat=f"t{i}")
        elif roll < 0.55:
            node = mk_node(name, {"flip": str(int(rng.integers(0, 2)))})
        elif roll < 0.65:
            node["status"]["capacity"] = {"nvidia.com/gpu": str(int(rng.integers(0, 9)))}
        elif roll < 0.75:
            node["spec"]["unschedulable"] = bool(rng.integers(0, 2))
        elif roll < 0.85 and name in state:
            kind = "DELETED"
        verdicts = (port.significant(WatchEvent(kind, node)),
                    ref.significant(RefWatchEvent(kind, node)))
        assert verdicts[0] == verdicts[1], (i, kind, node)
        if kind == "DELETED":
            state.pop(name, None)
        else:
            state[name] = node
