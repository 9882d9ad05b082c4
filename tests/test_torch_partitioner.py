"""The slice partitioner of the PyTorch port
(tpu_operator_torch/partitioner/partitioner.py) against the reference's
(tpu_operator/partitioner/partitioner.py): twin nodes in twin fake
apiservers, one a v5e TPU host, the other a fake NVML GPU node, driven
through the same passes. Each pass must return the same state and write
the same sequence of state labels; the handoffs must hold the same
partition, blocked GPUs and group sizes, and, on the boards where both
tilers must place the same GPUs, the same GPUs (never the topology
strings, the reference's ``grid`` or ``applied_at``).

Same-set boards: a 4-GPU NVSwitch node beside a 4-chip v5e host, and an
8-GPU node of four PCIe-switch pairs beside a 2x4 v5e host, for 1- and
2-GPU groups. Deliberate differences have tests of their own.

The twin of tests/test_partitioner.py.
"""

import json
import os

import pytest

from tpu_operator import consts as ref_consts
from tpu_operator.health import drain as ref_drain
from tpu_operator.partitioner import partitioner as ref_part
from tpu_operator_torch import consts, nvml
from tpu_operator_torch.health import drain
from tpu_operator_torch.partitioner import partitioner as part
from tpu_operator_torch.testing import fake_nvml
from tpu_operator_torch.validator import main as vmain

V5E = "tpu-v5-lite-podslice"
H100 = "nvidia-h100-80gb"

TABLE = {
    "all-disabled": [],
    "pairs": [{"chips": 2, "count": "all"}],
    "singles": [{"chips": 1, "count": "all"}],
    "pair-then-singles": [{"chips": 2}, {"chips": 1, "count": "all"}],
    "halves": [{"chips": 4}, {"chips": 4}],
    "odd": [{"chips": 3}, {"chips": 3}, {"chips": 3}],
}
#: boards where both tilers place the same GPUs for 1- and 2-GPU groups
SAME_SET_LAYOUTS = ("pairs", "singles", "pair-then-singles")


class Twins:
    """A v5e host and a GPU node side by side; every pass runs on both."""

    def __init__(self, fake_client, tmp_path, n=8, level=fake_nvml.two_sockets, table=TABLE,
                 config=None, state=None, gpus=None):
        self.clients = {"ref": type(fake_client)(), "port": type(fake_client)()}
        self.handoff = {k: str(tmp_path / f"handoff-{k}") for k in self.clients}
        self.status = str(tmp_path / "status")
        self.config = str(tmp_path / "table.json")
        with open(self.config, "w") as f:
            json.dump({"partitions": table}, f)
        gpus = gpus or fake_nvml.random_gpus(n, 7)
        self.nvml = fake_nvml.FakeNvml(gpus, links=fake_nvml.pcie_links(gpus, level)
                                       if level else {})
        self.n = n
        self.labels = {"ref": [], "port": []}
        for side, client in self.clients.items():
            labels = ({ref_consts.TPU_CHIP_COUNT_LABEL: str(n),
                       ref_consts.GKE_TPU_ACCELERATOR_LABEL: V5E} if side == "ref" else
                      {consts.TPU_CHIP_COUNT_LABEL: str(n), consts.TPU_CHIP_TYPE_LABEL: H100})
            if config:
                labels[consts.TPU_SLICE_CONFIG_LABEL] = config
            if state:
                labels[consts.TPU_SLICE_STATE_LABEL] = state
            client.create({"apiVersion": "v1", "kind": "Node",
                           "metadata": {"name": "n1", "labels": labels}, "status": {}})
            self._record(side, client)

    def _record(self, side, client):
        real = client.patch

        def patch(api_version, kind, name, body, namespace=None):
            labels = body.get("metadata", {}).get("labels", {})
            if kind == "Node" and consts.TPU_SLICE_STATE_LABEL in labels:
                self.labels[side].append(labels[consts.TPU_SLICE_STATE_LABEL])
            return real(api_version, kind, name, body, namespace)

        client.patch = patch

    def sync(self, **kw):
        ref = ref_part.sync_once(self.clients["ref"], "n1", self.config, self.handoff["ref"],
                                 status_dir=self.status, **kw)
        port = part.sync_once(self.clients["port"], "n1", self.config, self.handoff["port"],
                              status_dir=self.status, nvml_lib=self.nvml, **kw)
        assert port == ref
        assert self.labels["port"] == self.labels["ref"]
        return port

    def relabel(self, **labels):
        for client in self.clients.values():
            client.patch("v1", "Node", "n1", {"metadata": {"labels": labels}})

    def node_labels(self, side="port"):
        return self.clients[side].get("v1", "Node", "n1")["metadata"]["labels"]

    def handoffs(self, same_sets=False):
        ref = ref_part.read_handoff(self.handoff["ref"])
        port = part.read_handoff(self.handoff["port"])
        assert (ref is None) == (port is None)
        if port is None:
            return None
        assert "grid" not in port
        for key in ("partition", "blocked"):
            assert port.get(key) == ref.get(key)
        key = (lambda g: g["chips"]) if same_sets else (lambda g: len(g["chips"]))
        assert [key(g) for g in port["groups"]] == [key(g) for g in ref["groups"]]
        return port

    def consumer(self, phase="Running", init_only=False):
        for side, client in self.clients.items():
            resource = ref_consts.TPU_RESOURCE_NAME if side == "ref" else \
                consts.GPU_RESOURCE_NAME
            res = {"resources": {"limits": {resource: "4"}}}
            ctr = {"name": "c", "image": "user:1"}
            pod = {"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": "train", "namespace": "ml-team"},
                   "spec": {"nodeName": "n1", "containers": [ctr]}, "status": {"phase": phase}}
            if init_only:
                pod["spec"]["initContainers"] = [{"name": "warm", **res}]
            else:
                ctr.update(res)
            client.create(pod)

    def finish_consumer(self):
        for client in self.clients.values():
            client.delete("v1", "Pod", "train", "ml-team")


def write_barrier(status_dir, passed=True, failed_chips=None, n=8, **extra):
    os.makedirs(status_dir, exist_ok=True)
    payload = {"component": "workload", "passed": passed, "n_devices": n,
               "local_chips": list(range(n)), **extra}
    if failed_chips is not None:
        payload["failed_local_chips"] = list(failed_chips)
    with open(os.path.join(status_dir, "workload-ready"), "w") as f:
        json.dump(payload, f)


BOARDS = {"nvswitch-4": (4, None), "pcie-pairs-8": (8, fake_nvml.two_sockets)}


# -- apply, reapply, clear --------------------------------------------------------

@pytest.mark.parametrize("board", sorted(BOARDS))
@pytest.mark.parametrize("layout", SAME_SET_LAYOUTS)
def test_apply_is_idempotent_and_places_the_same_gpus(fake_client, tmp_path, board, layout):
    n, level = BOARDS[board]
    t = Twins(fake_client, tmp_path, n=n, level=level, config=layout)
    assert t.sync() == "success"
    applied = t.handoffs(same_sets=True)
    assert applied["partition"] == layout and "blocked" not in applied
    assert t.node_labels()[consts.TPU_SLICE_STATE_LABEL] == "success"
    before = os.path.getmtime(os.path.join(t.handoff["port"], part.HANDOFF_FILE))
    assert t.sync() == "success"  # content-identical: no rewrite, no patch
    assert os.path.getmtime(os.path.join(t.handoff["port"], part.HANDOFF_FILE)) == before
    assert t.labels["port"] == ["pending", "success"]


def test_reapply_on_a_config_change_and_clear(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="halves")
    assert t.sync() == "success"
    t.handoffs()
    t.relabel(**{consts.TPU_SLICE_CONFIG_LABEL: "singles"})
    assert t.sync() == "success"
    assert len(t.handoffs(same_sets=True)["groups"]) == 8
    t.relabel(**{consts.TPU_SLICE_CONFIG_LABEL: None})
    assert t.sync() is None
    assert t.handoffs() is None
    assert consts.TPU_SLICE_STATE_LABEL not in t.node_labels()


@pytest.mark.parametrize("config, n", [("nope", 8), ("odd", 8), ("halves", 4)])
def test_an_impossible_or_unknown_partition_fails(fake_client, tmp_path, config, n):
    t = Twins(fake_client, tmp_path, n=n, level=None if n == 4 else fake_nvml.two_sockets,
              config=config)
    assert t.sync() == "failed"
    assert t.handoffs() is None
    assert t.node_labels()[consts.TPU_SLICE_STATE_LABEL] == "failed"


def test_the_gpu_type_label_gates_the_bootstrap(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="pairs")
    t.clients["ref"].patch("v1", "Node", "n1", {"metadata": {"labels": {
        ref_consts.GKE_TPU_ACCELERATOR_LABEL: None}}})
    t.clients["port"].patch("v1", "Node", "n1", {"metadata": {"labels": {
        consts.TPU_CHIP_TYPE_LABEL: None}}})
    assert t.sync() == "pending"
    assert t.handoffs() is None
    t.clients["ref"].patch("v1", "Node", "n1", {"metadata": {"labels": {
        ref_consts.GKE_TPU_ACCELERATOR_LABEL: V5E}}})
    # GKE's own accelerator label serves as well as feature discovery's
    t.clients["port"].patch("v1", "Node", "n1", {"metadata": {"labels": {
        consts.GKE_ACCELERATOR_LABEL: H100}}})
    assert t.sync() == "success"


def test_a_stale_handoff_under_the_same_name_is_recomputed(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="pairs", state="success")
    for handoff in t.handoff.values():
        os.makedirs(handoff)
        with open(os.path.join(handoff, part.HANDOFF_FILE), "w") as f:
            json.dump({"partition": "pairs", "groups": [{"topology": "1x2", "chips": [0, 2]}]}, f)
    assert t.sync() == "success"
    assert [g["chips"] for g in t.handoffs(same_sets=True)["groups"]] == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]


# -- in-use deferral ------------------------------------------------------------------

def test_repartition_waits_for_the_consumer(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="halves")
    assert t.sync() == "success"
    t.consumer()
    t.relabel(**{consts.TPU_SLICE_CONFIG_LABEL: "singles"})
    assert t.sync() == "pending"
    assert t.handoffs()["partition"] == "halves"  # the old layout stays live
    counted = list(t.labels["port"])
    for _ in range(3):  # no redundant PATCH while parked
        assert t.sync() == "pending"
    assert t.labels["port"] == counted
    t.finish_consumer()
    assert t.sync() == "success"
    assert t.handoffs(same_sets=True)["partition"] == "singles"


def test_a_first_partition_waits_for_an_init_only_consumer(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="pairs")
    t.consumer(init_only=True)
    assert t.sync() == "pending"
    assert t.handoffs() is None
    t.finish_consumer()
    assert t.sync() == "success"


def test_unpartition_waits_for_the_consumer(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="pairs")
    assert t.sync() == "success"
    t.consumer()
    t.relabel(**{consts.TPU_SLICE_CONFIG_LABEL: None})
    assert t.sync() == "pending"
    assert t.handoffs() is not None
    t.finish_consumer()
    assert t.sync() is None
    assert t.handoffs() is None


def test_finished_consumers_do_not_defer(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="pairs")
    t.consumer(phase="Succeeded")
    assert t.sync() == "success"


def test_a_lost_success_write_heals_under_a_consumer(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="pairs")
    assert t.sync() == "success"
    t.relabel(**{consts.TPU_SLICE_STATE_LABEL: "pending"})
    t.consumer()
    assert t.sync() == "success"


def test_a_transient_pod_list_failure_defers(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="pairs")
    assert t.sync() == "success"
    t.relabel(**{consts.TPU_SLICE_CONFIG_LABEL: "singles"})
    real = {k: c.list for k, c in t.clients.items()}
    for side, client in t.clients.items():
        def flaky(api_version, kind, *a, _real=real[side], **kw):
            if kind == "Pod":
                raise ConnectionError("apiserver blip")
            return _real(api_version, kind, *a, **kw)
        client.list = flaky
    assert t.sync() == "pending"
    assert t.handoffs()["partition"] == "pairs"
    for side, client in t.clients.items():
        client.list = real[side]
    assert t.sync() == "success"


# -- the table -----------------------------------------------------------------------

def test_a_malformed_table_fails_cleanly(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="anything")
    with open(t.config, "w") as f:
        f.write("partitions: [unclosed")
    assert t.sync() == "failed"


def test_a_block_yaml_table_reads_as_the_reference_reads_it(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text("version: v1\npartitions:\n  all-disabled: []\n  halves:\n"
                    "    - chips: 4\n    - chips: 4\n      topology: numa\n"
                    "  singles:\n    - chips: 1\n      count: all\n")
    assert part.load_config(str(path)) == ref_part.load_config(str(path))


def test_the_default_table_tiles_on_the_boards(tmp_path):
    table = part.load_config(None)
    assert sorted(table) == ["all-disabled", "single-gpu", "two-halves"]
    pcie = part.node_links(fake_nvml.FakeNvml(
        gpus := fake_nvml.random_gpus(8, 1), links=fake_nvml.pcie_links(
            gpus, fake_nvml.two_sockets)))[1]
    for n in (1, 2, 4, 8):
        links = part.node_links(fake_nvml.FakeNvml(fake_nvml.random_gpus(n, n)))[1]
        assert part.compute_partition(table["all-disabled"], links) == []
        assert len(part.compute_partition(table["single-gpu"], links)) == n
    assert [g["chips"] for g in part.compute_partition(table["two-halves"], pcie)] == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]


# -- health-gated re-tiles ---------------------------------------------------------------

@pytest.mark.parametrize("board", sorted(BOARDS))
def test_a_gated_gpu_is_tiled_around_and_recovery_restores(fake_client, tmp_path, board):
    n, level = BOARDS[board]
    t = Twins(fake_client, tmp_path, n=n, level=level, config="singles")
    write_barrier(t.status, passed=False, failed_chips=[2], n=n)
    assert t.sync() == "retiled"
    data = t.handoffs(same_sets=True)
    assert data["blocked"] == [2] and [2] not in [g["chips"] for g in data["groups"]]
    assert t.sync() == "retiled"  # idempotent while degraded
    write_barrier(t.status, passed=True, n=n)
    assert t.sync() == "success"
    data = t.handoffs(same_sets=True)
    assert "blocked" not in data and len(data["groups"]) == n


@pytest.mark.parametrize("board", sorted(BOARDS))
def test_the_incremental_retile_keeps_the_healthy_groups(fake_client, tmp_path, board):
    n, level = BOARDS[board]
    t = Twins(fake_client, tmp_path, n=n, level=level, config="pairs")
    assert t.sync() == "success"
    applied = t.handoffs(same_sets=True)
    write_barrier(t.status, passed=False, failed_chips=[2], n=n)
    assert t.sync() == "retiled"
    data = t.handoffs(same_sets=True)
    assert data["groups"] == [g for g in applied["groups"] if 2 not in g["chips"]]
    write_barrier(t.status, passed=True, n=n)
    assert t.sync() == "success"
    assert t.handoffs(same_sets=True)["groups"] == applied["groups"]


def test_an_impossible_retile_defers_and_recovery_applies(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="halves")
    write_barrier(t.status, passed=False, failed_chips=[2])
    assert t.sync() == "pending"
    assert t.handoffs() is None
    assert t.node_labels()[consts.TPU_SLICE_STATE_LABEL] == "pending"
    write_barrier(t.status, passed=True)
    assert t.sync() == "success"


def test_an_unattributed_failure_keeps_the_configured_layout(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="singles")
    write_barrier(t.status, passed=False)
    assert t.sync() == "success"
    assert len(t.handoffs(same_sets=True)["groups"]) == 8


def test_unknown_cuda_ordinals_keep_the_configured_layout(fake_client, tmp_path, monkeypatch):
    """The plugin's rule: without PCI bus ids and without the CUDA
    driver's order, a barrier's ordinals name no GPU; the plugin gates the
    whole node, so the partitioner treats the failure as unattributed."""
    from tpu_operator_torch import cuda_driver

    gpus = [fake_nvml.FakeGpu(uuid=g.uuid, minor=g.minor, pci_bus_id=None)
            for g in fake_nvml.random_gpus(4, 2)]
    monkeypatch.setitem(cuda_driver._loaded, "lib",
                        fake_nvml.FakeCuda([g.uuid for g in gpus], fail={"cuInit": 100}))
    t = Twins(fake_client, tmp_path, n=4, level=None, config="singles", gpus=gpus)
    write_barrier(t.status, passed=False, failed_chips=[2], n=4)
    state = part.sync_once(t.clients["port"], "n1", t.config, t.handoff["port"],
                           status_dir=t.status, nvml_lib=t.nvml)
    assert state == "success"
    assert len(part.read_handoff(t.handoff["port"])["groups"]) == 4


# -- the coordinated drain -----------------------------------------------------------

def _publish_plan(t, deadline):
    fp = drain.plan_fingerprint("pairs", [2])
    for side, client in t.clients.items():
        plan = (ref_drain if side == "ref" else drain).RetilePlan(
            fingerprint=fp, deadline=deadline, reason="retile", blocked=[2])
        client.patch("v1", "Node", "n1", {"metadata": {"annotations": {
            consts.RETILE_PLAN_ANNOTATION: plan.to_json()}}})
    return fp


def test_a_gated_retile_waits_for_the_drain_ack(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="pairs")
    assert t.sync(drain_deadline_s=60) == "success"
    write_barrier(t.status, passed=False, failed_chips=[2])
    assert t.sync(drain_deadline_s=60) == "pending"  # no plan published yet
    fp = _publish_plan(t, deadline=4e9)
    assert t.sync(drain_deadline_s=60) == "pending"  # the window is open
    assert t.handoffs(same_sets=True).get("blocked") is None
    write_barrier(t.status, passed=False, failed_chips=[2],
                  drain_ack={"plan": fp, "acked_at": 1.0})
    assert t.sync(drain_deadline_s=60) == "retiled"
    assert t.handoffs(same_sets=True)["blocked"] == [2]


def test_a_passed_deadline_forces_the_retile(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="pairs")
    assert t.sync(drain_deadline_s=60) == "success"
    write_barrier(t.status, passed=False, failed_chips=[2])
    _publish_plan(t, deadline=1.0)
    assert t.sync(drain_deadline_s=60) == "retiled"
    assert t.handoffs(same_sets=True)["blocked"] == [2]


# -- where the port reads NVML ---------------------------------------------------------

def test_no_nvml_is_a_failure_never_a_guess(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="pairs")
    t.nvml.fail["nvmlInit_v2"] = 9  # DRIVER_NOT_LOADED
    assert part.sync_once(t.clients["port"], "n1", t.config, t.handoff["port"],
                          status_dir=t.status, nvml_lib=t.nvml) == "failed"
    t.nvml.fail = {"nvmlDeviceGetTopologyCommonAncestor": nvml.NOT_SUPPORTED}
    assert part.sync_once(t.clients["port"], "n1", t.config, t.handoff["port"],
                          status_dir=t.status, nvml_lib=t.nvml) == "failed"
    assert part.read_handoff(t.handoff["port"]) is None


@pytest.mark.parametrize("n, grouped, gated", [(2, "pair", None), (8, "two-halves", None),
                                               (8, "pair", 7)])
@pytest.mark.parametrize("call", ["nvmlDeviceGetP2PStatus",
                                  "nvmlDeviceGetTopologyCommonAncestor"])
def test_a_pair_nvml_cannot_answer_fails_only_the_layouts_that_need_it(
        fake_client, tmp_path, n, grouped, gated, call):
    """One-GPU groups read no pair: they apply on a node whose NVML answers
    no pair. A layout with a multi-GPU group fails, also as a re-tile
    around a gated GPU, where an unplaceable layout would defer."""
    t = Twins(fake_client, tmp_path, n=n, table=dict(part.DEFAULT_PARTITIONS,
                                                      pair=[{"chips": 2}]),
              config="single-gpu")
    t.nvml.fail[call] = nvml.NOT_SUPPORTED
    port = t.clients["port"]

    def sync():
        return part.sync_once(port, "n1", t.config, t.handoff["port"], status_dir=t.status,
                              nvml_lib=t.nvml)

    assert sync() == "success"
    assert part.read_handoff(t.handoff["port"])["groups"] == [
        {"topology": "single", "chips": [i]} for i in range(n)]
    if gated is not None:
        write_barrier(t.status, passed=False, failed_chips=[gated])
    port.patch("v1", "Node", "n1", {"metadata": {"labels": {
        consts.TPU_SLICE_CONFIG_LABEL: grouped}}})
    assert sync() == "failed"
    assert part.read_handoff(t.handoff["port"])["partition"] == "single-gpu"


def test_the_gpu_count_comes_from_the_label_else_nvml(fake_client, tmp_path):
    t = Twins(fake_client, tmp_path, config="singles")
    t.clients["port"].patch("v1", "Node", "n1", {"metadata": {"labels": {
        consts.TPU_CHIP_COUNT_LABEL: None}}})
    assert part.sync_once(t.clients["port"], "n1", t.config, t.handoff["port"],
                          status_dir=t.status, nvml_lib=t.nvml) == "success"
    assert len(part.read_handoff(t.handoff["port"])["groups"]) == 8
    t.clients["port"].patch("v1", "Node", "n1", {"metadata": {"labels": {
        consts.TPU_CHIP_COUNT_LABEL: "4"}}})
    assert part.sync_once(t.clients["port"], "n1", t.config, t.handoff["port"],
                          status_dir=t.status, nvml_lib=t.nvml) == "failed"


def test_four_gpu_groups_are_sockets_not_boxes(fake_client, tmp_path):
    """The deliberate difference, end to end: the reference's handoff
    holds the 2x2 boxes, the port's the two CPU sockets' halves."""
    t = Twins(fake_client, tmp_path, config="halves")
    assert t.sync() == "success"
    t.handoffs()
    ref = ref_part.read_handoff(t.handoff["ref"])
    port = part.read_handoff(t.handoff["port"])
    assert [g["chips"] for g in ref["groups"]] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert ref["grid"] == [2, 4]
    assert port["groups"] == [{"topology": "numa", "chips": [0, 1, 2, 3]},
                              {"topology": "numa", "chips": [4, 5, 6, 7]}]


# -- the component ------------------------------------------------------------------------

def test_run_one_pass(fake_client, tmp_path, monkeypatch):
    t = Twins(fake_client, tmp_path, config="pairs")
    monkeypatch.setenv("NODE_NAME", "n1")
    assert part.run(t.clients["port"], t.config, handoff_dir=t.handoff["port"], iterations=1,
                    status_dir=t.status, nvml_lib=t.nvml) == 0
    assert part.read_handoff(t.handoff["port"])["partition"] == "pairs"
    monkeypatch.delenv("NODE_NAME")
    assert part.run(t.clients["port"], t.config, iterations=1, nvml_lib=t.nvml) == 1


def test_the_cli_component_applies_the_default_table(fake_client, tmp_path, monkeypatch):
    """``-c slice-partitioner`` with no ``--config`` reads the port's own
    table; its loop is stopped by a ``time.sleep`` that raises."""
    t = Twins(fake_client, tmp_path, n=4, level=None, config="single-gpu")
    monkeypatch.setattr(nvml, "_loaded", {"lib": t.nvml})
    monkeypatch.setenv("NODE_NAME", "n1")
    monkeypatch.delenv(consts.PARTITION_CONFIG_ENV, raising=False)

    class Stop(Exception):
        pass

    def stop(_):
        raise Stop

    monkeypatch.setattr(part.time, "sleep", stop)
    with pytest.raises(Stop):
        vmain.run(["-c", "slice-partitioner", f"--handoff-dir={t.handoff['port']}",
                   f"--status-dir={t.status}"], client=t.clients["port"])
    assert part.read_handoff(t.handoff["port"])["groups"] == [
        {"topology": "single", "chips": [i]} for i in range(4)]
    assert t.node_labels()[consts.TPU_SLICE_STATE_LABEL] == "success"


def test_consumers_are_counted_over_http_as_in_the_fake(fake_client):
    """The consumer check through the port's own client: pods of every
    namespace, those on this node that hold a GPU and have not finished."""
    from tpu_operator.testing import MiniApiServer
    from tpu_operator_torch.client import ApiClient

    pods = [("train", "ml", "n1", "Running", consts.GPU_RESOURCE_NAME),
            ("infer", "serve", "n1", "Pending", consts.GPU_RESOURCE_NAME),
            ("done", "ml", "n1", "Succeeded", consts.GPU_RESOURCE_NAME),
            ("cpu", "ml", "n1", "Running", "cpu"),
            ("elsewhere", "ml", "n2", "Running", consts.GPU_RESOURCE_NAME)]
    srv = MiniApiServer()
    base = srv.start()
    try:
        for backend in (srv.backend, fake_client):
            for name, ns, node, phase, resource in pods:
                backend.create({"apiVersion": "v1", "kind": "Pod",
                                "metadata": {"name": name, "namespace": ns},
                                "spec": {"nodeName": node, "containers": [{
                                    "name": "c", "resources": {"requests": {resource: "1"}}}]},
                                "status": {"phase": phase}})
        assert part.gpu_consumers_on(ApiClient(base), "n1") == 2
        assert part.gpu_consumers_on(fake_client, "n1") == 2
        assert part.gpu_consumers_on(ApiClient(base), "n3") == 0
    finally:
        srv.stop()


def test_the_journal_hook_records_the_reference_s_decisions(fake_client, tmp_path):
    """With a decision journal wired in, a plain apply opens and closes its
    own episode, and a re-tile chains onto the episode the node is stamped
    with (the health machine's): the same canonical records, ids included,
    as the reference's hook writes."""
    from tpu_operator.provenance import DecisionJournal as RefJournal
    from tpu_operator_torch.provenance import DecisionJournal

    t = Twins(fake_client, tmp_path, config="pairs")
    journals = {"ref": RefJournal(now=lambda: 1000.0), "port": DecisionJournal(now=lambda: 1000.0)}

    def sync():
        ref = ref_part.sync_once(t.clients["ref"], "n1", t.config, t.handoff["ref"],
                                 status_dir=t.status, journal=journals["ref"])
        port = part.sync_once(t.clients["port"], "n1", t.config, t.handoff["port"],
                              status_dir=t.status, nvml_lib=t.nvml, journal=journals["port"])
        assert port == ref
        return port

    assert sync() == "success"
    assert sync() == "success"  # already applied: no second record
    for client in t.clients.values():
        client.patch("v1", "Node", "n1", {"metadata": {"annotations": {
            consts.PROVENANCE_EPISODE_ANNOTATION: "ep-health"}}})
    write_barrier(t.status, passed=False, failed_chips=[2])
    assert sync() == "retiled"
    port = journals["port"].canonical_export()
    assert port == journals["ref"].canonical_export()
    by_kind = {r["kind"]: r for r in port}
    assert sorted(by_kind) == ["partition-apply", "re-tile"]
    assert by_kind["partition-apply"]["outcome"] == "applied"
    assert by_kind["re-tile"]["outcome"] is None
    assert by_kind["re-tile"]["episode"] == "ep-health"
