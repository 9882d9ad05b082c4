"""The port's device plugin against the reference's, on the same barriers,
handoff files and a fake /dev tree (the port's GPUs from a fake NVML).

Units compare by position, ``tpu-i`` with ``gpu-i``: after every step of
the reference tests' barrier scenarios both plugins must report the same
change and the same health per unit, and push the same ListAndWatch
snapshots. Allocate compares field by mapped field, with the recorded
difference asserted (the port hands over only the allocated GPUs' device
nodes, and library files instead of a directory). Over the wire, the
reference's gRPC stubs drive the port's server.

The twin of tests/test_deviceplugin.py.
"""

import os
import queue
from concurrent import futures

import grpc
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_operator.deviceplugin import grpc_api as ref_grpc_api
from tpu_operator.deviceplugin import plugin as ref_plugin
from tpu_operator.deviceplugin.proto import deviceplugin_pb2 as ref_pb
from tpu_operator.partitioner.partitioner import write_handoff
from tpu_operator.validator.status import StatusFiles
from tpu_operator_torch import consts, cuda_driver, nvml
from tpu_operator_torch.deviceplugin import plugin as port_plugin
from tpu_operator_torch.ranks import run_ranks
from tpu_operator_torch.testing.fake_nvml import FakeCuda, FakeNvml, random_gpus
from tpu_operator_torch.utils import pin_device_order
from tpu_operator_torch.validator import main as vmain

SEED = 20261017
N_GPUS = 4
CALL_TIMEOUT_S = 10


class Node:
    """One fake node both plugins see: ``N_GPUS`` accelerator files for the
    reference, the GPUs' own device nodes (by minor number), a node of a GPU
    that is not this node's, and the control nodes for the port."""

    def __init__(self, tmp_path, monkeypatch, seed=SEED, n=N_GPUS):
        self.tmp = tmp_path
        self.dev = tmp_path / "dev"
        self.dev.mkdir()
        for i in range(n):
            (self.dev / f"accel{i}").touch()
        monkeypatch.setenv("TPU_DEV_GLOBS", str(self.dev / "accel*"))
        self.fake = FakeNvml(random_gpus(n, seed))
        for g in self.fake.gpus:
            (self.dev / f"nvidia{g.minor}").touch()
        (self.dev / "nvidia15").touch()  # another GPU's node, visible here too
        for name in ("nvidiactl", "nvidia-uvm"):
            (self.dev / name).touch()
        self.libs = tmp_path / "lib"
        self.libs.mkdir()
        (self.libs / "libcuda.so.580.1.2").write_bytes(b"\x7fELF")
        os.symlink("libcuda.so.580.1.2", self.libs / "libcuda.so.1")
        (self.libs / "libnvidia-ml.so.1").write_bytes(b"\x7fELF")
        (self.libs / "libc.so.6").write_bytes(b"\x7fELF")
        self.libtpu = tmp_path / "libtpu"
        self.status = StatusFiles(str(tmp_path / "validations"))
        self.handoff = str(tmp_path / "handoff")

    @property
    def pci_order(self):
        return sorted(self.fake.gpus, key=lambda g: g.pci_bus_id)

    def plugins(self, grace=0.0):
        ref = ref_plugin.TPUDevicePlugin(
            plugin_dir=str(self.tmp / "ref-kubelet"), libtpu_dir=str(self.libtpu),
            handoff_dir=self.handoff, status_dir=self.status.directory,
            absence_grace_s=grace)
        port = port_plugin.GPUDevicePlugin(
            plugin_dir=str(self.tmp / "kubelet"), install_dir=str(self.libs),
            handoff_dir=self.handoff, status_dir=self.status.directory,
            absence_grace_s=grace, dev_dir=str(self.dev), nvml_lib=self.fake)
        return ref, port

    def corrupt(self, text):
        os.makedirs(self.status.directory, exist_ok=True)
        with open(self.status.path("workload"), "w") as f:
            f.write(text)


@pytest.fixture
def node(tmp_path, monkeypatch):
    for env in (consts.USE_CDI_ENV, consts.PLUGIN_DEVICE_INJECTION_ENV, "TPU_USE_CDI",
                "TPU_PLUGIN_DEVICE_INJECTION"):
        monkeypatch.delenv(env, raising=False)
    return Node(tmp_path, monkeypatch)


def _mapped(units):
    return [(u.id.replace("tpu-", "gpu-"), u.health) for u in units]


def _fail(chips, check="compute"):
    """A full-host sweep's barrier failing ``chips`` in one check."""
    return {"passed": False, "n_devices": N_GPUS, "local_chips": list(range(N_GPUS)),
            "failed_local_chips": chips,
            "details": {check: {"passed": False, "failed_chips": chips}}}


def _churn():
    steps = []
    for i in range(32):
        if i % 2:
            steps.append(("pass", {"passed": True, "n_devices": 4, "local_chips": [0, 1, 2, 3],
                                   "failed_local_chips": []}))
        else:
            steps.append(("fail", _fail([(i // 2) % 4], check="ring")))
    return steps


#: the reference tests' barrier scenarios, as step lists: ("barrier",
#: payload) writes it, ("clear",) removes it, ("raw", text) writes bytes,
#: ("handoff", groups) publishes a partition, ("lose",) loses the last GPU
SCENARIOS = {
    "bootstrap-pass-clear-restore": [("barrier", {"passed": True}), ("clear",),
                                     ("barrier", {"passed": True})],
    "failed-record": [("barrier", {"passed": False}), ("barrier", {"passed": True})],
    "per-gpu-fail-then-pass": [("barrier", _fail([3])),
                               ("barrier", {"passed": True, "n_devices": 4,
                                            "local_chips": [0, 1, 2, 3]})],
    "legacy-identity-map": [("barrier", {"passed": False, "n_devices": 4, "details": {
        "compute": {"passed": False, "failed_chips": [1]}}})],
    "unattributable": [("barrier", {"passed": False, "n_devices": 16, "details": {
        "psum": {"passed": False, "failed_chips": [9]}}}),
        ("barrier", {"passed": False, "details": {"error": "rendezvous timed out"}})],
    "remote-failure": [("barrier", {"passed": False, "n_devices": 16, "local_chips": [4, 5, 6, 7],
                                    "details": {"ring": {"passed": False, "failed_chips": [12]}}}),
                       ("barrier", {"passed": False, "n_devices": 16, "local_chips": [4, 5, 6, 7],
                                    "details": {"ring": {"passed": False, "failed_chips": [6]}}})],
    "malformed-attribution": [("barrier", {"passed": False, "n_devices": 4, "details": {
        "compute": {"passed": False, "failed_chips": bad}}}) for bad in (["x"], "3", 7, [None])],
    "subset-sweep-fail": [("barrier", {"passed": False, "n_devices": 3, "local_chips": [0, 1, 2],
                                       "details": {"compute": {"passed": False,
                                                               "failed_chips": [2]}}})],
    "partial-pass-carries-forward": [
        ("barrier", _fail([3])),
        ("barrier", {"passed": True, "n_devices": 3, "local_chips": [0, 1, 2]}),
        ("barrier", {"passed": True, "n_devices": 4, "local_chips": [0, 1, 2, 3]})],
    "corrupt-and-non-dict": [("raw", "{not json"), ("barrier", {"passed": True}),
                             ("raw", "[1, 2]"), ("clear",)],
    "partition-groups": [("handoff", [{"topology": "1x2", "chips": [0, 1]},
                                      {"topology": "1x2", "chips": [2, 3]}]),
                         ("barrier", {"passed": False, "n_devices": 4,
                                      "local_chips": [0, 1, 2, 3],
                                      "details": {"ring": {"passed": False,
                                                           "failed_chips": [3]}}})],
    "partition-change": [("handoff", [{"topology": "2x2", "chips": [0, 1, 2, 3]},
                                      {"topology": "2x2", "chips": [4, 5, 6, 7]}])],
    "gpu-loss": [("lose",)],
    "health-churn": [("barrier", payload) for _, payload in _churn()]
    + [("barrier", _fail([1], check="ring"))],
}


def _apply(node, step):
    kind = step[0]
    if kind == "barrier":
        node.status.write("workload", step[1])
    elif kind == "clear":
        node.status.clear("workload")
    elif kind == "raw":
        node.corrupt(step[1])
    elif kind == "handoff":
        write_handoff(step[1], "p", node.handoff)
    elif kind == "lose":
        last = max(node.fake.gpus, key=lambda g: g.pci_bus_id)
        node.fake.gpus.remove(last)
        (node.dev / f"accel{N_GPUS - 1}").unlink()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_health_sequence_matches_reference(node, scenario):
    """After every step both plugins report the same change and the same
    per-unit health, and push the same ListAndWatch snapshots."""
    ref, port = node.plugins()
    pushed = {"ref": queue.Queue(), "port": queue.Queue()}
    ref._watchers.append(pushed["ref"])
    port._watchers.append(pushed["port"])
    for step in [("bootstrap",)] + SCENARIOS[scenario]:
        _apply(node, step)
        changed = (ref.refresh_units(), port.refresh_units())
        assert changed[0] == changed[1], step
        assert _mapped(ref._snapshot()) == _mapped(port._snapshot()), step
    snapshots = {k: [] for k in pushed}
    for k, q in pushed.items():
        while not q.empty():
            snapshots[k].append(_mapped(q.get_nowait()))
    assert snapshots["port"] == snapshots["ref"]
    assert len(snapshots["port"]) >= 1
    assert node.fake.open_sessions == 0


def test_absence_grace_window_matches_reference(node):
    ref, port = node.plugins(grace=60.0)
    for step in (("barrier", {"passed": True}), ("clear",), ("barrier", {"passed": True})):
        _apply(node, step)
        assert ref._validation_health()[0] == port._validation_health()[0] == "Healthy"
    assert ref._workload_gone_at is None and port._workload_gone_at is None


def test_units_are_gpus_in_pci_order(node):
    """One unit per GPU, ``gpu-<i>`` the i-th in PCI order: not NVML's
    index order, not minor-number order."""
    gpus = nvml.gpus(node.fake)
    assert [g.pci_bus_id for g in gpus] == sorted(g.pci_bus_id for g in node.fake.gpus)
    assert [g.index for g in gpus] != list(range(N_GPUS))  # the fake lists off PCI order
    assert [g.minor for g in gpus] != sorted(g.minor for g in gpus)
    units = port_plugin.discover_units(node.handoff, gpus=gpus)
    assert [(u.id, u.chips) for u in units] == [(f"gpu-{i}", [i]) for i in range(N_GPUS)]


@pytest.fixture
def no_order(monkeypatch):
    """This process without a CUDA device order, restored after the test."""
    monkeypatch.setenv(consts.CUDA_DEVICE_ORDER_ENV, "restored after the test")
    monkeypatch.delenv(consts.CUDA_DEVICE_ORDER_ENV)


def test_a_bus_id_nvml_cannot_give_keeps_nvml_order(node, monkeypatch, no_order):
    """Where NVML does not support the PCI query (as on some virtual
    machines), the bus id is None, as nvidia-smi prints N/A. With the CUDA
    driver unable to tell the order either, the GPUs keep NVML's index
    order and no CUDA ordinal; one GPU is ordinal 0 without asking the
    driver. Any other NVML error raises."""
    cuda = FakeCuda([g.uuid for g in node.pci_order], fail={"cuInit": 100})
    monkeypatch.setitem(cuda_driver._loaded, "lib", cuda)
    node.fake.gpus[1].pci_bus_id = None
    gpus = nvml.gpus(node.fake)
    assert [g.index for g in gpus] == list(range(N_GPUS)) and gpus[1].pci_bus_id is None
    assert [g.cuda_ordinal for g in gpus] == [None] * N_GPUS and cuda.calls == 1
    one = FakeNvml(node.fake.gpus[1:2])
    assert [(g.uuid, g.cuda_ordinal) for g in nvml.gpus(one)] == [(node.fake.gpus[1].uuid, 0)]
    assert cuda.calls == 1
    node.fake.fail["nvmlDeviceGetPciInfo_v3"] = 15  # NVML_ERROR_GPU_IS_LOST
    node.fake.gpus[1].pci_bus_id = "00000000:01:00.0"
    with pytest.raises(nvml.NvmlError, match="GPU_IS_LOST"):
        nvml.gpus(node.fake)
    assert node.fake.open_sessions == 0


def test_without_bus_ids_the_cuda_driver_orders_the_units(node, monkeypatch, no_order):
    """No bus ids from NVML, and NVML's index order is not CUDA's: the CUDA
    driver names each ordinal's UUID under ``CUDA_DEVICE_ORDER=PCI_BUS_ID``,
    so a barrier failing local GPU 1 still gates the unit whose device node
    is CUDA ordinal 1's minor."""
    cuda_order = node.pci_order
    assert [g.uuid for g in node.fake.gpus] != [g.uuid for g in cuda_order]
    for g in node.fake.gpus:
        g.pci_bus_id = None
    monkeypatch.setitem(cuda_driver._loaded, "lib", FakeCuda([g.uuid for g in cuda_order]))
    gpus = nvml.gpus(node.fake)
    assert [(g.uuid, g.cuda_ordinal) for g in gpus] == [
        (g.uuid, i) for i, g in enumerate(cuda_order)]
    assert os.environ[consts.CUDA_DEVICE_ORDER_ENV] == "PCI_BUS_ID"
    _, port = node.plugins()
    node.status.write("workload", _fail([1]))
    port.refresh_units()
    assert [u.id for u in port._snapshot() if u.health == "Unhealthy"] == ["gpu-1"]
    plan = port.allocation_plan(["gpu-1"])
    assert plan.envs["CUDA_VISIBLE_DEVICES"] == cuda_order[1].uuid
    assert plan.devices[0][1] == str(node.dev / f"nvidia{cuda_order[1].minor}")


@pytest.mark.parametrize("why", ["driver-error", "other-gpus", "other-order"])
def test_unknown_cuda_ordinals_gate_the_whole_node(node, monkeypatch, no_order, why):
    """No bus ids, and the CUDA driver cannot tell the order (it fails, it
    names other GPUs, or this process chose another order): which unit is
    the failing ordinal is unknown, so a per-GPU failure gates every unit,
    and a pass restores them."""
    uuids = [g.uuid for g in node.pci_order]
    cuda = {"driver-error": FakeCuda(uuids, fail={"cuDeviceGetUuid_v2": 999}),
            "other-gpus": FakeCuda(uuids[:-1]),
            "other-order": FakeCuda(uuids)}[why]
    if why == "other-order":
        monkeypatch.setenv(consts.CUDA_DEVICE_ORDER_ENV, "FASTEST_FIRST")
    monkeypatch.setitem(cuda_driver._loaded, "lib", cuda)
    for g in node.fake.gpus:
        g.pci_bus_id = None
    _, port = node.plugins()
    node.status.write("workload", _fail([1]))
    port.refresh_units()
    assert [u.health for u in port._snapshot()] == ["Unhealthy"] * N_GPUS
    assert all(g.cuda_ordinal is None for g in port._gpus)
    node.status.write("workload", {"passed": True, "n_devices": N_GPUS,
                                   "local_chips": list(range(N_GPUS)), "failed_local_chips": []})
    assert port.refresh_units()
    assert [u.health for u in port._snapshot()] == ["Healthy"] * N_GPUS


def _sweep_device_order(rank, n, device, t0):
    """A rank's view of CUDA's device order (a worker target)."""
    return os.environ.get(consts.CUDA_DEVICE_ORDER_ENV)


def test_a_failing_gpu_gates_its_own_device_node(node, monkeypatch):
    """The fault this pins: the sweep's ordinals are CUDA's, and CUDA's
    default order (fastest first) is bound neither to minor numbers nor to
    PCI order. Every sweep process runs with ``CUDA_DEVICE_ORDER=PCI_BUS_ID``,
    so ordinal 1 is the second GPU in PCI order, and a barrier failing local
    GPU 1 gates the unit whose device node is that GPU's minor."""
    monkeypatch.setenv(consts.CUDA_DEVICE_ORDER_ENV, "restored after the test")
    monkeypatch.delenv(consts.CUDA_DEVICE_ORDER_ENV)
    rng = np.random.default_rng(SEED)
    pci = node.pci_order
    fastest_first = [pci[i] for i in rng.permutation(N_GPUS)]
    if fastest_first[1] is pci[1]:
        fastest_first[1], fastest_first[2] = fastest_first[2], fastest_first[1]
    # the order the sweep's workers run with, spawned as the sweep spawns them
    orders = run_ranks(_sweep_device_order, 2, "cpu", timeout_s=120)
    assert orders == ["PCI_BUS_ID", "PCI_BUS_ID"]
    cuda_order = pci if orders[0] == "PCI_BUS_ID" else fastest_first
    failing = cuda_order[1]

    _, port = node.plugins()
    node.status.write("workload", _fail([1], check="compute"))
    port.refresh_units()
    gated = [u.id for u in port._snapshot() if u.health == "Unhealthy"]
    assert gated == ["gpu-1"]
    plan = port.allocation_plan(gated)
    assert plan.envs["CUDA_VISIBLE_DEVICES"] == failing.uuid
    assert plan.devices[0][1] == str(node.dev / f"nvidia{failing.minor}")
    # what the pin prevents: in the fast-first order ordinal 1 is another GPU
    assert fastest_first[1] is not failing and fastest_first[1].minor != failing.minor


def test_every_sweep_process_pins_the_device_order(tmp_path, monkeypatch):
    """The CLI process, the revalidation subprocess and the spawned pod all
    run with PCI order unless the caller chose one."""
    monkeypatch.setenv(consts.CUDA_DEVICE_ORDER_ENV, "restored after the test")
    monkeypatch.delenv(consts.CUDA_DEVICE_ORDER_ENV)
    seen = []
    monkeypatch.setattr(vmain.subprocess, "run", lambda argv, **kw: seen.append(kw["env"]) or
                        type("R", (), {"stdout": "", "stderr": ""})())
    assert vmain.revalidate_local(vmain.StatusFiles(str(tmp_path)), 64, device="cpu") is None
    assert seen[0][consts.CUDA_DEVICE_ORDER_ENV] == "PCI_BUS_ID"
    monkeypatch.delenv(consts.CUDA_DEVICE_ORDER_ENV, raising=False)
    assert vmain.run(["-c", "wait", "--for=none", "--timeout=0",
                      f"--status-dir={tmp_path}"]) == 1
    assert os.environ[consts.CUDA_DEVICE_ORDER_ENV] == "PCI_BUS_ID"
    assert pin_device_order({consts.CUDA_DEVICE_ORDER_ENV: "FASTEST_FIRST"}) == {
        consts.CUDA_DEVICE_ORDER_ENV: "FASTEST_FIRST"}


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_prefer_compact_matches_reference(data):
    n = data.draw(st.integers(2, 8), label="units")
    available = data.draw(st.lists(st.integers(0, n - 1), min_size=1, max_size=n, unique=True))
    must = data.draw(st.lists(st.sampled_from(available), max_size=len(available), unique=True))
    size = data.draw(st.integers(1, len(available)))
    grid = data.draw(st.sampled_from([None] + ([(2, n // 2)] if n % 2 == 0 else [])))
    picks = {}
    for prefix, fn in (("tpu", ref_plugin.prefer_compact), ("gpu", port_plugin.prefer_compact)):
        chips_of = {f"{prefix}-{i}": [i] for i in range(n)}
        picks[prefix] = fn([f"{prefix}-{i}" for i in available], [f"{prefix}-{i}" for i in must],
                           size, chips_of, grid)
    assert [p.replace("tpu-", "gpu-") for p in picks["tpu"]] == picks["gpu"]


class _Context:
    def abort(self, code, details):
        raise RuntimeError(code, details)


def _ref_allocate(ref, ids):
    resp = ref.Allocate(ref_pb.AllocateRequest(container_requests=[
        ref_pb.ContainerAllocateRequest(devicesIDs=[i.replace("gpu-", "tpu-") for i in ids])]),
        _Context())
    return resp.container_responses[0]


@pytest.mark.parametrize("mode", ["devices", "mounts", "cdi", "partition"])
def test_allocate_matches_reference_field_by_field(node, monkeypatch, mode):
    node.libtpu.mkdir()
    if mode == "partition":
        write_handoff([{"topology": "2x1", "chips": [0, 1]}, {"topology": "2x1", "chips": [2, 3]}],
                      "pair", node.handoff)
    if mode == "mounts":
        monkeypatch.setenv("TPU_PLUGIN_DEVICE_INJECTION", "mounts")
        monkeypatch.setenv(consts.PLUGIN_DEVICE_INJECTION_ENV, "mounts")
    if mode == "cdi":
        monkeypatch.setenv("TPU_USE_CDI", "1")
        monkeypatch.setenv(consts.USE_CDI_ENV, "1")
    ref, port = node.plugins()
    ref.refresh_units()
    port.refresh_units()
    ids = ["gpu-part-1"] if mode == "partition" else ["gpu-1", "gpu-3"]
    chips = [2, 3] if mode == "partition" else [1, 3]
    want = _ref_allocate(ref, ids)
    plan = port.allocation_plan(ids)
    if mode == "cdi":
        assert [d.name for d in want.cdi_devices] == [f"google.com/tpu=tpu{c}" for c in chips]
        assert plan.cdi_devices == [f"nvidia.com/gpu=gpu{c}" for c in chips]
        assert list(want.devices) == plan.devices == [] and plan.envs == {}
        return
    # visibility: TPU_VISIBLE_CHIPS (indexes) -> the GPUs' UUIDs, both names
    assert want.envs["TPU_VISIBLE_CHIPS"] == ",".join(map(str, chips))
    uuids = ",".join(node.pci_order[c].uuid for c in chips)
    assert plan.envs["NVIDIA_VISIBLE_DEVICES"] == plan.envs["CUDA_VISIBLE_DEVICES"] == uuids
    assert want.envs["TPU_CHIPS_PER_HOST_BOUNDS"] == str(len(uuids.split(",")))
    assert plan.envs.get("GPU_TOPOLOGY") == want.envs.get("TPU_TOPOLOGY")
    assert set(plan.envs) == {"NVIDIA_VISIBLE_DEVICES", "CUDA_VISIBLE_DEVICES"} | (
        {"GPU_TOPOLOGY"} if mode == "partition" else set())
    # device nodes (kept different on purpose): every node there, only the
    # allocated GPUs' own nodes and the control nodes here
    mine = [str(node.dev / f"nvidia{node.pci_order[c].minor}") for c in chips] + [
        str(node.dev / "nvidiactl"), str(node.dev / "nvidia-uvm")]
    ref_nodes = sorted(str(p) for p in node.dev.glob("accel*"))
    ref_libtpu = [(str(node.libtpu), str(node.libtpu), True)]
    libs = [(str(node.libs / n), str(node.libs / n), True)
            for n in ("libcuda.so.1", "libnvidia-ml.so.1", "libcuda.so.580.1.2")]
    ref_mounts = [(m.container_path, m.host_path, m.read_only) for m in want.mounts]
    ref_devices = [(d.container_path, d.host_path, d.permissions) for d in want.devices]
    if mode == "mounts":
        assert ref_devices == [] and plan.devices == []
        assert ref_mounts == [(d, d, True) for d in ref_nodes] + ref_libtpu
        assert plan.mounts == [(d, d, True) for d in mine] + libs
    else:
        assert ref_devices == [(d, d, "rw") for d in ref_nodes]
        assert plan.devices == [(d, d, "rw") for d in mine]
        # the library: a read-only mount of its directory there, of the
        # driver's files here (the directory holds the host's libc)
        assert ref_mounts == ref_libtpu and plan.mounts == libs


# -- over the wire: the reference's stubs against the port's server ----------------

@pytest.fixture
def served(node):
    _, port = node.plugins()
    port.health_interval = 0.2
    socket_path = port.start()
    channel = grpc.insecure_channel(f"unix://{socket_path}")
    stub = ref_grpc_api.DevicePluginStub(channel)
    yield port, stub
    channel.close()
    port.stop()


def test_wire_list_and_watch_and_a_pushed_health_change(served, node):
    port, stub = served
    stream = stub.ListAndWatch(ref_pb.Empty(), timeout=CALL_TIMEOUT_S)
    first = next(stream)
    assert [(d.ID, d.health) for d in first.devices] == [
        (f"gpu-{i}", "Healthy") for i in range(N_GPUS)]
    node.status.write("workload", _fail([2]))
    update = next(stream)  # the health loop's refresh pushes it
    assert {d.ID: d.health for d in update.devices}["gpu-2"] == "Unhealthy"
    assert [d.health for d in update.devices].count("Unhealthy") == 1
    stream.cancel()


def test_wire_allocate_and_unknown_id(served, node):
    port, stub = served
    resp = stub.Allocate(ref_pb.AllocateRequest(container_requests=[
        ref_pb.ContainerAllocateRequest(devicesIDs=["gpu-0"])]), timeout=CALL_TIMEOUT_S)
    c = resp.container_responses[0]
    plan = port.allocation_plan(["gpu-0"])
    assert dict(c.envs) == plan.envs
    assert [(d.container_path, d.host_path, d.permissions) for d in c.devices] == plan.devices
    assert [(m.container_path, m.host_path, m.read_only) for m in c.mounts] == plan.mounts
    with pytest.raises(grpc.RpcError) as err:
        stub.Allocate(ref_pb.AllocateRequest(container_requests=[
            ref_pb.ContainerAllocateRequest(devicesIDs=["ghost"])]), timeout=CALL_TIMEOUT_S)
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    prefs = stub.GetPreferredAllocation(ref_pb.PreferredAllocationRequest(container_requests=[
        ref_pb.ContainerPreferredAllocationRequest(
            available_deviceIDs=["gpu-0", "gpu-3", "gpu-1"], must_include_deviceIDs=["gpu-0"],
            allocation_size=2)]), timeout=CALL_TIMEOUT_S)
    assert list(prefs.container_responses[0].deviceIDs) == ["gpu-0", "gpu-1"]


def test_wire_registration_round_trip(served, node):
    port, _ = served
    registered = {}

    class FakeKubelet:
        def Register(self, request, context):
            registered.update(resource=request.resource_name, endpoint=request.endpoint,
                              version=request.version)
            return ref_pb.Empty()

    kubelet_socket = str(node.tmp / "kubelet" / "kubelet.sock")
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    ref_grpc_api.add_registration_servicer(server, FakeKubelet())
    server.add_insecure_port(f"unix://{kubelet_socket}")
    server.start()
    try:
        port.register(kubelet_socket)
        assert registered == {"resource": "nvidia.com/gpu", "endpoint": "gpu.sock",
                              "version": "v1beta1"}
        endpoint = os.path.join(os.path.dirname(kubelet_socket), registered["endpoint"])
        with grpc.insecure_channel(f"unix://{endpoint}") as ch:
            opts = ref_grpc_api.DevicePluginStub(ch).GetDevicePluginOptions(
                ref_pb.Empty(), timeout=CALL_TIMEOUT_S)
        assert opts.get_preferred_allocation_available is True
    finally:
        server.stop(grace=1)


def test_no_nvml_no_inventory(node):
    """No NVML is an error, never an empty inventory: the plugin does not
    start, and a refresh of a running plugin raises (its health loop logs
    it and keeps the last inventory)."""
    _, port = node.plugins()
    node.fake.fail["nvmlInit_v2"] = 9  # NVML_ERROR_DRIVER_NOT_LOADED
    with pytest.raises(nvml.NvmlError, match="DRIVER_NOT_LOADED"):
        port.start()
    node.fake.fail.clear()
    node.fake.gpus.clear()
    with pytest.raises(RuntimeError, match="empty inventory"):
        port.start()


# -- the CLI -----------------------------------------------------------------------

def test_device_plugin_cli_registers_with_a_fake_kubelet(node, monkeypatch, tmp_path):
    """``-c device-plugin`` serves, registers with the kubelet's socket,
    reads its tunables from the ConfigMap text, and runs until stopped
    (here by the kubelet, once the plugin has registered) and exits 0."""
    registered = []
    made = []

    class FakeKubelet:
        def Register(self, request, context):
            registered.append(request.resource_name)
            made[0]._stop.set()
            return ref_pb.Empty()

    plugin_dir = tmp_path / "device-plugins"
    plugin_dir.mkdir()
    kubelet_socket = str(plugin_dir / "kubelet.sock")
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    ref_grpc_api.add_registration_servicer(server, FakeKubelet())
    server.add_insecure_port(f"unix://{kubelet_socket}")
    server.start()
    config = tmp_path / "plugin.yaml"
    config.write_text("# tunables\nhealthIntervalS: 3\nabsenceGraceS: 120\n")
    monkeypatch.setenv(consts.PLUGIN_CONFIG_ENV, str(config))

    class Plugin(port_plugin.GPUDevicePlugin):
        """The CLI's plugin on this node's kubelet dir, /dev tree and NVML."""

        def __init__(self, **kw):
            super().__init__(plugin_dir=str(plugin_dir), dev_dir=str(node.dev),
                             nvml_lib=node.fake, **kw)
            made.append(self)

        def run_forever(self):
            return super().run_forever(kubelet_socket)

    monkeypatch.setattr(port_plugin, "GPUDevicePlugin", Plugin)
    try:
        assert vmain.run(["-c", "device-plugin", f"--status-dir={node.status.directory}",
                          f"--install-dir={node.libs}", f"--handoff-dir={node.handoff}"]) == 0
    finally:
        server.stop(grace=1)
    assert registered == ["nvidia.com/gpu"]
    plugin = made[0]
    assert (plugin.health_interval, plugin.absence_grace_s) == (3.0, 120.0)
    assert plugin._stop.is_set()  # the CLI stopped its server on the way out
    assert [u.id for u in plugin._snapshot()] == [f"gpu-{i}" for i in range(N_GPUS)]


def test_device_plugin_cli_without_nvml_exits_nonzero(tmp_path, monkeypatch):
    monkeypatch.setitem(nvml._loaded, "lib", FakeNvml([], fail={"nvmlInit_v2": 12}))
    assert vmain.run(["-c", "device-plugin", f"--status-dir={tmp_path}"]) == 1


@pytest.mark.parametrize("text, expected", [
    ('{"healthIntervalS": 3, "absenceGraceS": 120}', {"health_interval": 3.0,
                                                       "absence_grace_s": 120.0}),
    ("healthIntervalS: 3\nabsenceGraceS: 120\n", {"health_interval": 3.0,
                                                 "absence_grace_s": 120.0}),
    ("healthIntervalS: fast\n", {}),
    ("{healthIntervalS: 3}\n", {}),
])
def test_plugin_tunables_read_as_the_reference_reads_them(tmp_path, monkeypatch, text,
                                                          expected):
    """The port's reader gives the reference's values where the text is in
    its subset; text outside it, and values that are not numbers, give the
    defaults (the reference parses the flow mapping with PyYAML: the one
    difference, recorded)."""
    import yaml

    config = tmp_path / "plugin.yaml"
    config.write_text(text)
    monkeypatch.setenv(consts.PLUGIN_CONFIG_ENV, str(config))
    assert vmain._plugin_tunables() == expected
    if expected:
        raw = yaml.safe_load(text)
        assert {"health_interval": float(raw["healthIntervalS"]),
                "absence_grace_s": float(raw["absenceGraceS"])} == expected


def test_handoff_reader_matches_reference(tmp_path):
    from tpu_operator.partitioner.partitioner import read_handoff as ref_read
    from tpu_operator_torch.partitioner.partitioner import read_handoff

    assert read_handoff(str(tmp_path)) is None is ref_read(str(tmp_path))
    write_handoff([{"topology": "2x2", "chips": [0, 1, 2, 3]}], "full", str(tmp_path),
                  grid=(2, 2))
    assert read_handoff(str(tmp_path)) == ref_read(str(tmp_path))
    (tmp_path / "partition.json").write_text("{torn")
    assert read_handoff(str(tmp_path)) is None is ref_read(str(tmp_path))


# -- preferred allocations over NVML's link topology ------------------------------

def _eight(tmp_path, links=True):
    from tpu_operator_torch.testing.fake_nvml import pcie_links, two_sockets

    gpus = random_gpus(8, SEED)
    fake = FakeNvml(gpus, links=pcie_links(gpus, two_sockets) if links else {})
    plugin = port_plugin.GPUDevicePlugin(plugin_dir=str(tmp_path / "kubelet"),
                                         status_dir=str(tmp_path / "st"),
                                         handoff_dir=str(tmp_path / "handoff"), nvml_lib=fake)
    plugin.refresh_units()
    return plugin, fake


def test_preferred_keeps_to_one_socket_on_a_pcie_board(tmp_path):
    """8 GPUs, 0-3 under one CPU socket and 4-7 under the other: a request
    for 4 takes one socket, not the 2-row grid guess's 0, 1, 4, 5; a pair
    that must hold GPU 5 stays on its socket, on its PCIe switch."""
    plugin, _ = _eight(tmp_path)
    ids = [f"gpu-{i}" for i in range(8)]
    assert plugin.preferred(ids, [], 4) == ["gpu-0", "gpu-1", "gpu-2", "gpu-3"]
    assert port_plugin.prefer_compact(ids, [], 4, {d: [i] for i, d in enumerate(ids)}) == \
        ["gpu-0", "gpu-1", "gpu-4", "gpu-5"]
    assert plugin.preferred(ids, ["gpu-5"], 2) == ["gpu-5", "gpu-4"]
    assert plugin.preferred(ids, ["gpu-5"], 3) == ["gpu-5", "gpu-4", "gpu-6"]
    assert plugin.preferred([d for d in ids if d != "gpu-1"], ["gpu-0"], 2) == ["gpu-0", "gpu-2"]


def test_preferred_is_lexical_where_every_pair_is_alike(tmp_path):
    plugin, fake = _eight(tmp_path, links=False)  # an NVSwitch board
    ids = [f"gpu-{i}" for i in range(8)]
    assert plugin.preferred(ids, [], 4) == ["gpu-0", "gpu-1", "gpu-2", "gpu-3"]
    assert plugin.preferred(ids, ["gpu-5"], 2) == ["gpu-5", "gpu-0"]
    # NVML cannot tell the links: the inventory stands, the pick is lexical
    fake.fail["nvmlDeviceGetP2PStatus"] = nvml.NOT_SUPPORTED
    fake.gpus = fake.gpus[:-1]
    assert plugin.refresh_units()
    assert plugin.preferred(ids[:7], ["gpu-6"], 2) == ["gpu-6", "gpu-0"]


def test_preferred_ranks_partitioned_units_by_their_gpus(tmp_path):
    from tpu_operator_torch.partitioner.partitioner import write_handoff as port_write

    plugin, _ = _eight(tmp_path)
    port_write([{"topology": "pcie-switch", "chips": [0, 1]},
                {"topology": "pcie-switch", "chips": [4, 5]},
                {"topology": "pcie-switch", "chips": [2, 3]},
                {"topology": "pcie-switch", "chips": [6, 7]}], "pairs", plugin.handoff_dir)
    plugin.refresh_units()
    parts = [f"gpu-part-{i}" for i in range(4)]
    assert plugin.preferred(parts, [], 2) == ["gpu-part-0", "gpu-part-2"]
    assert plugin.preferred(parts, ["gpu-part-3"], 2) == ["gpu-part-3", "gpu-part-1"]


def test_preferred_survives_a_handoff_naming_gpus_nvml_does_not_list(tmp_path):
    """A stale handoff (groups over 8 GPUs on a node NVML now shows with
    4) must not break GetPreferredAllocation: the pick falls back to
    lexical."""
    from tpu_operator_torch.partitioner.partitioner import write_handoff as port_write

    plugin, fake = _eight(tmp_path)
    port_write([{"topology": "pcie-switch", "chips": [6, 7]},
                {"topology": "pcie-switch", "chips": [0, 1]},
                {"topology": "pcie-switch", "chips": [2, 3]}], "pairs", plugin.handoff_dir)
    fake.gpus = fake.gpus[:4]
    plugin.refresh_units()
    parts = [f"gpu-part-{i}" for i in range(3)]
    assert plugin.preferred(parts, [], 2) == ["gpu-part-0", "gpu-part-1"]
