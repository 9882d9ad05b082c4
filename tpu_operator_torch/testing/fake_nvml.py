"""A fake ``libnvidia-ml.so.1`` for tests: an object with the functions
:mod:`tpu_operator_torch.nvml` binds, taking the same ``ctypes``
arguments and returning NVML return codes; and a fake ``libcuda.so.1``
with the calls :mod:`tpu_operator_torch.cuda_driver` binds.

Its GPUs are listed in NVML index order, which need not be PCI order; a
test changes them (or sets ``fail[<function>] = <code>``) between calls.
The links between GPUs are keyed by their UUIDs, so the listed order does
not move them: by default every pair is NVLink (an NVSwitch board), and
:func:`pcie_links` builds a board without NVLink.
:func:`install` makes it the process's NVML, as a subprocess script does
before it runs a component's CLI.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from .. import nvml

GIB = 2 ** 30


@dataclasses.dataclass
class FakeGpu:
    uuid: str
    minor: int
    pci_bus_id: Optional[str]
    memory_total: int = 80 * GIB
    memory_used: int = 0
    gpu_util: int = 0
    memory_util: int = 0
    power_mw: int = 70_000
    temperature_c: int = 30


#: (common ancestor level, peer access over NVLink) of one pair of GPUs
Link = Tuple[int, bool]
#: the NVSwitch board's pair: every GPU reaches every other over NVLink
NVSWITCH: Link = (nvml.TOPOLOGY_SYSTEM, True)


class FakeNvml:
    def __init__(self, gpus: List[FakeGpu], fail: Dict[str, int] = None,
                 links: Dict[FrozenSet[str], Link] = None,
                 driver_version: str = "570.133.20"):
        self.gpus = list(gpus)
        self.fail = dict(fail or {})
        #: {frozenset of two UUIDs: Link}; a pair not listed is NVSWITCH
        self.links = dict(links or {})
        self.driver_version = driver_version
        #: nvmlInit_v2 calls not yet matched by nvmlShutdown
        self.open_sessions = 0

    def _code(self, name: str) -> int:
        return self.fail.get(name, 0)

    def _gpu(self, handle) -> FakeGpu:
        return self.gpus[handle.value - 1]

    def nvmlInit_v2(self):
        code = self._code("nvmlInit_v2")
        if code == 0:
            self.open_sessions += 1
        return code

    def nvmlShutdown(self):
        self.open_sessions -= 1
        return 0

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = len(self.gpus)
        return self._code("nvmlDeviceGetCount_v2")

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        if not 0 <= index < len(self.gpus):
            return 2  # NVML_ERROR_INVALID_ARGUMENT
        handle._obj.value = index + 1
        return self._code("nvmlDeviceGetHandleByIndex_v2")

    def nvmlDeviceGetUUID(self, handle, buf, size):
        buf.value = self._gpu(handle).uuid.encode()
        return self._code("nvmlDeviceGetUUID")

    def nvmlDeviceGetMinorNumber(self, handle, minor):
        minor._obj.value = self._gpu(handle).minor
        return self._code("nvmlDeviceGetMinorNumber")

    def nvmlDeviceGetPciInfo_v3(self, handle, pci):
        """NOT_SUPPORTED for a GPU without a bus id, as on some VMs."""
        bus_id = self._gpu(handle).pci_bus_id
        if bus_id is None:
            return 3
        pci._obj.busId = bus_id.encode()
        return self._code("nvmlDeviceGetPciInfo_v3")

    def nvmlDeviceGetMemoryInfo_v2(self, handle, mem):
        if mem._obj.version != nvml.MEMORY_VERSION:
            return 25  # NVML_ERROR_ARGUMENT_VERSION_MISMATCH
        g = self._gpu(handle)
        mem._obj.total, mem._obj.used = g.memory_total, g.memory_used
        mem._obj.reserved = 480 * 2 ** 20
        mem._obj.free = g.memory_total - g.memory_used - mem._obj.reserved
        return self._code("nvmlDeviceGetMemoryInfo_v2")

    def nvmlDeviceGetUtilizationRates(self, handle, util):
        g = self._gpu(handle)
        util._obj.gpu, util._obj.memory = g.gpu_util, g.memory_util
        return self._code("nvmlDeviceGetUtilizationRates")

    def nvmlDeviceGetPowerUsage(self, handle, power):
        power._obj.value = self._gpu(handle).power_mw
        return self._code("nvmlDeviceGetPowerUsage")

    def nvmlDeviceGetTemperature(self, handle, sensor, temp):
        temp._obj.value = self._gpu(handle).temperature_c
        return self._code("nvmlDeviceGetTemperature")

    def _link(self, a, b) -> Link:
        return self.links.get(frozenset((self._gpu(a).uuid, self._gpu(b).uuid)), NVSWITCH)

    def nvmlDeviceGetP2PStatus(self, a, b, index, status):
        if index != nvml.P2P_CAPS_INDEX_NVLINK:
            return 2  # the fake answers the NVLink capability only
        status._obj.value = nvml.P2P_STATUS_OK if self._link(a, b)[1] else 5
        return self._code("nvmlDeviceGetP2PStatus")

    def nvmlDeviceGetTopologyCommonAncestor(self, a, b, level):
        level._obj.value = self._link(a, b)[0]
        return self._code("nvmlDeviceGetTopologyCommonAncestor")

    def nvmlSystemGetDriverVersion(self, buf, size):
        buf.value = self.driver_version.encode()
        return self._code("nvmlSystemGetDriverVersion")


class FakeCuda:
    """The CUDA driver of a node whose ordinals name ``uuids`` in order:
    no primary context is active. ``calls`` counts the driver calls."""

    def __init__(self, uuids: List[str], fail: Dict[str, int] = None):
        self.uuids = list(uuids)
        self.fail = dict(fail or {})
        self.calls = 0

    def _code(self, name: str) -> int:
        self.calls += 1
        return self.fail.get(name, 0)

    def cuInit(self, flags):
        return self._code("cuInit")

    def cuDeviceGetCount(self, count):
        count._obj.value = len(self.uuids)
        return self._code("cuDeviceGetCount")

    def cuDeviceGet(self, dev, ordinal):
        dev._obj.value = ordinal
        return self._code("cuDeviceGet")

    def cuDeviceGetUuid_v2(self, uuid, dev):
        raw = bytes.fromhex(self.uuids[dev.value].removeprefix("GPU-").replace("-", ""))
        uuid._obj.bytes[:] = list(raw)
        return self._code("cuDeviceGetUuid_v2")

    def cuDevicePrimaryCtxGetState(self, dev, flags, state):
        flags._obj.value, state._obj.value = 0, 0
        return self._code("cuDevicePrimaryCtxGetState")


def random_gpus(n: int, seed: int) -> List[FakeGpu]:
    """``n`` H100s from a seed: UUIDs, distinct minor numbers and PCI bus
    ids, listed in an order that is neither minor nor PCI order (for
    ``n`` > 2), with memory, utilisation, power and temperature samples."""
    rng = np.random.default_rng(seed)
    minors = rng.choice(16, size=n, replace=False)
    buses = np.sort(rng.choice(np.arange(0x10, 0xf0), size=n, replace=False))
    gpus = [FakeGpu(uuid="GPU-" + "-".join(rng.bytes(k).hex() for k in (4, 2, 2, 2, 6)),
                    minor=int(minors[i]), pci_bus_id=f"00000000:{buses[i]:02X}:00.0",
                    memory_used=int(rng.integers(0, 80 * GIB)),
                    gpu_util=int(rng.integers(0, 101)), memory_util=int(rng.integers(0, 101)),
                    power_mw=int(rng.integers(60_000, 700_000)),
                    temperature_c=int(rng.integers(25, 90)))
            for i in range(n)]
    order = list(rng.permutation(n))
    # keep the listed order off PCI order, so a test that skips sorting shows
    if n > 1 and order == sorted(order):
        order = order[1:] + order[:1]
    return [gpus[i] for i in order]


def pcie_links(gpus: List[FakeGpu], level: Callable[[int, int], int]
               ) -> Dict[FrozenSet[str], Link]:
    """The links of a board without NVLink: ``level(i, j)`` is the common
    PCIe ancestor of the ``i``-th and ``j``-th GPU in PCI bus-id order."""
    ordered = sorted(gpus, key=lambda g: g.pci_bus_id.lower())
    return {frozenset((ordered[i].uuid, ordered[j].uuid)): (level(i, j), False)
            for i, j in itertools.combinations(range(len(ordered)), 2)}


def two_sockets(i: int, j: int) -> int:
    """An 8-GPU PCIe board: GPUs in pairs under four PCIe switches, two
    switches under each CPU socket (GPUs 0-3 and 4-7 in PCI order)."""
    if i // 2 == j // 2:
        return nvml.TOPOLOGY_SINGLE
    return nvml.TOPOLOGY_NODE if i // 4 == j // 4 else nvml.TOPOLOGY_SYSTEM


def install(fake: FakeNvml) -> None:
    """Make ``fake`` the process's NVML (what :func:`nvml.library` returns)."""
    nvml._loaded["lib"] = fake
