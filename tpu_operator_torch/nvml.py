"""NVIDIA's management library (NVML, ``libnvidia-ml.so.1``) over ``ctypes``.

The GPU's counterpart of the TPU operator's ``/dev`` enumeration and of
libtpu's per-chip runtime counters: which GPUs the node has (index, UUID,
device-node minor number, PCI bus id), one sample of each (memory,
utilisation, power, temperature), how near each pair is (NVLink, or the
closest common PCIe ancestor: :meth:`Session.links`, the counterpart of a
TPU host's ICI grid) and the driver's version. NVML answers without a
CUDA context, so the resident daemons (the device plugin, the telemetry
exporter, the CDI writer, the partitioner) never pin device memory nor
block an exclusive-mode workload.

The library is loaded at the first call, never at import. Every NVML
error raises :class:`NvmlError` with NVML's return code; a missing library
raises too, so no caller ever mistakes it for a node without GPUs. One
answer is not an error: a PCI query NVML does not support (as in some
virtual machines, where ``nvidia-smi`` prints the bus id as N/A) leaves
the GPU's bus id None, and the CUDA driver then tells the GPUs' order
(:meth:`Session.gpus`). Tests pass a fake library object (``lib=``) with
the same functions (``testing/fake_nvml.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import logging
from typing import Iterator, List, Optional

from . import cuda_driver

log = logging.getLogger(__name__)

LIBRARY = "libnvidia-ml.so.1"

#: nvmlTemperatureSensors_t: the GPU die
TEMPERATURE_GPU = 0
#: nvmlReturn_t NVML_ERROR_NOT_SUPPORTED
NOT_SUPPORTED = 3
#: NVML_DEVICE_UUID_V2_BUFFER_SIZE
UUID_BUFFER = 96
#: NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE
DRIVER_VERSION_BUFFER = 80

#: nvmlGpuTopologyLevel_t: the closest common ancestor of two GPUs
TOPOLOGY_INTERNAL = 0      # one board (a multi-GPU card)
TOPOLOGY_SINGLE = 10       # one PCIe switch
TOPOLOGY_MULTIPLE = 20     # several PCIe switches, no host bridge crossed
TOPOLOGY_HOSTBRIDGE = 30   # one PCIe host bridge
TOPOLOGY_NODE = 40         # one NUMA node (CPU socket), several host bridges
TOPOLOGY_SYSTEM = 50       # across NUMA nodes (the sockets' interconnect)
#: nvmlGpuP2PCapsIndex_t NVML_P2P_CAPS_INDEX_NVLINK
P2P_CAPS_INDEX_NVLINK = 2
#: nvmlGpuP2PStatus_t NVML_P2P_STATUS_OK
P2P_STATUS_OK = 0

#: link classes between two GPUs, tightest first: the measure of nearness
#: the partitioner tiles with and the device plugin ranks allocations by
LINK_NVLINK = "nvlink"
LINK_PCIE_SWITCH = "pcie-switch"
LINK_HOST_BRIDGE = "host-bridge"
LINK_NUMA = "numa"
LINK_SYSTEM = "system"
LINK_CLASSES = (LINK_NVLINK, LINK_PCIE_SWITCH, LINK_HOST_BRIDGE, LINK_NUMA, LINK_SYSTEM)
_ANCESTOR_CLASS = {TOPOLOGY_INTERNAL: LINK_NVLINK, TOPOLOGY_SINGLE: LINK_PCIE_SWITCH,
                   TOPOLOGY_MULTIPLE: LINK_PCIE_SWITCH, TOPOLOGY_HOSTBRIDGE: LINK_HOST_BRIDGE,
                   TOPOLOGY_NODE: LINK_NUMA, TOPOLOGY_SYSTEM: LINK_SYSTEM}

#: nvmlReturn_t values, for error messages
ERRORS = {
    1: "UNINITIALIZED", 2: "INVALID_ARGUMENT", 3: "NOT_SUPPORTED", 4: "NO_PERMISSION",
    5: "ALREADY_INITIALIZED", 6: "NOT_FOUND", 7: "INSUFFICIENT_SIZE",
    8: "INSUFFICIENT_POWER", 9: "DRIVER_NOT_LOADED", 10: "TIMEOUT", 11: "IRQ_ISSUE",
    12: "LIBRARY_NOT_FOUND", 13: "FUNCTION_NOT_FOUND", 14: "CORRUPTED_INFOROM",
    15: "GPU_IS_LOST", 16: "RESET_REQUIRED", 17: "OPERATING_SYSTEM",
    18: "LIB_RM_VERSION_MISMATCH", 19: "IN_USE", 20: "MEMORY", 21: "NO_DATA",
    25: "ARGUMENT_VERSION_MISMATCH", 27: "NOT_READY", 28: "GPU_NOT_FOUND",
    999: "UNKNOWN",
}


class NvmlError(RuntimeError):
    """An NVML call failed (``code`` is its nvmlReturn_t) or the library
    could not be loaded (``code`` is None)."""

    def __init__(self, call: str, code: Optional[int], detail: str = ""):
        self.call = call
        self.code = code
        what = (f"NVML_ERROR_{ERRORS.get(code, 'UNKNOWN')} ({code})" if code is not None
                else f"{LIBRARY} not loadable")
        super().__init__(f"{call}: {what}" + (f": {detail}" if detail else ""))


class PciInfo(ctypes.Structure):
    """nvmlPciInfo_t (the v3 layout)."""

    _fields_ = [("busIdLegacy", ctypes.c_char * 16), ("domain", ctypes.c_uint),
                ("bus", ctypes.c_uint), ("device", ctypes.c_uint),
                ("pciDeviceId", ctypes.c_uint), ("pciSubSystemId", ctypes.c_uint),
                ("busId", ctypes.c_char * 32)]


class Memory(ctypes.Structure):
    """nvmlMemory_v2_t: bytes. Its ``used`` leaves out the memory the
    driver reserves, as ``nvidia-smi``'s memory.used does; the v1 struct's
    ``used`` is ``total - free``, the reserve included."""

    _fields_ = [("version", ctypes.c_uint), ("total", ctypes.c_ulonglong),
                ("reserved", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


#: nvmlMemory_v2: the struct's size, the version in the top byte
MEMORY_VERSION = ctypes.sizeof(Memory) | (2 << 24)


class Utilization(ctypes.Structure):
    """nvmlUtilization_t: percent of the last sample period."""

    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


_P = ctypes.POINTER
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetCount_v2": [_P(ctypes.c_uint)],
    "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint, _P(ctypes.c_void_p)],
    "nvmlDeviceGetUUID": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetMinorNumber": [ctypes.c_void_p, _P(ctypes.c_uint)],
    "nvmlDeviceGetPciInfo_v3": [ctypes.c_void_p, _P(PciInfo)],
    "nvmlDeviceGetMemoryInfo_v2": [ctypes.c_void_p, _P(Memory)],
    "nvmlDeviceGetUtilizationRates": [ctypes.c_void_p, _P(Utilization)],
    "nvmlDeviceGetPowerUsage": [ctypes.c_void_p, _P(ctypes.c_uint)],
    "nvmlDeviceGetTemperature": [ctypes.c_void_p, ctypes.c_int, _P(ctypes.c_uint)],
    "nvmlDeviceGetTopologyCommonAncestor": [ctypes.c_void_p, ctypes.c_void_p, _P(ctypes.c_int)],
    "nvmlDeviceGetP2PStatus": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, _P(ctypes.c_int)],
    "nvmlSystemGetDriverVersion": [ctypes.c_char_p, ctypes.c_uint],
}

_loaded = {}


def library():
    """The process's NVML, loaded once, at the first call."""
    if "lib" not in _loaded:
        try:
            lib = ctypes.CDLL(LIBRARY)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        except (OSError, AttributeError) as e:
            raise NvmlError("load", None, str(e)) from e
        _loaded["lib"] = lib
    return _loaded["lib"]


@dataclasses.dataclass(frozen=True)
class Gpu:
    #: NVML's index (not CUDA's ordinal: see :func:`gpus`)
    index: int
    uuid: str
    #: minor number of the GPU's device node, ``/dev/nvidia<minor>``
    minor: int
    #: ``domain:bus:device.function``, as ``nvidia-smi -q`` prints it; None
    #: where NVML does not support the query (``nvidia-smi`` prints N/A),
    #: as on some virtual machines
    pci_bus_id: Optional[str]
    #: CUDA's ordinal for this GPU in a process with
    #: ``CUDA_DEVICE_ORDER=PCI_BUS_ID``; None where neither the bus ids nor
    #: the CUDA driver tell it (see :meth:`Session.gpus`)
    cuda_ordinal: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Sample:
    uuid: str
    memory_used_bytes: int
    memory_total_bytes: int
    #: share of the sample period in which a kernel ran
    gpu_utilization_percent: int
    #: share of the sample period in which device memory was read or written
    memory_utilization_percent: int
    power_mw: int
    temperature_c: int


class Session:
    """Calls on an initialised NVML (see :func:`session`)."""

    def __init__(self, lib):
        self.lib = lib

    def _call(self, name: str, *args) -> None:
        code = getattr(self.lib, name)(*args)
        if code != 0:
            raise NvmlError(name, code)

    def count(self) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def handle(self, index: int) -> ctypes.c_void_p:
        h = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, ctypes.byref(h))
        return h

    def gpu(self, index: int) -> Gpu:
        h = self.handle(index)
        uuid = ctypes.create_string_buffer(UUID_BUFFER)
        self._call("nvmlDeviceGetUUID", h, uuid, UUID_BUFFER)
        minor = ctypes.c_uint()
        self._call("nvmlDeviceGetMinorNumber", h, ctypes.byref(minor))
        pci = PciInfo()
        code = self.lib.nvmlDeviceGetPciInfo_v3(h, ctypes.byref(pci))
        if code not in (0, NOT_SUPPORTED):
            raise NvmlError("nvmlDeviceGetPciInfo_v3", code)
        return Gpu(index=index, uuid=uuid.value.decode(), minor=minor.value,
                   pci_bus_id=pci.busId.decode() if code == 0 else None)

    def sample(self, gpu: Gpu) -> Sample:
        h = self.handle(gpu.index)
        mem = Memory(version=MEMORY_VERSION)
        self._call("nvmlDeviceGetMemoryInfo_v2", h, ctypes.byref(mem))
        util = Utilization()
        self._call("nvmlDeviceGetUtilizationRates", h, ctypes.byref(util))
        power = ctypes.c_uint()
        self._call("nvmlDeviceGetPowerUsage", h, ctypes.byref(power))
        temp = ctypes.c_uint()
        self._call("nvmlDeviceGetTemperature", h, TEMPERATURE_GPU, ctypes.byref(temp))
        return Sample(uuid=gpu.uuid, memory_used_bytes=mem.used, memory_total_bytes=mem.total,
                      gpu_utilization_percent=util.gpu, memory_utilization_percent=util.memory,
                      power_mw=power.value, temperature_c=temp.value)

    def driver_version(self) -> str:
        """The kernel driver's version, as ``nvidia-smi`` prints it."""
        buf = ctypes.create_string_buffer(DRIVER_VERSION_BUFFER)
        self._call("nvmlSystemGetDriverVersion", buf, DRIVER_VERSION_BUFFER)
        return buf.value.decode()

    def link(self, a: Gpu, b: Gpu) -> str:
        """The class of the link between two GPUs (:data:`LINK_CLASSES`):
        ``nvlink`` where peer access over NVLink is OK or the two share a
        board, else what their closest common PCIe ancestor says. Raises
        :class:`NvmlError` where NVML cannot answer: nearness is never
        guessed."""
        ha, hb = self.handle(a.index), self.handle(b.index)
        status = ctypes.c_int()
        self._call("nvmlDeviceGetP2PStatus", ha, hb, P2P_CAPS_INDEX_NVLINK,
                   ctypes.byref(status))
        if status.value == P2P_STATUS_OK:
            return LINK_NVLINK
        level = ctypes.c_int()
        self._call("nvmlDeviceGetTopologyCommonAncestor", ha, hb, ctypes.byref(level))
        if level.value not in _ANCESTOR_CLASS:
            raise NvmlError("nvmlDeviceGetTopologyCommonAncestor", 999,
                            f"unknown topology level {level.value}")
        return _ANCESTOR_CLASS[level.value]

    def links(self, gpus: List[Gpu]) -> List[List[Optional[str]]]:
        """The pairwise link classes of ``gpus``, in their order (that of
        :meth:`gpus`: PCI bus-id order, or CUDA's ordinals): ``m[i][j]`` is
        the link between ``gpus[i]`` and ``gpus[j]``, None on the
        diagonal."""
        m: List[List[Optional[str]]] = [[None] * len(gpus) for _ in gpus]
        for i, a in enumerate(gpus):
            for j in range(i + 1, len(gpus)):
                m[i][j] = m[j][i] = self.link(a, gpus[j])
        return m

    def gpus(self) -> List[Gpu]:
        """Every GPU, in CUDA's ordinal order under
        ``CUDA_DEVICE_ORDER=PCI_BUS_ID``, which every sweep process the
        port starts runs with: position ``i`` here, CUDA ordinal ``i`` and
        a barrier's local GPU ``i`` name one GPU. That is PCI bus-id order.
        Where NVML gives no bus id for some GPU of several, the CUDA driver
        names each ordinal's UUID (no context); where it cannot, or names
        other GPUs, the list keeps NVML's index order with every
        ``cuda_ordinal`` None, and a caller must not take a position for
        an ordinal."""
        found = [self.gpu(i) for i in range(self.count())]
        if all(g.pci_bus_id for g in found):
            found.sort(key=lambda g: g.pci_bus_id.lower())
        elif len(found) > 1:
            try:
                order = cuda_driver.uuids_by_ordinal()
            except cuda_driver.CudaError as e:
                log.warning("NVML gives no PCI bus id and the CUDA driver no order (%s): "
                            "the GPUs' CUDA ordinals are unknown", e)
                return found
            if sorted(order) != sorted(g.uuid for g in found):
                log.warning("NVML's GPUs %s are not CUDA's %s: their CUDA ordinals are "
                            "unknown", [g.uuid for g in found], order)
                return found
            found.sort(key=lambda g: order.index(g.uuid))
        return [dataclasses.replace(g, cuda_ordinal=i) for i, g in enumerate(found)]


@contextlib.contextmanager
def session(lib=None) -> Iterator[Session]:
    """NVML initialised for the ``with`` body, shut down after it."""
    lib = lib if lib is not None else library()
    code = lib.nvmlInit_v2()
    if code != 0:
        raise NvmlError("nvmlInit_v2", code)
    try:
        yield Session(lib)
    finally:
        lib.nvmlShutdown()


def gpus(lib=None) -> List[Gpu]:
    """The node's GPUs in CUDA's PCI order (see :meth:`Session.gpus`)."""
    with session(lib) as s:
        return s.gpus()
