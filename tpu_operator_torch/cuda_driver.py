"""The CUDA driver API (``libcuda.so.1``) over ``ctypes``, for the two
questions a torch-free process asks it: which GPU each CUDA ordinal names
(by UUID, under ``CUDA_DEVICE_ORDER=PCI_BUS_ID``, the order every sweep
process the port starts runs with), and whether this process holds a GPU's
primary context. Neither makes a context: ``cuInit`` makes none, so a
resident daemon may ask both.

The library is loaded at the first call, never at import. Every driver
error raises :class:`CudaError`. Tests inject a fake library object
(``testing/fake_nvml.py``).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

from . import consts
from .utils import pin_device_order

LIBRARY = "libcuda.so.1"


class CudaError(RuntimeError):
    """A driver call failed (``code`` is its CUresult), or could not be
    made (``code`` is None)."""

    def __init__(self, call: str, code: Optional[int], detail: str = ""):
        self.call = call
        self.code = code
        super().__init__(f"{call}: " + (f"CUresult {code}" if code is not None else detail))


class Uuid(ctypes.Structure):
    """CUuuid: the GPU's 16 bytes."""

    _fields_ = [("bytes", ctypes.c_ubyte * 16)]


_P = ctypes.POINTER
_SIGNATURES = {
    "cuInit": [ctypes.c_uint],
    "cuDeviceGetCount": [_P(ctypes.c_int)],
    "cuDeviceGet": [_P(ctypes.c_int), ctypes.c_int],
    "cuDeviceGetUuid_v2": [_P(Uuid), ctypes.c_int],
    "cuDevicePrimaryCtxGetState": [ctypes.c_int, _P(ctypes.c_uint), _P(ctypes.c_int)],
}

_loaded = {}


def library():
    """The process's driver library, loaded once, at the first call."""
    if "lib" not in _loaded:
        try:
            lib = ctypes.CDLL(LIBRARY)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        except (OSError, AttributeError) as e:
            raise CudaError("load", None, f"{LIBRARY} not loadable: {e}") from e
        _loaded["lib"] = lib
    return _loaded["lib"]


def _call(lib, name: str, *args) -> None:
    code = getattr(lib, name)(*args)
    if code != 0:
        raise CudaError(name, code)


def _devices(lib) -> List[ctypes.c_int]:
    _call(lib, "cuInit", 0)
    count = ctypes.c_int()
    _call(lib, "cuDeviceGetCount", ctypes.byref(count))
    devices = []
    for i in range(count.value):
        dev = ctypes.c_int()
        _call(lib, "cuDeviceGet", ctypes.byref(dev), i)
        devices.append(dev)
    return devices


def uuids_by_ordinal() -> List[str]:
    """Each CUDA ordinal's UUID, as NVML writes it (``GPU-`` and 8-4-4-4-12
    hex digits), in PCI order. Pins that order in this process first;
    raises :class:`CudaError` where the process chose another one, since
    its ordinals would not be a sweep's."""
    order = pin_device_order(os.environ)[consts.CUDA_DEVICE_ORDER_ENV]
    if order != consts.CUDA_DEVICE_ORDER:
        raise CudaError("cuInit", None, f"{consts.CUDA_DEVICE_ORDER_ENV}={order} in this "
                        f"process, not {consts.CUDA_DEVICE_ORDER}")
    lib = library()
    uuids = []
    for dev in _devices(lib):
        uuid = Uuid()
        _call(lib, "cuDeviceGetUuid_v2", ctypes.byref(uuid), dev)
        h = bytes(uuid.bytes).hex()
        uuids.append(f"GPU-{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}")
    return uuids


def primary_contexts_active() -> List[bool]:
    """Whether this process holds each GPU's primary context
    (``cuDevicePrimaryCtxGetState``), whatever PyTorch has initialised."""
    lib = library()
    active = []
    for dev in _devices(lib):
        flags, state = ctypes.c_uint(), ctypes.c_int()
        _call(lib, "cuDevicePrimaryCtxGetState", dev, ctypes.byref(flags),
              ctypes.byref(state))
        active.append(bool(state.value))
    return active
