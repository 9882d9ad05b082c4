"""Streaming copy: the Hopper kernel behind the perf validator's HBM twin.

Replaces ``tpu_operator/validator/perf.py:measure_hbm_pallas_gbps`` (the
Pallas ``copy_kernel``); the CUDA source is ``csrc/stream_copy.cu``. It is
bound by device-memory bandwidth: one read and one write of every element.

``stream_copy`` launches the kernel for a CUDA tensor and raises if it
cannot; it takes the plain version only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches made by :func:`stream_copy` (plain-version calls on the
#: CPU do not count); callers reset it to 0 to see what a run launched
launches = 0


def stream_copy_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a fresh tensor holding a copy of ``x``."""
    return torch.empty_like(x).copy_(x)


def _entry():
    lib = _build.library("stream_copy")
    fn = lib.tpuop_stream_copy_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tpuop_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpuop_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"stream_copy takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("stream_copy takes a contiguous tensor")
    if x.numel() == 0:
        raise ValueError("stream_copy takes a non-empty tensor")


def launch(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel copying CUDA tensor ``x`` into ``out`` (same shape,
    fp32, contiguous, same device; either may start at any 4-byte offset)
    on the current stream. No synchronisation."""
    global launches
    _check(x)
    _check(out)
    if x.device.type != "cuda" or out.device != x.device or out.shape != x.shape:
        raise ValueError(f"stream_copy launches on one CUDA device with matching "
                         f"shapes, got {x.device} {tuple(x.shape)} -> "
                         f"{out.device} {tuple(out.shape)}")
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    if err != 0:
        raise RuntimeError("stream_copy launch failed: "
                           f"{lib.tpuop_cuda_error_string(err).decode()} ({err})")
    launches += 1
    return out


def stream_copy(x: torch.Tensor) -> torch.Tensor:
    """Copy of a contiguous, non-empty fp32 tensor."""
    _check(x)
    if x.device.type == "cpu":
        return stream_copy_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"stream_copy runs on cuda (or cpu), got {x.device}")
    return launch(x, torch.empty_like(x))
