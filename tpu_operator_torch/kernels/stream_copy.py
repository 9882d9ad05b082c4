"""Streaming copy: the Hopper kernel behind the perf validator's HBM twin.

Replaces ``tpu_operator/validator/perf.py:measure_hbm_pallas_gbps`` (the
Pallas ``copy_kernel``); the CUDA source is ``csrc/stream_copy.cu``. It is
bound by device-memory bandwidth: one read and one write of every element.
The aligned body moves as bulk asynchronous copies (TMA) through shared
memory, two chunks per CTA; :func:`launch_plan` cuts the range into a
scalar head, bulk chunks and a scalar tail, and the C entry checks that
plan.

``stream_copy`` launches the kernel for a CUDA tensor and raises if it
cannot; it takes the plain version only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

#: kernel launches made by :func:`launch` (plain-version calls on the CPU
#: do not count); callers reset it to 0 to see what a run launched
launches = 0

#: bytes of one bulk copy: ``kChunkBytes`` of ``csrc/stream_copy.cu``, which
#: refuses a plan cut to any other size (the kernel's shape, chosen on the
#: card, is fixed there: PERF.md)
CHUNK_BYTES = 16 * 1024

#: bulk copies need 16-byte-aligned global addresses and 16-byte multiples
BULK_ALIGN = 16
_ELEM = 4  # bytes of one fp32 element


class Plan(NamedTuple):
    """How one copy of ``n`` fp32 elements is cut: ``head`` scalar elements,
    then ``n_chunks`` bulk copies of ``chunk_bytes`` (the last one
    ``last_bytes``), then ``tail`` scalar elements. With no bulk body
    (``n_chunks == 0``) the whole range is the head."""
    head: int
    chunk_bytes: int
    n_chunks: int
    last_bytes: int
    tail: int


def launch_plan(src_addr: int, dst_addr: int, n: int) -> Plan:
    """The launch plan for copying ``n`` fp32 elements from byte address
    ``src_addr`` to ``dst_addr`` (both multiples of 4)."""
    if n <= 0 or src_addr % _ELEM or dst_addr % _ELEM:
        raise ValueError(f"launch_plan takes n > 0 and 4-byte-aligned addresses, got "
                         f"n={n} src={src_addr:#x} dst={dst_addr:#x}")
    scalar = Plan(head=n, chunk_bytes=CHUNK_BYTES, n_chunks=0, last_bytes=0, tail=0)
    if (src_addr - dst_addr) % BULK_ALIGN:
        return scalar  # misaligned relative to each other: no bulk pairing
    head = (-src_addr) % BULK_ALIGN // _ELEM
    body_bytes = max(n - head, 0) * _ELEM // BULK_ALIGN * BULK_ALIGN
    if body_bytes == 0:
        return scalar
    n_chunks = -(-body_bytes // CHUNK_BYTES)
    return Plan(head=head, chunk_bytes=CHUNK_BYTES, n_chunks=n_chunks,
                last_bytes=body_bytes - (n_chunks - 1) * CHUNK_BYTES,
                tail=n - head - body_bytes // _ELEM)


def stream_copy_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a fresh tensor holding a copy of ``x``."""
    return torch.empty_like(x).copy_(x)


def _entry():
    lib = _build.library("stream_copy")
    fn = lib.tpuop_stream_copy_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
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


def _check_pair(x: torch.Tensor, out: torch.Tensor) -> None:
    _check(x)
    _check(out)
    if x.device.type != "cuda" or out.device != x.device or out.shape != x.shape:
        raise ValueError(f"stream_copy launches on one CUDA device with matching "
                         f"shapes, got {x.device} {tuple(x.shape)} -> "
                         f"{out.device} {tuple(out.shape)}")


def run_plan(x: torch.Tensor, out: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Launch the kernel copying CUDA tensor ``x`` into ``out`` by ``plan``
    on the current stream. Raises if the C entry refuses the plan or the
    launch fails. No synchronisation."""
    global launches
    _check_pair(x, out)
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), *plan, stream)
    if err != 0:
        raise RuntimeError("stream_copy launch failed: "
                           f"{lib.tpuop_cuda_error_string(err).decode()} ({err})")
    launches += 1
    return out


def launch(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel copying CUDA tensor ``x`` into ``out`` (same shape,
    fp32, contiguous, same device; either may start at any 4-byte offset)
    on the current stream. No synchronisation."""
    return run_plan(x, out, launch_plan(x.data_ptr(), out.data_ptr(), x.numel()))


def stream_copy(x: torch.Tensor) -> torch.Tensor:
    """Copy of a contiguous, non-empty fp32 tensor."""
    _check(x)
    if x.device.type == "cpu":
        return stream_copy_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"stream_copy runs on cuda (or cpu), got {x.device}")
    return launch(x, torch.empty_like(x))
