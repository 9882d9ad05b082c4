"""Device selection: CUDA unless the caller explicitly asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_numerics() -> None:
    """Exact numerics for the validation GEMMs.

    cuBLAS may otherwise reduce bf16 split-K partial sums in bf16, which is
    exact only in steps of 4 above 512: the sweep's ``c == 2*dim`` check
    would then fail on a healthy card. TF32 is off so an fp32 product is
    full fp32, as on the CPU."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda:0`` by default (or the CUDA device given); ``cpu`` only when
    asked for by name. Raises when CUDA is wanted and absent — a node
    validator that quietly measured the host CPU would certify nothing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the host")
    set_numerics()
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def device_kind(device: torch.device) -> str:
    """Device name as the perf tables key it ("NVIDIA H100 80GB HBM3")."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def platform_of(device: torch.device) -> str:
    """JAX's platform names: ``gpu`` for CUDA, ``cpu`` for the host."""
    return "gpu" if device.type == "cuda" else "cpu"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
