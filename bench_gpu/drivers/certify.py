"""Driver of node certification, ``gpu-validator -c perf``, one CLI run a
pass. Set-up loads K1 from the build cache (``kernels/_build.py``; only a
checkout's first run calls ``nvcc``) and warms the shapes a certification
launches at the configuration's sizes, and no others: the GEMM (cuBLAS's
handle and its choice of kernel), the HBM probe and K1, with the
allocator's blocks for their arrays. The all-reduce's ranks are spawned
afresh by the program in every pass, so there is nothing of theirs to
warm here."""

from __future__ import annotations

import time

from .. import sizes as sizes_mod
from ..counts import k1
from .cli import CliDriver


def warm(config: dict) -> None:
    import torch

    from tpu_operator_torch.device import resolve_device
    from tpu_operator_torch.kernels.stream_copy import stream_copy
    from tpu_operator_torch.validator import perf

    sizes = sizes_mod.perf_sizes(config["validator_flags"])
    dev = resolve_device("cuda")
    a = torch.ones((sizes["matrix_dim"],) * 2, dtype=torch.bfloat16, device=dev)
    torch.matmul(a, a)
    x = torch.ones((sizes["hbm_mib"] * 1024 * 1024 // 4,), dtype=torch.float32, device=dev)
    perf.scale_add(x)
    stream_copy(torch.ones((k1.rows(sizes["hbm_mib"]), k1.LANES), dtype=torch.float32,
                           device=dev))
    torch.cuda.synchronize(dev)


def prepare(config: dict, mix: dict, status_dir: str, log) -> CliDriver:
    from tpu_operator_torch.kernels import _build

    t = time.perf_counter()
    _build.library("stream_copy")
    kernel_load_s = time.perf_counter() - t
    log(f"set-up: K1 loaded in {kernel_load_s:.3f} s")
    warm(config)
    return CliDriver.of(config, mix, status_dir, {"kernel_load_s": kernel_load_s})
