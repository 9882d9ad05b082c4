"""The accelerator workload check: the GPU health sweep
(counterpart of tpu_operator/validator/workload.py).

Real math on every GPU through the whole stack — driver, device-plugin
mounts, CUDA, cuBLAS and NCCL over NVLink. Four checks per GPU, each rank
on its own device:

1. compute: bf16 GEMM of ones by twos, every element exactly ``2*dim``
2. ``all_reduce`` of the ranks: ``n(n-1)/2``
3. an n-hop ring of ``batch_isend_irecv``: every rank gets its own back
4. ``all_gather`` of the ranks: ``arange(n)``

then an ``all_reduce`` of the one-hot (n, 4) flag matrix gives every rank
every GPU's verdict. Integer-valued operands make every check exact.

One process per GPU (NCCL's model): :func:`ici_health_check` runs one rank
per local GPU and takes the merged matrix from rank 0; with one GPU it runs
in this process as a world of one. :func:`run_multihost` is one rank of a
group that spans hosts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, platform_of, resolve_device, synchronize
from ..ranks import init_group, rank_device, run_ranks

CHECK_NAMES = ("compute", "psum", "ring", "all_gather")


@dataclasses.dataclass
class IciCheckReport:
    passed: bool
    n_devices: int
    platform: str
    elapsed_s: float
    #: set-up time: CUDA context, cuBLAS handle and NCCL communicator (gloo
    #: on the CPU) — what the TPU sweep spends compiling its program
    compile_s: float
    details: dict
    #: global sweep ordinals (ranks) of THIS host's GPUs, in local order
    local_chips: list = dataclasses.field(default_factory=list)
    #: LOCAL indices (positions in local_chips) with any failing check
    failed_local_chips: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def gemm_operands(matrix_dim: int, device: torch.device):
    """The compute check's operands: ones and twos, bf16."""
    a = torch.ones((matrix_dim, matrix_dim), dtype=torch.bfloat16, device=device)
    b = torch.full((matrix_dim, matrix_dim), 2, dtype=torch.bfloat16, device=device)
    return a, b


def sweep_rank(matrix_dim: int, device: torch.device, a: Optional[torch.Tensor] = None,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's four checks in the default process group; returns the
    (n, 4) int32 flag matrix of every rank, all-reduced.

    ``a`` and ``b`` default to :func:`gemm_operands`; the check holds the
    product to ``2*matrix_dim`` whatever was passed."""
    n = dist.get_world_size()
    rank = dist.get_rank()
    if a is None or b is None:
        a, b = gemm_operands(matrix_dim, device)
    me = torch.tensor([rank], dtype=torch.int32, device=device)
    # 1. compute: plain matmul (cuBLAS), exact in bf16 with fp32 accumulation
    c = torch.matmul(a, b).float()
    compute_ok = torch.all(c == 2.0 * matrix_dim)
    # 2. all_reduce of the ranks
    total = me.clone()
    dist.all_reduce(total)
    psum_ok = total[0] == (n * (n - 1)) // 2
    # 3. ring: n hops to the next rank bring every rank its own ordinal back
    token = me.clone()
    if n > 1:
        for _ in range(n):
            recv = torch.empty_like(token)
            ops = [dist.P2POp(dist.isend, token, (rank + 1) % n),
                   dist.P2POp(dist.irecv, recv, (rank - 1) % n)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            token = recv
    ring_ok = token[0] == rank
    # 4. all_gather: every rank sees every ordinal
    gathered = [torch.empty_like(me) for _ in range(n)]
    dist.all_gather(gathered, me)
    gather_ok = torch.all(torch.cat(gathered) ==
                          torch.arange(n, dtype=torch.int32, device=device))
    flags = torch.stack([compute_ok, psum_ok, ring_ok, gather_ok]).to(torch.int32)
    # one-hot row in an (n, 4) matrix, summed over ranks: every rank holds
    # every rank's verdict
    mine = torch.zeros((n, 4), dtype=torch.int32, device=device)
    mine[rank] = flags
    dist.all_reduce(mine)
    return mine


def warm_up(device: torch.device) -> None:
    """Create what the sweep's first call would otherwise create inside the
    timed sweep: the cuBLAS handle and the process group's communicator."""
    x = torch.ones((8, 8), dtype=torch.bfloat16, device=device)
    torch.matmul(x, x)
    dist.all_reduce(torch.zeros(1, device=device))
    synchronize(device)


def build_report(per_chip_results: np.ndarray, local_chips: list, platform: str,
                 elapsed_s: float, compile_s: float) -> IciCheckReport:
    """The report of a finished sweep (built exactly as the TPU sweep's)."""
    n = per_chip_results.shape[0]
    details = {
        name: {"passed": bool(per_chip_results[:, i].all()),
               "failed_chips": [int(c) for c in range(n) if not per_chip_results[c, i]]}
        for i, name in enumerate(CHECK_NAMES)
    }
    failed_global = {c for check in details.values() for c in check["failed_chips"]}
    return IciCheckReport(
        passed=bool(per_chip_results.all()),
        n_devices=n,
        platform=platform,
        elapsed_s=round(elapsed_s, 4),
        compile_s=round(compile_s, 4),
        details=details,
        local_chips=list(local_chips),
        failed_local_chips=[local for local, global_ord in enumerate(local_chips)
                            if global_ord in failed_global],
    )


def _timed_sweep(rank: int, n: int, device: torch.device, t0: float,
                 matrix_dim: int):
    """One rank of the local sweep: (flag matrix, set-up s, elapsed s)."""
    warm_up(device)
    setup = time.perf_counter() - t0
    flags = sweep_rank(matrix_dim, device).cpu().numpy()
    return flags, setup, time.perf_counter() - t0


def ici_health_check(matrix_dim: int = 512, device: DeviceLike = None,
                     world_size: Optional[int] = None) -> IciCheckReport:
    """Run the sweep over this host's devices: one rank per visible GPU
    (``world_size`` of them, default all), or ``world_size`` gloo ranks on
    the host CPU for ``device="cpu"`` (default 1)."""
    dev = resolve_device(device)
    if world_size is None:
        world_size = torch.cuda.device_count() if dev.type == "cuda" else 1
    results = run_ranks(_timed_sweep, world_size, dev.type, args=(matrix_dim,))
    # every rank holds the all-reduced matrix; the slowest rank's clock
    # covers the whole group's set-up and sweep
    return build_report(results[0][0], list(range(world_size)), platform_of(dev),
                        elapsed_s=max(r[2] for r in results),
                        compile_s=max(r[1] for r in results))


def init_method_for(coordinator: str) -> str:
    """``host:port`` means TCP; a URL (``tcp://``, ``file://``) is taken as is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def run_multihost(coordinator: str, num_processes: int, process_id: int,
                  matrix_dim: int = 512, init_timeout: Optional[float] = None,
                  device: DeviceLike = None) -> IciCheckReport:
    """This process as rank ``process_id`` of a ``num_processes``-rank sweep
    that spans hosts, one GPU per rank.

    ``init_timeout`` bounds the rendezvous: a worker that never joins must
    fail this validation closed within the budget, not hang the barrier.
    Raises on rendezvous failure — callers fail closed."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = rank_device("cuda", process_id)
    t0 = time.perf_counter()
    init_group(dev.type, process_id, num_processes, init_method_for(coordinator),
               init_timeout)
    try:
        flags, setup, elapsed = _timed_sweep(process_id, num_processes, dev, t0,
                                             matrix_dim)
    finally:
        dist.destroy_process_group()
    return build_report(flags, [process_id], platform_of(dev),
                        elapsed_s=elapsed, compile_s=setup)
