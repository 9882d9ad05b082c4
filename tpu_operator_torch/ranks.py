"""One ``torch.distributed`` rank per device.

NCCL wants one process per GPU, where JAX drove every local chip from one
process. :func:`run_ranks` runs ``target`` as ``n`` ranks of one process
group: in this process as a world of one when ``n == 1`` (NCCL is still
initialised, through a 1-rank group), else in ``n`` spawned workers that
meet through a ``file://`` store. Rank ``r`` gets ``cuda:r`` on the card,
or the host CPU (gloo) when ``device_type == "cpu"``; every worker runs
with ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` unless its parent chose an order.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from .device import set_numerics
from .utils import pin_device_order

#: default budget for the workers of one run_ranks call, rendezvous included
DEFAULT_TIMEOUT_S = 300.0


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(device_type: str, rank: int) -> torch.device:
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        set_numerics()
        return dev
    return torch.device("cpu")


def init_group(device_type: str, rank: int, world_size: int,
               init_method: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
    """Join the default process group; a world of one meets in memory."""
    kwargs = {}
    if timeout_s:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs an init_method")
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = init_method
    dist.init_process_group(backend_for(device_type), world_size=world_size,
                            rank=rank, **kwargs)


def _rank_main(target, rank, n, device_type, init_method, timeout_s, args, results):
    pin_device_order(os.environ)  # before this worker's first CUDA call
    try:
        device = rank_device(device_type, rank)
        t0 = time.perf_counter()
        init_group(device_type, rank, n, init_method, timeout_s)
        try:
            out = target(rank, n, device, t0, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, traceback.format_exc(), None))


def run_ranks(target: Callable[..., Any], n: int, device_type: str,
              args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """``[target(rank, n, device, t0, *args) for each rank]``, in rank order.

    ``t0`` is the ``perf_counter`` reading taken just before the rank joined
    the group, so a target can time its own set-up. ``target`` must be a
    module-level function (workers are spawned, not forked, and import it).
    Raises if any rank raised or the ranks did not all report within
    ``timeout_s``."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    if device_type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"{n} ranks need {n} GPUs, have {torch.cuda.device_count()}")
    if n == 1:
        device = rank_device(device_type, 0)
        t0 = time.perf_counter()
        init_group(device_type, 0, 1)
        try:
            return [target(0, 1, device, t0, *args)]
        finally:
            dist.destroy_process_group()

    ctx = multiprocessing.get_context("spawn")
    rendezvous = tempfile.mkdtemp(prefix="tpuop-torch-ranks-")
    init_method = "file://" + os.path.join(rendezvous, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, r, n, device_type, init_method, timeout_s,
                               args, results))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        got = {}
        # drain the queue before joining: a worker blocks in exit until
        # its queued result is read
        while len(got) < n:
            remaining = deadline - time.monotonic()
            try:
                rank, err, out = results.get(timeout=min(max(remaining, 0.01), 1.0))
            except queue_mod.Empty:
                missing = sorted(set(range(n)) - set(got))
                crashed = [r for r in missing if procs[r].exitcode not in (None, 0)]
                if crashed:
                    raise RuntimeError(f"ranks {crashed} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in crashed]})"
                                       ) from None
                if remaining <= 0:
                    raise TimeoutError(f"ranks {missing} did not report within "
                                       f"{timeout_s}s") from None
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(rendezvous, ignore_errors=True)
