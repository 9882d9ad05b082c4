"""One ``torch.distributed`` rank per device.

NCCL wants one process per GPU, where JAX drove every local chip from one
process. :func:`run_ranks` runs ``target`` as ``n`` local ranks of one
process group: in this process when ``n == 1`` (NCCL is still initialised,
through a 1-rank group), else in ``n`` spawned workers. Local rank ``i``
gets ``cuda:i`` on the card, or the host CPU (gloo) when ``device_type ==
"cpu"``; every worker runs with ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` unless its
parent chose an order.

By default the ranks are the whole world and meet through a private
``file://`` store. A group that spans hosts (:class:`Rendezvous`) is one
world of every process's local ranks: the processes open one store
(``tcp://`` served by process 0, or ``file://``), trade their local counts
through it (:func:`join_world`) and number their ranks process by process,
as JAX orders the devices of a multi-process run.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
import urllib.parse
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from .device import set_numerics
from .utils import pin_device_order

#: default budget for the workers of one run_ranks call, rendezvous included
DEFAULT_TIMEOUT_S = 300.0
#: the store key under which each process of a group posts its local count
LOCAL_COUNT_KEY = "local-ranks"


@dataclasses.dataclass(frozen=True)
class Rendezvous:
    """Where the ranks of a group meet, and this process's share of them:
    global ranks ``first_rank`` to ``first_rank + n - 1`` of ``world_size``.
    ``url`` is the store every rank opens: ``tcp://host:port`` (served by
    process 0) or ``file:///path``."""

    url: str
    first_rank: int
    world_size: int
    timeout_s: Optional[float] = None


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """This process's ``local_rank``-th GPU (never a global rank folded onto
    the GPUs); the host CPU for ``device_type == "cpu"``."""
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if not 0 <= local_rank < count:
            raise RuntimeError(f"local rank {local_rank} has no GPU: {count} visible")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        set_numerics()
        return dev
    return torch.device("cpu")


def open_store(url: str, serve: bool = False,
               timeout_s: Optional[float] = None) -> dist.Store:
    """The store at ``url``: ``tcp://host:port`` (``serve`` makes this
    process its server) or ``file:///path``. ``timeout_s`` bounds every wait
    on it (:data:`DEFAULT_TIMEOUT_S` when None)."""
    timeout = datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S)
    parsed = urllib.parse.urlparse(url)
    if parsed.scheme == "tcp":
        return dist.TCPStore(parsed.hostname, parsed.port, is_master=serve,
                             timeout=timeout, wait_for_workers=False)
    if parsed.scheme == "file":
        store = dist.FileStore(parsed.path, -1)
        store.set_timeout(timeout)
        return store
    raise ValueError(f"unsupported rendezvous {url!r}: tcp://host:port or file:///path")


def join_world(store: dist.Store, num_processes: int, process_id: int, n_local: int,
               timeout_s: Optional[float] = None) -> Tuple[int, int]:
    """(first global rank of this process, world size): every process posts
    its local count and waits for the others', and the ranks are numbered
    process by process (the counts' prefix sums), so nodes with different
    GPU counts still make one world. Raises when a process has not posted
    within ``timeout_s`` (:data:`DEFAULT_TIMEOUT_S` when None)."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    if n_local < 1:
        raise ValueError(f"a process needs at least one local rank, got {n_local}")
    keys = [f"{LOCAL_COUNT_KEY}/{p}" for p in range(num_processes)]
    store.set(keys[process_id], str(n_local))
    store.wait(keys, datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S))
    counts = [int(store.get(k)) for k in keys]
    return sum(counts[:process_id]), sum(counts)


def init_group(device_type: str, rank: int, world_size: int,
               store: Optional[dist.Store] = None,
               timeout_s: Optional[float] = None) -> None:
    """Join the default process group through ``store``; a world of one
    meets in memory."""
    kwargs = {}
    if timeout_s:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if store is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs a store")
        store = dist.HashStore()
    dist.init_process_group(backend_for(device_type), world_size=world_size,
                            rank=rank, store=store, **kwargs)


def _rank_main(target, local, device_type, rendezvous, args, results):
    pin_device_order(os.environ)  # before this worker's first CUDA call
    try:
        device = rank_device(device_type, local)
        t0 = time.perf_counter()
        store = open_store(rendezvous.url, timeout_s=rendezvous.timeout_s)
        init_group(device_type, rendezvous.first_rank + local, rendezvous.world_size,
                   store, rendezvous.timeout_s)
        try:
            out = target(rendezvous.first_rank + local, rendezvous.world_size, device, t0,
                         *args)
        finally:
            dist.destroy_process_group()
        results.put((local, None, out))
    except BaseException:  # reported to the parent, which raises
        results.put((local, traceback.format_exc(), None))


def run_ranks(target: Callable[..., Any], n: int, device_type: str,
              args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S,
              rendezvous: Optional[Rendezvous] = None,
              store: Optional[dist.Store] = None) -> List[Any]:
    """``[target(rank, world_size, device, t0, *args) for each local rank]``,
    in local order.

    Without ``rendezvous`` the ``n`` ranks are the whole world. With it they
    are global ranks ``rendezvous.first_rank`` onwards of a group that other
    processes share; ``store`` is this process's open handle on
    ``rendezvous.url`` (a world of one local rank joins through it in this
    process). ``t0`` is the ``perf_counter`` reading taken just before the
    rank joined the group, so a target can time its own set-up. ``target``
    must be a module-level function (workers are spawned, not forked, and
    import it). Raises if any rank raised or the ranks did not all report
    within ``timeout_s``."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    if device_type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"{n} ranks need {n} GPUs, have {torch.cuda.device_count()}")
    if n == 1:
        device = rank_device(device_type, 0)
        rank, world = (0, 1) if rendezvous is None else (rendezvous.first_rank,
                                                         rendezvous.world_size)
        if rendezvous is not None and store is None:
            store = open_store(rendezvous.url, timeout_s=rendezvous.timeout_s)
        t0 = time.perf_counter()
        init_group(device_type, rank, world, store,
                   None if rendezvous is None else rendezvous.timeout_s)
        try:
            return [target(rank, world, device, t0, *args)]
        finally:
            dist.destroy_process_group()

    ctx = multiprocessing.get_context("spawn")
    private = None
    if rendezvous is None:
        private = tempfile.mkdtemp(prefix="tpuop-torch-ranks-")
        rendezvous = Rendezvous("file://" + os.path.join(private, "store"), 0, n, timeout_s)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, r, device_type, rendezvous, args, results))
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
                raise RuntimeError(f"local rank {rank} failed:\n{err}")
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
        if private is not None:
            shutil.rmtree(private, ignore_errors=True)
