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
in this process as a world of one. :func:`run_multihost` is one node of a
sweep that spans hosts: the same ranks, one per local GPU, in one world
with every other node's.

:func:`spawn_workload_pod` is the deployed form of the check: the
``workload`` component spawns a pod on its own node that requests every
GPU through the device plugin and runs ``workload-local`` inside it.
:func:`prewarm_compile_cache` fills the build cache ahead of the
validations.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import consts
from ..client import is_not_found
from ..device import DeviceLike, platform_of, resolve_device, synchronize
from ..kernels import _build
from ..ranks import DEFAULT_TIMEOUT_S, Rendezvous, join_world, open_store, run_ranks
from ..utils import deep_get


def enable_compilation_cache() -> Optional[str]:
    """The host-path build cache, ``$GPU_COMPILATION_CACHE_DIR``, created if
    missing; None when unset. ``kernels/_build.py`` builds the CUDA sources
    there, so a build outlives the pod that made it (the counterpart of
    pointing XLA's persistent compilation cache at that path)."""
    cache_dir = os.environ.get(consts.COMPILATION_CACHE_DIR_ENV)
    if not cache_dir:
        return None
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:  # the cache is an optimisation, never a failure
        return None
    return cache_dir


def prewarm_compile_cache(device: DeviceLike = None) -> Optional[dict]:
    """Build (never launch) every CUDA source of the port into the build
    cache, so that a later process loads them without ``nvcc``.

    The reference compiles its ICI sweep into XLA's persistent cache here.
    The port's sweep builds nothing that persists: its ``compile_s`` is
    per-process set-up (CUDA context, cuBLAS, NCCL). The port's one
    persistent compile artefact is the ``nvcc`` build of its CUDA sources
    (K1, the streaming copy ``perf`` launches), so that is what is warmed;
    ``perf`` then loads K1 from the cache. Returns ``{"cache_dir",
    "compile_s", "n_devices"}``, or None when no cache dir is configured
    (nothing would persist, so nothing to warm)."""
    cache_dir = enable_compilation_cache()
    if cache_dir is None:
        return None
    dev = resolve_device(device)
    t0 = time.monotonic()
    _build.build_all()
    return {"cache_dir": cache_dir,
            "compile_s": round(time.monotonic() - t0, 4),
            "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1}


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


def local_rank_count(dev: torch.device, requested: Optional[int] = None) -> int:
    """How many ranks this process runs in a sweep that spans hosts: every
    visible GPU on ``cuda`` (any other count is refused, so that no node
    writes a subset sweep as its own), ``requested`` (default 1) gloo ranks
    on the CPU, where each stands in for a GPU."""
    if dev.type == "cuda":
        visible = torch.cuda.device_count()
        if requested is not None and requested != visible:
            raise ValueError(f"{requested} local ranks asked for on a node with {visible} "
                             "visible GPUs: a multi-node sweep covers every GPU")
        return visible
    return 1 if requested is None else requested


def run_multihost(coordinator: str, num_processes: int, process_id: int,
                  matrix_dim: int = 512, init_timeout: Optional[float] = None,
                  device: DeviceLike = None,
                  local_ranks: Optional[int] = None) -> IciCheckReport:
    """This process (one node) as process ``process_id`` of a
    ``num_processes``-process sweep that spans hosts, one rank per local GPU
    (:func:`local_rank_count`), all in one world: the reference's
    ``jax.distributed`` slice with every chip of every host.

    The processes meet at ``coordinator`` (``host:port``, served by process
    0, or a ``file://`` store), trade their local counts and number their
    ranks process by process, so this node's GPUs are contiguous global
    ordinals (``local_chips``). ``init_timeout`` bounds the rendezvous: a
    worker that never joins must fail this validation closed within the
    budget, not hang the barrier. Raises on rendezvous failure — callers
    fail closed."""
    dev = resolve_device(device)
    n_local = local_rank_count(dev, local_ranks)
    url = init_method_for(coordinator)
    store = open_store(url, serve=process_id == 0, timeout_s=init_timeout)
    first, world = join_world(store, num_processes, process_id, n_local, init_timeout)
    results = run_ranks(_timed_sweep, n_local, dev.type, args=(matrix_dim,),
                        timeout_s=DEFAULT_TIMEOUT_S + (init_timeout or 0.0),
                        rendezvous=Rendezvous(url, first, world, init_timeout), store=store)
    # every rank holds the all-reduced matrix; this node's slowest rank's
    # clock covers its share of the set-up and the sweep
    return build_report(results[0][0], list(range(first, first + n_local)), platform_of(dev),
                        elapsed_s=max(r[2] for r in results),
                        compile_s=max(r[1] for r in results))


# -- pod-spawning mode: a validation pod on this node, through the device plugin

WORKLOAD_POD_TEMPLATE = {
    "apiVersion": "v1",
    "kind": "Pod",
    "metadata": {"name": "gpu-workload-validation", "labels": {"app": "gpu-workload-validation"}},
    "spec": {
        "restartPolicy": "Never",
        "tolerations": [{"key": consts.GPU_RESOURCE_NAME, "operator": "Exists",
                         "effect": "NoSchedule"}],
        "containers": [{
            "name": "gpu-workload",
            "image": "FILLED_BY_VALIDATOR",
            "command": ["gpu-validator"],
            "args": ["-c", "workload-local"],
            "resources": {"limits": {consts.GPU_RESOURCE_NAME: "FILLED_BY_VALIDATOR"}},
            # the status hostPath rides along so the in-pod sweep writes the
            # DETAILED barrier (per-GPU failed_chips) straight to the host —
            # the spawner only has a pass/fail pod phase; its ordinals are
            # in PCI order, as the device plugin's units are
            "env": [{"name": "STATUS_DIR", "value": "FILLED_BY_VALIDATOR"},
                    {"name": consts.CUDA_DEVICE_ORDER_ENV, "value": consts.CUDA_DEVICE_ORDER}],
            "volumeMounts": [{"name": "validation-status",
                              "mountPath": "FILLED_BY_VALIDATOR"}],
        }],
        "volumes": [{"name": "validation-status",
                     "hostPath": {"path": "FILLED_BY_VALIDATOR",
                                  "type": "DirectoryOrCreate"}}],
    },
}


def _delete_pod(client, name: str, namespace: str) -> None:
    try:
        client.delete("v1", "Pod", name, namespace)
    except Exception as e:
        if not is_not_found(e):
            raise


def spawn_workload_pod(client, namespace: str, node_name: str, image: str,
                       resource_name: str = consts.GPU_RESOURCE_NAME,
                       chips: Optional[int] = None, timeout: float = 300.0,
                       poll: float = 1.0, status_dir: Optional[str] = None) -> Optional[bool]:
    """Create a validation pod pinned to this node that requests every
    allocatable GPU through the device plugin, and wait for it to finish.

    Returns True on Succeeded, False when the pod RAN and Failed (a real
    sweep verdict), None on timeout (never scheduled / image trouble — not
    a verdict about the GPUs). The pod is deleted afterwards either way."""
    if chips is None:
        node = client.get("v1", "Node", node_name)
        chips = int(deep_get(node, "status", "allocatable", resource_name,
                             default=deep_get(node, "status", "capacity", resource_name,
                                              default=1)))
    pod = copy.deepcopy(WORKLOAD_POD_TEMPLATE)
    name = f"gpu-workload-validation-{node_name}"[:63]
    pod["metadata"]["namespace"] = namespace
    pod["metadata"]["name"] = name
    pod["spec"]["nodeName"] = node_name
    status_dir = status_dir or consts.VALIDATION_STATUS_DIR
    pod["spec"]["volumes"][0]["hostPath"]["path"] = status_dir
    ctr = pod["spec"]["containers"][0]
    ctr["image"] = image
    ctr["resources"]["limits"] = {resource_name: str(chips)}
    ctr["env"][0]["value"] = status_dir
    ctr["volumeMounts"][0]["mountPath"] = status_dir
    # the node's build cache rides along, so the pod's sweep and perf load
    # the kernels a prewarm built instead of running nvcc
    cache_dir = os.environ.get(consts.COMPILATION_CACHE_DIR_ENV)
    if cache_dir:
        ctr["env"].append({"name": consts.COMPILATION_CACHE_DIR_ENV, "value": cache_dir})
        ctr["volumeMounts"].append({"name": "kernel-cache", "mountPath": cache_dir})
        pod["spec"]["volumes"].append({
            "name": "kernel-cache",
            "hostPath": {"path": cache_dir, "type": "DirectoryOrCreate"}})

    _delete_pod(client, name, namespace)
    client.create(pod)
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            live = client.get("v1", "Pod", name, namespace)
            phase = deep_get(live, "status", "phase")
            if phase == "Succeeded":
                return True
            if phase == "Failed":
                return False
            time.sleep(poll)
        return None
    finally:
        _delete_pod(client, name, namespace)
