"""Entry points of the GPU health math (counterpart of __graft_entry__.py).

``entry`` is the single-GPU compute check; ``dryrun_multichip`` runs the
slice-wide validation step over an n-rank ("host", "chip") device mesh with
tensor-parallel (all_reduce over the contraction axis), data-parallel
(mean over hosts), ring (send/recv over every rank) and broadcast
(all_gather) collectives, one rank per GPU.

``python -m tpu_operator_torch.graft_entry`` runs both (the counterpart of
``python __graft_entry__.py``): the check on the card, then the dry run
over every visible GPU; ``--device=cpu`` runs them on the host, the dry
run over :data:`CPU_RANKS` gloo ranks.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from .device import DeviceLike, resolve_device
from .ranks import run_ranks


def entry(device: DeviceLike = None):
    """(health_forward, (a, b)): the single-GPU compute-check step."""
    dev = resolve_device(device)
    dim = 512

    def health_forward(a, b):
        # bf16 operands, fp32 accumulation AND fp32 result (JAX's
        # preferred_element_type=float32): a bf16 result would round a
        # one-element error (1022) back to 1024 and hide it
        c = torch.matmul(a.float(), b.float())
        expected = 2.0 * dim
        checks = torch.stack([
            torch.all(c == expected),      # every element exact
            torch.isfinite(c).all(),       # no NaN/Inf from a sick card
        ])
        return c, checks

    a = torch.ones((dim, dim), dtype=torch.bfloat16, device=dev)
    b = torch.full((dim, dim), 2, dtype=torch.bfloat16, device=dev)
    return health_forward, (a, b)


#: the dry run's ranks on the CPU: the reference's graft check's virtual devices
CPU_RANKS = 8


def _mesh_factors(n_devices: int) -> tuple:
    """(n_host, n_chip) — the squarest host x chip factorization
    (16 -> (4, 4), 8 -> (4, 2), 4 -> (2, 2))."""
    n_chip = max(f for f in range(1, int(n_devices ** 0.5) + 1)
                 if n_devices % f == 0)
    return n_devices // n_chip, n_chip


def _step(rank: int, n: int, device: torch.device, t0: float) -> None:
    """One rank of the mesh step; asserts what the TPU dry run asserts."""
    from torch.distributed.device_mesh import init_device_mesh

    n_host, n_chip = _mesh_factors(n)
    mesh = init_device_mesh(device.type, (n_host, n_chip), mesh_dim_names=("host", "chip"))
    chip_group, host_group = mesh.get_group("chip"), mesh.get_group("host")
    batch, dim = 4 * n_host, 8 * n_chip
    # this rank's shards: x (batch/host, dim/chip), w (dim/chip, dim)
    x = torch.ones((batch // n_host, dim // n_chip), dtype=torch.float32, device=device)
    w = torch.ones((dim // n_chip, dim), dtype=torch.float32, device=device)
    me = torch.tensor([rank], dtype=torch.int32, device=device)

    # tensor parallel: contraction over the sharded dim -> sum over chip
    # bf16 operands, fp32 products and sums (see entry)
    y = torch.matmul(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float())
    dist.all_reduce(y, group=chip_group)
    # data parallel: batch-mean over hosts
    mean = y.sum().reshape(1)
    dist.all_reduce(mean, group=host_group)
    mean /= n_host
    # ring over every rank: chip axis fast, host axis slow (rank-major mesh)
    flat = me.clone()
    if n > 1:
        for _ in range(n):
            recv = torch.empty_like(flat)
            ops = [dist.P2POp(dist.isend, flat, (rank + 1) % n),
                   dist.P2POp(dist.irecv, recv, (rank - 1) % n)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            flat = recv
    ring_ok = flat == me
    gathered = [torch.empty_like(me) for _ in range(n)]
    dist.all_gather(gathered, me)
    gather_ok = torch.all(torch.sort(torch.cat(gathered)).values ==
                          torch.arange(n, dtype=torch.int32, device=device)).reshape(1)
    flags = torch.stack([ring_ok, gather_ok], dim=1).to(torch.int32)  # (1, 2)
    # out_specs: y is (batch, dim) assembled over hosts, flags over all ranks
    y_parts = [torch.empty_like(y) for _ in range(n_host)]
    dist.all_gather(y_parts, y, group=host_group)
    y_full = torch.cat(y_parts)
    flag_parts = [torch.empty_like(flags) for _ in range(n)]
    dist.all_gather(flag_parts, flags)
    all_flags = torch.cat(flag_parts)

    assert y_full.shape == (batch, dim)
    assert torch.all(y_full == dim), f"tensor-parallel sum wrong: {y_full[0, :4]}"
    assert mean.item() == batch // n_host * dim * dim, f"data-parallel mean wrong: {mean}"
    assert all_flags.all(), f"ring/all_gather failed: {all_flags}"


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """Run the multi-GPU validation step once over an n-rank mesh at tiny
    shapes: one rank per GPU, or n gloo ranks on the CPU for ``device="cpu"``.
    Raises if any rank's assertion fails."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"need {n_devices} devices, have {torch.cuda.device_count()}")
    run_ranks(_step, n_devices, dev.type)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpu_operator_torch.graft_entry")
    p.add_argument("--device", default="cuda", help="cuda (the card), or cpu for tests")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    fn, fn_args = entry(dev)
    out, checks = fn(*fn_args)
    print("entry ok:", bool(checks.all()), tuple(out.shape))
    if not checks.all():
        return 1
    n = torch.cuda.device_count() if dev.type == "cuda" else CPU_RANKS
    dryrun_multichip(n, dev)
    print(f"dryrun_multichip({n}) ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
