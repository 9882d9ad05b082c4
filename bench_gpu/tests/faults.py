"""Faults planted in the program under a run of the harness: each has to
turn ``correct`` false. Module-level, so that spawned ranks can unpickle
them."""

from __future__ import annotations

import dataclasses

import torch

PERF = "tpu_operator_torch.validator.perf"


def state_unchanged(x):
    """The HBM probe's step returns its state unchanged: no work done."""
    return x


def half_batch(x):
    """The HBM probe's step does half the array and leaves the rest unset,
    while the reading still counts every byte."""
    from tpu_operator_torch.validator import perf

    out = torch.empty_like(x)
    half = x.numel() // 2
    torch.add(perf._PROBE_ONE, x[:half], alpha=1.0001, out=out[:half])
    return out


def altered_answer(original):
    """The report's GEMM reading altered where it is made: 1.3 times the
    measured TFLOP/s, still under the card's peak, so the program's own
    gates pass it."""
    def run_perf(*args, **kwargs):
        report = original(*args, **kwargs)
        report = dataclasses.replace(report, mxu_tflops=report.mxu_tflops * 1.3)
        if report.mxu_peak_fraction is not None:
            report.mxu_peak_fraction = report.mxu_peak_fraction * 1.3
        return report
    return run_perf


def no_exchange_rank(rank, n, device, t0, mib, iters, growth_budget_s):
    """One rank of the all-reduce sweep with the exchange left out: the
    payload's all-reduce returns at once; the ranks' small agreements
    still run, so the sweep completes and reports."""
    import torch.distributed as dist

    from tpu_operator_torch.validator import perf

    real = dist.all_reduce

    def all_reduce(tensor, *args, **kwargs):
        if tensor.numel() > 3:
            return None
        return real(tensor, *args, **kwargs)

    dist.all_reduce = all_reduce
    return perf._allreduce_rank(rank, n, device, t0, mib, iters, growth_budget_s)
