"""The certification's GEMM: a bf16 ``dim x dim`` by ``dim x dim`` product
with an fp32 accumulator and a bf16 result (``perf.measure_mxu_tflops``)."""

BF16_BYTES = 2


def flops(dim: int) -> float:
    """Multiply-adds of one product, two operations each."""
    return 2.0 * dim ** 3


def bytes_moved(dim: int) -> float:
    """Each operand read once and the result written once."""
    return 3.0 * dim * dim * BF16_BYTES


def least_seconds(dim: int, flops_per_s: float, bytes_per_s: float) -> tuple:
    """(seconds, bound): the larger of the compute and the memory time."""
    compute, memory = flops(dim) / flops_per_s, bytes_moved(dim) / bytes_per_s
    return (compute, "flops") if compute >= memory else (memory, "bytes")
