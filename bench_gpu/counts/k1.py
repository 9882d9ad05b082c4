"""K1, the port's streaming copy (``csrc/stream_copy.cu``), as the
certification launches it: an fp32 ``(rows, 1024)`` array, ``rows`` the
configuration's MiB cut to whole 512-row blocks (``perf.stream_rows``)."""

LANES = 1024
BLOCK_ROWS = 512
F32_BYTES = 4


def rows(mib: int) -> int:
    total = mib * 1024 * 1024 // F32_BYTES // LANES
    block = min(BLOCK_ROWS, max(total, 1))
    return total - total % block


def bytes_moved(mib: int) -> float:
    """The array read once and written once."""
    return 2.0 * rows(mib) * LANES * F32_BYTES


def least_seconds(mib: int, flops_per_s: float, bytes_per_s: float) -> tuple:
    """(seconds, bound): a copy does no arithmetic, so bytes bound it."""
    return bytes_moved(mib) / bytes_per_s, "bytes"
