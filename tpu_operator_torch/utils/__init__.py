"""Helpers of the validator and the operator (counterpart of
tpu_operator/utils/): object helpers (:mod:`.objects`), object hashing
(:mod:`.hash`), the injectable wall clock (:mod:`.clock`), scenario
seeding (:mod:`.seeds`) and the lock factory the race sanitizer sees the
operator through (:mod:`.locks`), plus the CUDA device-order pin every sweep process
gets. Torch-free: the node daemons import it."""

from __future__ import annotations

from typing import MutableMapping

from .. import consts
from .hash import fnv32a, object_hash, template_fingerprint
from .locks import make_lock, make_rlock, register_shared
from .objects import (
    deep_get,
    deep_merge,
    json_merge_patch,
    parse_quantity,
    pod_requests_resource,
    rfc3339_now,
)

__all__ = [
    "deep_get",
    "deep_merge",
    "fnv32a",
    "json_merge_patch",
    "make_lock",
    "make_rlock",
    "object_hash",
    "parse_quantity",
    "pin_device_order",
    "pod_requests_resource",
    "register_shared",
    "rfc3339_now",
    "template_fingerprint",
]


def pin_device_order(env: MutableMapping[str, str]) -> MutableMapping[str, str]:
    """Set ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` in ``env`` unless the caller
    chose an order, and return it. CUDA reads it once, at its first call in
    a process, so a sweep process gets it before it touches CUDA: then
    ordinal ``i`` is the ``i``-th GPU in PCI order, the device plugin's unit
    ``i`` (whose device node is that GPU's minor), and a barrier's failing
    local GPU ``i`` gates the GPU that failed."""
    env.setdefault(consts.CUDA_DEVICE_ORDER_ENV, consts.CUDA_DEVICE_ORDER)
    return env
