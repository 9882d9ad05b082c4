"""Lock factory: the one seam through which opsan sees the operator's locks
and shared structures (copy of tpu_operator/utils/locks.py).

Every long-lived lock of the operator is built through :func:`make_lock` /
:func:`make_rlock` under its static lock-graph label (``ClassName._attr``,
or ``module._name`` for a module-level lock: exactly what
:meth:`tpu_operator_torch.analysis.graph.LockNode.label` gives, so the
dynamic acquisition graph lines up with ``gpuop-lint``'s static one in the
cross-check). With ``GPU_OPERATOR_OPSAN`` unset they return the raw
``threading`` primitive: no wrapper, no import of the sanitizer package,
nothing paid in production. With ``GPU_OPERATOR_OPSAN=1`` they return a
``TrackedLock`` / ``TrackedRLock`` and install the happens-before hooks on
first use.

The switch is read when the lock is built: a module-level lock is built at
import, so a sanitized process sets the switch before it imports the port.

``gpuop-lint`` knows these names: ``make_lock``/``make_rlock`` are in the
static analyzer's ``LOCK_FACTORIES``, so ``self._lock = make_lock(...)`` is
a lock attribute to the lock graph and the lock-discipline rules exactly as
``threading.Lock()`` is.
"""

from __future__ import annotations

import os
import threading

_OPSAN_ENV = "GPU_OPERATOR_OPSAN"


def opsan_on() -> bool:
    """Whether this process runs under the race sanitizer."""
    return os.environ.get(_OPSAN_ENV) == "1"


def make_lock(name: str):
    """A ``threading.Lock``, tracked when opsan is on.

    ``name`` must be the static lock-graph label, ``ClassName._attr``."""
    if opsan_on():
        # imported here: a production process never loads the sanitizer
        from ..sanitizer import TrackedLock, ensure_installed
        ensure_installed()
        return TrackedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock``, tracked when opsan is on."""
    if opsan_on():
        from ..sanitizer import TrackedRLock, ensure_installed
        ensure_installed()
        return TrackedRLock(name)
    return threading.RLock()


def register_shared(name: str, obj):
    """Register a mutable shared structure with the sanitizer.

    Opsan off: ``obj`` itself, the sanitizer never imported. Opsan on:
    :func:`tpu_operator_torch.sanitizer.registry.register_shared`'s tracked
    proxy, which reports every access to the lockset algorithm. Call it
    again with the replacement when a structure is swapped wholesale (the
    informer's relist, the batcher's flush)."""
    if opsan_on():
        from ..sanitizer import ensure_installed
        from ..sanitizer.registry import register_shared as _register
        ensure_installed()
        return _register(name, obj)
    return obj
