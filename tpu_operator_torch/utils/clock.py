"""Process-wide injectable wall clock (copy of tpu_operator/utils/clock.py).

Reconcilers that take deadlines thread an explicit ``now=`` callable
(MigrationReconciler, AutoscaleReconciler, UpgradeStateMachine,
HealthStateMachine) — that stays the preferred pattern. This module exists
for the handful of *stamp* sites that historically called ``time.time()``
directly (the image-prepull annotation in ``nodeinfo/labeler.py`` being the
canonical one) where threading a parameter through every caller would churn
unrelated signatures. Deterministic harnesses — the crash-soak matrix, the
fleet simulator — pin the source to a virtual clock so stamped values are
byte-identical run-to-run; production never touches it and gets real time.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

_source: Callable[[], float] = time.time


def now() -> float:
    """Current wall-clock time via the active source (defaults to
    ``time.time``)."""
    return _source()


def set_source(source: Optional[Callable[[], float]]) -> Callable[[], float]:
    """Install ``source`` as the process clock (``None`` restores real
    time). Returns the previous source so callers can restore it."""
    global _source
    previous = _source
    _source = source if source is not None else time.time
    return previous


class pinned:
    """Context manager pinning the clock to an injected source::

        with clock.pinned(virtual_clock.now):
            ...   # every clock.now() stamp inside is virtual

    Re-entrant only in the stack discipline sense: the previous source is
    restored on exit, so nested pins unwind correctly.
    """

    def __init__(self, source: Callable[[], float]):
        self._new = source
        self._prev: Optional[Callable[[], float]] = None

    def __enter__(self) -> "pinned":
        self._prev = set_source(self._new)
        return self

    def __exit__(self, *exc) -> None:
        set_source(self._prev)
