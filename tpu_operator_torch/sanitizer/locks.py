"""Drop-in instrumented locks (copy of tpu_operator/sanitizer/locks.py).

:class:`TrackedLock`/:class:`TrackedRLock` wrap the real ``threading``
primitives — same blocking semantics, same API surface — and report
acquire/release to the opsan runtime: per-thread held-set maintenance,
dynamic acquisition-graph edges (acquired-while-holding), the
release→acquire happens-before edge, and perturbation points at both
boundaries. They are only ever constructed through the
:mod:`tpu_operator_torch.utils.locks` factory, which degrades to the raw
primitives when ``GPU_OPERATOR_OPSAN`` is off — production pays nothing.

An RLock's re-entrant acquires/releases are tracked only at the
outermost level: nesting the same lock is not an acquisition-order edge
and must not double-count the held set.
"""

from __future__ import annotations

import threading

from .core import caller_site, runtime


class TrackedLock:
    """Instrumented ``threading.Lock``."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        rt = runtime()
        perturber = rt.perturber
        if perturber is not None:
            perturber.point("acquire")
        got = self._inner.acquire(blocking, timeout)
        if got:
            rt.lock_acquired(self.name, caller_site())
        return got

    def release(self) -> None:
        runtime().lock_released(self.name)
        self._inner.release()
        perturber = runtime().perturber
        if perturber is not None:
            perturber.point("release")

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.name} {self._inner!r}>"


class TrackedRLock:
    """Instrumented ``threading.RLock`` (outermost-level tracking)."""

    __slots__ = ("name", "_inner", "_owner", "_depth")

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.RLock()
        self._owner: int | None = None
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        rt = runtime()
        ident = threading.get_ident()
        reentrant = self._owner == ident
        if not reentrant:
            perturber = rt.perturber
            if perturber is not None:
                perturber.point("acquire")
        got = self._inner.acquire(blocking, timeout)
        if got:
            # _owner/_depth are only touched by the thread that holds
            # _inner, so they need no extra guard
            self._owner = ident
            self._depth += 1
            if self._depth == 1:
                rt.lock_acquired(self.name, caller_site())
        return got

    def release(self) -> None:
        if self._owner != threading.get_ident():
            raise RuntimeError("cannot release un-acquired TrackedRLock")
        outermost = self._depth == 1
        if outermost:
            runtime().lock_released(self.name)
            self._owner = None
        self._depth -= 1
        self._inner.release()
        if outermost:
            perturber = runtime().perturber
            if perturber is not None:
                perturber.point("release")

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedRLock {self.name} depth={self._depth}>"
