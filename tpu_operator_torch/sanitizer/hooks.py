"""Happens-before hooks: thread start/join and ``queue.Queue`` hand-off
(copy of tpu_operator/sanitizer/hooks.py).

The lockset core only sees locks and accesses; the edges that make
Eraser usable on real code — "the parent initialized this before
starting the worker", "the producer built this before queueing it" —
come from here. :func:`install` patches:

* ``threading.Thread.start`` — the parent snapshots its clock
  (:meth:`~.core.OpsanRuntime.fork_vc`) and the child inherits it as its
  first action, via an instance-level ``run`` wrapper (so subclasses
  that override ``run`` are covered without touching their MRO);
* ``threading.Thread.join`` — after the target dies, the joiner absorbs
  the target's final clock;
* ``queue.Queue.put`` / ``get`` — the queue carries a clock: put joins
  the putter's clock into it *before* the item becomes visible, get
  absorbs it after receiving. ``PriorityQueue``/``LifoQueue`` inherit
  these methods, so they are covered too.

Patching is process-global and reversible (:func:`uninstall`, for unit
tests); :func:`ensure_installed` is the idempotent entry point the
:mod:`tpu_operator_torch.utils.locks` factory calls on first use — it also
attaches the seeded perturber when ``GPU_OPERATOR_OPSAN_PERTURB=1`` and
registers the at-exit report dump when ``GPU_OPERATOR_OPSAN_REPORT``
names a directory.
"""

from __future__ import annotations

import atexit
import os
import queue
import threading
from typing import Optional

from .core import (
    OPSAN_REPORT_ENV,
    opsan_perturb_enabled,
    runtime,
)
from .perturb import Perturber

_mu = threading.Lock()
_installed = False
_atexit_registered = False

_orig_start = threading.Thread.start
_orig_join = threading.Thread.join
_orig_put = queue.Queue.put
_orig_get = queue.Queue.get


def _patched_start(self: threading.Thread) -> None:
    parent_vc = runtime().fork_vc()
    inner_run = self.run  # bound method — subclass overrides included

    def _run_with_clock() -> None:
        runtime().begin_thread(parent_vc)
        try:
            inner_run()
        finally:
            runtime().finish_thread(self)

    # instance attribute shadows the class method for this thread only
    self.run = _run_with_clock
    _orig_start(self)


def _patched_join(self: threading.Thread,
                  timeout: Optional[float] = None) -> None:
    _orig_join(self, timeout)
    if not self.is_alive():
        runtime().join_thread(self)


def _patched_put(self: queue.Queue, item, block: bool = True,
                 timeout: Optional[float] = None) -> None:
    # publish the putter's clock before the item becomes visible: a
    # consumer that sees the item must also see everything before put
    runtime().queue_put(self)
    _orig_put(self, item, block, timeout)


def _patched_get(self: queue.Queue, block: bool = True,
                 timeout: Optional[float] = None):
    item = _orig_get(self, block, timeout)
    runtime().queue_get(self)
    return item


def install() -> None:
    """Patch the threading/queue hooks (idempotent)."""
    global _installed
    with _mu:
        if _installed:
            return
        threading.Thread.start = _patched_start
        threading.Thread.join = _patched_join
        queue.Queue.put = _patched_put
        queue.Queue.get = _patched_get
        _installed = True


def uninstall() -> None:
    """Restore the unpatched primitives (unit tests only)."""
    global _installed
    with _mu:
        if not _installed:
            return
        threading.Thread.start = _orig_start
        threading.Thread.join = _orig_join
        queue.Queue.put = _orig_put
        queue.Queue.get = _orig_get
        _installed = False


def _dump_at_exit() -> None:
    directory = os.environ.get(OPSAN_REPORT_ENV)
    if directory:
        runtime().dump(directory)


def ensure_installed() -> None:
    """One-shot opsan bring-up: HB hooks, perturber, at-exit report.

    Called by the :mod:`tpu_operator_torch.utils.locks` factory the first time
    a tracked lock is constructed; safe to call any number of times."""
    global _atexit_registered
    install()
    rt = runtime()
    if rt.perturber is None and opsan_perturb_enabled():
        rt.perturber = Perturber()
    with _mu:
        if not _atexit_registered and os.environ.get(OPSAN_REPORT_ENV):
            atexit.register(_dump_at_exit)
            _atexit_registered = True
