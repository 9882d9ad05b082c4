"""opsan: the dynamic lockset race sanitizer of the operator's control plane
(copy of tpu_operator/sanitizer/).

``gpuop-lint``'s static lock graph proves what the *source* promises about
locking; opsan proves what real *executions* deliver. When
``GPU_OPERATOR_OPSAN=1`` the :mod:`tpu_operator_torch.utils.locks` factory
builds :class:`TrackedLock`/:class:`TrackedRLock` in place of
``threading.Lock/RLock`` across the operator, every reconciler registers
its mutable shared structures with :func:`register_shared`, and the
runtime runs the classic Eraser lockset algorithm refined with
happens-before edges (thread start/join, ``queue.Queue`` put/get, lock
release→acquire) so benign initialization and hand-off patterns stay
silent. A seeded schedule perturber (:mod:`.perturb`) widens the
interleavings a soak explores, and :mod:`.crosscheck` diffs the
dynamically observed lock-acquisition graph against ``gpuop-lint``'s static
one (``python -m tpu_operator_torch.cmd.opsan check``).

Environment (each read once, at install time):

* ``GPU_OPERATOR_OPSAN=1``         — enable tracking (the master switch)
* ``GPU_OPERATOR_OPSAN_PERTURB=1`` — enable the schedule perturber
* ``OPSAN_SEED``                   — the perturber's root seed (falls back to
  ``SCENARIO_SEED``, then the pinned default 20260807)
* ``GPU_OPERATOR_OPSAN_REPORT``    — the directory the JSON report is dumped
  into at process exit (one file per process)

Nothing here imports torch: the sanitizer runs in the operator's process.
"""

from .core import (
    OpsanRuntime,
    RaceReport,
    opsan_enabled,
    opsan_perturb_enabled,
    reset_runtime,
    runtime,
)
from .hooks import ensure_installed, install, uninstall
from .locks import TrackedLock, TrackedRLock
from .perturb import Perturber, resolve_opsan_seed
from .registry import register_shared, registered_names

__all__ = [
    "OpsanRuntime",
    "Perturber",
    "RaceReport",
    "TrackedLock",
    "TrackedRLock",
    "ensure_installed",
    "install",
    "opsan_enabled",
    "opsan_perturb_enabled",
    "register_shared",
    "registered_names",
    "reset_runtime",
    "resolve_opsan_seed",
    "runtime",
    "uninstall",
]
