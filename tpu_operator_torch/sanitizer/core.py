"""opsan runtime: vector clocks, locksets, the dynamic lock graph, and
race reports (copy of tpu_operator/sanitizer/core.py).

The algorithm is Eraser's lockset state machine (Savage et al., SOSP '97)
per tracked variable — VIRGIN → EXCLUSIVE → SHARED → SHARED_MODIFIED,
with the candidate lockset ``C(v)`` intersected against the accessing
thread's held set on every shared access and a race reported the moment
``C(v)`` empties in SHARED_MODIFIED — refined with a vector-clock
happens-before relation so the two patterns Eraser false-positives on
stay silent:

* **initialization**: a structure built single-threaded and only then
  published (thread start carries the parent's clock, so the child's
  first access happens-after every init write);
* **hand-off**: ownership transferred through ``queue.Queue`` put/get or
  a lock release→acquire pair — when a *different* thread's access
  happens-after every prior access, the variable re-enters EXCLUSIVE
  under the new owner with a fresh (unconstrained) lockset instead of
  going SHARED.

HB edges are deliberately the only refinement: the lockset core stays
schedule-insensitive (a missing lock is flagged on the interleaving that
*didn't* bite, which is the whole point over a pure happens-before
detector), and the perturber widens schedules so hand-off edges that
merely happened to be ordered get re-examined across seeds.

Everything the runtime owns is guarded by one internal raw
``threading.Lock`` (never a TrackedLock — the sanitizer must not
sanitize itself); user callbacks and perturbation sleeps run outside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

OPSAN_ENV = "GPU_OPERATOR_OPSAN"
OPSAN_PERTURB_ENV = "GPU_OPERATOR_OPSAN_PERTURB"
OPSAN_REPORT_ENV = "GPU_OPERATOR_OPSAN_REPORT"

#: lockset state machine states (Eraser fig. 4)
VIRGIN, EXCLUSIVE, SHARED, SHARED_MODIFIED = (
    "virgin", "exclusive", "shared", "shared-modified")

_SANITIZER_DIR = os.path.dirname(os.path.abspath(__file__))


def opsan_enabled() -> bool:
    return os.environ.get(OPSAN_ENV) == "1"


def opsan_perturb_enabled() -> bool:
    return os.environ.get(OPSAN_PERTURB_ENV) == "1"


# -- vector clocks ------------------------------------------------------------

def vc_join(dst: Dict[str, int], src: Dict[str, int]) -> None:
    for key, val in src.items():
        if val > dst.get(key, 0):
            dst[key] = val


def vc_leq(a: Dict[str, int], b: Dict[str, int]) -> bool:
    """a happens-before-or-equals b (pointwise <=)."""
    return all(b.get(key, 0) >= val for key, val in a.items())


def caller_site(skip_dirs: Tuple[str, ...] = (_SANITIZER_DIR,)) -> str:
    """``relpath:lineno`` of the nearest caller frame outside the
    sanitizer package — the access/acquisition site a report names. The
    path is cut at the last ``tpu_operator_torch/`` or ``tests/`` in it."""
    frame = sys._getframe(1)
    while frame is not None:
        fname = frame.f_code.co_filename
        if not any(fname.startswith(d) for d in skip_dirs):
            short = fname
            for marker in ("tpu_operator_torch", "tests"):
                idx = fname.rfind(os.sep + marker + os.sep)
                if idx >= 0:
                    short = fname[idx + 1:].replace(os.sep, "/")
                    break
            return f"{short}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


# -- per-thread / per-variable state ------------------------------------------

class _ThreadState:
    __slots__ = ("label", "vc", "held")

    def __init__(self, label: str):
        self.label = label
        self.vc: Dict[str, int] = {label: 1}
        #: lock names in acquisition order (outermost first)
        self.held: List[str] = []


class _VarState:
    __slots__ = ("name", "state", "owner", "lockset", "last_vc",
                 "last_site", "last_thread", "reported", "accesses")

    def __init__(self, name: str):
        self.name = name
        self.state = VIRGIN
        self.owner: Optional[str] = None
        #: candidate locks; None means "unconstrained" (no shared access
        #: has refined it yet — the EXCLUSIVE phases never constrain)
        self.lockset: Optional[Set[str]] = None
        self.last_vc: Dict[str, int] = {}
        self.last_site = ""
        self.last_thread = ""
        self.reported = False
        self.accesses = 0


@dataclasses.dataclass
class RaceReport:
    """One unsynchronized shared-modified access: ``C(v)`` emptied."""

    var: str
    site: str
    thread: str
    held: List[str]
    prior_site: str
    prior_thread: str
    kind: str  # "write" or "read"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        held = ", ".join(self.held) if self.held else "no locks"
        return (f"data race on {self.var}: {self.kind} at {self.site} "
                f"({self.thread}, holding {held}) unordered with prior "
                f"access at {self.prior_site} ({self.prior_thread}); "
                f"candidate lockset is empty")


class OpsanRuntime:
    """Process-wide sanitizer state. One instance per process (module
    global via :func:`runtime`); tests swap in a fresh one with
    :func:`reset_runtime`."""

    def __init__(self, perturber=None):
        self._mu = threading.Lock()  # raw on purpose: see module docstring
        self._threads: Dict[int, _ThreadState] = {}
        self._thread_seq = 0
        self._vars: Dict[str, _VarState] = {}
        self._var_seq: Dict[str, int] = {}
        #: lock name -> VC carried across release→acquire
        self._lock_vcs: Dict[str, Dict[str, int]] = {}
        #: dynamic acquisition graph: (held, acquired) -> first sample site
        self._edges: Dict[Tuple[str, str], str] = {}
        self._lock_names: Set[str] = set()
        self.races: List[RaceReport] = []
        self.accesses_total = 0
        #: suppressed variable-name prefixes -> rationale (mirrors the
        #: gpuop-lint inline-suppression contract: say WHY)
        self._suppressed: Dict[str, str] = {}
        #: hooks (wired by OperatorMetrics.wire_opsan); never raise
        self.on_race: Optional[Callable[[RaceReport], None]] = None
        self.on_access: Optional[Callable[[], None]] = None
        self.perturber = perturber

    # -- thread lifecycle -----------------------------------------------------

    def _thread_state_locked(self) -> _ThreadState:
        ident = threading.get_ident()
        ts = self._threads.get(ident)
        if ts is None:
            self._thread_seq += 1
            label = f"t{self._thread_seq}:{threading.current_thread().name}"
            ts = _ThreadState(label)
            self._threads[ident] = ts
        return ts

    def fork_vc(self) -> Dict[str, int]:
        """Called by the patched ``Thread.start`` in the parent: tick the
        parent's clock and snapshot it for the child to inherit."""
        with self._mu:
            ts = self._thread_state_locked()
            ts.vc[ts.label] = ts.vc.get(ts.label, 0) + 1
            return dict(ts.vc)

    def begin_thread(self, parent_vc: Optional[Dict[str, int]]) -> None:
        """First thing the child runs: inherit the parent's clock (the
        start edge — init writes happen-before everything the child does)."""
        with self._mu:
            ts = self._thread_state_locked()
            if parent_vc:
                vc_join(ts.vc, parent_vc)

    def finish_thread(self, thread) -> None:
        """Last thing the child runs: publish its final clock for join."""
        with self._mu:
            ts = self._threads.pop(threading.get_ident(), None)
            if ts is not None:
                thread.__dict__["_opsan_final_vc"] = dict(ts.vc)

    def join_thread(self, thread) -> None:
        """Called by the patched ``Thread.join`` in the joiner after the
        target died: everything the target did happens-before here."""
        final = thread.__dict__.get("_opsan_final_vc")
        if final is None:
            return
        with self._mu:
            ts = self._thread_state_locked()
            vc_join(ts.vc, final)

    # -- queue hand-off edges -------------------------------------------------

    def queue_put(self, q) -> None:
        """put edge: the queue's clock absorbs the putter's (conservative:
        per-queue, not per-item — extra HB edges can only hide races, never
        invent them, and the perturber re-explores across seeds)."""
        with self._mu:
            ts = self._thread_state_locked()
            qvc = q.__dict__.setdefault("_opsan_vc", {})
            vc_join(qvc, ts.vc)
            ts.vc[ts.label] = ts.vc.get(ts.label, 0) + 1

    def queue_get(self, q) -> None:
        with self._mu:
            ts = self._thread_state_locked()
            qvc = q.__dict__.get("_opsan_vc")
            if qvc:
                vc_join(ts.vc, qvc)

    # -- lock events (TrackedLock/TrackedRLock call these) --------------------

    def lock_acquired(self, name: str, site: str) -> None:
        with self._mu:
            ts = self._thread_state_locked()
            self._lock_names.add(name)
            for held in ts.held:
                if held != name and (held, name) not in self._edges:
                    self._edges[(held, name)] = site
            ts.held.append(name)
            # release→acquire HB edge: the previous holder's critical
            # section happens-before this one
            lvc = self._lock_vcs.get(name)
            if lvc:
                vc_join(ts.vc, lvc)

    def lock_released(self, name: str) -> None:
        with self._mu:
            ts = self._thread_state_locked()
            for i in range(len(ts.held) - 1, -1, -1):
                if ts.held[i] == name:
                    del ts.held[i]
                    break
            ts.vc[ts.label] = ts.vc.get(ts.label, 0) + 1
            lvc = self._lock_vcs.setdefault(name, {})
            vc_join(lvc, ts.vc)

    def held_locks(self) -> List[str]:
        with self._mu:
            return list(self._thread_state_locked().held)

    # -- variable registry ----------------------------------------------------

    def unique_var_name(self, name: str) -> str:
        """Stable-per-run unique id for a registered structure: the first
        registration of ``name`` keeps it verbatim, later ones (an object
        re-registered after a wholesale swap, or a second instance) get
        ``name#<n>``. Reports stay greppable by prefix."""
        with self._mu:
            n = self._var_seq.get(name, 0)
            self._var_seq[name] = n + 1
            return name if n == 0 else f"{name}#{n}"

    def suppress(self, prefix: str, reason: str) -> None:
        """Silence race reports on variables whose name starts with
        ``prefix``. The rationale is mandatory and lands in the report so
        a suppression is as auditable as a gpuop-lint baseline entry."""
        if not reason.strip():
            raise ValueError("opsan suppression requires a rationale")
        with self._mu:
            self._suppressed[prefix] = reason

    # -- the lockset algorithm ------------------------------------------------

    def access(self, var: str, write: bool, site: Optional[str] = None) -> None:
        """Record one read/write of a tracked variable by this thread."""
        perturber = self.perturber
        if perturber is not None:
            perturber.point("access")
        report: Optional[RaceReport] = None
        with self._mu:
            ts = self._thread_state_locked()
            st = self._vars.get(var)
            if st is None:
                st = _VarState(var)
                self._vars[var] = st
            self.accesses_total += 1
            st.accesses += 1
            report = self._step_locked(st, ts, write,
                                       site or caller_site())
            on_access = self.on_access
            on_race = self.on_race
        if on_access is not None:
            on_access()
        if report is not None and on_race is not None:
            on_race(report)

    def _step_locked(self, st: _VarState, ts: _ThreadState, write: bool,
                     site: str) -> Optional[RaceReport]:
        held = set(ts.held)
        report: Optional[RaceReport] = None
        if st.state == VIRGIN:
            st.state = EXCLUSIVE
            st.owner = ts.label
        elif st.state == EXCLUSIVE:
            if st.owner != ts.label:
                if vc_leq(st.last_vc, ts.vc):
                    # ordered hand-off: re-enter EXCLUSIVE under the new
                    # owner, lockset unconstrained again
                    st.owner = ts.label
                    st.lockset = None
                else:
                    st.state = SHARED_MODIFIED if write else SHARED
                    st.lockset = (held if st.lockset is None
                                  else st.lockset & held)
        else:
            if write and st.state == SHARED:
                st.state = SHARED_MODIFIED
            st.lockset = held if st.lockset is None else st.lockset & held
        if (st.state == SHARED_MODIFIED and not st.lockset
                and not st.reported):
            st.reported = True
            report = RaceReport(
                var=st.name, site=site, thread=ts.label,
                held=sorted(held), prior_site=st.last_site,
                prior_thread=st.last_thread,
                kind="write" if write else "read")
            if not any(st.name.startswith(p) for p in self._suppressed):
                self.races.append(report)
            else:
                report = None
        st.last_vc = dict(ts.vc)
        st.last_site = site
        st.last_thread = ts.label
        return report

    # -- reporting ------------------------------------------------------------

    def lock_edges(self) -> List[Tuple[str, str, str]]:
        """Sorted dynamic acquisition edges (src, dst, sample site)."""
        with self._mu:
            return sorted((src, dst, site)
                          for (src, dst), site in self._edges.items())

    def report(self) -> dict:
        with self._mu:
            vars_snapshot = sorted(self._vars)
            lock_names = sorted(self._lock_names)
            races = [r.to_dict() for r in self.races]
            edges = sorted([src, dst, site]
                           for (src, dst), site in self._edges.items())
            suppressed = dict(sorted(self._suppressed.items()))
            return {
                "version": 1,
                "accesses_total": self.accesses_total,
                "tracked_vars": vars_snapshot,
                "locks": lock_names,
                "lock_edges": edges,
                "races": races,
                "suppressions": suppressed,
            }

    def dump(self, directory: str) -> str:
        """Write the report as one JSON file per process; the merge step
        (``python -m tpu_operator_torch.cmd.opsan check``) unions every file."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory, f"opsan-{os.getpid()}-{int(time.time() * 1000)}.json")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.report(), fh, indent=2, sort_keys=True)
            fh.write("\n")
        return path


_runtime: Optional[OpsanRuntime] = None
_runtime_mu = threading.Lock()


def runtime() -> OpsanRuntime:
    global _runtime
    if _runtime is None:
        with _runtime_mu:
            if _runtime is None:
                _runtime = OpsanRuntime()
    return _runtime


def reset_runtime(perturber=None) -> OpsanRuntime:
    """Swap in a fresh runtime (tests; each soak lane is one process so
    production never resets)."""
    global _runtime
    with _runtime_mu:
        _runtime = OpsanRuntime(perturber=perturber)
        return _runtime
