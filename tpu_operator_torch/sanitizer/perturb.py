"""Seeded schedule perturber (copy of tpu_operator/sanitizer/perturb.py).

The GIL serializes bytecode but not *schedules*: which thread runs
between a lock release and the next acquire is up to the OS, and the
soaks only ever explore the interleavings the machine happens to
produce. The perturber injects ``sched_yield``-style preemption points
at every lock boundary and tracked access — sometimes nothing, sometimes
``time.sleep(0)`` (release the GIL, let another runnable thread in),
sometimes a sub-millisecond sleep (force a real reschedule) — so one
seeded soak run explores many more orderings than an unperturbed one.

Determinism contract (tested): decisions derive from the scenario seed
machinery (:mod:`tpu_operator_torch.utils.seeds`) —
``seed_for(root, "opsan-perturb:<thread-name>")`` — so each thread's decision *sequence* is a pure function of (root seed, thread
name, that thread's own hook-point sequence). Threads never share an
RNG: one thread taking a different code path cannot perturb another's
decisions, and a red run replays from the one printed root seed.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..utils.seeds import SCENARIO_SEED_ENV, seed_for

OPSAN_SEED_ENV = "OPSAN_SEED"
#: the pinned default of the race-soak lane and the smoke's sanitized join
DEFAULT_OPSAN_SEED = 20260807

#: decision space: (action name, sleep seconds); weights sum to 1.0
_ACTIONS: Tuple[Tuple[str, float], ...] = (
    ("pass", 0.0),        # no perturbation
    ("yield", 0.0),       # time.sleep(0): drop the GIL
    ("sleep", 0.0005),    # force a real reschedule
)
_WEIGHTS = (0.75, 0.15, 0.10)

#: per-thread decision-trace bound: enough to assert determinism over,
#: small enough that a long soak cannot grow without bound
_TRACE_BOUND = 20000


def resolve_opsan_seed(explicit: Optional[int] = None) -> int:
    """Root-seed precedence: explicit > $OPSAN_SEED > $SCENARIO_SEED >
    pinned default — so a perturbed scenario-fuzz run shares the fuzzer's
    root by default and replays from the same printed seed."""
    if explicit is not None:
        return int(explicit)
    for env in (OPSAN_SEED_ENV, SCENARIO_SEED_ENV):
        raw = os.environ.get(env)
        if raw:
            return int(raw)
    return DEFAULT_OPSAN_SEED


class Perturber:
    """Seeded preemption-point injector; one per opsan runtime."""

    def __init__(self, root_seed: Optional[int] = None,
                 sleep=time.sleep):
        self.root_seed = resolve_opsan_seed(root_seed)
        self._sleep = sleep
        self._mu = threading.Lock()
        self._rngs: Dict[str, random.Random] = {}
        self._traces: Dict[str, Deque[Tuple[str, str]]] = {}
        self.points_total = 0
        self.perturbed_total = 0

    def _thread_rng_locked(self, name: str) -> random.Random:
        rng = self._rngs.get(name)
        if rng is None:
            rng = random.Random(seed_for(self.root_seed,
                                         f"opsan-perturb:{name}"))
            self._rngs[name] = rng
            self._traces[name] = deque(maxlen=_TRACE_BOUND)
        return rng

    def point(self, kind: str) -> str:
        """One preemption point of the given kind ("acquire" / "release"
        / "access") on the calling thread; returns the action taken."""
        name = threading.current_thread().name
        with self._mu:
            rng = self._thread_rng_locked(name)
            action, delay = rng.choices(_ACTIONS, weights=_WEIGHTS, k=1)[0]
            self._traces[name].append((kind, action))
            self.points_total += 1
            if action != "pass":
                self.perturbed_total += 1
        if action == "yield":
            self._sleep(0)
        elif action == "sleep":
            self._sleep(delay)
        return action

    def trace(self, thread_name: Optional[str] = None) -> List[Tuple[str, str]]:
        """The decision trace for one thread (default: the caller's) —
        the determinism fixture asserts same seed → same trace."""
        name = thread_name or threading.current_thread().name
        with self._mu:
            return list(self._traces.get(name, ()))

    def stats(self) -> dict:
        with self._mu:
            return {
                "root_seed": self.root_seed,
                "threads": sorted(self._traces),
                "points_total": self.points_total,
                "perturbed_total": self.perturbed_total,
            }
