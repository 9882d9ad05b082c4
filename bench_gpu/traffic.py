"""The one traffic generator: a mix file (``mixes/<name>.json``) turned
into passes.

A mix names its ``driver`` (``drivers/<driver>.py``: the set-up a pass
needs and what one pass runs), its ``reference`` (``references/<name>.py``:
what decides ``correct``), the driver's own parameters (a validator
mix's ``component`` and ``barrier``) and how passes arrive. Only a closed
loop with one client is defined: the node's one validator, each pass
started when the last has returned. The sizes and gates are the
configuration's; the mix says what runs and how often.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class Pass:
    """One validator run: its host-clock interval (``perf_counter``), exit
    code (None when it raised), the JSON report it printed and the barrier
    it left."""
    index: int
    t0: float
    t1: float
    rc: Optional[int]
    report: Optional[dict]
    barrier: Optional[dict]

    @property
    def passed(self) -> bool:
        return self.rc == 0 and bool(self.report and self.report.get("passed"))


def check_mix(mix: dict) -> None:
    if mix.get("loop") != "closed" or int(mix.get("clients", 0)) != 1:
        raise ValueError(f"mix {mix.get('name')!r}: only a closed loop of one client "
                         f"is defined, got loop={mix.get('loop')!r} "
                         f"clients={mix.get('clients')!r}")


def closed_loop(mix: dict, seconds: float, run_pass: Callable[[int], Pass],
                clock: Callable[[], float] = time.perf_counter) -> List[Pass]:
    """Start passes until ``seconds`` have gone by since the first began;
    the window ends when the last started pass returns."""
    check_mix(mix)
    passes: List[Pass] = []
    start = clock()
    while not passes or clock() - start < seconds:
        passes.append(run_pass(len(passes)))
    return passes


def window_s(passes: List[Pass]) -> float:
    """From the first pass's start to the last pass's end."""
    return passes[-1].t1 - passes[0].t0
