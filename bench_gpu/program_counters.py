"""What the readers of the program's own counters share: a counter's total
after the window, per pass.

The program counts from its process's start (``tpu_operator_torch.tracing``
``counters()``); where the cell's set-up runs none of the counted work
(certification's runs no timed chain) the total is the window's. Nothing
enforces that: a driver whose warm-up ran a timed chain would have it
counted here. A program without the counter, or without counters at all,
reads None.

The harness reads per-layer metrics in ``--trace 1`` runs only, under
``torch.profiler``: a counter of wall time (``perf.prep_s``) then includes
the profiler's own host overhead.
"""

from __future__ import annotations

import importlib
from typing import Optional

TRACING = "tpu_operator_torch.tracing"


def per_pass(run, name: str) -> Optional[float]:
    """The counter ``name``'s total over the passes, or None where the
    program keeps no such counter."""
    snapshot = getattr(importlib.import_module(TRACING), "counters", None)
    if snapshot is None or not run.passes:
        return None
    total = snapshot().get(name)
    return None if total is None else total / len(run.passes)
