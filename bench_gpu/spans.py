"""The benchmark's own spans, placed around calls into the program's layers
by wrapping the program's module functions for the length of a run (the
program is not edited).

Each metric module may name the functions it reads in ``SPANS``: span
name -> ``"package.module:function"``. A span is kept on the host clock
(``perf_counter``), tagged with the pass it fell in, and given to the
profiler as a ``record_function`` range, so the device trace can say what
the host was doing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import time
from typing import Dict, Iterator, List, Optional

from torch.profiler import record_function


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    pass_index: Optional[int]
    t0: float
    t1: float

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Spans:
    def __init__(self) -> None:
        self.records: List[Span] = []
        self.pass_index: Optional[int] = None
        self._undo: list = []

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        with record_function(name):
            try:
                yield
            finally:
                self.records.append(Span(name, self.pass_index, t0, time.perf_counter()))

    def wrap(self, name: str, target: str) -> None:
        """Record every call of ``target`` (``"module:function"``) as ``name``."""
        module_name, attr = target.split(":")
        module = importlib.import_module(module_name)
        original = getattr(module, attr)

        @functools.wraps(original)
        def traced(*args, **kwargs):
            with self.span(name):
                return original(*args, **kwargs)

        setattr(module, attr, traced)
        self._undo.append((module, attr, original))

    def wrap_all(self, targets: Dict[str, str]) -> None:
        for name, target in sorted(targets.items()):
            self.wrap(name, target)

    def restore(self) -> None:
        while self._undo:
            module, attr, original = self._undo.pop()
            setattr(module, attr, original)

    def named(self, name: str) -> List[Span]:
        return [s for s in self.records if s.name == name]

    def per_pass(self, name: str) -> Dict[int, float]:
        """Seconds spent in ``name`` in each pass."""
        out: Dict[int, float] = {}
        for s in self.named(name):
            if s.pass_index is not None:
                out[s.pass_index] = out.get(s.pass_index, 0.0) + s.seconds
        return out
