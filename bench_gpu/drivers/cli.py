"""A pass that is one ``gpu-validator`` run in this process: the CLI's
``run(argv)``, its printed report kept off this process's standard output,
and the barrier it left read back. The mix names the component and its
barrier; the configuration's ``validator_flags`` give the sizes and gates.
Drivers of validator components return a ``CliDriver``."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import time
import traceback
from typing import Dict, List, Optional

from .. import traffic


@dataclasses.dataclass
class CliDriver:
    argv: List[str]
    barrier: str
    setup_parts: Dict[str, float]

    @classmethod
    def of(cls, config: dict, mix: dict, status_dir: str,
           setup_parts: Dict[str, float]) -> "CliDriver":
        argv = ["-c", mix["component"], "--status-dir", status_dir, *config["validator_flags"]]
        return cls(argv, os.path.join(status_dir, f"{mix['barrier']}-ready"), setup_parts)

    def run_pass(self, index: int, spans) -> traffic.Pass:
        """One ``gpu-validator`` run; a raise is a failed pass, and the
        window goes on."""
        from tpu_operator_torch.validator import main as vmain

        with contextlib.suppress(FileNotFoundError):
            os.remove(self.barrier)
        out = io.StringIO()
        spans.pass_index = index
        rc: Optional[int] = None
        t0 = time.perf_counter()
        with spans.span("pass"), contextlib.redirect_stdout(out):
            try:
                rc = vmain.run(self.argv)
            except Exception:
                traceback.print_exc()
        t1 = time.perf_counter()
        spans.pass_index = None
        report = None
        for line in reversed(out.getvalue().splitlines()):
            if line.startswith("{"):
                report = json.loads(line)
                break
        try:
            with open(self.barrier) as f:
                written = json.load(f)
        except FileNotFoundError:
            written = None
        return traffic.Pass(index, t0, t1, rc, report, written)
