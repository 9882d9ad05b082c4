"""The benchmark's description: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one metric
lives in a file of its own, found by its name:

- a configuration: the ``file`` its ``configs`` entry names;
- a traffic mix: ``mixes/<traffic>.json``, whose ``driver`` names
  ``drivers/<driver>.py`` (set-up and one pass) and whose ``reference``
  names ``references/<reference>.py`` (what decides ``correct``);
- a metric, end-to-end or per-layer: ``metrics/<name>.py``, whose
  ``read(run)`` returns the value or None when it finds nothing to read.

So a later cell, mix or metric is new files and new entries, and no edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
SPEC_FILE = "BENCHMARK.json"


class SpecError(ValueError):
    """The benchmark's files do not describe the cell asked for."""


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    module: ModuleType


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    driver: ModuleType
    reference: ModuleType
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_module(path: Path, name: str, register: bool = False) -> ModuleType:
    """Import the file at ``path`` under ``name``, by path (metric names
    hold dots, and a later cell's files may lie in another copy of the
    benchmark). With ``register`` the module is also entered in
    ``sys.modules`` under ``name`` where that name is free, so that
    processes it spawns can unpickle its functions by name."""
    if not path.is_file():
        raise SpecError(f"no file {path}")
    loaded = sys.modules.get(name)
    if loaded is not None and Path(getattr(loaded, "__file__", "")).resolve() == path.resolve():
        return loaded
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if register and loaded is None:
        sys.modules[name] = module
    return module


def _metrics(entries: List[dict], cell: str, bench_dir: Path) -> List[Metric]:
    found = []
    for entry in entries:
        if "workloads" in entry and cell not in entry["workloads"]:
            continue
        module = load_module(bench_dir / "metrics" / f"{entry['name']}.py",
                             f"bench_gpu.metrics.{entry['name']}")
        found.append(Metric(entry["name"], entry["unit"], module))
    return found


def load_cell(root: Path, workload: str, bench_dir: Path = HERE) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files."""
    spec_path = Path(root) / SPEC_FILE
    if not spec_path.is_file():
        raise SpecError(f"no {SPEC_FILE} in {root}")
    spec = json.loads(spec_path.read_text())
    cells: Dict[str, dict] = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r}; the cells are {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((Path(root) / configs[entry["config"]]["file"]).read_text())
    mix = json.loads((bench_dir / "mixes" / f"{entry['traffic']}.json").read_text())
    driver = load_module(bench_dir / "drivers" / f"{mix['driver']}.py",
                         f"bench_gpu.drivers.{mix['driver']}", register=True)
    reference = load_module(bench_dir / "references" / f"{mix['reference']}.py",
                            f"bench_gpu.references.{mix['reference']}", register=True)
    return Cell(name=workload, chips=int(entry["chips"]), config=config, mix=mix,
                driver=driver, reference=reference,
                end_to_end=_metrics(spec["end_to_end"], workload, bench_dir),
                per_layer=_metrics(spec["per_layer"], workload, bench_dir))
