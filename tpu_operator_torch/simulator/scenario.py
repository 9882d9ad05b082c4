"""The declarative scenario DSL (copy of tpu_operator/simulator/scenario.py,
read and written with the port's YAML subset, ``yamlsubset``).

A scenario is data — YAML on disk for committed regression cases, a plain
dict in tests, or the compact one-line string form in docs and failure
messages — describing one fleet, one primary control-plane operation, and
a list of failure injections placed on the timeline either absolutely
(``at: <tick>``) or conditionally (``when: <condition>``, evaluated
against live cluster state every tick and fired once on the first tick it
holds).

YAML form::

    name: az-loss-mid-drain
    operation: autoscale          # autoscale | migrate | upgrade
    fleet: {size: 4, preemptible: true, zones: 2}
    ticks: 64
    injections:
      - az_loss: {frac: 0.5}
        when: drain_open
      - apiserver_brownout: {p: 0.4, dur: 60}
        at: 10

Compact string form::

    az_loss(frac=0.5) at t=drain_open
    apiserver_brownout(p=0.4, dur=60) during migration.restoring
    thundering_herd(join=1000) during upgrade
    revocation_wave(frac=0.2) at scale_up

``at t=<int>`` pins a tick; ``at t=<cond>``/``at <cond>``/``during
<cond>`` name a condition. Conditions the engine evaluates:

``start``                 tick 0
``drain_open``            any node carries an un-acked re-tile plan
``scale_up``              fleet has grown past its seeded size
``migration.<phase>``     the migration episode is in ``<phase>``
``upgrade``               any node in an in-progress upgrade state
``upgrade.draining``      a node is inside the upgrade drain window
"""

from __future__ import annotations

import dataclasses
import io
import re
from typing import Dict, List, Optional, Union

from .. import yamlsubset

OPERATIONS = ("autoscale", "migrate", "upgrade")

#: injection kind -> (allowed params, defaults)
INJECTION_KINDS: Dict[str, Dict[str, float]] = {
    "az_loss": {"frac": 0.5},
    "revocation_wave": {"frac": 0.25},
    "apiserver_brownout": {"p": 0.4, "dur": 60.0},
    "thundering_herd": {"join": 10},
    "pod_chaos": {"kills": 2},
    "frontier_drift": {"frac": 0.25, "factor": 0.25},
}

CONDITIONS = ("start", "drain_open", "scale_up", "upgrade",
              "upgrade.draining")
_MIGRATION_COND = re.compile(r"^migration\.[a-z_]+$")

_STR_FORM = re.compile(
    r"^\s*(?P<kind>[a-z_]+)\s*\((?P<params>[^)]*)\)\s*"
    r"(?:(?:at\s+t=|at\s+|during\s+)(?P<where>[A-Za-z0-9_.]+))?\s*$")


class ScenarioError(ValueError):
    """Malformed scenario source."""


def _valid_condition(cond: str) -> bool:
    return cond in CONDITIONS or bool(_MIGRATION_COND.match(cond))


@dataclasses.dataclass
class Injection:
    kind: str
    params: Dict[str, float]
    at: Optional[int] = None      # absolute tick
    when: Optional[str] = None    # condition name (first tick it holds)

    def __post_init__(self):
        if self.kind not in INJECTION_KINDS:
            raise ScenarioError(
                f"unknown injection kind {self.kind!r} "
                f"(known: {', '.join(sorted(INJECTION_KINDS))})")
        allowed = INJECTION_KINDS[self.kind]
        merged = dict(allowed)
        for key, value in (self.params or {}).items():
            if key not in allowed and key != "target":
                raise ScenarioError(
                    f"{self.kind}: unknown param {key!r} "
                    f"(allowed: {', '.join(sorted(allowed))}, target)")
            merged[key] = value
        self.params = merged
        if self.at is None and self.when is None:
            self.when = "start"
        if self.at is not None and self.when is not None:
            raise ScenarioError(f"{self.kind}: give `at` or `when`, not both")
        if self.when is not None and not _valid_condition(self.when):
            raise ScenarioError(
                f"{self.kind}: unknown condition {self.when!r}")

    def to_dict(self) -> dict:
        out: dict = {self.kind: {k: v for k, v in sorted(self.params.items())}}
        if self.at is not None:
            out["at"] = self.at
        else:
            out["when"] = self.when
        return out

    @classmethod
    def from_string(cls, text: str) -> "Injection":
        """Parse the compact form: ``kind(k=v, ...) [at t=X | during C]``."""
        m = _STR_FORM.match(text)
        if not m:
            raise ScenarioError(f"unparseable injection {text!r}")
        params: Dict[str, float] = {}
        for term in m.group("params").split(","):
            term = term.strip()
            if not term:
                continue
            if "=" not in term:
                raise ScenarioError(f"{text!r}: param {term!r} needs k=v")
            key, value = (s.strip() for s in term.split("=", 1))
            try:
                params[key] = int(value) if value.isdigit() else float(value)
            except ValueError:
                params[key] = value  # symbolic (e.g. target=upgrading)
        where = m.group("where")
        if where is None:
            return cls(kind=m.group("kind"), params=params)
        if where.isdigit():
            return cls(kind=m.group("kind"), params=params, at=int(where))
        return cls(kind=m.group("kind"), params=params, when=where)

    @classmethod
    def from_dict(cls, raw: dict) -> "Injection":
        raw = dict(raw)
        at, when = raw.pop("at", None), raw.pop("when", None)
        if len(raw) != 1:
            raise ScenarioError(
                f"injection entry must have exactly one kind key, got "
                f"{sorted(raw)}")
        kind, params = next(iter(raw.items()))
        return cls(kind=kind, params=dict(params or {}),
                   at=int(at) if at is not None else None, when=when)


@dataclasses.dataclass
class Scenario:
    name: str
    operation: str
    fleet: int = 4
    preemptible: bool = True
    zones: int = 2
    ticks: int = 64
    tick_s: float = 10.0
    injections: List[Injection] = dataclasses.field(default_factory=list)
    #: optional per-scenario SLO-attainment floor (autoscale operation)
    slo_floor: float = 0.5

    def __post_init__(self):
        if self.operation not in OPERATIONS:
            raise ScenarioError(
                f"unknown operation {self.operation!r} "
                f"(known: {', '.join(OPERATIONS)})")
        if self.fleet < 2:
            raise ScenarioError("fleet size must be >= 2")
        if self.ticks < 4:
            raise ScenarioError("ticks must be >= 4")
        self.zones = max(1, int(self.zones))

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "operation": self.operation,
            "fleet": {"size": self.fleet, "preemptible": self.preemptible,
                      "zones": self.zones},
            "ticks": self.ticks,
            "tick_s": self.tick_s,
            "slo_floor": self.slo_floor,
            "injections": [i.to_dict() for i in self.injections],
        }

    def to_yaml(self) -> str:
        return yamlsubset.dump(self.to_dict()) + "\n"

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


def parse(source: Union[str, dict, "io.TextIOBase"]) -> Scenario:
    """Parse a scenario from a dict, a YAML string, or an open file."""
    if hasattr(source, "read"):
        source = source.read()
    if isinstance(source, str):
        try:
            source = yamlsubset.parse(source)
        except yamlsubset.SubsetError as e:
            raise ScenarioError(f"bad scenario YAML: {e}")
    if not isinstance(source, dict):
        raise ScenarioError(f"scenario must be a mapping, got "
                            f"{type(source).__name__}")
    raw = dict(source)
    fleet = raw.get("fleet") or {}
    if isinstance(fleet, int):
        fleet = {"size": fleet}
    injections = []
    for entry in raw.get("injections") or []:
        if isinstance(entry, str):
            injections.append(Injection.from_string(entry))
        elif isinstance(entry, dict):
            injections.append(Injection.from_dict(entry))
        else:
            raise ScenarioError(f"bad injection entry {entry!r}")
    try:
        return Scenario(
            name=str(raw.get("name") or "unnamed"),
            operation=str(raw.get("operation") or ""),
            fleet=int(fleet.get("size", 4)),
            preemptible=bool(fleet.get("preemptible", True)),
            zones=int(fleet.get("zones", 2)),
            ticks=int(raw.get("ticks", 64)),
            tick_s=float(raw.get("tick_s", 10.0)),
            slo_floor=float(raw.get("slo_floor", 0.5)),
            injections=injections,
        )
    except (TypeError, ValueError) as e:
        if isinstance(e, ScenarioError):
            raise
        raise ScenarioError(f"bad scenario field: {e}")


def parse_file(path: str) -> Scenario:
    with open(path) as f:
        return parse(f.read())
