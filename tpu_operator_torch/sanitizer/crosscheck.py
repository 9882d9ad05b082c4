"""Static↔dynamic lock-graph cross-check (copy of
tpu_operator/sanitizer/crosscheck.py).

``gpuop-lint``'s lock graph (:mod:`tpu_operator_torch.analysis.graph`) predicts which
locks *can* be acquired while holding which; opsan records which
acquisitions *actually happened* in a soak. Diffing the two answers two
different questions:

* **static-only** edges — predicted by the source, never exercised by
  any soak: an acquisition-order *coverage* gap. The deadlock detector
  (``lock-order-cycle``) is only as good as the orders the soaks
  exercise, so these are surfaced as a coverage report, not an error.
* **dynamic-only** edges — observed at runtime but absent from the
  static graph: the static analyzer has a blind spot (an aliased lock,
  an acquisition through a callback it can't resolve). Each one must be
  committed as a fixture (``tests/cases/torch_opsan/dynamic_edges.json``) with
  a rationale naming the blind spot, and where the blind spot is real
  and fixable, it becomes a ``gpuop-lint`` improvement. An *unfixtured*
  dynamic-only edge fails the build — that is the regression gate that
  keeps the static graph honest as the codebase grows.

Lock names line up by construction: the :mod:`tpu_operator_torch.utils.locks`
factory requires the static ``LockNode.label()`` format
(``ClassName._attr``) as the tracked-lock name.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Set, Tuple

Edge = Tuple[str, str]


@dataclasses.dataclass
class CrosscheckResult:
    """Outcome of one static↔dynamic diff."""

    static_edges: List[Edge]
    dynamic_edges: List[Edge]
    #: dynamic site sample per edge, for reports
    dynamic_sites: Dict[Edge, str]
    #: statically predicted, never exercised (coverage gaps)
    static_only: List[Edge]
    #: observed at runtime, missing from the static graph
    dynamic_only: List[Edge]
    #: dynamic-only edges covered by a committed fixture
    fixtured: List[Edge]
    #: dynamic-only edges NOT covered — these fail the gate
    unfixtured: List[Edge]
    #: fixtures whose edge no longer occurs anywhere (stale — the static
    #: analyzer caught up or the code path died; prune them)
    stale_fixtures: List[Edge]

    def ok(self) -> bool:
        return not self.unfixtured

    def coverage(self) -> float:
        """Fraction of statically predicted edges exercised dynamically."""
        if not self.static_edges:
            return 1.0
        exercised = len(self.static_edges) - len(self.static_only)
        return exercised / len(self.static_edges)


def static_lock_edges(project) -> List[Edge]:
    """Unique (src-label, dst-label) pairs from a ProjectContext."""
    seen: Set[Edge] = set()
    for e in project.lock_edges:
        seen.add((e.src.label(), e.dst.label()))
    return sorted(seen)


def load_reports(paths: List[str]) -> Tuple[List[Edge], Dict[Edge, str], List[dict]]:
    """Union the dynamic edges (and races) of opsan JSON report files."""
    edges: Dict[Edge, str] = {}
    races: List[dict] = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
        for src, dst, site in data.get("lock_edges", []):
            edges.setdefault((src, dst), site)
        races.extend(data.get("races", []))
    return sorted(edges), edges, races


def load_fixtures(path: Optional[str]) -> Dict[Edge, str]:
    """``dynamic_edges.json``: list of {src, dst, rationale} entries.

    Every entry carries a rationale naming the static blind spot it
    papers over — a fixture without one is rejected, same contract as an
    opsan suppression or a gpuop-lint baseline entry."""
    if not path or not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    out: Dict[Edge, str] = {}
    for entry in data.get("edges", []):
        rationale = entry.get("rationale", "").strip()
        if not rationale:
            raise ValueError(
                f"fixture edge {entry.get('src')}->{entry.get('dst')} "
                f"in {path} has no rationale")
        out[(entry["src"], entry["dst"])] = rationale
    return out


def crosscheck(static_edges: List[Edge], dynamic_edges: List[Edge],
               dynamic_sites: Dict[Edge, str],
               fixtures: Dict[Edge, str]) -> CrosscheckResult:
    sset, dset = set(static_edges), set(dynamic_edges)
    dynamic_only = sorted(dset - sset)
    fixtured = [e for e in dynamic_only if e in fixtures]
    unfixtured = [e for e in dynamic_only if e not in fixtures]
    # a fixture is stale only when its edge is in the static graph now
    # (analyzer caught up) — merely not occurring in THIS soak's sample
    # is expected, coverage varies by scenario slice
    stale = sorted(e for e in fixtures if e in sset)
    return CrosscheckResult(
        static_edges=sorted(sset),
        dynamic_edges=sorted(dset),
        dynamic_sites=dict(dynamic_sites),
        static_only=sorted(sset - dset),
        dynamic_only=dynamic_only,
        fixtured=fixtured,
        unfixtured=unfixtured,
        stale_fixtures=stale,
    )


def render(result: CrosscheckResult, races: List[dict]) -> str:
    """Human-readable gate report (``cmd.opsan check`` output)."""
    lines: List[str] = []
    lines.append(
        f"opsan cross-check: {len(result.static_edges)} static edge(s), "
        f"{len(result.dynamic_edges)} dynamic edge(s), "
        f"coverage {result.coverage():.0%}")
    if result.static_only:
        lines.append("statically predicted, never exercised "
                     "(acquisition-order coverage gaps):")
        for src, dst in result.static_only:
            lines.append(f"  {src} -> {dst}")
    if result.fixtured:
        lines.append("dynamic-only edges covered by committed fixtures:")
        for src, dst in result.fixtured:
            site = result.dynamic_sites.get((src, dst), "?")
            lines.append(f"  {src} -> {dst} (observed at {site})")
    if result.unfixtured:
        lines.append("ERROR: dynamic-only edges with NO fixture — the "
                     "static lock graph missed these; add the edge to "
                     "tests/cases/torch_opsan/dynamic_edges.json with a "
                     "rationale, or fix the analyzer blind spot:")
        for src, dst in result.unfixtured:
            site = result.dynamic_sites.get((src, dst), "?")
            lines.append(f"  {src} -> {dst} (observed at {site})")
    if result.stale_fixtures:
        lines.append("stale fixtures (edge now in the static graph — "
                     "prune from dynamic_edges.json):")
        for src, dst in result.stale_fixtures:
            lines.append(f"  {src} -> {dst}")
    if races:
        lines.append(f"ERROR: {len(races)} unsuppressed race(s):")
        for r in races:
            held = ", ".join(r.get("held", [])) or "no locks"
            lines.append(
                f"  {r['var']}: {r.get('kind', '?')} at {r.get('site')} "
                f"({r.get('thread')}, holding {held}) vs prior "
                f"{r.get('prior_site')} ({r.get('prior_thread')})")
    if not result.unfixtured and not races:
        lines.append("opsan cross-check OK")
    return "\n".join(lines)
