"""Durable, bounded, append-only decision journal (copy of
tpu_operator/provenance/journal.py).

Identity is content-addressed: a record's id is the canonical hash of its
non-volatile payload, so a crashed operator that replays the same decision
after restart lands on the SAME record id — the in-memory append dedupes,
the on-disk JSONL load dedupes, and the ConfigMap mirror create hits
``AlreadyExists`` and stands down. Provenance thereby obeys the exact
crash/fencing discipline of the state it explains: mirror writes go
through the operator's client chain (WriteBatcher → … → FencedClient),
where ``create`` is a flush barrier and a deposed replica's mirror write
is fenced like any other actuation. The leader epoch a record carries is
the one the fence last dispatched a write under.

Volatile fields — wall-clock ``ts``, the reconcile ``trace`` id, the
leader ``epoch``, and the per-episode ``seq`` — are excluded from
:meth:`DecisionRecord.canonical`, so a record's identity is its content.

Bounds: ``bound`` records in memory (oldest closed episodes pruned
first); the JSONL file is compacted back to the live set when it exceeds
``4 * bound`` lines; pruned records' mirror ConfigMaps are deleted
best-effort. A torn final line (crash mid-append) is skipped on load.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional

from .. import tracing
from ..client.errors import AlreadyExistsError, ApiError
from ..client.fenced import find_fenced
from ..utils import object_hash
from ..utils.locks import make_rlock, register_shared

log = logging.getLogger(__name__)

#: default in-memory record bound (journal is a flight recorder, not a DB)
DEFAULT_BOUND = 512

#: volatile keys stripped from actuation dicts in the canonical form
_VOLATILE_ACTUATION_KEYS = ("trace", "epoch")


def episode_id(*parts) -> str:
    """Deterministic episode id from the parts that make the episode what
    it is (subsystem kind, node, triggering digest …). No uuid input: a
    crash replay of the same decision must rejoin the same episode instead
    of forking a new one."""
    return "ep-" + object_hash(list(parts))


@dataclasses.dataclass
class DecisionRecord:
    """One decision, append-only. ``outcome`` records close their episode;
    everything else extends the causal chain."""

    episode: str
    subsystem: str
    kind: str
    trigger: Dict[str, object]
    inputs: Dict[str, object]
    decision: Dict[str, object]
    alternatives: List[dict]
    actuations: List[dict]
    outcome: Optional[str]
    node: Optional[str]
    seq: int = 0
    ts: float = 0.0
    trace: Optional[str] = None
    epoch: Optional[int] = None
    record_id: str = ""

    def canonical(self) -> dict:
        """The replay-stable identity payload: everything that must be
        identical across a record/replay double run, and the basis of the
        content address. Volatile observability stamps (ts / trace /
        epoch / seq) are absent; so are ``inputs`` and ``alternatives`` —
        they are forensic ENRICHMENT (a crash replay recomputes its
        forecast from a refilled predictor window and must still land on
        the same record id), so call sites keep ``trigger`` and
        ``decision`` clock-free and put anything wall-clock-derived in
        ``inputs``."""
        return {
            "episode": self.episode,
            "subsystem": self.subsystem,
            "kind": self.kind,
            "trigger": self.trigger,
            "decision": self.decision,
            "actuations": [
                {k: v for k, v in act.items()
                 if k not in _VOLATILE_ACTUATION_KEYS}
                for act in self.actuations
            ],
            "outcome": self.outcome,
            "node": self.node,
        }

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "DecisionRecord":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields})


class _Episode:
    __slots__ = ("kind", "first_ts", "last_ts", "closed", "records", "node")

    def __init__(self, kind: str, ts: float, node: Optional[str]):
        self.kind = kind          # root decision kind labels the episode
        self.first_ts = ts
        self.last_ts = ts
        self.closed = False
        self.records: List[str] = []
        self.node = node


class DecisionJournal:
    """The journal. Thread-safe; every surface (controllers, health server,
    must-gather, benches) shares one instance per operator process.

    ``client=None`` keeps it purely in-process (benches, node agents);
    ``path=None`` skips the on-disk JSONL. Hooks (``on_record``,
    ``on_episode_closed``, ``on_orphan``) are wired by
    ``OperatorMetrics.wire_provenance`` and must never raise into a
    reconcile."""

    def __init__(self, client=None, namespace: str = "tpu-system",
                 path: Optional[str] = None, bound: int = DEFAULT_BOUND,
                 now=time.time):
        self._client = client
        self._namespace = namespace
        self._path = path
        self._bound = max(1, int(bound))
        self._now = now
        self._lock = make_rlock("DecisionJournal._lock")
        # rid -> record (insertion order)
        self._records: Dict[str, DecisionRecord] = register_shared(
            "DecisionJournal._records", {})
        self._episodes: Dict[str, _Episode] = register_shared(
            "DecisionJournal._episodes", {})
        self.recorded_total = 0
        self.replayed_total = 0   # dedupe hits: crash replay / double record
        self.pruned_total = 0
        self.mirror_errors_total = 0
        self.on_record = None          # fn(subsystem)
        self.on_episode_closed = None  # fn(kind, duration_s)
        self.on_orphan = None          # fn(count)
        if path:
            self._load()

    # -- recording ------------------------------------------------------------

    def record_decision(self, subsystem: str, kind: str, episode: str,
                        trigger: dict, inputs: Optional[dict] = None,
                        decision: Optional[dict] = None,
                        alternatives: Optional[List[dict]] = None,
                        actuations: Optional[List[dict]] = None,
                        outcome: Optional[str] = None,
                        node: Optional[str] = None) -> DecisionRecord:
        """Append one decision record. Idempotent on content: re-recording
        an identical decision (crash replay) returns the existing record
        without re-appending, re-mirroring, or double-counting metrics."""
        rec = DecisionRecord(
            episode=episode, subsystem=subsystem, kind=kind,
            trigger=dict(trigger or {}), inputs=dict(inputs or {}),
            decision=dict(decision or {}),
            alternatives=list(alternatives or []),
            actuations=[dict(a) for a in (actuations or [])],
            outcome=outcome, node=node)
        rec.record_id = object_hash(rec.canonical())
        with self._lock:
            existing = self._records.get(rec.record_id)
            if existing is not None:
                self.replayed_total += 1
                return existing
            rec.ts = float(self._now())
            rec.trace = tracing.current_trace_id()
            rec.epoch = self._current_epoch()
            for act in rec.actuations:
                act.setdefault("trace", rec.trace)
                act.setdefault("epoch", rec.epoch)
            ep = self._episodes.get(episode)
            if ep is None:
                ep = self._episodes[episode] = _Episode(kind, rec.ts, node)
            ep.last_ts = rec.ts
            if ep.node is None and node is not None:
                ep.node = node
            rec.seq = len(ep.records)
            ep.records.append(rec.record_id)
            self._records[rec.record_id] = rec
            self.recorded_total += 1
            closed_now = outcome is not None and not ep.closed
            if closed_now:
                ep.closed = True
            self._append_disk(rec)
            self._mirror(rec)
            self._prune_locked()
        self._fire(self.on_record, subsystem)
        if closed_now:
            self._fire(self.on_episode_closed, ep.kind,
                       max(0.0, rec.ts - ep.first_ts))
        return rec

    def note_orphans(self, count: int) -> None:
        """Feed audit-detected orphan actuations into the metric family."""
        if count > 0:
            self._fire(self.on_orphan, count)

    def _current_epoch(self) -> Optional[int]:
        fenced = find_fenced(self._client)
        return getattr(fenced, "last_dispatched_epoch", None)

    @staticmethod
    def _fire(hook, *args) -> None:
        if hook is None:
            return
        try:
            hook(*args)
        except Exception:  # telemetry must never break a reconcile
            log.debug("provenance hook failed", exc_info=True)

    # -- read side ------------------------------------------------------------

    def timeline(self, node: Optional[str] = None,
                 episode: Optional[str] = None,
                 limit: Optional[int] = None) -> List[dict]:
        """Newest-first record dicts, filterable by node and/or episode
        (the /debug/timeline contract)."""
        with self._lock:
            out = [r for r in self._records.values()
                   if (episode is None or r.episode == episode)
                   and (node is None or r.node == node
                        or any(a.get("name") == node for a in r.actuations))]
        out.sort(key=lambda r: (r.ts, r.seq), reverse=True)
        if limit is not None:
            out = out[:max(0, int(limit))]
        return [r.to_dict() for r in out]

    def records(self) -> List[DecisionRecord]:
        with self._lock:
            return list(self._records.values())

    def chain(self, episode: str) -> List[DecisionRecord]:
        """The episode's records in causal (seq) order."""
        with self._lock:
            ep = self._episodes.get(episode)
            if ep is None:
                return []
            return [self._records[rid] for rid in ep.records
                    if rid in self._records]

    def episode_complete(self, episode: str) -> bool:
        """Complete = a root record (seq 0 survived pruning) AND a closing
        outcome record — the causality audit's reachability criterion."""
        chain = self.chain(episode)
        return (bool(chain) and chain[0].seq == 0
                and any(r.outcome is not None for r in chain))

    def episodes(self) -> List[dict]:
        """Episode summaries, newest-first (the /debug/timeline header)."""
        with self._lock:
            out = [{"episode": eid, "kind": ep.kind, "node": ep.node,
                    "records": len(ep.records), "closed": ep.closed,
                    "first_ts": ep.first_ts, "last_ts": ep.last_ts,
                    "duration_s": round(ep.last_ts - ep.first_ts, 6)}
                   for eid, ep in self._episodes.items()]
        out.sort(key=lambda e: e["first_ts"], reverse=True)
        return out

    def oldest_open_age(self) -> float:
        """Age in seconds of the oldest still-open episode (0 when none) —
        scraped via set_function as ``tpu_operator_episode_open_age_
        seconds``."""
        now = float(self._now())
        with self._lock:
            opens = [ep.first_ts for ep in self._episodes.values()
                     if not ep.closed]
        return max(0.0, now - min(opens)) if opens else 0.0

    def canonical_export(self) -> List[dict]:
        """Replay-stable journal image: canonical records in (episode,
        seq) order; two runs of the same decisions export identically."""
        with self._lock:
            recs = sorted(self._records.values(),
                          key=lambda r: (r.episode, r.seq))
        return [r.canonical() for r in recs]

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "records": len(self._records),
                "episodes": len(self._episodes),
                "open_episodes": sum(1 for ep in self._episodes.values()
                                     if not ep.closed),
                "bound": self._bound,
                "recorded_total": self.recorded_total,
                "replayed_total": self.replayed_total,
                "pruned_total": self.pruned_total,
                "mirror_errors_total": self.mirror_errors_total,
                "path": self._path,
            }

    # -- bounds ---------------------------------------------------------------

    def _prune_locked(self) -> None:
        if len(self._records) <= self._bound:
            return
        # oldest records of closed episodes go first; if everything is
        # still open, oldest wins anyway — bounded beats complete.
        victims = [r for r in self._records.values()
                   if self._episodes[r.episode].closed]
        victims += [r for r in self._records.values()
                    if not self._episodes[r.episode].closed]
        for rec in victims:
            if len(self._records) <= self._bound:
                break
            del self._records[rec.record_id]
            ep = self._episodes.get(rec.episode)
            if ep is not None:
                ep.records = [rid for rid in ep.records
                              if rid != rec.record_id]
                if not ep.records:
                    del self._episodes[rec.episode]
            self.pruned_total += 1
            self._unmirror(rec)
        self._compact_disk()

    # -- on-disk JSONL --------------------------------------------------------

    def _append_disk(self, rec: DecisionRecord) -> None:
        if not self._path:
            return
        try:
            line = json.dumps(rec.to_dict(), sort_keys=True)
            with open(self._path, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")
        except OSError:
            log.warning("provenance journal append failed: %s", self._path,
                        exc_info=True)

    def _compact_disk(self) -> None:
        """Rewrite the JSONL to the live record set once the append log
        outgrows 4x the in-memory bound. Rewrite-then-rename so a crash
        mid-compaction leaves the old (complete) log in place."""
        if not self._path:
            return
        try:
            with open(self._path, "r", encoding="utf-8") as fh:
                lines = sum(1 for _ in fh)
        except OSError:
            return
        if lines <= 4 * self._bound:
            return
        tmp = self._path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                for rec in self._records.values():
                    fh.write(json.dumps(rec.to_dict(), sort_keys=True) + "\n")
            os.replace(tmp, self._path)
        except OSError:
            log.warning("provenance journal compaction failed",
                        exc_info=True)

    def _load(self) -> None:
        """Crash recovery: rebuild memory from the JSONL, deduping by
        record id and skipping a torn final line."""
        if not self._path or not os.path.exists(self._path):
            return
        try:
            with open(self._path, "r", encoding="utf-8") as fh:
                raw_lines = fh.readlines()
        except OSError:
            log.warning("provenance journal unreadable: %s", self._path,
                        exc_info=True)
            return
        with self._lock:
            for raw in raw_lines:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    rec = DecisionRecord.from_dict(json.loads(raw))
                except (ValueError, TypeError):
                    continue  # torn append (crash mid-write) or foreign line
                if not rec.record_id or rec.record_id in self._records:
                    continue
                ep = self._episodes.get(rec.episode)
                if ep is None:
                    ep = self._episodes[rec.episode] = _Episode(
                        rec.kind, rec.ts, rec.node)
                ep.last_ts = max(ep.last_ts, rec.ts)
                ep.first_ts = min(ep.first_ts, rec.ts)
                if rec.outcome is not None:
                    ep.closed = True
                ep.records.append(rec.record_id)
                self._records[rec.record_id] = rec
            for ep in self._episodes.values():
                ep.records.sort(key=lambda rid: self._records[rid].seq)

    # -- cluster mirror -------------------------------------------------------

    def _mirror(self, rec: DecisionRecord) -> None:
        """Content-addressed ConfigMap per record, created through the
        ambient client chain. AlreadyExists = this exact decision was
        already journaled (crash replay) — stand down."""
        if self._client is None:
            return
        from .. import consts
        obj = {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {
                "name": f"prov-{rec.record_id}",
                "namespace": self._namespace,
                "labels": {consts.PROVENANCE_LABEL: rec.subsystem},
            },
            "data": {"record": json.dumps(rec.to_dict(), sort_keys=True)},
        }
        try:
            self._client.create(obj)
        except AlreadyExistsError:
            pass
        except ApiError:
            self.mirror_errors_total += 1
            log.debug("provenance mirror create failed: %s",
                      rec.record_id, exc_info=True)

    def _unmirror(self, rec: DecisionRecord) -> None:
        if self._client is None:
            return
        try:
            self._client.delete("v1", "ConfigMap", f"prov-{rec.record_id}",
                                self._namespace)
        except ApiError:
            pass  # best-effort: a leaked pruned mirror is harmless
