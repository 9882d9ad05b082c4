"""Human-readable causal chains: the ``gpuop-cfg explain`` renderer (copy
of tpu_operator/provenance/explain.py).

Takes journal record dicts (the /debug/timeline wire format, so the CLI
can render straight from the health server or from a must-gather capture)
and prints each episode as an indented causal chain::

    episode ep-1a2b3c4d  drain-plan  node=gpu-3  CLOSED in 42.1s
      [0] health/drain-plan  trigger=verdict plan=7c1e…
          decision: node=gpu-3 plan=7c1e… reason=remediate
          rejected: force-immediate — drain window configured; …
          actuation: plan Node/gpu-3  trace=9f… epoch=7
      [1] health/drain-force  trigger=deadline plan=7c1e…
      ...
      [3] health/health-recover  outcome=recovered
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _fmt_kv(data: dict) -> str:
    return " ".join(f"{k}={data[k]}" for k in sorted(data))


def _fmt_trigger(trigger: dict) -> str:
    kind = trigger.get("type", "?")
    rest = {k: v for k, v in trigger.items() if k != "type"}
    return f"{kind} {_fmt_kv(rest)}".strip()


def render_explain(records: List[dict], node: Optional[str] = None,
                   episode: Optional[str] = None) -> str:
    """Render record dicts as per-episode causal chains, oldest episode
    first (the order an incident unfolded). Returns '' when nothing
    matches — callers add their own "no episodes" message."""
    by_episode: Dict[str, List[dict]] = {}
    for rec in records:
        if episode is not None and rec.get("episode") != episode:
            continue
        if node is not None and rec.get("node") != node and not any(
                a.get("name") == node for a in rec.get("actuations", [])):
            continue
        by_episode.setdefault(rec.get("episode", "?"), []).append(rec)
    if not by_episode:
        return ""

    lines: List[str] = []
    episodes = sorted(
        by_episode.items(),
        key=lambda item: min(r.get("ts", 0.0) for r in item[1]))
    for eid, recs in episodes:
        recs = sorted(recs, key=lambda r: (r.get("seq", 0), r.get("ts", 0.0)))
        root = recs[0]
        closed = any(r.get("outcome") is not None for r in recs)
        span_s = (max(r.get("ts", 0.0) for r in recs)
                  - min(r.get("ts", 0.0) for r in recs))
        state = f"CLOSED in {span_s:.1f}s" if closed else "OPEN"
        lines.append(f"episode {eid}  {root.get('kind', '?')}  "
                     f"node={root.get('node') or '-'}  {state}")
        for rec in recs:
            lines.append(
                f"  [{rec.get('seq', 0)}] {rec.get('subsystem', '?')}/"
                f"{rec.get('kind', '?')}  "
                f"trigger={_fmt_trigger(rec.get('trigger') or {})}")
            decision = rec.get("decision") or {}
            if decision:
                lines.append(f"      decision: {_fmt_kv(decision)}")
            for alt in rec.get("alternatives") or []:
                option = alt.get("option", "?")
                why = alt.get("reason", alt.get("reason_rejected", ""))
                lines.append(f"      rejected: {option} — {why}")
            inputs = rec.get("inputs") or {}
            if inputs:
                lines.append(f"      inputs: {_fmt_kv(inputs)}")
            for act in rec.get("actuations") or []:
                trace = act.get("trace") or "-"
                epoch = act.get("epoch")
                lines.append(
                    f"      actuation: {act.get('verb', '?')} "
                    f"{act.get('kind', '?')}/{act.get('name', '?')}  "
                    f"trace={str(trace)[:12]} "
                    f"epoch={'-' if epoch is None else epoch}")
            if rec.get("outcome") is not None:
                lines.append(f"      outcome: {rec['outcome']}")
    return "\n".join(lines)
