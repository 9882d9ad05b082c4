"""Critical-path attribution: join wall-clock -> per-phase seconds (copy of
tpu_operator/joinprofile/critical_path.py; the phase names are the
reference's, and on the GPU ``xla-compile`` is the set-up window: the
sweep's cuBLAS and NCCL set-up, ``prewarm``'s ``nvcc`` build or cache load).

The merged join trace is a bag of (phase, t0, t1) intervals from three
sources (operator sweep spans, per-state rollout-wait observations, and
node-side span records). Intervals overlap — the validator's XLA compile
happens INSIDE a DS-rollout wait, a reconcile sweep runs concurrently with
everything. Attribution is a sweep-line over interval boundaries: every
instant of the join window is charged to exactly one phase, the
highest-priority phase active at that instant, so phase durations sum to
(at most) the window and coverage = attributed / window is honest.

Priority order: the most specific explanation wins. An instant during XLA
compile is "compiling", even though the DS rollout is also unfinished.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

#: attribution priority, most specific first; "other" catches spans whose
#: names match no known phase without inventing a new label cardinality
PHASES = (
    "xla-compile",
    "image-pull",
    "barrier-handshake",
    "validation-run",
    "serving-probe",
    # background image pre-pulls (labeler stamp -> node schedulable): less
    # specific than any node-side span but a better explanation than a
    # bare rollout wait — the kubelet IS doing useful join work
    "image-prepull",
    "ds-rollout-wait",
    "reconcile",
    "other",
)

_PRIORITY = {p: i for i, p in enumerate(PHASES)}

#: span-name fragments -> phase, checked in order (first match wins)
_NAME_RULES: Tuple[Tuple[str, str], ...] = (
    ("xla-compile", "xla-compile"),
    ("compile", "xla-compile"),
    # "prepull" before the generic "pull" fragment, or pre-pull spans
    # would be mislabeled as foreground pulls
    ("prepull", "image-prepull"),
    ("image-pull", "image-pull"),
    ("pull", "image-pull"),
    # rollout before the generic "wait": "ds-rollout-wait" is a rollout
    ("rollout", "ds-rollout-wait"),
    ("barrier-wait", "barrier-handshake"),
    ("wait", "barrier-handshake"),
    ("handshake", "barrier-handshake"),
    ("serving", "serving-probe"),
    ("ici-sweep", "validation-run"),
    ("workload", "validation-run"),
    ("validate", "validation-run"),
    ("validation", "validation-run"),
    ("driver", "validation-run"),
    ("plugin", "validation-run"),
    ("perf", "validation-run"),
    ("reconcile", "reconcile"),
    ("state.", "reconcile"),
    ("label-nodes", "reconcile"),
    ("sync-state", "reconcile"),
    ("status-update", "reconcile"),
    ("health-sweep", "reconcile"),
    ("api.", "reconcile"),
)


def phase_of(name: str, kind: str = "") -> str:
    """Map a span name (plus kind hint) to an attribution phase."""
    if kind in ("phase", "reconcile", "api", "state"):
        return "reconcile"
    lowered = (name or "").lower()
    for fragment, phase in _NAME_RULES:
        if fragment in lowered:
            return phase
    return "other"


def attribute(intervals: Iterable[Tuple[str, float, float]],
              window: Tuple[float, float]) -> Dict[str, object]:
    """Sweep-line attribution of ``window=(t0, t1)`` over
    ``(phase, start, end)`` intervals.

    Returns ``{"phases": {phase: seconds}, "window_s", "attributed_s",
    "unattributed_s", "coverage"}``. Intervals are clipped to the window;
    unknown phases degrade to "other" rather than being dropped."""
    w0, w1 = float(window[0]), float(window[1])
    window_s = max(0.0, w1 - w0)
    clipped: List[Tuple[str, float, float]] = []
    for phase, t0, t1 in intervals:
        if phase not in _PRIORITY:
            phase = "other"
        a, b = max(float(t0), w0), min(float(t1), w1)
        if b > a:
            clipped.append((phase, a, b))
    phases: Dict[str, float] = {}
    if window_s > 0 and clipped:
        bounds = sorted({w0, w1, *(t for _, a, b in clipped for t in (a, b))})
        for lo, hi in zip(bounds, bounds[1:]):
            active = [p for p, a, b in clipped if a <= lo and b >= hi]
            if not active:
                continue
            winner = min(active, key=_PRIORITY.__getitem__)
            phases[winner] = phases.get(winner, 0.0) + (hi - lo)
    attributed = sum(phases.values())
    return {
        "phases": {p: round(s, 4) for p, s in
                   sorted(phases.items(), key=lambda kv: -kv[1])},
        "window_s": round(window_s, 4),
        "attributed_s": round(attributed, 4),
        "unattributed_s": round(max(0.0, window_s - attributed), 4),
        "coverage": round(attributed / window_s, 4) if window_s else 0.0,
    }


def record_intervals(records: Iterable[dict]) -> List[Tuple[str, float, float]]:
    """(phase, t0, t1) intervals from compact span records (open records —
    ``d`` None — contribute nothing: an interval needs both ends)."""
    out = []
    for rec in records:
        if rec.get("d") is None:
            continue
        t0 = float(rec["s"])
        out.append((phase_of(rec.get("n", "")), t0, t0 + float(rec["d"])))
    return out
