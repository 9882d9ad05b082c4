"""Seeded multi-tenant serving traffic scenario over partitioned GPU groups
(copy of tpu_operator/serving/traffic.py; the arithmetic is the
reference's, line for line, so both give the same dict for the same
inputs).

A discrete-event simulation that replays a Poisson-arrival, heavy-tailed
multi-tenant request mix against the partitioner's healthy layout (the
``groups`` list of the partition handoff file; a group's ``chips`` are its
GPUs). Tenants are bin-packed first-fit onto groups with free GPUs, queue
under pressure, and interactive (priority-0) tenants preempt batch traffic
when the queue would otherwise violate their SLO. A mid-run health re-tile
can block groups: tenants running there drain and re-place onto the
remaining healthy capacity, and the scenario measures how fast.

Everything is driven by one ``random.Random(seed)`` so runs are
reproducible bit-for-bit; no wall clock is consulted (simulated time only).

Outputs (one dict): SLO attainment, p50/p99 queue+decode latency,
preemptions, placement churn, and — when a re-tile was injected — whether
every drained tenant re-placed within the drain window.
"""

from __future__ import annotations

import heapq
import random
from typing import Dict, List, Optional, Sequence

#: priority vocabulary: 0 = interactive (may preempt), 2 = batch
PRIORITIES = (0, 1, 2)
_PRIORITY_WEIGHTS = (0.15, 0.35, 0.50)


class _Request:
    __slots__ = ("rid", "arrival", "priority", "chips", "tokens",
                 "remaining", "slice_id", "service_start", "first_start",
                 "finish", "placements", "preempted", "drained_at",
                 "replaced_at", "epoch")

    def __init__(self, rid: int, arrival: float, priority: int,
                 chips: int, tokens: int):
        self.rid = rid
        self.arrival = arrival
        self.priority = priority
        self.chips = chips
        self.tokens = tokens
        self.remaining = float(tokens)
        self.slice_id: Optional[int] = None
        self.service_start = 0.0
        self.first_start: Optional[float] = None
        self.finish: Optional[float] = None
        self.placements = 0
        self.preempted = 0
        self.drained_at: Optional[float] = None
        self.replaced_at: Optional[float] = None
        self.epoch = 0  # bumped on preempt/drain so stale completions drop


class _Slice:
    __slots__ = ("sid", "capacity", "free", "blocked", "pending_block")

    def __init__(self, sid: int, capacity: int):
        self.sid = sid
        self.capacity = capacity
        self.free = capacity
        self.blocked = False
        #: a RetilePlanned signal named this slice: still serving, but no
        #: NEW placements land here — tenants migrate out during the window
        self.pending_block = False


def _gen_requests(rng: random.Random, duration_s: float,
                  arrival_rate_per_s: float, max_chips: int) -> List[_Request]:
    """Poisson arrivals; Pareto (heavy-tailed) chip footprints and token
    counts — a few whale tenants among many small interactive ones."""
    out: List[_Request] = []
    t = 0.0
    rid = 0
    while True:
        t += rng.expovariate(arrival_rate_per_s)
        if t >= duration_s:
            return out
        chips = min(max_chips, max(1, int(rng.paretovariate(1.6))))
        tokens = max(8, min(4096, int(rng.paretovariate(1.2) * 32)))
        priority = rng.choices(PRIORITIES, weights=_PRIORITY_WEIGHTS)[0]
        out.append(_Request(rid, t, priority, chips, tokens))
        rid += 1


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def run_scenario(groups: Sequence[dict],
                 seed: int = 0,
                 duration_s: float = 60.0,
                 arrival_rate_per_s: float = 2.0,
                 per_token_ms: float = 2.0,
                 queue_slo_s: float = 1.0,
                 retile: Optional[dict] = None,
                 sample_interval_s: Optional[float] = None) -> Dict:
    """Run the multi-tenant scenario against a slice layout.

    ``groups`` is the partitioner handoff's ``groups`` list (each entry
    needs a ``chips`` list; ``topology`` is carried through for labels).
    ``retile``, when given, injects a health-driven re-tile:
    ``{"at": <sim seconds>, "blocked": [group index, ...],
    "drain_window_s": <float>}`` — at that moment the named slices go
    unhealthy, tenants running there drain and re-place.

    ``sample_interval_s``, when given, adds a ``timeseries`` list to the
    result: the scenario's live state sampled every that-many simulated
    seconds — queue depth, backlog chips requested (waiting + running =
    the chips the fleet would need to serve everything now), and rolling
    SLO attainment over recent completions. This is the autoscaler's
    input signal: the fleet simulator replays it tick by tick into the
    ``tpu.ai/traffic-snapshot`` annotation.

    ``retile["planned"] = True`` models the coordinated drain protocol:
    the ``RetilePlanned`` signal fires at ``at`` — the named slices stop
    accepting NEW tenants and the ones running there migrate proactively —
    and the slices only actually block at ``at + drain_window_s`` (the
    deadline). The summary then reports ``drained_within_window``: tenants
    that finished migrating before the deadline.

    ``retile["migrate"] = True`` models the migration subsystem on top:
    drained tenants do NOT re-queue — their decoded progress travels with
    the checkpoint and each resumes directly on a destination slice after
    ``retile["migrate_latency_s"]`` (default 0.25 s, the
    transfer+restore cost), keeping its place ahead of the arrival queue.
    The summary then also reports ``migrated_within_window``.

    Returns a plain dict (JSON-ready); ``unhandled_errors`` counts
    event-loop exceptions and must be 0 in any healthy run.
    """
    rng = random.Random(seed)
    slices = [_Slice(i, len(g.get("chips", [])) or 1)
              for i, g in enumerate(groups)]
    if not slices:
        slices = [_Slice(0, 1)]
    max_chips = max(s.capacity for s in slices)
    requests = _gen_requests(rng, duration_s, arrival_rate_per_s, max_chips)

    # tokens/s a request decodes at: linear in assigned chips (each chip
    # serves its shard of the batch), 1 chip = 1000/per_token_ms tokens/s
    def rate(req: _Request) -> float:
        return req.chips * 1000.0 / per_token_ms

    ARRIVE, COMPLETE, RETILE, PLAN, MIGRATE = 0, 1, 2, 3, 4
    events: List[tuple] = []
    seq = 0
    for req in requests:
        events.append((req.arrival, seq, ARRIVE, req, 0))
        seq += 1
    planned = bool(retile and retile.get("planned"))
    migrate = bool(retile and retile.get("migrate"))
    migrate_latency = (float(retile.get("migrate_latency_s", 0.25))
                       if retile else 0.0)
    if retile:
        if planned:
            # coordinated drain: the plan lands at `at`, the block at the
            # deadline — migration happens in between
            window = float(retile.get("drain_window_s", 5.0))
            events.append((float(retile["at"]), seq, PLAN, None, 0))
            seq += 1
            events.append((float(retile["at"]) + window, seq, RETILE,
                           None, 0))
        else:
            events.append((float(retile["at"]), seq, RETILE, None, 0))
        seq += 1
    heapq.heapify(events)

    waiting: List[_Request] = []
    running: Dict[int, _Request] = {}
    completed: List[_Request] = []
    rejected = 0
    preemptions = 0
    unhandled_errors = 0
    drained: List[_Request] = []
    migrated: List[_Request] = []

    # -- per-tick sampling (the autoscaler's live signal) --
    timeseries: List[dict] = []
    completion_log: List[tuple] = []  # (finish, slo_met) in finish order
    attain_window_s = (max(10.0 * sample_interval_s, queue_slo_s)
                       if sample_interval_s else 0.0)

    def sample(at: float) -> None:
        lo = at - attain_window_s
        recent = [ok for fin, ok in completion_log if fin > lo]
        backlog = sum(r.chips for r in waiting)
        in_service = sum(r.chips for r in running.values())
        timeseries.append({
            "t": round(at, 3),
            "queue_depth": len(waiting),
            "backlog_chips": backlog,
            "demand_chips": backlog + in_service,
            "running": len(running),
            "attainment": (round(sum(recent) / len(recent), 4)
                           if recent else None),
            "completed": len(completed),
        })

    def push_completion(req: _Request, now: float) -> None:
        nonlocal seq
        finish = now + req.remaining / rate(req)
        heapq.heappush(events, (finish, seq, COMPLETE, req, req.epoch))
        seq += 1

    def unplace(req: _Request, now: float) -> None:
        """Take a running request off its slice, crediting decoded tokens."""
        req.remaining = max(0.0, req.remaining - rate(req) * (now - req.service_start))
        slices[req.slice_id].free += req.chips
        req.slice_id = None
        req.epoch += 1
        del running[req.rid]

    def place(req: _Request, sl: _Slice, now: float) -> None:
        sl.free -= req.chips
        req.slice_id = sl.sid
        req.service_start = now
        if req.first_start is None:
            req.first_start = now
        if req.drained_at is not None and req.replaced_at is None:
            req.replaced_at = now
        req.placements += 1
        running[req.rid] = req
        push_completion(req, now)

    def try_place_all(now: float) -> None:
        # interactive first, then arrival order; stable across runs
        waiting.sort(key=lambda r: (r.priority, r.arrival, r.rid))
        still: List[_Request] = []
        for req in waiting:
            sl = next((s for s in slices
                       if not s.blocked and not s.pending_block
                       and s.free >= req.chips), None)
            if sl is None and req.priority == 0:
                # preempt batch traffic: find a slice where evicting
                # strictly-lower-priority tenants frees enough chips
                for cand in slices:
                    if (cand.blocked or cand.pending_block
                            or cand.capacity < req.chips):
                        continue
                    victims = sorted(
                        (r for r in running.values()
                         if r.slice_id == cand.sid and r.priority > 0),
                        key=lambda r: (-r.priority, -r.service_start))
                    freed = cand.free
                    chosen = []
                    for v in victims:
                        if freed >= req.chips:
                            break
                        chosen.append(v)
                        freed += v.chips
                    if freed >= req.chips:
                        for v in chosen:
                            unplace(v, now)
                            v.preempted += 1
                            still.append(v)
                        sl = cand
                        break
            if sl is not None:
                place(req, sl, now)
            else:
                still.append(req)
        waiting[:] = still

    next_sample = 0.0
    while events:
        now, _, kind, req, epoch = heapq.heappop(events)
        if sample_interval_s:
            # state is constant between events, so samples due before this
            # event read the world exactly as the previous event left it
            while next_sample <= min(now, duration_s):
                sample(next_sample)
                next_sample += sample_interval_s
        try:
            if kind == ARRIVE:
                if req.chips > max_chips:
                    rejected += 1
                    continue
                waiting.append(req)
                try_place_all(now)
            elif kind == COMPLETE:
                if req.epoch != epoch or req.rid not in running:
                    continue  # stale: preempted/drained since scheduled
                slices[req.slice_id].free += req.chips
                del running[req.rid]
                req.slice_id = None
                req.remaining = 0.0
                req.finish = now
                completed.append(req)
                if sample_interval_s:
                    ideal = req.tokens / rate(req)
                    completion_log.append(
                        (now, (now - req.arrival) - ideal <= queue_slo_s))
                try_place_all(now)
            elif kind == PLAN:
                # RetilePlanned: named slices stop taking new tenants and
                # running ones start migrating NOW — the whole point of the
                # protocol is that the drain clock starts at the plan, not
                # at the block
                for idx in retile.get("blocked", []):
                    if 0 <= idx < len(slices):
                        slices[idx].pending_block = True
                        for r in [r for r in running.values()
                                  if r.slice_id == idx]:
                            unplace(r, now)
                            r.drained_at = now
                            drained.append(r)
                            if migrate:
                                # migration subsystem: the checkpoint
                                # travels with the tenant; it resumes on
                                # the destination after the transfer
                                # latency, never re-queueing
                                migrated.append(r)
                                heapq.heappush(
                                    events, (now + migrate_latency, seq,
                                             MIGRATE, r, r.epoch))
                                seq += 1
                            else:
                                waiting.append(r)
                try_place_all(now)
            elif kind == RETILE:
                for idx in retile.get("blocked", []):
                    if 0 <= idx < len(slices):
                        slices[idx].blocked = True
                        slices[idx].pending_block = False
                        # stragglers (none in planned mode — the plan
                        # already drained them): drain at the deadline
                        for r in [r for r in running.values()
                                  if r.slice_id == idx]:
                            unplace(r, now)
                            r.drained_at = now
                            drained.append(r)
                            if migrate:
                                migrated.append(r)
                                heapq.heappush(
                                    events, (now + migrate_latency, seq,
                                             MIGRATE, r, r.epoch))
                                seq += 1
                            else:
                                waiting.append(r)
                try_place_all(now)
            elif kind == MIGRATE:
                if req.epoch != epoch or req.slice_id is not None:
                    continue  # stale: already resumed elsewhere
                sl = next((s for s in slices
                           if not s.blocked and not s.pending_block
                           and s.free >= req.chips), None)
                if sl is not None:
                    # restore-on-destination: the tenant lands directly
                    # with its progress intact, ahead of the queue
                    place(req, sl, now)
                else:
                    # destination capacity genuinely missing: degrade to
                    # the re-queue path rather than losing the tenant
                    waiting.append(req)
                    try_place_all(now)
        except Exception:
            unhandled_errors += 1

    if sample_interval_s:
        while next_sample <= duration_s:
            sample(next_sample)
            next_sample += sample_interval_s

    preemptions = sum(r.preempted for r in requests)
    # churn: every placement beyond a request's first (preempt or drain)
    churn = sum(max(0, r.placements - 1) for r in requests)

    lat = sorted(r.finish - r.arrival for r in completed)
    excess = []
    slo_met = 0
    for r in completed:
        ideal = r.tokens / rate(r)
        e = (r.finish - r.arrival) - ideal
        excess.append(e)
        if e <= queue_slo_s:
            slo_met += 1
    excess.sort()

    result = {
        "simulated": True,
        "seed": seed,
        "duration_s": duration_s,
        "slices": [{"capacity": s.capacity, "blocked": s.blocked}
                   for s in slices],
        "arrivals": len(requests),
        "completed": len(completed),
        "rejected": rejected,
        "incomplete": len(waiting) + len(running),
        "slo_attainment": round(slo_met / len(completed), 4) if completed else None,
        "latency_p50_s": round(_percentile(lat, 0.50), 4),
        "latency_p99_s": round(_percentile(lat, 0.99), 4),
        "queue_excess_p50_s": round(_percentile(excess, 0.50), 4),
        "queue_excess_p99_s": round(_percentile(excess, 0.99), 4),
        "preemptions": preemptions,
        "placement_churn": churn,
        "unhandled_errors": unhandled_errors,
    }
    if sample_interval_s:
        result["sample_interval_s"] = sample_interval_s
        result["timeseries"] = timeseries
    if retile:
        window = float(retile.get("drain_window_s", 5.0))
        replaced = [r for r in drained if r.replaced_at is not None]
        within = [r for r in replaced
                  if r.replaced_at - r.drained_at <= window]
        result["retile"] = {
            "at": float(retile["at"]),
            "blocked": list(retile.get("blocked", [])),
            "drain_window_s": window,
            "planned": planned,
            "drained_tenants": len(drained),
            "replaced": len(replaced),
            "replaced_within_window": len(within),
            "all_replaced_within_window": len(within) == len(drained),
            # the drain-protocol bench number: tenants fully migrated off
            # the planned slices before the deadline (== replaced within
            # the window; in planned mode the clock starts at the plan)
            "drained_within_window": len(within),
            "all_drained_within_window": len(within) == len(drained),
            "max_replace_s": round(max(
                (r.replaced_at - r.drained_at for r in replaced),
                default=0.0), 4),
        }
        # migration-subsystem numbers: tenants that resumed on their
        # destination slice (no re-queue) before the drain deadline
        resumed = [r for r in migrated if r.replaced_at is not None]
        m_within = [r for r in resumed
                    if r.replaced_at - r.drained_at <= window]
        result["retile"].update({
            "migrate": migrate,
            "migrated_tenants": len(migrated),
            "migrated_within_window": len(m_within),
            "all_migrated_within_window": len(m_within) == len(migrated),
        })
    return result


def scenario_from_handoff(handoff: Optional[dict], **kwargs) -> Dict:
    """Convenience: run the scenario against a partitioner handoff payload
    (``read_handoff`` result); falls back to one group of one GPU when no
    partition has been applied yet (the reference's fallback is one 4-chip
    slice)."""
    groups = (handoff or {}).get("groups") or [{"topology": "single",
                                                "chips": [0]}]
    return run_scenario(groups, **kwargs)
