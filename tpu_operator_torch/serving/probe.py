"""The serving SLO probe: a miniature continuous-batching decode engine
(counterpart of tpu_operator/serving/probe.py).

One engine step processes a fixed slot array behind an active mask, with a
paged decode cache (per-slot page indirection through a page table;
admission swaps in the one free page, nothing is copied or grown per
token) and mixed prompt/decode admission (each timed step retires one
sequence and prefills a newcomer into its slot). For each depth on the
batch ladder the probe times ``samples`` steps (at least ``min_samples``)
and emits a ``FrontierPoint``: depth -> (p99_ms, tokens/s, samples).

The reference compiles the step once with XLA, since its shapes never
change. The port's counterpart on ``cuda`` is one CUDA graph: the step is
captured once over static buffers sized for the deepest rung and replayed
for every timed step; a rung or an admission only rewrites the buffers'
contents. A capture that fails raises: there is no eager fallback on the
card. On the CPU the step runs eagerly (the tests' plain path).

The two products are plain ``torch.matmul`` (cuBLAS on the card), as the
reference's are plain XLA dots: the step holds no hand-written kernel.
The weights are the identity and the tokens one-hot, so the argmax check
is equality, never a tolerance call.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..device import DeviceLike, platform_of, resolve_device, synchronize
from .frontier import Frontier, FrontierPoint

#: floor on timed steps per measured point: below this a nearest-rank p99
#: is dominated by scheduler noise and consumers cannot judge confidence
MIN_FRONTIER_SAMPLES = 16

#: the stream each device's step is warmed up and captured on, made once per
#: process: cuBLAS keeps a workspace for every (handle, stream) it has run
#: on, so a fresh stream per capture would leave one more workspace behind
#: on every re-probe of a long-lived ``--serving-interval`` loop
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}

#: tokens per cache page; the probe keeps one live row per page (the
#: accumulator), the page granularity is what a real paged KV cache
#: allocates in
PAGE_SIZE = 16


@dataclasses.dataclass
class BatchRungResult:
    """Measured numbers for one rung of the batch ladder."""

    batch: int
    #: requested steps for this rung
    steps: int
    #: timed steps actually measured: max(steps, MIN_FRONTIER_SAMPLES)
    samples: int
    p50_ms: float
    p99_ms: float
    mean_ms: float
    tokens_per_s: float
    #: fraction of this rung's steps whose latency met the p99 SLO ceiling
    slo_attainment: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServingReport:
    passed: bool
    platform: str
    n_devices: int
    #: on ``cuda``, the side-stream warm-up that capture needs plus the
    #: capture of the step into its CUDA graph — what the reference spends
    #: in ``.lower().compile()``; 0.0 on the CPU, where the step runs eagerly
    compile_s: float
    elapsed_s: float
    #: worst rung's tail latency — the number the SLO gate applies to
    decode_p99_ms: float
    decode_p50_ms: float
    #: best rung's steady-state throughput (peak of the ladder)
    throughput_tokens_per_s: float
    #: min over rungs: fraction of steps meeting the p99 SLO ceiling
    slo_attainment: float
    batches: List[dict]
    thresholds: dict
    failures: List[str] = dataclasses.field(default_factory=list)
    #: the measured latency-vs-throughput curve (serving/frontier.py
    #: schema); None only for skipped reports
    frontier: Optional[dict] = None
    #: set when the probe never ran (health-gated node, probe error)
    skipped_reason: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def skipped_report(reason: str, thresholds: Optional[dict] = None) -> ServingReport:
    """A fail-closed report for a probe that never ran: ``passed=False`` so
    the barrier blocks serving traffic, with the reason preserved."""
    return ServingReport(
        passed=False, platform="", n_devices=0, compile_s=0.0, elapsed_s=0.0,
        decode_p99_ms=0.0, decode_p50_ms=0.0, throughput_tokens_per_s=0.0,
        slo_attainment=0.0, batches=[], thresholds=dict(thresholds or {}),
        failures=[f"skipped: {reason}"], frontier=None, skipped_reason=reason)


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an ascending-sorted sequence."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands with an fp32 result that is never rounded
    to bf16: what XLA compiles ``(a @ b).astype(float32)`` to, since it
    allows excess precision by default (the reference's jitted step keeps
    its products' fp32 results; run eagerly, JAX would round them). The
    operands widen exactly, so the products are exact and the sums fp32."""
    return torch.matmul(a.float(), b.float())


def engine_step(tokens: torch.Tensor, pages: torch.Tensor, page_table: torch.Tensor,
                active: torch.Tensor, admit: torch.Tensor, w: torch.Tensor):
    """One decode step over every slot; ``pages`` is updated in place.

    tokens (slots, dim) bf16; pages (n_pages, PAGE_SIZE, dim) fp32;
    page_table (slots,) integer, slot -> page, no page twice; active and
    admit (slots,) fp32 masks; w (dim, dim) bf16. Returns the argmax token
    of each slot (int64; ties go to the first index, as ``jnp.argmax``'s
    do) and ``pages``. The gather and scatter touch one row per slot."""
    cache = pages[page_table, 0, :]
    # prefill: an admitted slot starts from a fresh (zeroed) page
    cache = cache * (1.0 - admit)[:, None]
    h = _dot_f32(tokens, w)
    h = h * active[:, None]
    cache = cache + h
    pages[page_table, 0, :] = cache
    logits = _dot_f32(h.bfloat16(), w)
    return logits.argmax(-1), pages


class DecodeEngine:
    """The step's static buffers, sized for the deepest rung, and the step
    itself: a CUDA graph replay after :meth:`capture`, else eager.

    The page table is int64, the index type of PyTorch's gather and
    scatter (the reference's is int32; an int32 index would add a cast)."""

    def __init__(self, max_batch: int, model_dim: int, device: torch.device):
        self.device = device
        self.w = torch.eye(model_dim, dtype=torch.bfloat16, device=device)
        self.tokens = torch.zeros((max_batch, model_dim), dtype=torch.bfloat16, device=device)
        self.tokens[:, 0] = 1
        # one spare page so admission always has a free page
        self.pages = torch.zeros((max_batch + 1, PAGE_SIZE, model_dim), dtype=torch.float32,
                                 device=device)
        self.page_table = torch.arange(max_batch, dtype=torch.int64, device=device)
        self.active = torch.ones((max_batch,), dtype=torch.float32, device=device)
        self.admit = torch.zeros((max_batch,), dtype=torch.float32, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None

    def args(self):
        """The step's arguments, in ``engine_step``'s order."""
        return (self.tokens, self.pages, self.page_table, self.active, self.admit, self.w)

    def capture(self) -> None:
        """Capture the step into one CUDA graph. Three warm-up steps run
        first on the capture stream, as ``torch.cuda.graph`` wants (cuBLAS
        creates its handle and workspace there, outside the capture); their
        writes to the cache are then cleared, so the first replay starts from
        zeroed pages. Raises if any op of the step cannot be captured.

        The stream is the device's one capture stream (``_CAPTURE_STREAMS``).
        ``torch.cuda.graph`` empties the allocator's cache on entry, which
        returns the private pools of earlier graphs already destroyed, so
        repeated probes in one process hold the same memory."""
        stream = _CAPTURE_STREAMS.get(self.device)
        if stream is None:
            stream = _CAPTURE_STREAMS[self.device] = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for _ in range(3):
                engine_step(*self.args())
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            self.out, _ = engine_step(*self.args())
        self.graph = graph
        self.pages.zero_()
        synchronize(self.device)

    def load(self, page_table: Sequence[int], admit_slot: Optional[int] = None) -> None:
        """Write this step's page table and admission mask into the buffers."""
        self.page_table.copy_(torch.tensor(page_table, dtype=torch.int64))
        admit = torch.zeros(self.admit.shape, dtype=torch.float32)
        if admit_slot is not None:
            admit[admit_slot] = 1.0
        self.admit.copy_(admit)

    def set_depth(self, batch: int) -> None:
        self.active.copy_((torch.arange(self.active.numel()) < batch).float())

    def step(self) -> torch.Tensor:
        """Run one step (asynchronously on the card); returns the argmax."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self.out, _ = engine_step(*self.args())
        return self.out


def run_probe(batch_sizes: Sequence[int] = (1, 4, 8),
              steps_per_batch: int = 32,
              max_decode_p99_ms: float = 200.0,
              min_throughput_tokens_per_s: float = 0.0,
              min_slo_attainment: float = 0.99,
              model_dim: int = 256,
              min_samples: int = MIN_FRONTIER_SAMPLES,
              device: DeviceLike = None) -> ServingReport:
    """Run the continuous-batching engine across the batch ladder, measure
    the frontier, gate on SLOs. Runs on ``cuda`` (one CUDA graph) unless
    ``device="cpu"`` (eager); raises without a card."""
    dev = resolve_device(device)
    start = time.monotonic()
    max_batch = max(batch_sizes) if batch_sizes else 1
    engine = DecodeEngine(max_batch, model_dim, dev)

    compile_s_total = 0.0
    if dev.type == "cuda":
        compile_start = time.monotonic()
        engine.capture()
        compile_s_total = time.monotonic() - compile_start

    # warm-up step: first execution can still pay dispatch setup
    out = engine.step()
    synchronize(dev)

    rungs: List[BatchRungResult] = []
    failures: List[str] = []
    if int(out[0]) != 0:  # identity weights: argmax must be column 0
        failures.append(f"decode produced wrong argmax {int(out[0])} "
                        f"(expected 0)")

    for batch in batch_sizes:
        samples = max(int(steps_per_batch), int(min_samples))
        engine.set_depth(batch)
        # host-side page bookkeeping: slot -> page, plus one free page so
        # every admission lands on a DIFFERENT page than the one retired
        table = list(range(max_batch))
        free_page = max_batch
        lat_s: List[float] = []
        for step in range(samples):
            # continuous-batching admission: one sequence retires, a new
            # one is prefilled into its slot on a freshly-mapped page
            slot = step % batch
            table[slot], free_page = free_page, table[slot]
            engine.load(table, admit_slot=slot)
            synchronize(dev)  # the buffers are written before the clock starts
            t0 = time.monotonic()
            out = engine.step()
            synchronize(dev)
            lat_s.append(time.monotonic() - t0)
        if int(out[0]) != 0:
            failures.append(f"batch={batch}: decode produced wrong argmax "
                            f"{int(out[0])} (expected 0)")
        lat_s.sort()
        p50 = _percentile(lat_s, 0.50) * 1000
        p99 = _percentile(lat_s, 0.99) * 1000
        total = sum(lat_s)
        met = sum(1 for s in lat_s if s * 1000 <= max_decode_p99_ms)
        rungs.append(BatchRungResult(
            batch=batch, steps=int(steps_per_batch), samples=samples,
            p50_ms=round(p50, 4), p99_ms=round(p99, 4),
            mean_ms=round(total / len(lat_s) * 1000, 4),
            tokens_per_s=round(batch * len(lat_s) / total, 1) if total else 0.0,
            slo_attainment=round(met / len(lat_s), 4)))

    elapsed = time.monotonic() - start
    worst_p99 = max((r.p99_ms for r in rungs), default=0.0)
    worst_p50 = max((r.p50_ms for r in rungs), default=0.0)
    peak_tps = max((r.tokens_per_s for r in rungs), default=0.0)
    attainment = min((r.slo_attainment for r in rungs), default=0.0)

    if worst_p99 > max_decode_p99_ms:
        failures.append(f"decode_p99_ms={worst_p99} above SLO ceiling "
                        f"{max_decode_p99_ms}")
    if min_throughput_tokens_per_s > 0 and peak_tps < min_throughput_tokens_per_s:
        failures.append(f"throughput_tokens_per_s={peak_tps} below required "
                        f"floor {min_throughput_tokens_per_s}")
    if attainment < min_slo_attainment:
        failures.append(f"slo_attainment={attainment} below required "
                        f"{min_slo_attainment}")

    frontier = Frontier(
        points=[FrontierPoint(batch=r.batch, p99_ms=r.p99_ms,
                              tokens_per_s=r.tokens_per_s, samples=r.samples)
                for r in rungs],
        model_dim=model_dim,
        measured_at=round(time.time(), 3))

    return ServingReport(
        passed=not failures,
        platform=platform_of(dev),
        n_devices=torch.cuda.device_count() if dev.type == "cuda" else 1,
        compile_s=round(compile_s_total, 4),
        elapsed_s=round(elapsed, 4),
        decode_p99_ms=round(worst_p99, 4),
        decode_p50_ms=round(worst_p50, 4),
        throughput_tokens_per_s=peak_tps,
        slo_attainment=attainment,
        batches=[r.to_dict() for r in rungs],
        thresholds={
            "max_decode_p99_ms": max_decode_p99_ms,
            "min_throughput_tokens_per_s": min_throughput_tokens_per_s,
            "min_slo_attainment": min_slo_attainment,
        },
        failures=failures,
        frontier=frontier.to_dict(),
    )
