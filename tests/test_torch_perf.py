"""Perf validation of the PyTorch port (tpu_operator_torch/validator/perf.py)
held against tpu_operator/validator/perf.py: the shared report schema, the
H100 peak rows, and the gates, driven with monkeypatched measures on both
packages (real timings on the CPU sit at the noise floor, so no test here
asserts that a timing gate passes).

The twin of tests/test_perf.py.
"""

import dataclasses
import weakref

import pytest
import torch

from tpu_operator.validator import perf as ref_perf
from tpu_operator_torch.ranks import run_ranks
from tpu_operator_torch.validator import perf

TINY = dict(matrix_dim=128, hbm_mib=4, ici_mib=1, iters=2)
H100 = ("h100-sxm5", 989.0, 3350.0)


def test_report_schema_matches_reference():
    port_fields = [f.name for f in dataclasses.fields(perf.PerfReport)]
    ref_fields = [f.name for f in dataclasses.fields(ref_perf.PerfReport)]
    assert port_fields == ref_fields
    assert perf.PerfReport().to_dict() == ref_perf.PerfReport().to_dict()


def test_gate_constants_match_reference():
    assert perf.MAX_PEAK_FRACTION == ref_perf.MAX_PEAK_FRACTION
    assert perf.CROSS_CHECK_BAND == ref_perf.CROSS_CHECK_BAND
    assert perf.HBM_STREAMING_BAND == ref_perf.HBM_STREAMING_BAND


@pytest.mark.parametrize("name, expected", [
    ("NVIDIA H100 80GB HBM3", ("h100-sxm5", 989.0, 3350.0)),
    ("NVIDIA H100 SXM5 80GB", ("h100-sxm5", 989.0, 3350.0)),
    ("NVIDIA H100 PCIe", ("h100-pcie", 756.0, 2000.0)),
    ("NVIDIA H100 NVL", ("h100-nvl", 835.0, 3900.0)),
    ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", None),
])
def test_lookup_peaks(name, expected):
    assert perf.lookup_peaks(name) == expected


def _patch(monkeypatch, mod, mxu, hbm, ici, twin, peaks=H100):
    twin_name = ("measure_hbm_kernel_gbps" if mod is perf
                 else "measure_hbm_pallas_gbps")
    monkeypatch.setattr(mod, "measure_mxu_tflops", lambda *a, **k: mxu)
    monkeypatch.setattr(mod, "measure_hbm_gbps", lambda *a, **k: hbm)
    monkeypatch.setattr(mod, "measure_ici_allreduce_gbps", lambda *a, **k: ici)
    monkeypatch.setattr(mod, twin_name, twin if callable(twin) else lambda *a, **k: twin)
    monkeypatch.setattr(mod, "lookup_peaks", lambda kind: peaks)


def _run_both(monkeypatch, thresholds=None, **measures):
    reports = []
    for mod, kwargs in ((perf, {"device": "cpu"}), (ref_perf, {})):
        _patch(monkeypatch, mod, **measures)
        reports.append(mod.run_perf(thresholds=thresholds, **TINY, **kwargs))
    return reports


HEALTHY = dict(mxu=(700.0, True, 0.993), hbm=(2516.1, True), ici=(None, True),
               twin=(2791.6, True))

SCENARIOS = {
    # name: (measure overrides, thresholds, failure substrings expected)
    "healthy": ({}, None, []),
    "streaming disagreement": ({"twin": (5100.0, True)}, None, ["streaming"]),
    "hbm over peak": ({"hbm": (3600.0, True), "twin": (3590.0, True)}, None,
                      ["hbm_peak_fraction"]),
    "mxu over peak": ({"mxu": (1100.0, True, 1.0)}, None, ["mxu_peak_fraction"]),
    "cross-check out of band": ({"mxu": (700.0, True, 1.3)}, None, ["timing"]),
    "noise floor": ({"hbm": (2516.1, False)}, None, ["timing"]),
    "mxu below floor": ({}, {"mxu_tflops": 800.0}, ["mxu_tflops"]),
    "ici floor on one card": ({}, {"ici_allreduce_gbps": 100.0}, ["not measured"]),
    "ici below floor": ({"ici": (150.0, True)}, {"ici_allreduce_gbps": 300.0},
                        ["ici_allreduce_gbps"]),
    "twin absent": ({"twin": (0.0, False)}, None, []),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gates_agree_with_reference(monkeypatch, name):
    overrides, thresholds, expected = SCENARIOS[name]
    port, ref = _run_both(monkeypatch, thresholds, **{**HEALTHY, **overrides})
    assert port.passed == ref.passed == (not expected)
    assert len(port.failures) == len(ref.failures)
    for substring in expected:
        assert any(substring in f for f in port.failures), port.failures
    for key in ("measurement_valid", "mxu_tflops", "hbm_gbps", "ici_allreduce_gbps",
                "ici_skipped", "mxu_peak_fraction", "hbm_peak_fraction",
                "mxu_cross_check_ratio", "hbm_pallas_gbps",
                "hbm_streaming_cross_check_ratio"):
        assert getattr(port, key) == getattr(ref, key), key
    assert port.platform == "cpu" and port.device_kind == "cpu"


def test_streaming_reading_recorded(monkeypatch):
    port, _ = _run_both(monkeypatch, **HEALTHY)
    assert port.hbm_pallas_gbps == 2791.6
    assert port.hbm_streaming_cross_check_ratio == round(2516.1 / 2791.6, 3)
    assert port.chip == "h100-sxm5" and port.ici_skipped


def test_kernel_failure_is_a_visible_failure(monkeypatch):
    """On the card the kernel measure propagates its errors: the sweep
    records them and fails, it never reads 0.0 and passes."""
    def broken(*a, **k):
        raise RuntimeError("nvcc not found")

    _patch(monkeypatch, perf, **{**HEALTHY, "twin": broken})
    report = perf.run_perf(device="cpu", **TINY)
    assert not report.passed and not report.measurement_valid
    assert report.failures == ["perf sweep failed: nvcc not found"]
    assert report.hbm_pallas_gbps == 0.0


def test_run_perf_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default measures it")
    with pytest.raises(RuntimeError, match="CUDA"):
        perf.run_perf(**TINY)


def test_real_cpu_measures_run():
    """Real measures at tiny sizes: positive numbers of the right shape
    (timing trust is not asserted on the CPU)."""
    tflops, _, ratio = perf.measure_mxu_tflops(64, iters=1, device="cpu")
    assert tflops > 0 and ratio is not None and ratio > 0
    gbps, _ = perf.measure_hbm_gbps(1, iters=1, device="cpu")
    assert gbps > 0
    assert perf.measure_ici_allreduce_gbps(1, device="cpu") == (None, True)


def test_chain_time_grows_the_chain():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    t, _, iters, ratio = perf._chain_time(fn, torch.zeros(4), 1, torch.device("cpu"),
                                          cross_check=True, max_iters=16)
    assert t > 0 and ratio is not None
    assert iters in (1, 4, 16)
    assert len(calls) > iters


def test_allreduce_ranks_agree_on_gloo():
    """Two gloo ranks run the all-reduce bandwidth measure; every growth
    decision is taken on agreed numbers, so both report the same value."""
    results = run_ranks(perf._allreduce_rank, 2, "cpu", args=(1, 2, 5.0),
                        timeout_s=120)
    (g0, ok0), (g1, ok1) = results
    assert g0 > 0 and g0 == g1 and ok0 == ok1


# -- where a measurement's time goes: spans and counters ------------------------

class _FakeClock:
    """``perf``'s clock, moved only by the closes of timed runs: each
    ``_fetch_one`` or ``synchronize`` takes the next duration of ``runs``
    after the warm-up's fetch and the five round-trip fetches, which take
    none (so the floor is 50 ms)."""

    def __init__(self, runs):
        self.now = 0.0
        self.runs = list(runs)
        self.warmup_fetches = 0

    def perf_counter(self):
        return self.now

    def close(self, *_):
        if self.warmup_fetches < 6:
            self.warmup_fetches += 1
            return 0.0
        self.now += self.runs.pop(0)
        return 0.0

    def install(self, monkeypatch):
        monkeypatch.setattr(perf, "time", self)
        monkeypatch.setattr(perf, "_fetch_one", self.close)
        monkeypatch.setattr(perf, "synchronize", self.close)


@dataclasses.dataclass
class Chain:
    """A fake-clock chain from 1 call: the durations of its timed runs in
    order, where they went, its settled length and the probes it threw away."""
    runs: list
    kept: float
    discarded: float
    iters: int
    probes: int
    cross_check: bool = False
    max_iters: int = 4096
    ok: bool = True


CHAIN_CASES = {
    # the first probe's 1 ms a call predicts 64 calls, 64 ms: 4 and 16 are skipped
    "probes under the floor": Chain([0.001, 0.064, 0.06, 0.07], 0.194, 0.001, 64, 1),
    # the median of the first length's samples falls under the floor: x4, as before
    "samples at a length left": Chain([0.06, 0.01, 0.01, 0.06, 0.07, 0.06], 0.19, 0.08, 4, 0),
    # 11 ms a call: 4 calls, predicted 44 ms, is within 20% of the floor and timed first
    "cross-checked": Chain([0.011, 0.06, 0.05, 0.06, 0.05, 0.06, 0.05], 0.33, 0.011, 4, 1,
                           cross_check=True),
    # 2 ms a call: 16 calls, predicted 32 ms, is far under the floor; 64 clears
    "the jump settles at once": Chain([0.002, 0.13, 0.13, 0.12, 0.13, 0.14, 0.13], 0.78,
                                      0.002, 64, 1, cross_check=True),
    # predicted 64 ms at 64 calls, read 40 ms: the chain grows x4 from there
    "a sized probe under the floor grows x4": Chain([0.001, 0.04, 0.16, 0.15, 0.17], 0.48,
                                                    0.041, 256, 2),
    # the guard's step below reads under the floor too: the chain goes on to 16
    "the step below timed first, then x4": Chain([0.011, 0.045, 0.18, 0.17, 0.19], 0.54,
                                                 0.056, 16, 2),
    # 16 calls is the longest: the run there is kept, under the floor, as untrustworthy
    "the max_iters cap": Chain([0.001, 0.02, 0.02, 0.02], 0.06, 0.001, 16, 1,
                               max_iters=16, ok=False),
    "the first probe clears": Chain([0.06, 0.05, 0.07], 0.18, 0.0, 1, 0),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_time_splits_its_runs_into_kept_and_discarded(monkeypatch, case):
    chain = CHAIN_CASES[case]
    clock = _FakeClock(chain.runs)
    clock.install(monkeypatch)
    times = perf.ChainTimes()
    _, ok, settled, _ = perf._chain_time(lambda x: x, torch.zeros(2), 1, torch.device("cpu"),
                                         cross_check=chain.cross_check,
                                         max_iters=chain.max_iters, times=times)
    assert clock.runs == [] and ok is chain.ok and settled == chain.iters == times.iters
    assert times.kept_s == pytest.approx(chain.kept)
    assert times.discarded_s == pytest.approx(chain.discarded)
    assert times.probes == chain.probes and times.rtt_s == 0.0 and not times.retried


class _LinearDevice:
    """A device whose chain of ``n`` calls takes ``n * per_call`` s, and whose
    every fetch takes ``rtt`` s more, for the port's and the reference's
    ``_chain_time`` alike: ``fn`` counts the calls, the fetch closes them."""

    def __init__(self, per_call, rtt):
        self.per_call, self.rtt = per_call, rtt
        self.now, self.pending, self.closes = 0.0, 0, []

    def perf_counter(self):
        return self.now

    def fn(self, x):
        self.pending += 1
        return x

    def fetch(self, _out):
        self.now += self.pending * self.per_call + self.rtt
        self.closes.append(self.pending)
        self.pending = 0
        return 0.0

    def settle(self, module, monkeypatch, *device):
        """``module._chain_time``'s settled length, and the lengths of the
        runs it threw away (those before the three samples)."""
        with monkeypatch.context() as m:
            m.setattr(module, "time", self)
            m.setattr(module, "_fetch_one", self.fetch)
            _, _, iters, _ = module._chain_time(self.fn, torch.zeros(2), 5, *device,
                                                cross_check=False)
        runs = self.closes[6:]  # past the warm-up and the five round trips
        return iters, runs[:-3]


def _straddles():
    """Per-call times a hundredth either side of where each x4 length from
    5 calls (to 5120, past the 4096 cap) just clears the floor, and either
    side of where it is predicted at the sizing guard's 80% of the floor,
    on the floor's two forms."""
    for rtt in (0.0, 0.004):  # floor 50 ms, then 20 RTTs: 80 ms
        floor = max(20 * rtt, 0.05)
        for length in (5, 20, 80, 320, 1280, 5120):
            for side in (0.99, 1.01):
                yield pytest.param((floor - rtt) / length * side, rtt,
                                   id=f"rtt{rtt}-{length}x{side}")
                yield pytest.param(((1 - perf.SIZING_MARGIN) * floor - rtt) / length * side,
                                   rtt, id=f"rtt{rtt}-guard{length}x{side}")


@pytest.mark.parametrize("per_call, rtt", list(_straddles()))
def test_the_sized_chain_settles_where_the_reference_climbs(monkeypatch, per_call, rtt):
    """On a device whose runs take their length times a per-call time, the
    port settles at the length the reference's x4 climb reaches, and
    throws away no more runs: the first probe, and the step below where
    the guard times it."""
    ref_iters, ref_thrown = _LinearDevice(per_call, rtt).settle(ref_perf, monkeypatch)
    port_iters, port_thrown = _LinearDevice(per_call, rtt).settle(
        perf, monkeypatch, torch.device("cpu"))
    assert port_iters == ref_iters
    assert len(port_thrown) <= min(len(ref_thrown), 2)
    assert port_thrown == [n for n in ref_thrown if n in port_thrown]
    if len(ref_thrown) > 2:
        assert len(port_thrown) < len(ref_thrown)


class _AllocatingDevice(_LinearDevice):
    """A linear device whose calls each return a new buffer, and where a
    call that holds more buffers at once than any call before it pays
    ``alloc`` s (a caching allocator's first allocation of a block)."""

    def __init__(self, per_call, rtt, alloc):
        super().__init__(per_call, rtt)
        self.alloc, self.live, self.peak, self.owed = alloc, 0, 0, 0.0

    def fn(self, x):
        super().fn(x)
        buf = type("Buffer", (), {})()
        self.live += 1
        weakref.finalize(buf, self._free)
        if self.live > self.peak:
            self.peak, self.owed = self.live, self.owed + self.alloc
        return buf

    def _free(self):
        self.live -= 1

    def fetch(self, out):
        self.now, self.owed = self.now + self.owed, 0.0
        return super().fetch(out)


def test_the_first_probe_pays_for_no_allocation(monkeypatch):
    """The HBM probe on an H100: 0.36 ms a launch, two 512 MiB buffers
    first allocated at about 0.45 ms each. Paid inside the first probe,
    they would read 80 launches as 43 ms, near enough the floor for the
    step below to be timed first; the warm-up pays them, and the chain
    goes from 5 launches straight to the reference's 320."""
    ref_iters, _ = _AllocatingDevice(0.00036, 2e-5, 0.00045).settle(ref_perf, monkeypatch)
    port_iters, port_thrown = _AllocatingDevice(0.00036, 2e-5, 0.00045).settle(
        perf, monkeypatch, torch.device("cpu"))
    assert port_iters == ref_iters == 320 and port_thrown == [5]


@pytest.mark.parametrize("retry", [False, True], ids=["in-band", "retried"])
def test_a_retried_cross_check_discards_the_first_attempt(monkeypatch, retry):
    """The GEMM's first probe, 15 ms at 5 calls, sizes it at 20; out of band
    (fetch twice the block close) it is timed again from 20, and its first
    attempt is thrown away."""
    from tpu_operator_torch import tracing
    from tpu_operator_torch.joinprofile import records

    first_block = 0.03 if retry else 0.06
    runs = [0.015, 0.06, first_block, 0.06, first_block, 0.06, first_block]
    if retry:
        runs += [0.0] * 6 + [0.06] * 6  # the retry's warm-up fetches, then its runs
    clock = _FakeClock(runs)
    clock.install(monkeypatch)
    before = tracing.counters()
    captured = []
    with tracing.remote_trace("operand.perf", "0123456789abcdef0123456789abcdef-fedcba9876543210",
                              sink=captured.append):
        _, ok, ratio = perf.measure_mxu_tflops(8, iters=5, device="cpu")
    assert clock.runs == [] and ok and ratio == 1.0
    after = tracing.counters()

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    kept, discarded = (0.36, 0.015 + 0.27) if retry else (0.36, 0.015)
    assert delta("perf.gemm.iters") == 20 and delta("perf.chain.probes") == 1
    assert delta("perf.chain.kept_s") == pytest.approx(kept)
    assert delta("perf.chain.discarded_s") == pytest.approx(discarded)
    assert delta("perf.prep_s") == pytest.approx(0.0, abs=1e-12)  # the clock moves in runs only
    attrs = {r["n"]: r["a"] for r in records.span_to_records(captured[-1])}["perf.gemm"]
    assert attrs["iters"] == 20 and attrs["retried"] is retry
    assert attrs["kept_s"] == pytest.approx(kept) and attrs["discarded_s"] == pytest.approx(discarded)
    assert attrs["prep_s"] == 0.0 and attrs["rtt_s"] == 0.0


def test_a_traced_cpu_certification_adds_at_most_six_records(tmp_path, monkeypatch):
    """``-c perf`` on the CPU at tiny sizes under a join trace: one span a
    chain measurement under ``perf.sweep``, each carrying where its time
    went, none for the all-reduce on one device, and the join profiler
    charges every record to ``validation-run``."""
    from tpu_operator_torch.joinprofile import critical_path, records
    from tpu_operator_torch.validator import main as vmain

    monkeypatch.setenv("GPU_TRACE_PARENT", "0123456789abcdef0123456789abcdef-fedcba9876543210")
    log = records.SpanLog(str(tmp_path))
    log.append([{"i": "00000000000000aa", "p": "", "t": "0" * 32, "n": "driver.validate",
                 "s": 1.0, "d": 0.5, "st": "ok", "a": {}}])
    vmain.run(["-c", "perf", "--device=cpu", "--perf-matrix-dim=32", "--perf-hbm-mib=1",
               "--perf-ici-mib=1", f"--status-dir={tmp_path}"])
    recs = [r for r in log.read() if r["n"] != "driver.validate"]
    assert len(log.read()) - 1 == len(recs) <= 6
    by_name = {r["n"]: r for r in recs}
    assert sorted(by_name) == ["operand.perf", "perf.gemm", "perf.hbm", "perf.k1",
                               "perf.sweep"]
    for name in ("perf.gemm", "perf.hbm", "perf.k1"):
        assert by_name[name]["p"] == by_name["perf.sweep"]["i"]
        assert set(by_name[name]["a"]) == {"iters", "kept_s", "discarded_s", "prep_s",
                                           "rtt_s", "retried"}
    assert by_name["perf.gemm"]["a"]["iters"] >= 5 and by_name["perf.gemm"]["a"]["kept_s"] > 0
    assert by_name["perf.k1"]["a"]["iters"] == 0  # no kernel to time on the CPU
    assert {critical_path.phase_of(r["n"]) for r in recs} == {"validation-run"}
    assert {p for p, _, _ in critical_path.record_intervals(recs)} == {"validation-run"}


@pytest.mark.parametrize("gpus", [1, 4])
def test_the_allreduce_span_is_opened_only_across_gpus(monkeypatch, gpus):
    """One GPU measures no all-reduce and opens no span; with more, one
    plain ``perf.allreduce`` span around the ranks carries their number."""
    from tpu_operator_torch import tracing
    from tpu_operator_torch.joinprofile import records

    monkeypatch.setattr(perf, "resolve_device", lambda _d: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    monkeypatch.setattr(perf, "run_ranks", lambda fn, n, kind, args: [(123.0, True)] * n)
    captured = []
    with tracing.remote_trace("operand.perf", "0123456789abcdef0123456789abcdef-fedcba9876543210",
                              sink=captured.append):
        got = perf.measure_ici_allreduce_gbps(1, iters=5, device="cuda")
    recs = {r["n"]: r["a"] for r in records.span_to_records(captured[-1])}
    if gpus == 1:
        assert got == (None, True) and "perf.allreduce" not in recs
    else:
        assert got == (123.0, True) and recs["perf.allreduce"] == {"ranks": gpus}
