"""Perf validation of the PyTorch port (tpu_operator_torch/validator/perf.py)
held against tpu_operator/validator/perf.py: the shared report schema, the
H100 peak rows, and the gates, driven with monkeypatched measures on both
packages (real timings on the CPU sit at the noise floor, so no test here
asserts that a timing gate passes).

The twin of tests/test_perf.py.
"""

import dataclasses

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


CHAIN_CASES = {
    # name: (cross_check, durations of the timed runs in order, kept, discarded, iters)
    "probes under the floor": (False, [0.001, 0.004, 0.016, 0.064, 0.06, 0.07],
                               0.194, 0.021, 64),
    "samples at a length left": (False, [0.06, 0.01, 0.01, 0.06, 0.07, 0.06],
                                 0.19, 0.08, 4),
    "cross-checked": (True, [0.01, 0.06, 0.05, 0.06, 0.05, 0.06, 0.05], 0.33, 0.01, 4),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_time_splits_its_runs_into_kept_and_discarded(monkeypatch, case):
    cross_check, runs, kept, discarded, iters = CHAIN_CASES[case]
    clock = _FakeClock(runs)
    clock.install(monkeypatch)
    times = perf.ChainTimes()
    _, ok, settled, _ = perf._chain_time(lambda x: x, torch.zeros(2), 1, torch.device("cpu"),
                                         cross_check=cross_check, times=times)
    assert clock.runs == [] and ok and settled == iters == times.iters
    assert times.kept_s == pytest.approx(kept) and times.discarded_s == pytest.approx(discarded)
    assert times.rtt_s == 0.0 and not times.retried


@pytest.mark.parametrize("retry", [False, True], ids=["in-band", "retried"])
def test_a_retried_cross_check_discards_the_first_attempt(monkeypatch, retry):
    """The GEMM grows 5 -> 20 calls; out of band (fetch twice the block
    close) it is timed again from 20, and its first attempt is thrown away."""
    from tpu_operator_torch import tracing
    from tpu_operator_torch.joinprofile import records

    first_block = 0.03 if retry else 0.06
    runs = [0.01, 0.06, first_block, 0.06, first_block, 0.06, first_block]
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

    kept, discarded = (0.36, 0.01 + 0.27) if retry else (0.36, 0.01)
    assert delta("perf.gemm.iters") == 20
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
