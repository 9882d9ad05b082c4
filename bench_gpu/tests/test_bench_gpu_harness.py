"""The harness on the CPU: cells, configurations, mixes and metrics found
by name; new files picked up with no edit; the result's keys; the
window's arithmetic; the roofline counts; the readers on a made-up trace;
the comparison; and what the harness and the reference import."""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_gpu import run, sizes, spec, traffic
from bench_gpu.counts import gemm, k1
from bench_gpu.references import certify
from bench_gpu.trace import DeviceOp, DeviceTrace, HostOp

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_gpu"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
H100 = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


def _tree_digest(path: Path) -> dict:
    return {str(p.relative_to(path)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_found_by_name(entry):
    cell = spec.load_cell(ROOT, entry["name"])
    assert cell.chips == entry["chips"]
    assert cell.config["name"] == entry["config"]
    assert cell.mix["name"] == entry["traffic"]
    assert cell.driver.__name__ == f"bench_gpu.drivers.{cell.mix['driver']}"
    assert cell.reference.__name__ == f"bench_gpu.references.{cell.mix['reference']}"
    assert callable(cell.driver.prepare) and callable(cell.reference.checks)
    wanted = [m["name"] for m in SPEC["per_layer"]
              if entry["name"] in m.get("workloads", [entry["name"]])]
    assert [m.name for m in cell.per_layer] == wanted
    assert {m.name for m in cell.end_to_end} == {"certify_s", "setup_s"}
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(metric.module.read)


def test_every_configuration_file_is_its_entry():
    files = set()
    for entry in SPEC["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        assert config["name"] == entry["name"]
        assert config["source"] == entry["source"]
        assert config["reduced"] == entry["reduced"]
        for key in ("deployment", "assumed", "validator_flags", "gpus"):
            assert key in config, key
        assert entry["file"].startswith("bench_gpu/configs/")
        files.add(entry["file"])
    assert len(files) == len(SPEC["configs"])


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_sizes_are_what_the_validator_reads_from_the_flags(entry):
    """The warm-up, the reference and the counts read the sizes from the
    flags the timed pass is given, as the validator's own parser reads them."""
    from tpu_operator_torch.validator.main import build_parser

    flags = json.loads((ROOT / entry["file"]).read_text())["validator_flags"]
    args = build_parser().parse_args(["-c", "perf", *flags])
    assert sizes.perf_sizes(flags) == {"matrix_dim": args.perf_matrix_dim,
                                       "hbm_mib": args.perf_hbm_mib,
                                       "ici_mib": args.perf_ici_mib}
    assert sizes.perf_sizes(["--perf-hbm-mib=256", "--perf-matrix-dim", "1024",
                             "--perf-ici-mib", "8", "--min-hbm-gbps", "0"]) == {
        "matrix_dim": 1024, "hbm_mib": 256, "ici_mib": 8}
    with pytest.raises(ValueError, match="--perf-ici-mib"):
        sizes.perf_sizes(["--perf-matrix-dim", "4096", "--perf-hbm-mib", "512"])


ECHO_DRIVER = """\
\"\"\"A made-up kind of pass that is not a certification: each pass
reports the configuration's number back.\"\"\"
import time

from bench_gpu import traffic


class Echo:
    def __init__(self, number):
        self.number = number
        self.setup_parts = {"echo_load_s": 0.25}

    def run_pass(self, index, spans):
        t0 = time.perf_counter()
        with spans.span("pass"):
            time.sleep(0.01)
        report = {"passed": True, "number": self.number}
        return traffic.Pass(index, t0, time.perf_counter(), 0, report, dict(report))


def prepare(config, mix, status_dir, log):
    log("set-up: echo ready")
    return Echo(config["number"])
"""
ECHO_REFERENCE = """\
def measure(config, seed, lower=False):
    return {"number": config["number"]}


def checks(passes, ref, config, peaks):
    worst = max(abs(p.report["number"] - ref["number"]) for p in passes)
    return {"number_gap": {"value": worst, "limit": 0}}


def correct(compared):
    return all(c["value"] <= c["limit"] for c in compared.values())
"""


def _fake_card(monkeypatch):
    """torch.cuda's calls that ``execute`` makes, answered without a card."""
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "made-up card")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda i=0: 1)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)


def test_new_configuration_mix_and_metric_need_no_edit(tmp_path, monkeypatch):
    """A later cell of another kind of pass brings a configuration, a mix
    naming its own driver and reference, and a metric, as new files and
    entries; it runs end to end, and nothing that is there changes."""
    before = _tree_digest(BENCH)
    bench = tmp_path / "bench_gpu"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "configs" / "echo-node.json").write_text(json.dumps(
        {"name": "echo-node", "source": "https://example.org/echo", "reduced": [],
         "gpus": 1, "number": 7}))
    (bench / "mixes" / "echo.json").write_text(json.dumps(
        {"name": "echo", "driver": "echo_bench_test", "reference": "echo_bench_test",
         "loop": "closed", "clients": 1}))
    (bench / "drivers" / "echo_bench_test.py").write_text(ECHO_DRIVER)
    (bench / "references" / "echo_bench_test.py").write_text(ECHO_REFERENCE)
    (bench / "metrics" / "echo.passes_n.py").write_text("def read(run):\n"
                                                       "    return len(run.passes)\n")
    doc = json.loads(json.dumps(SPEC))
    doc["configs"].append({"name": "echo-node", "source": "https://example.org/echo",
                           "file": "bench_gpu/configs/echo-node.json", "reduced": [],
                           "why": "x"})
    doc["workloads"].append({"name": "echo-1gpu", "config": "echo-node", "traffic": "echo",
                             "chips": 1, "why": "x"})
    doc["per_layer"].append({"name": "echo.passes_n", "unit": "passes", "better": "higher",
                             "source": "program_counter", "layer": "Echo",
                             "moves": "certify_s", "workloads": ["echo-1gpu"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    for name in ("bench_gpu.drivers.echo_bench_test", "bench_gpu.references.echo_bench_test"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    cell = spec.load_cell(tmp_path, "echo-1gpu", bench_dir=bench)
    assert cell.config["number"] == 7 and cell.mix["driver"] == "echo_bench_test"
    # the metrics that list their cells read only there
    assert [m.name for m in cell.per_layer] == ["echo.passes_n"]
    old = spec.load_cell(tmp_path, "perf-1gpu", bench_dir=bench)
    assert "echo.passes_n" not in [m.name for m in old.per_layer]
    assert old.driver.__name__ == "bench_gpu.drivers.certify"

    _fake_card(monkeypatch)
    result = run.execute(cell, 2**31 + 11, 0.05, False)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"certify_s", "setup_s"}
    assert result["checks"] == {"number_gap": {"value": 0, "limit": 0}}
    assert result["device"]["kind"] == "made-up card"
    traced = run.execute(cell, 2**31 + 12, 0.05, True)
    assert traced["correct"]
    assert traced["metrics"]["echo.passes_n"]["value"] == traced["attempted"]
    assert list(traced)[-2:] == ["breakdown", "checks"]
    # a pass that reports a wrong number is not correct
    monkeypatch.setattr(cell.driver.Echo, "run_pass",
                        lambda self, i, spans, real=cell.driver.Echo.run_pass: dataclasses.replace(
                            real(self, i, spans), report={"passed": True, "number": 8}))
    assert not run.execute(cell, 2**31 + 13, 0.05, False)["correct"]
    assert _tree_digest(BENCH) == before


def test_unknown_cell_is_refused():
    with pytest.raises(spec.SpecError):
        spec.load_cell(ROOT, "no-such-cell")


def _pass(i, t0, t1, passed=True, **readings):
    report = {"passed": passed, "n_devices": 1, "ici_skipped": True,
              "mxu_tflops": 700.0, "hbm_gbps": 3000.0, "hbm_pallas_gbps": 3000.0,
              "ici_allreduce_gbps": None, **readings}
    return traffic.Pass(i, t0, t1, 0 if passed else 1, report,
                        dict(report) if passed else None)


def test_certify_s_is_the_whole_window_over_the_passes():
    passes = [_pass(0, 10.0, 11.5), _pass(1, 11.6, 13.0), _pass(2, 13.1, 14.9)]
    assert traffic.window_s(passes) == pytest.approx(4.9)
    cell = spec.load_cell(ROOT, "perf-1gpu")
    reader = {m.name: m.module for m in cell.end_to_end}["certify_s"]
    assert reader.read(run.Run({}, passes, 7.0, {}, None, None, None)) == pytest.approx(4.9 / 3)


def test_closed_loop_starts_passes_until_the_window_is_spent():
    now = [0.0]

    def one_pass(i):
        t0 = now[0]
        now[0] += 2.0
        return _pass(i, t0, now[0])

    mix = {"loop": "closed", "clients": 1}
    passes = traffic.closed_loop(mix, 5.0, one_pass, clock=lambda: now[0])
    # passes start at 0, 2 and 4 s; the last ends at 6 s
    assert [p.t0 for p in passes] == [0.0, 2.0, 4.0]
    assert traffic.window_s(passes) == 6.0
    with pytest.raises(ValueError):
        traffic.closed_loop({"loop": "open", "clients": 1}, 1.0, one_pass)


def test_result_line_keys_in_order():
    passes = [_pass(0, 0.0, 1.0), _pass(1, 1.0, 2.0, passed=False)]
    line = run.result_line(True, passes, {"certify_s": {"value": 1.0, "unit": "s"}},
                           {"platform": "gpu", "kind": "k", "count": 1,
                            "memory_peak_bytes": 1},
                           None, {"gemm_gap": {"value": 0.01, "limit": 0.1}})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["attempted"] == 2 and line["failed"] == 1
    traced = run.result_line(True, passes, {}, {}, {"device_ops": [], "idle_gaps": []}, {})
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device",
                            "breakdown", "checks"]
    json.dumps(traced)


def test_roofline_counts():
    assert k1.rows(512) == 131072
    assert k1.bytes_moved(512) == 2 * 131072 * 1024 * 4 == 1073741824
    seconds, bound = k1.least_seconds(512, H100["bf16_flops_per_s"], H100["hbm_bytes_per_s"])
    assert bound == "bytes" and seconds == pytest.approx(1073741824 / 3.35e12)
    assert seconds * 1e3 == pytest.approx(0.32052, abs=1e-5)  # the kernel table's bound
    assert k1.rows(1) == 0 or k1.rows(1) % 256 == 0
    assert gemm.flops(4096) == 2 * 4096 ** 3
    assert gemm.bytes_moved(4096) == 3 * 4096 * 4096 * 2
    seconds, bound = gemm.least_seconds(4096, H100["bf16_flops_per_s"], H100["hbm_bytes_per_s"])
    assert bound == "flops" and seconds == pytest.approx(2 * 4096 ** 3 / 989e12)


def _trace() -> DeviceTrace:
    """Two passes on one device: in each, two products of 0.2 ms (a mm
    under a matmul) and two K1 launches of 0.4 ms; 1 ms windows."""
    ms = 1_000_000
    host, dev = [], []
    corr = 100
    for p in range(2):
        base = p * 10 * ms
        host.append(HostOp("pass", base, base + 10 * ms, corr, True))
        host.append(HostOp("perf.measure_mxu_tflops", base, base + 2 * ms, corr + 1, True))
        host.append(HostOp("perf.measure_hbm_kernel_gbps", base + 3 * ms, base + 5 * ms,
                           corr + 2, True))
        for j in range(2):
            c = corr + 10 + j
            host.append(HostOp("aten::matmul", base + j * ms, base + j * ms + 10, c, False))
            host.append(HostOp("aten::mm", base + j * ms + 1, base + j * ms + 9, c + 5, False))
            dev.append(DeviceOp("sm90_gemm", 0, base + j * ms + 100, base + j * ms + 100
                                + ms // 5, c + 5))
            dev.append(DeviceOp("stream_copy_f32_bulk_kernel", 0, base + 3 * ms + j * ms,
                                base + 3 * ms + j * ms + 2 * ms // 5, 0))
        corr += 100
    return DeviceTrace(dev, host, 0, 20 * ms)


def _reader(name: str):
    return spec.load_module(BENCH / "metrics" / f"{name}.py", f"bench_gpu.metrics.{name}").read


def test_readers_on_a_made_up_trace():
    config = json.loads((BENCH / "configs" / "a3-highgpu-1g.json").read_text())
    passes = [_pass(0, 0.0, 0.01), _pass(1, 0.01, 0.02)]
    traced = run.Run(config, passes, 5.0, {"kernel_load_s": 0.2}, None, _trace(), H100)
    assert _reader("gemm_roofline")(traced) == pytest.approx(
        100 * gemm.flops(4096) / 989e12 / 0.2e-3)
    assert _reader("k1_roofline")(traced) == pytest.approx(
        100 * k1.bytes_moved(512) / 3.35e12 / 0.4e-3)
    # busy 2 x (0.4 + 0.8) ms of 20 ms
    assert _reader("device.idle_share")(traced) == pytest.approx(100 * (1 - 2.4 / 20))
    assert _reader("setup.kernel_load_s")(traced) == 0.2
    breakdown = traced.trace.breakdown(0)
    assert breakdown["device_ops"][0][0] == "stream_copy_f32_bulk_kernel"
    # the longest gap, 4.4 to 10 ms, is named by the host's span at 7.2 ms
    assert breakdown["idle_gaps"][0] == ["pass", pytest.approx(5.6e-3, rel=1e-3)]
    assert len(breakdown["idle_gaps"]) <= 10
    # nothing to read: nothing, never 0
    untraced = run.Run(config, passes, 5.0, {}, None, None, H100)
    assert _reader("setup.kernel_load_s")(untraced) is None
    unknown_card = run.Run(config, passes, 5.0, {}, None, _trace(), None)
    for name in ("gemm_roofline", "k1_roofline", "device.idle_share"):
        assert _reader(name)(untraced) is None
    for name in ("gemm_roofline", "k1_roofline"):
        assert _reader(name)(unknown_card) is None


def test_span_readers_per_pass():
    from bench_gpu.spans import Span, Spans

    spans = Spans()
    spans.records = [Span("perf.run_perf", 0, 0.1, 1.1), Span("perf.run_perf", 1, 2.1, 3.1),
                     Span("perf.measure_mxu_tflops", 0, 0.1, 0.6),
                     Span("perf.measure_mxu_tflops", 1, 2.1, 2.5),
                     Span("perf.measure_hbm_gbps", 0, 0.6, 0.8),
                     Span("perf.measure_hbm_kernel_gbps", 0, 0.8, 1.0)]
    passes = [_pass(0, 0.0, 1.2), _pass(1, 2.0, 3.3)]
    r = run.Run({}, passes, 5.0, {}, spans, None, H100)
    assert _reader("cli.overhead_s")(r) == pytest.approx(((1.2 - 1.0) + (1.3 - 1.0)) / 2)
    assert _reader("perf.gemm_s")(r) == pytest.approx((0.5 + 0.4) / 2)
    assert _reader("perf.hbm_s")(r) == pytest.approx(0.4 / 2)


def test_comparison_passes_sound_readings_and_refuses_the_control():
    config = {"gpus": 1}
    ref = {"gemm_tflops": 690.0, "hbm_gbps": 3010.0, "copy_gbps": 2995.0,
           "allreduce_gbps": None}
    sound = [_pass(0, 0, 1, mxu_tflops=697.0, hbm_gbps=3000.0, hbm_pallas_gbps=3020.0)]
    compared = certify.checks(sound, ref, config, H100)
    assert set(compared) == {"gemm_gap", "hbm_gap", "k1_gap", "verdict_mismatches"}
    assert certify.correct(compared)
    control = [_pass(0, 0, 1, mxu_tflops=1300.0, hbm_gbps=5900.0, hbm_pallas_gbps=5800.0)]
    assert not certify.correct(certify.checks(control, ref, config, H100))
    # a healthy card fenced: the verdict is compared exactly
    fenced = [_pass(0, 0, 1), _pass(1, 1, 2, passed=False)]
    compared = certify.checks(fenced, ref, config, H100)
    assert compared["verdict_mismatches"] == {"value": 1, "limit": 0}
    # a reading never made reads a gap of 1
    missing = [_pass(0, 0, 1, hbm_pallas_gbps=0.0)]
    assert certify.checks(missing, ref, config, H100)["k1_gap"]["value"] == 1.0
    # four GPUs: the fabric's reading is compared, and must have been made
    four = {"gpus": 4}
    ref4 = dict(ref, allreduce_gbps=360.0)
    made = [_pass(0, 0, 1, n_devices=4, ici_skipped=False, ici_allreduce_gbps=355.0)]
    assert certify.correct(certify.checks(made, ref4, four, H100))
    skipped = [_pass(0, 0, 1, n_devices=4)]
    assert not certify.correct(certify.checks(skipped, ref4, four, H100))


def test_reference_settles_on_the_certifications_buffer():
    assert certify.allreduce_bytes(64) == 256 * 1024 * 1024
    assert certify.allreduce_bytes(256) == 256 * 1024 * 1024


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_operator_torch_probe", sys)
    assert "tpu_operator" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_operator.probe", sys)
    assert "tpu_operator" in run.forbidden_modules()


def _imports_of(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _loaded_after(code: str) -> set:
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    loaded = _loaded_after(
        "from pathlib import Path\n"
        "from bench_gpu import run, spec, spans, trace\n"
        "for w in spec.json.loads(Path('BENCHMARK.json').read_text())['workloads']:\n"
        "    spec.load_cell(Path('.'), w['name'])\n"
        "import tpu_operator_torch.validator.main, tpu_operator_torch.validator.perf\n"
        "import tpu_operator_torch.kernels.stream_copy, tpu_operator_torch.ranks\n")
    assert "tpu_operator_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)
    for path in BENCH.rglob("*.py"):
        assert not _imports_of(path) & set(run.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded_after("import bench_gpu.references.certify, bench_gpu.counts.gemm, "
                           "bench_gpu.counts.k1, bench_gpu.sizes")
    assert not loaded & ({run.PROGRAM} | set(run.FORBIDDEN))
    for path in [*(BENCH / "references").glob("*.py"), *(BENCH / "counts").glob("*.py"),
                 BENCH / "sizes.py"]:
        assert not _imports_of(path) & ({run.PROGRAM} | set(run.FORBIDDEN)), path


def _bench(cwd: Path, *extra) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "bench_gpu.run", "--workload", "perf-1gpu",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=120)


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is for a machine without one")
    out = _bench(ROOT)
    assert out.returncode == 3, out.stderr
    assert out.stdout == ""


def test_in_a_directory_of_the_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _bench(tmp_path)
    assert out.returncode == 4, out.stderr
    assert out.stdout == ""
