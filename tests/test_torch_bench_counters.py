"""The benchmark's readers of the program's own counters
(``bench_gpu/metrics/perf.{chain_kept_s,chain_discarded_s,prep_s,gemm_iters,chain_probes}.py``
over ``bench_gpu/program_counters.py``): a counter's total over the passes,
None where the program has no such counter; their entries in
``BENCHMARK.json`` as the harness loads them; and a CPU certification
through the harness's own CLI pass, whose counters account for the
passes' time."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench_gpu import spec
from tpu_operator_torch import tracing

ROOT = Path(__file__).resolve().parents[1]
READERS = {
    "perf.chain_kept_s": "perf.chain.kept_s",
    "perf.chain_discarded_s": "perf.chain.discarded_s",
    "perf.prep_s": "perf.prep_s",
    "perf.gemm_iters": "perf.gemm.iters",
    "perf.chain_probes": "perf.chain.probes",
}


def _reader(name):
    return spec.load_module(ROOT / "bench_gpu" / "metrics" / f"{name}.py",
                            f"bench_gpu.metrics.{name}")


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_is_the_counters_total_over_the_passes(monkeypatch, metric):
    run = SimpleNamespace(passes=[object()] * 7)
    totals = {READERS[metric]: 560.0, "perf.other": 1.0}
    monkeypatch.setattr(tracing, "counters", lambda: dict(totals))
    assert _reader(metric).read(run) == pytest.approx(80.0)
    del totals[READERS[metric]]
    assert _reader(metric).read(run) is None
    # a program without the registry (the parent of the counters) reads nothing
    monkeypatch.delattr(tracing, "counters")
    assert _reader(metric).read(run) is None


def test_the_counter_metrics_are_the_cells_as_the_harness_loads_them():
    entries = json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
    ours = [e for e in entries if e["name"] in READERS]
    assert [e["name"] for e in entries[-len(READERS):]] == list(READERS)
    for entry in ours:
        assert entry["source"] == "program_counter" and entry["layer"] == "Perf"
        assert entry["moves"] == "certify_s" and entry["workloads"] == ["perf-1gpu"]
    cell = spec.load_cell(ROOT, "perf-1gpu")
    wanted = [e["name"] for e in entries if "perf-1gpu" in e.get("workloads", ["perf-1gpu"])]
    assert [m.name for m in cell.per_layer] == wanted
    for metric in cell.per_layer:
        assert callable(metric.module.read)


SCRIPT = r"""
import json, sys, tempfile, time
from pathlib import Path
from bench_gpu import run, spec
from bench_gpu.drivers.cli import CliDriver
from bench_gpu.spans import Spans

cell = spec.load_cell(Path("."), "perf-1gpu")
config = dict(cell.config, validator_flags=[
    "--device=cpu", "--perf-matrix-dim", "32", "--perf-hbm-mib", "1", "--perf-ici-mib", "1"])
driver = CliDriver.of(config, cell.mix, tempfile.mkdtemp(), {})
spans = Spans()
passes = [driver.run_pass(i, spans) for i in range(2)]
result = run.Run(config, passes, 0.0, {}, spans, None, None)
print(json.dumps({"pass_s": sum(p.t1 - p.t0 for p in passes) / len(passes),
                  **{m.name: m.module.read(result) for m in cell.per_layer
                     if m.name.startswith("perf.")}}))
"""


def test_a_cpu_certification_s_counters_account_for_its_passes():
    """Two CPU passes through the harness's CLI pass in a fresh process:
    the chains' kept, discarded and set-up seconds add up to nearly all of a
    pass, and the GEMM's settled length, a mean over the two passes, is
    that of two lengths the chain can reach (on a loaded CPU the passes may
    settle apart). The process takes one intra-op thread: torch's pool of
    one thread a core would spread each of these tiny ops over cores the
    suite's other workers hold, and wait at every op for the last of them."""
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    read = json.loads(out.stdout.splitlines()[-1])
    timed = read["perf.chain_kept_s"] + read["perf.chain_discarded_s"] + read["perf.prep_s"]
    assert read["perf.chain_kept_s"] > 0 and read["perf.prep_s"] > 0
    assert 0.8 * read["pass_s"] < timed < read["pass_s"]
    lengths = (5, 20, 80, 320, 1280)
    assert read["perf.gemm_iters"] in {(a + b) / 2 for a in lengths for b in lengths}
