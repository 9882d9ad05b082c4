"""The serving SLO probe of the PyTorch port (tpu_operator_torch/serving/,
tpu_operator_torch/validator/serving.py) against the JAX package's
(tpu_operator/serving/, tpu_operator/validator/serving.py).

The step is held to the reference's own jitted step, captured while the
reference's ``run_probe`` runs, on seeded integer-valued inputs: every
product and fp32 sum is exact, both steps keep their products' fp32
results (XLA's excess precision; see ``probe._dot_f32``), and both
argmaxes take the first maximal index, so the tolerance is zero (bit-equal
argmax and cache). Reports are compared field
by field apart from timings and ``n_devices`` (the reference's CPU mesh has
8 devices). The same step on the card, eager and as a CUDA graph, is held
in tests/test_torch_serving_gpu.py.
"""

import json
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator import consts as ref_consts
from tpu_operator.serving import frontier as ref_frontier
from tpu_operator.serving import probe as ref_probe
from tpu_operator.testing import MiniApiServer
from tpu_operator.validator import feature_discovery
from tpu_operator.validator import serving as ref_serving
from tpu_operator.validator import status as ref_status
from tpu_operator_torch import consts
from tpu_operator_torch.client import ApiClient
from tpu_operator_torch.serving import frontier
from tpu_operator_torch.serving import probe
from tpu_operator_torch.validator import main as vmain
from tpu_operator_torch.validator import serving
from tpu_operator_torch.validator.status import StatusFiles

#: small-but-real probe settings, the reference tests' own
FAST = dict(batch_sizes=(1, 2), steps_per_batch=8)

#: the parity inputs: dim 64, 4 slots, 5 pages (one left free)
DIM, SLOTS, N_PAGES = 64, 4, 5


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """Eager CPU steps on one intra-op thread: a small bf16 GEMM spread over
    every core can stall for a scheduling quantum under a parallel test
    run, which would read as a tail latency the probe did not cause."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_health_env(monkeypatch):
    monkeypatch.delenv(consts.HEALTH_STATE_ENV, raising=False)
    monkeypatch.delenv("TPU_HEALTH_STATE", raising=False)
    monkeypatch.delenv(consts.TEMPLATE_HASH_ENV, raising=False)
    monkeypatch.delenv("TPU_TEMPLATE_HASH", raising=False)
    monkeypatch.delenv("KUBE_API_URL", raising=False)
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)


@pytest.fixture(scope="module")
def ref_step():
    """The reference's own engine step, as ``run_probe`` hands it to
    ``jax.jit`` (run at dim 64), rebuilt per call with its weight ``w`` (a
    closure cell) replaced and jitted: a new function object per weight, so
    no trace made with another ``w`` is reused."""
    captured = []
    real_jit = jax.jit

    def spy(fn, *args, **kwargs):
        captured.append(fn)
        return real_jit(fn, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", spy)
        report = ref_probe.run_probe(model_dim=DIM, **FAST)
    assert report.passed, report.failures
    (fn,) = [f for f in captured if f.__name__ == "engine_step"]
    free = fn.__code__.co_freevars
    identity = fn.__closure__[free.index("w")].cell_contents
    assert identity.shape == (DIM, DIM) and identity.dtype == jnp.bfloat16

    def call(tokens, pages, page_table, active, admit, w):
        closure = tuple(types.CellType(jnp.asarray(w, jnp.bfloat16)) if name == "w" else cell
                        for name, cell in zip(free, fn.__closure__))
        step = types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                                  fn.__defaults__, closure)
        out, new_pages = real_jit(step)(
            jnp.asarray(tokens, jnp.bfloat16), jnp.asarray(pages),
            jnp.asarray(page_table, jnp.int32), jnp.asarray(active), jnp.asarray(admit))
        return np.asarray(out), np.asarray(new_pages)

    return call


def step_inputs(seed: int, kind: str):
    """Seeded numpy inputs for one step. ``random``: integer tokens and
    weights in [-2, 2]; ``probe``: the real probe's identity weights and
    one-hot tokens. Both: integer cache values, a permutation page table
    that leaves one page free, random masks with an inactive row."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        tokens = rng.integers(-2, 3, (SLOTS, DIM)).astype(np.float32)
        w = rng.integers(-2, 3, (DIM, DIM)).astype(np.float32)
    else:
        tokens = np.zeros((SLOTS, DIM), np.float32)
        tokens[np.arange(SLOTS), rng.integers(0, DIM, SLOTS)] = 1.0
        tokens[0] = 0.0
        tokens[0, 0] = 1.0
        w = np.eye(DIM, dtype=np.float32)
    pages = rng.integers(-8, 9, (N_PAGES, probe.PAGE_SIZE, DIM)).astype(np.float32)
    page_table = rng.permutation(N_PAGES)[:SLOTS].astype(np.int32)
    active = rng.integers(0, 2, SLOTS).astype(np.float32)
    active[rng.integers(0, SLOTS)] = 0.0
    admit = rng.integers(0, 2, SLOTS).astype(np.float32)
    return tokens, pages, page_table, active, admit, w


def port_step(tokens, pages, page_table, active, admit, w, device="cpu"):
    t = torch.from_numpy(pages.copy()).to(device)
    out, new_pages = probe.engine_step(
        torch.from_numpy(tokens).to(device, torch.bfloat16), t,
        torch.from_numpy(page_table).to(device, torch.int64),
        torch.from_numpy(active).to(device), torch.from_numpy(admit).to(device),
        torch.from_numpy(w).to(device, torch.bfloat16))
    assert new_pages is t  # updated in place
    return out.cpu().numpy(), new_pages.cpu().numpy()


@pytest.mark.parametrize("kind", ["random", "probe"])
@pytest.mark.parametrize("seed", range(4))
def test_step_matches_reference_step_bit_for_bit(ref_step, seed, kind):
    inputs = step_inputs(seed, kind)
    ref_out, ref_pages = ref_step(*inputs)
    out, pages = port_step(*inputs)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(pages.view(np.int32), ref_pages.view(np.int32))
    if kind == "probe":
        assert out[0] == 0
    # inactive rows have all-zero logits: the first index wins in both
    assert all(out[i] == 0 for i in np.flatnonzero(inputs[3] == 0))


@pytest.mark.parametrize("case", ["logits", "cache"])
def test_products_keep_their_fp32_results_as_the_jitted_reference(ref_step, case):
    """The reference's jitted step keeps its bf16 products' fp32 results
    (XLA allows excess precision), where an eager ``(a @ b).astype(float32)``
    would round them to bf16 first. ``logits``: 512 (column 3) and 513
    (column 5) stay apart, so the argmax is 5, not the tie's 3. ``cache``:
    the first product's 513 reaches the cache unrounded (bf16: 512)."""
    tokens, pages, page_table, active, admit, _ = step_inputs(0, "probe")
    tokens[:] = 0.0
    w = np.zeros((DIM, DIM), np.float32)
    active[:] = 1.0
    if case == "logits":
        tokens[:, 0] = 1.0  # h = w[0]
        w[0, 1] = w[0, 2] = 1.0  # logits = w[1] + w[2]
        w[1, 3] = w[1, 5] = 512.0
        w[2, 5] = 1.0
    else:
        tokens[:, 0] = tokens[:, 1] = 1.0  # h = w[0] + w[1]
        w[0, 4], w[1, 4] = 512.0, 1.0
        admit[:] = 1.0  # the cache row becomes h
    ref_out, ref_pages = ref_step(tokens, pages, page_table, active, admit, w)
    out, new_pages = port_step(tokens, pages, page_table, active, admit, w)
    if case == "logits":
        np.testing.assert_array_equal(ref_out, np.full(SLOTS, 5))
    else:
        np.testing.assert_array_equal(ref_pages[page_table, 0, 4], np.full(SLOTS, 513.0))
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(new_pages.view(np.int32), ref_pages.view(np.int32))


def test_step_leaves_the_free_page_alone(ref_step):
    tokens, pages, page_table, active, admit, w = step_inputs(7, "random")
    free = sorted(set(range(N_PAGES)) - set(page_table.tolist()))
    _, new_pages = port_step(tokens, pages, page_table, active, admit, w)
    np.testing.assert_array_equal(new_pages[free], pages[free])
    np.testing.assert_array_equal(new_pages[:, 1:], pages[:, 1:])  # one live row per page


# -- reports ------------------------------------------------------------------

def _failure_kinds(failures):
    """Failure messages without their measured numbers."""
    return [re.sub(r"[-+]?[0-9][0-9.e+-]*", "#", f) for f in failures]


@pytest.mark.parametrize("kwargs", [
    FAST,
    dict(batch_sizes=(1, 3, 4), steps_per_batch=20, model_dim=64),
    dict(max_decode_p99_ms=1e-9, **FAST),
    dict(min_throughput_tokens_per_s=1e12, **FAST),
    dict(min_slo_attainment=1.5, **FAST),
], ids=["fast", "ladder", "p99-ceiling", "throughput-floor", "attainment"])
def test_report_matches_reference(kwargs):
    ref = ref_probe.run_probe(**kwargs).to_dict()
    port = probe.run_probe(device="cpu", **kwargs).to_dict()
    assert set(port) == set(ref)
    assert port["passed"] == ref["passed"]
    assert _failure_kinds(port["failures"]) == _failure_kinds(ref["failures"])
    assert port["thresholds"] == ref["thresholds"]
    assert port["platform"] == ref["platform"] == "cpu"
    assert port["skipped_reason"] is ref["skipped_reason"] is None
    assert port["compile_s"] == 0.0  # eager on the CPU: nothing captured
    assert port["n_devices"] == 1
    for mine, theirs in zip(port["batches"], ref["batches"], strict=True):
        assert set(mine) == set(theirs)
        assert (mine["batch"], mine["steps"], mine["samples"]) == \
            (theirs["batch"], theirs["steps"], theirs["samples"])
    assert set(port["frontier"]) == set(ref["frontier"])
    assert port["frontier"]["model_dim"] == ref["frontier"]["model_dim"]
    assert [(p["batch"], p["samples"]) for p in port["frontier"]["points"]] == \
        [(p["batch"], p["samples"]) for p in ref["frontier"]["points"]]
    assert set(port["frontier"]["points"][0]) == set(ref["frontier"]["points"][0])


def _check_passes(report):
    assert report.passed, report.failures
    assert report.platform == "cpu"
    assert len(report.batches) == 2
    assert report.decode_p99_ms >= report.decode_p50_ms > 0
    assert report.throughput_tokens_per_s > 0
    assert report.slo_attainment == 1.0
    for rung in report.batches:
        assert rung["p99_ms"] >= rung["p50_ms"]
        assert rung["steps"] == 8


def _check_p99_ceiling(report):
    assert not report.passed
    assert any("decode_p99_ms" in f for f in report.failures)
    assert any("slo_attainment" in f for f in report.failures)


def _check_throughput_floor(report):
    assert not report.passed
    assert any("throughput" in f for f in report.failures)


def _check_min_samples(report):
    assert FAST["steps_per_batch"] < probe.MIN_FRONTIER_SAMPLES
    for rung in report.batches:
        assert rung["steps"] == FAST["steps_per_batch"]
        assert rung["samples"] >= probe.MIN_FRONTIER_SAMPLES
    for point in report.frontier["points"]:
        assert point["samples"] >= probe.MIN_FRONTIER_SAMPLES


def _check_frontier(report):
    for schema in (frontier, ref_frontier):
        fr = schema.from_dict(report.frontier)
        assert fr is not None
        assert fr.version == schema.FRONTIER_VERSION
        assert [p.batch for p in fr.points] == list(FAST["batch_sizes"])
        assert all(p.tokens_per_s > 0 for p in fr.points)
        assert fr.model_dim > 0 and fr.measured_at > 0
    assert probe.skipped_report("health-state=failed", {}).frontier is None


@pytest.mark.parametrize("extra, check", [
    ({}, _check_passes),
    ({"max_decode_p99_ms": 1e-9}, _check_p99_ceiling),
    ({"min_throughput_tokens_per_s": 1e12}, _check_throughput_floor),
    ({}, _check_min_samples),
    ({}, _check_frontier),
], ids=["passes", "p99-ceiling", "throughput-floor", "min-sample-floor", "frontier"])
def test_reference_probe_cases_on_the_port(extra, check):
    check(probe.run_probe(device="cpu", **FAST, **extra))


def test_constants_match_reference():
    assert probe.MIN_FRONTIER_SAMPLES == ref_probe.MIN_FRONTIER_SAMPLES
    assert probe.PAGE_SIZE == ref_probe.PAGE_SIZE
    assert serving.GATED_HEALTH_STATES == ref_serving.GATED_HEALTH_STATES
    for name in ("FRONTIER_VERSION", "MAX_ANNOTATION_BYTES", "P99_BUCKETS_MS"):
        assert getattr(frontier, name) == getattr(ref_frontier, name)
    # label and annotation keys stay the operator's until its control plane
    # is ported
    for name in ("HEALTH_STATE_LABEL", "SERVING_SLO_LABEL", "SERVING_SLO_ANNOTATION",
                 "SERVING_FRONTIER_ANNOTATION", "SERVING_REPROBE_ANNOTATION"):
        assert getattr(consts, name) == getattr(ref_consts, name)


@pytest.mark.parametrize("seed", range(3))
def test_skipped_report_and_percentile_match_reference(seed):
    rng = np.random.default_rng(seed)
    reason = f"health-state={rng.choice(['quarantined', 'failed', 'remediating'])}"
    thresholds = {"max_decode_p99_ms": float(rng.uniform(1, 500)),
                  "min_slo_attainment": float(rng.uniform(0, 1))}
    assert probe.skipped_report(reason, thresholds).to_dict() == \
        ref_probe.skipped_report(reason, thresholds).to_dict()
    assert probe.skipped_report(reason).to_dict() == ref_probe.skipped_report(reason).to_dict()
    vals = sorted(rng.exponential(3.0, int(rng.integers(0, 40))).tolist())
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert probe._percentile(vals, q) == ref_probe._percentile(vals, q)


def test_percentile_nearest_rank():
    assert probe._percentile([], 0.5) == 0.0
    vals = [float(i) for i in range(1, 101)]
    assert probe._percentile(vals, 0.0) == 1.0
    assert probe._percentile(vals, 0.50) == 51.0
    assert probe._percentile(vals, 1.0) == 100.0


def test_probe_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.run_probe(**FAST)


# -- frontier schema ----------------------------------------------------------

def _random_points(rng, n):
    return [dict(batch=int(rng.integers(1, 512)), p99_ms=float(rng.uniform(0.01, 400)),
                 tokens_per_s=float(rng.uniform(1, 1e6)),
                 samples=int(rng.integers(16, 256))) for _ in range(n)]


def _random_payload(rng):
    return {"version": 1, "model_dim": int(rng.integers(64, 4096)),
            "measured_at": float(rng.uniform(1.7e9, 1.8e9)),
            "template": f"t{int(rng.integers(0, 1 << 30)):x}",
            "points": _random_points(rng, int(rng.integers(0, 12)))}


def _as_dict(fr):
    return None if fr is None else fr.to_dict()


@pytest.mark.parametrize("seed", range(6))
def test_frontier_matches_reference(seed):
    rng = np.random.default_rng(seed)
    payload = _random_payload(rng)
    mine, theirs = frontier.from_dict(payload), ref_frontier.from_dict(payload)
    assert mine.to_dict() == theirs.to_dict() == payload
    for ceiling in (1.0, 50.0, 250.0, 1e9):
        assert mine.best_tokens_per_s(ceiling) == theirs.best_tokens_per_s(ceiling)
        assert mine.best_depth(ceiling) == theirs.best_depth(ceiling)
    assert mine.min_samples() == theirs.min_samples()
    for max_bytes in (1024, 200, 80, 10):
        value = frontier.encode_annotation(mine, max_bytes=max_bytes)
        assert value == ref_frontier.encode_annotation(theirs, max_bytes=max_bytes)
        assert _as_dict(frontier.decode_annotation(value)) == \
            _as_dict(ref_frontier.decode_annotation(value))
    for p99 in rng.uniform(0, 400, 20).tolist() + [5.0, 250.0, 250.01]:
        assert frontier.p99_bucket(p99) == ref_frontier.p99_bucket(p99)


@pytest.mark.parametrize("payload", [
    {"points": [{"batch": 2, "p99_ms": 1.5, "tokens_per_s": 900}]},  # v-less: v1
    {"version": 2, "points": []},
    {"version": 0, "points": []},
    {"version": "1", "points": []},
    {"version": 1, "points": "nope"},
    {"version": 1, "points": [{"batch": "x", "p99_ms": 1, "tokens_per_s": 1}]},
    {"version": 1, "points": [{"p99_ms": 1}]},
    {"version": 1, "points": [], "model_dim": "wide"},
    None, [], "garbage",
], ids=lambda p: json.dumps(p)[:40])
def test_frontier_from_dict_edge_cases_match_reference(payload):
    assert _as_dict(frontier.from_dict(payload)) == _as_dict(ref_frontier.from_dict(payload))


@pytest.mark.parametrize("value", [
    None, "", "garbage", "v=2;p=1:1:1:1", "v=1;at=x", "v=1;p=1:2:3", "v=1;p=",
    "v=1;at=17;t=abc;p=1:0.5:100:16,4:1.25:300:32", "p=8:3:9:16;junk;v=1",
])
def test_frontier_decode_edge_cases_match_reference(value):
    assert _as_dict(frontier.decode_annotation(value)) == \
        _as_dict(ref_frontier.decode_annotation(value))


# -- validator glue: health gate + barrier contract ---------------------------

def test_run_serving_writes_barrier_on_pass(tmp_path, capsys):
    status = StatusFiles(str(tmp_path))
    assert serving.run_serving(status, device="cpu", **FAST) == 0
    report = ref_status.StatusFiles(str(tmp_path)).read("serving")
    assert report["passed"] is True and report["platform"] == "cpu"
    assert ref_status.StatusFiles(str(tmp_path)).is_ready("serving")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["passed"] is True


def test_run_serving_failure_still_writes_barrier(tmp_path):
    status = StatusFiles(str(tmp_path))
    assert serving.run_serving(status, max_decode_p99_ms=1e-9, device="cpu", **FAST) == 1
    report = status.read("serving")
    assert report["passed"] is False
    assert report["skipped_reason"] is None  # measured, not gated
    assert not status.is_ready("serving")


@pytest.mark.parametrize("state", ["quarantined", "remediating", "failed"])
def test_run_serving_health_gate_env_fails_closed(tmp_path, monkeypatch, state):
    monkeypatch.setenv(consts.HEALTH_STATE_ENV, state)
    status = StatusFiles(str(tmp_path))
    assert serving.run_serving(status, device="cpu", **FAST) == 1
    report = status.read("serving")
    assert report["passed"] is False
    assert report["skipped_reason"] == f"health-state={state}"
    assert not status.is_ready("serving")


@pytest.mark.parametrize("state, rc", [("quarantined", 1), ("degraded", 0), (None, 0)])
def test_serving_cli_health_gate_via_node_label_over_http(tmp_path, monkeypatch, state, rc):
    """The deployed DS stamps no health env: the gate reads the node's
    label through the port's apiserver client."""
    srv = MiniApiServer()
    base = srv.start()
    try:
        labels = {} if state is None else {consts.HEALTH_STATE_LABEL: state}
        srv.backend.create({"apiVersion": "v1", "kind": "Node",
                            "metadata": {"name": "gpu-0", "labels": labels}, "status": {}})
        monkeypatch.setenv("KUBE_API_URL", base)
        monkeypatch.setenv("NODE_NAME", "gpu-0")
        assert serving.node_health_state(ApiClient(base)) == state
        assert vmain.run(["-c", "serving", "--device=cpu", f"--status-dir={tmp_path}",
                          "--serving-batch-sizes=1", "--serving-steps=4"]) == rc
    finally:
        srv.stop()
    report = StatusFiles(str(tmp_path)).read("serving")
    assert report["passed"] is (rc == 0)
    assert report["skipped_reason"] == (None if rc == 0 else f"health-state={state}")


def test_serving_cli_health_gate_via_reference_fake_client(fake_client, tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("NODE_NAME", "gpu-0")
    fake_client.create({"apiVersion": "v1", "kind": "Node",
                        "metadata": {"name": "gpu-0",
                                     "labels": {consts.HEALTH_STATE_LABEL: "failed"}},
                        "status": {}})
    assert vmain.run(["-c", "serving", "--device=cpu", f"--status-dir={tmp_path}",
                      "--serving-batch-sizes=1", "--serving-steps=4"],
                     client=fake_client) == 1
    assert StatusFiles(str(tmp_path)).read("serving")["skipped_reason"] == \
        "health-state=failed"


def test_health_lookup_failure_does_not_gate(monkeypatch):
    monkeypatch.setenv("NODE_NAME", "absent")
    srv = MiniApiServer()
    base = srv.start()
    try:
        assert serving.node_health_state(ApiClient(base)) is None
    finally:
        srv.stop()
    assert serving.node_health_state(None, "n1") is None


def test_serving_cli_dispatch_off_cluster(tmp_path, capsys):
    rc = vmain.run(["-c", "serving", "--device=cpu", "--status-dir", str(tmp_path),
                    "--serving-batch-sizes", "1,2", "--serving-steps", "6"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["passed"] is True
    assert [r["batch"] for r in out["batches"]] == [1, 2]
    assert (tmp_path / "serving-ready").exists()


def test_serving_cli_without_cuda_fails_closed(tmp_path, monkeypatch):
    """The default device is ``cuda``: without one the probe cannot run, and
    the barrier records a failed verdict, never a CPU measurement."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = vmain.run(["-c", "serving", f"--status-dir={tmp_path}",
                    "--serving-batch-sizes=1", "--serving-steps=4"])
    assert rc == 1
    report = StatusFiles(str(tmp_path)).read("serving")
    assert report["passed"] is False
    assert report["skipped_reason"].startswith("probe-error: CUDA device requested")
    assert report["frontier"] is None


def test_template_hash_is_stamped(tmp_path, monkeypatch):
    monkeypatch.setenv(consts.TEMPLATE_HASH_ENV, "abc123")
    assert serving.run_serving(StatusFiles(str(tmp_path)), device="cpu", **FAST) == 0
    assert StatusFiles(str(tmp_path)).read("serving")["frontier"]["template"] == "abc123"


def test_cli_flag_defaults_match_reference(monkeypatch):
    for env in ("SERVING_BATCH_SIZES", "SERVING_STEPS", "MAX_DECODE_P99_MS",
                "MIN_TOKENS_PER_S", "MIN_SLO_ATTAINMENT"):
        monkeypatch.delenv(env, raising=False)
    from tpu_operator.validator import main as ref_main

    argv = ["-c", "serving"]
    mine, theirs = vmain.build_parser().parse_args(argv), ref_main.build_parser().parse_args(argv)
    for flag in ("serving_batch_sizes", "serving_steps", "max_decode_p99_ms",
                 "min_tokens_per_s", "min_slo_attainment"):
        assert getattr(mine, flag) == getattr(theirs, flag)
    monkeypatch.setenv("SERVING_BATCH_SIZES", "2,16")
    monkeypatch.setenv("MIN_SLO_ATTAINMENT", "0.5")
    args = vmain.build_parser().parse_args(argv)
    assert (args.serving_batch_sizes, args.min_slo_attainment) == ("2,16", 0.5)


def _seeded_report(rng):
    if rng.random() < 0.3:
        return {"skipped_reason": f"health-state={rng.choice(['failed', 'quarantined'])}"}
    return {"decode_p99_ms": float(np.round(rng.uniform(0.01, 300), 4)),
            "throughput_tokens_per_s": float(np.round(rng.uniform(1, 1e6), 1)),
            "slo_attainment": float(np.round(rng.uniform(0, 1), 4))}


@pytest.mark.parametrize("seed", range(5))
def test_serving_detail_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        report = _seeded_report(rng)
        detail = serving.serving_detail(report)
        assert detail == ref_serving.serving_detail(report)
        assert serving.parse_serving_detail(detail) == ref_serving.parse_serving_detail(detail)
    for garbage in (None, "", "p99_ms=not-a-number,=,junk", 7, "skipped=", "a=1,b"):
        assert serving.parse_serving_detail(garbage) == ref_serving.parse_serving_detail(garbage)


@pytest.mark.parametrize("gate", [None, "quarantined", "slow"])
def test_port_barrier_reads_like_reference_barrier_in_feature_discovery(tmp_path,
                                                                        monkeypatch, gate):
    """The reference's feature discovery labels a node from the port's
    serving barrier as it would from the reference's own."""
    kwargs = dict(FAST, max_decode_p99_ms=1e-9) if gate == "slow" else dict(FAST)
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    if gate == "quarantined":
        monkeypatch.setenv(consts.HEALTH_STATE_ENV, gate)
        monkeypatch.setenv("TPU_HEALTH_STATE", gate)
    monkeypatch.setenv(consts.TEMPLATE_HASH_ENV, "h1")
    monkeypatch.setenv("TPU_TEMPLATE_HASH", "h1")
    port_rc = serving.run_serving(StatusFiles(str(port_dir)), device="cpu", **kwargs)
    ref_rc = ref_serving.run_serving(ref_status.StatusFiles(str(ref_dir)), **kwargs)
    assert port_rc == ref_rc
    readings = {}
    for name, directory in (("port", port_dir), ("ref", ref_dir)):
        monkeypatch.setenv("STATUS_DIR", str(directory))
        verdict, detail = feature_discovery.serving_slo_verdict()
        readings[name] = (verdict, ref_serving.parse_serving_detail(detail),
                          feature_discovery.serving_frontier_value())
    (pv, pd, pf), (rv, rd, rf) = readings["port"], readings["ref"]
    assert pv == rv == ("passed" if gate is None else "failed")
    assert set(pd) == set(rd)
    if gate == "quarantined":
        assert pd == rd == {"skipped": "health-state=quarantined"}
    if gate is None:
        mine, theirs = ref_frontier.decode_annotation(pf), ref_frontier.decode_annotation(rf)
        assert [p.batch for p in mine.points] == [p.batch for p in theirs.points] == [1, 2]
        assert [p.samples for p in mine.points] == [p.samples for p in theirs.points]
        assert mine.template == theirs.template == "h1"
    else:
        assert pf == rf == ""  # a non-passing barrier clears the curve
