"""Node identity in the PyTorch port (validator/feature_discovery.py,
info.py, metrics.py) against the JAX package's, on the CPU: the same label
and annotation patches, the same status, the same exposition."""

import copy
import json
import os
import socket
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request

import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

from tpu_operator import consts as ref_consts
from tpu_operator.client import FakeClient
from tpu_operator.joinprofile import records as ref_records
from tpu_operator.validator import feature_discovery as ref_fd
from tpu_operator.validator import info as ref_info
from tpu_operator.validator import metrics as ref_metrics
from tpu_operator.validator.status import StatusFiles as RefStatusFiles
from tpu_operator_torch import consts
from tpu_operator_torch.validator import feature_discovery as fd
from tpu_operator_torch.validator import info
from tpu_operator_torch.validator import main as vmain
from tpu_operator_torch.validator import metrics
from tpu_operator_torch.validator.status import StatusFiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"
H100_BYTES = 85_029_158_912  # what torch reports for the 80 GB part


@pytest.fixture
def node_env(tmp_path, monkeypatch):
    """Four device nodes both packages count, and the status dir both read."""
    devdir = tmp_path / "dev"
    devdir.mkdir()
    for i in range(4):
        (devdir / f"nvidia{i}").touch()
    pattern = str(devdir / "nvidia[0-9]*")
    monkeypatch.setenv("GPU_DEV_GLOBS", pattern)
    monkeypatch.setenv("TPU_DEV_GLOBS", pattern)
    monkeypatch.setenv("TPU_FD_SKIP_JAX", "1")
    monkeypatch.delenv("LIBTPU_VERSION", raising=False)
    status_dir = tmp_path / "validations"
    monkeypatch.setenv("STATUS_DIR", str(status_dir))
    return str(status_dir)


@pytest.fixture
def fake_h100(monkeypatch):
    """torch.cuda reporting one H100, with every call that would create a
    context refused: enumeration must need none."""
    props = types.SimpleNamespace(name=H100, total_memory=H100_BYTES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i=0: props)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: H100)

    def refused(*a, **kw):
        raise AssertionError("this call creates a CUDA context")

    for name in ("mem_get_info", "set_device", "synchronize", "init", "current_device"):
        monkeypatch.setattr(torch.cuda, name, refused)
    return props


class RecordingClient:
    """A FakeClient that records every patch it applies."""

    def __init__(self, node):
        self.inner = FakeClient()
        self.inner.create(node)
        self.patches = []

    def get(self, *a, **kw):
        return self.inner.get(*a, **kw)

    def patch(self, api_version, kind, name, patch, namespace=None):
        self.patches.append((api_version, kind, name, copy.deepcopy(patch)))
        return self.inner.patch(api_version, kind, name, patch, namespace)


def _node(labels=None, annotations=None):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "n1", "labels": dict(labels or {}),
                         "annotations": dict(annotations or {})}, "status": {}}


FRONTIER = {"version": 1, "model_dim": 256, "measured_at": 1700000000.5, "template": "tmpl-1",
            "points": [{"batch": 1, "p99_ms": 0.0969, "tokens_per_s": 18280.0, "samples": 32},
                       {"batch": 8, "p99_ms": 0.0563, "tokens_per_s": 157736.8, "samples": 32}]}
SERVING_PASS = {"passed": True, "platform": "gpu", "decode_p99_ms": 0.0969,
                "throughput_tokens_per_s": 157736.8, "slo_attainment": 1.0,
                "frontier": FRONTIER}
SERVING_FAIL = {"passed": False, "skipped_reason": "health-state=quarantined",
                "frontier": None}
GKE = {consts.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb",
       ref_consts.GKE_TPU_ACCELERATOR_LABEL: "nvidia-h100-80gb"}


def _write(status_dir, component, payload):
    """A barrier: a dict, or raw (possibly corrupt) file content."""
    status = StatusFiles(status_dir)
    if isinstance(payload, dict):
        status.write(component, payload)
    else:
        os.makedirs(status_dir, exist_ok=True)
        with open(status.path(component), "w") as f:
            f.write(payload)


# case -> (node labels, node annotations, {barrier: payload}, span log records)
FD_CASES = {
    "pass": ({}, {}, {"workload": {"passed": True, "n_devices": 4},
                      "driver": {"libtpu_version": "550.54.15"}}, None),
    "gke-passthrough": (GKE, {}, {"workload": {"passed": True}}, None),
    "bundled-version": ({}, {}, {"driver": {"libtpu_version": "bundled"}}, None),
    "failed-chips": ({}, {}, {"workload": {
        "passed": False, "n_devices": 4, "local_chips": [0, 1, 2, 3],
        "failed_local_chips": [3, 1]}}, None),
    "failed-unattributed": ({}, {consts.WORKLOAD_HEALTH_ANNOTATION: "passed"},
                            {"workload": {"passed": False, "details": {"error": "x"}}}, None),
    "workload-corrupt": ({}, {}, {"workload": "{torn"}, None),
    "serving-pass": ({}, {}, {"serving": SERVING_PASS}, None),
    "serving-failed": ({consts.SERVING_SLO_LABEL: "passed"},
                       {consts.SERVING_FRONTIER_ANNOTATION: "v=1;at=1;p=1:0.1:10:32"},
                       {"serving": SERVING_FAIL}, None),
    "serving-corrupt": ({}, {consts.SERVING_SLO_ANNOTATION: "p99_ms=1,tokens_per_s=2",
                             consts.SERVING_FRONTIER_ANNOTATION: "v=1;at=1;p=1:0.1:10:32"},
                        {"serving": "[1, 2]"}, None),
    "serving-no-verdict": ({}, {}, {"serving": {"decode_p99_ms": 1.0}}, None),
    "frontier-clear": ({}, {consts.SERVING_FRONTIER_ANNOTATION: "v=1;at=1;p=1:0.1:10:32"},
                       {"serving": dict(SERVING_PASS, frontier=None)}, None),
    "reprobe-clear": ({consts.TEMPLATE_HASH_LABEL: "tmpl-1"},
                      {consts.SERVING_REPROBE_ANNOTATION: "tmpl-1"},
                      {"serving": SERVING_PASS}, None),
    "reprobe-kept": ({consts.TEMPLATE_HASH_LABEL: "tmpl-2"},
                     {consts.SERVING_REPROBE_ANNOTATION: "tmpl-2"},
                     {"serving": SERVING_PASS}, None),
    "drain-ack-mirror": ({}, {}, {"workload": {
        "passed": True, "drain_ack": {"plan": "aaaa", "step": 7, "acked_at": 1.0}}}, None),
    "drain-ack-retire": ({}, {consts.DRAIN_ACK_ANNOTATION: '{"plan": "aaaa", "step": 7}'},
                         {"workload": {"passed": True}}, None),
    "trace-spans": ({}, {}, {}, [
        {"i": f"{k:016x}", "p": "", "t": "0" * 32, "n": n, "s": 1000.0 + k, "d": 0.5,
         "st": "ok", "a": {}}
        for k, n in enumerate(["operand.workload-local", "ici-sweep", "xla-compile"])]),
}


@pytest.mark.parametrize("case", sorted(FD_CASES))
def test_sync_node_labels_patches_match_reference(case, node_env, tmp_path, monkeypatch):
    labels, annotations, barriers, spans = FD_CASES[case]
    runs = {}
    for side in ("ref", "port"):
        status_dir = str(tmp_path / side)
        monkeypatch.setenv("STATUS_DIR", status_dir)
        for component, payload in barriers.items():
            _write(status_dir, component, payload)
        if spans:
            ref_records.SpanLog(status_dir).append(spans)
        client = RecordingClient(_node(labels, annotations))
        for _ in range(2):  # the second pass finds nothing drifted
            if side == "ref":
                ref_fd.sync_node_labels(client, "n1", use_jax=False)
            else:
                fd.sync_node_labels(client, "n1", device="cpu")
        runs[side] = (client.patches, client.get("v1", "Node", "n1")["metadata"])
    assert runs["port"][0] == runs["ref"][0]
    port_meta, ref_meta = runs["port"][1], runs["ref"][1]
    assert port_meta["labels"] == ref_meta["labels"]
    assert port_meta.get("annotations") == ref_meta.get("annotations")
    assert runs["port"][0], "every case patches something"


def test_cuda_branch_labels_a_fake_h100_without_a_context(node_env, fake_h100):
    labels = fd.discover()
    assert labels == {consts.TPU_CHIP_TYPE_LABEL: "nvidia-h100-80gb",
                      consts.TPU_CHIP_COUNT_LABEL: "1",
                      consts.TPU_MEMORY_LABEL: "79Gi"}
    client = RecordingClient(_node(GKE))
    fd.sync_node_labels(client, "n1")
    assert client.patches[0][3] == {"metadata": {"labels": labels}}
    # the GKE label never overrides what enumeration found
    client = RecordingClient(_node({consts.GKE_ACCELERATOR_LABEL: "nvidia-l4"}))
    fd.sync_node_labels(client, "n1")
    assert client.patches[0][3]["metadata"]["labels"][consts.TPU_CHIP_TYPE_LABEL] == \
        "nvidia-h100-80gb"


@pytest.mark.parametrize("kind,expected", [
    (H100, "nvidia-h100-80gb"), ("NVIDIA H200", "nvidia-h200-141gb"),
    ("NVIDIA A100-SXM4-80GB", "nvidia-a100-80gb"), ("NVIDIA A100-SXM4-40GB",
                                                    "nvidia-tesla-a100"),
    ("NVIDIA L4", "nvidia-l4"), ("NVIDIA H100 PCIe", "nvidia-h100-pcie"), ("", "unknown"),
])
def test_chip_type_from_kind(kind, expected):
    assert fd.chip_type_from_kind(kind) == expected


def test_no_topology_label_on_gpus(node_env):
    client = RecordingClient(_node({ref_consts.GKE_TPU_TOPOLOGY_LABEL: "2x4"}))
    desired = fd.sync_node_labels(client, "n1", device="cpu")
    assert not any("topology" in k for k in desired)


def test_feature_discovery_fails_closed_without_a_card(node_env):
    with pytest.raises(RuntimeError, match="CUDA"):
        fd.discover()
    with pytest.raises(RuntimeError, match="CUDA"):
        fd.run(RecordingClient(_node()), node_name="n1", iterations=1)
    assert fd.run(RecordingClient(_node()), node_name="n1", iterations=2,
                  sleep_interval=0.0, device="cpu") == 0


def _info_cases():
    perf = {"mxu_tflops": 706.291, "hbm_gbps": 2991.598, "ici_allreduce_gbps": None,
            "ici_skipped": True}
    return {
        "empty": {},
        "all-pass": {"driver": {"libtpu_version": "550.54.15"}, "plugin": {},
                     "workload": {"passed": True}, "perf": perf, "serving": SERVING_PASS},
        "ici-measured": {"perf": dict(perf, ici_allreduce_gbps=334.349, ici_skipped=False)},
        "ici-null": {"perf": dict(perf, ici_skipped=False)},
        "failed-chips": {"workload": {"passed": False, "local_chips": [0, 1, 2, 3],
                                      "failed_local_chips": [2]}},
        "unattributed": {"workload": {"passed": False}},
        "none-local": {"workload": {"passed": False, "n_devices": 4, "local_chips": [],
                                    "details": {"psum": {"passed": False,
                                                         "failed_chips": [9]}}}},
        "corrupt": {"workload": "{torn"},
        "serving-skipped": {"serving": SERVING_FAIL},
    }


# the render's wording that names the accelerator stack
RENAMES = [("tpu-info", "gpu-info"), ("libtpu:       ", "driver:       "),
           ("no libtpu runtime in this process", "no CUDA enumeration in this process"),
           ("MXU ", "GEMM "), ("· ICI ", "· NVLink ")]


def _as_port_render(text, ref_path, port_path):
    for old, new in RENAMES + [(ref_path, port_path)]:
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("case", sorted(_info_cases()))
def test_info_collect_and_render_match_reference(case, node_env, tmp_path):
    install = tmp_path / "lib"
    install.mkdir()
    (install / "libtpu.so").write_bytes(b"\x7fELF fake")
    (install / "libcuda.so.1").write_bytes(b"\x7fELF fake")
    status_dir = str(tmp_path / "st")
    for component, payload in _info_cases()[case].items():
        _write(status_dir, component, payload)
    port = info.collect(str(install), StatusFiles(status_dir), device="cpu")
    ref = ref_info.collect(str(install), RefStatusFiles(status_dir), use_jax=False)
    assert port["libtpu"].pop("path") == str(install / "libcuda.so.1")
    assert ref["libtpu"].pop("path") == str(install / "libtpu.so")
    assert port == ref
    port["libtpu"]["path"] = str(install / "libcuda.so.1")
    ref["libtpu"]["path"] = str(install / "libtpu.so")
    assert info.render(port) == _as_port_render(ref_info.render(ref), ref["libtpu"]["path"],
                                                port["libtpu"]["path"])


def test_info_chip_rows_on_a_fake_h100(node_env, fake_h100, monkeypatch, tmp_path, capsys):
    free = H100_BYTES - 700 * (1 << 20)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i=0: (free, H100_BYTES))
    status = StatusFiles(str(tmp_path / "st"))
    status.write("driver")
    collected = info.collect(str(tmp_path), status)
    assert collected["chips"] == [{"id": 0, "kind": H100, "hbm_used_bytes": 700 * (1 << 20),
                                   "hbm_total_bytes": H100_BYTES}]
    assert collected["validations"]["driver"] is True
    text = info.render(collected)
    assert "chips:        1 x NVIDIA H100 80GB HBM3" in text
    assert "chip 0: HBM 0.7/79.2 GiB" in text
    # the reference renders the same rows from the same dict
    assert text == _as_port_render(ref_info.render(collected), "", "")
    assert vmain.run(["-c", "info", "--json", f"--status-dir={status.directory}",
                      f"--install-dir={tmp_path}"]) == 1  # no driver library there
    assert json.loads(capsys.readouterr().out)["chips"] == collected["chips"]


def _triples(text, skip=("tpu_operator_node_metrics_last_refresh_ts_seconds",)):
    out = []
    for family in text_string_to_metric_families(text):
        for sample in family.samples:
            if sample.name not in skip:
                out.append((family.name, family.documentation, family.type, sample.name,
                            tuple(sorted(sample.labels.items())), sample.value))
    return out


def _without_refresh_sample(text):
    return "\n".join(line for line in text.splitlines()
                     if not line.startswith("tpu_operator_node_metrics_last_refresh_ts_seconds "))


METRIC_CASES = {
    "none": [{}],
    "pass": [{"driver": {}, "plugin": {}, "workload": {"passed": True, "n_devices": 4},
              "perf": {"mxu_tflops": 706.291, "hbm_gbps": 2991.598,
                       "ici_allreduce_gbps": None}}],
    "attributed-failure": [{"workload": {"passed": False, "local_chips": [0, 1, 2, 3],
                                         "failed_local_chips": [1, 3]}}],
    "unattributed-failure": [{"workload": {"passed": False, "details": {"error": "x"}}}],
    "corrupt": [{"workload": "[1, 2]"}],
    "partial-sweep": [{"workload": {"passed": True, "local_chips": [0, 1]}}],
    "ici-null-number-null": [
        {"perf": {"mxu_tflops": 1.0, "hbm_gbps": 2.0, "ici_allreduce_gbps": None}},
        {"perf": {"mxu_tflops": 1.0, "hbm_gbps": 2.0, "ici_allreduce_gbps": 334.349}},
        {"perf": {"mxu_tflops": 1.0, "hbm_gbps": 2.0, "ici_allreduce_gbps": None}},
    ],
    "perf-cleared": [{"perf": {"mxu_tflops": 5.0, "hbm_gbps": 6.0}}, {"perf": None}],
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metrics_exposition_matches_reference(case, node_env, tmp_path):
    status_dir = str(tmp_path / "st")
    port = metrics.NodeMetrics(status=StatusFiles(status_dir))
    ref = ref_metrics.NodeMetrics(status=RefStatusFiles(status_dir))
    for step in METRIC_CASES[case]:
        for component, payload in step.items():
            if payload is None:
                StatusFiles(status_dir).clear(component)
            else:
                _write(status_dir, component, payload)
        port.refresh()
        ref.refresh()
        port_text = port.scrape().decode()
        ref_text = ref.scrape().decode()
        assert _triples(port_text) == _triples(ref_text)
        assert _without_refresh_sample(port_text) == _without_refresh_sample(ref_text)


def test_metrics_exposition_escapes_as_prometheus():
    gauge = metrics.Gauge("g", "help with \\ and\nnewline", ("chip",))
    gauge.set(1.5, chip='a"b\\c\nd')
    family = next(iter(text_string_to_metric_families(gauge.expose())))
    assert family.documentation == "help with \\ and\nnewline"
    assert family.samples[0].labels == {"chip": 'a"b\\c\nd'}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metrics_serve_over_http(node_env, tmp_path):
    status = StatusFiles(str(tmp_path / "st"))
    status.write("workload", {"passed": True})
    node = metrics.NodeMetrics(status=status)
    ready, stop = threading.Event(), threading.Event()
    port = _free_port()
    thread = threading.Thread(target=metrics.serve, args=(port, node),
                              kwargs={"refresh_interval": 0.05, "ready_event": ready,
                                      "stop_event": stop}, daemon=True)
    thread.start()
    try:
        assert ready.wait(10)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            body = r.read().decode()
        assert _triples(body) == _triples(node.scrape().decode())
        assert 'tpu_operator_node_chip_healthy{chip="3"} 1.0' in body
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/other", timeout=10)
        assert err.value.code == 404
    finally:
        stop.set()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("argv", [
    ["-c", "info"],
    ["-c", "feature-discovery"],
    ["-c", "sleep", "--revalidate-interval=30"],
], ids=lambda a: a[1])
def test_components_fail_closed_without_a_card(argv, tmp_path):
    env = dict(os.environ, NODE_NAME="n1", KUBE_API_URL="http://127.0.0.1:9",
               PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-m", "tpu_operator_torch.cmd.validator", *argv,
                             f"--status-dir={tmp_path}"], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode != 0
    assert "torch.cuda.is_available() is False" in result.stderr
