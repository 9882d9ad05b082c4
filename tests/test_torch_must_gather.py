"""``gpu-must-gather`` against the reference's collector (the twins of
tests/test_must_gather.py): each package's collector runs against its own
live harness cluster seeded with the same objects (the reference's mapped
onto the port's, tests/test_torch_operator_mapping.py), and the two bundles
must hold the same files, section by section, after the mapping's renames
and the port's one addition, ``cluster/clusterinfo.txt``. The shell wrapper
``hack/gpu-must-gather.sh`` runs beside ``hack/must-gather.sh``; the
cluster harness and ``clusterinfo`` are held to the reference's too.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import tarfile
import threading
import time
import types

import pytest
import yaml

from test_torch_operator_mapping import (
    DEBUG_ROUTES_LEFT_OUT,
    map_chart_object,
    map_driver,
    map_node,
)
from tpu_operator import consts as ref_consts
from tpu_operator.api.clusterpolicy import new_cluster_policy as ref_new_policy
from tpu_operator.api.tpudriver import new_tpu_driver
from tpu_operator.clusterinfo import ClusterInfo as RefClusterInfo
from tpu_operator.cmd import must_gather as ref_mg
from tpu_operator.controllers.manager import OperatorApp as RefApp
from tpu_operator.client.rest import RestClient as RefRest
from tpu_operator.testing import MiniApiServer as RefServer
from tpu_operator_torch import consts, yamlsubset
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.client.rest import RestClient
from tpu_operator_torch.clusterinfo import ClusterInfo
from tpu_operator_torch.cmd import must_gather
from tpu_operator_torch.controllers.manager import DEBUG_ROUTES, OperatorApp
from tpu_operator_torch.testing.apiserver import MiniApiServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "tpu-operator"

REF = types.SimpleNamespace(
    name="reference", port=False, Server=RefServer, Rest=RefRest, App=RefApp, mg=ref_mg,
    script="must-gather.sh")
PORT = types.SimpleNamespace(
    name="port", port=True, Server=MiniApiServer, Rest=RestClient, App=OperatorApp,
    mg=must_gather, script="gpu-must-gather.sh")


def reference_objects():
    """The reference test's harness objects."""
    return [
        ref_new_policy(),
        new_tpu_driver("pool-a", {"image": "img"}),
        {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}},
        {"apiVersion": "v1", "kind": "Node",
         "metadata": {"name": "tpu-0", "labels": {
             ref_consts.TPU_PRESENT_LABEL: "true",
             ref_consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
             ref_consts.UPGRADE_STATE_LABEL: "upgrade-done"}},
         "spec": {},
         "status": {"capacity": {ref_consts.TPU_RESOURCE_NAME: "4"}}},
        {"apiVersion": "apps/v1", "kind": "DaemonSet",
         "metadata": {"name": "libtpu-driver", "namespace": NS},
         "spec": {"template": {"metadata": {}, "spec": {}}}},
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "drv-0", "namespace": NS},
         "spec": {"nodeName": "tpu-0", "containers": []},
         "status": {"phase": "Running"}},
        {"apiVersion": "v1", "kind": "Event",
         "metadata": {"name": "ev-1", "namespace": NS},
         "reason": "Ready", "message": "all ready", "lastTimestamp": "2026-01-01T00:00:00Z"},
    ]


def port_object(obj):
    """A reference harness object as the port's harness holds it (the
    namespace keeps its name)."""
    if obj["kind"] == "TPUDriver":
        return map_driver(obj)
    if obj["kind"] == "Node":
        return map_node(obj)
    if obj["kind"] == "ClusterPolicy":
        return new_cluster_policy()
    if obj["kind"] == "DaemonSet":
        return dict(obj, metadata=dict(obj["metadata"], name="gpu-driver"))
    return obj


def map_path(path: str) -> str:
    """A reference bundle file's path as the port's."""
    return "/".join(map_chart_object(part) for part in path.split("/"))


class Harness:
    """One package's live cluster seeded with the reference test's objects
    (mapped for the port), and the validation barriers a node would have."""

    def __init__(self, s, tmp_path):
        self.s = s
        self.tmp = tmp_path / s.name
        self.srv = s.Server()
        self.base = self.srv.start()
        self.client = s.Rest(base_url=self.base)
        for obj in reference_objects():
            self.client.create(port_object(obj) if s.port else obj)
        self.status_dir = self.tmp / "validations"
        self.status_dir.mkdir(parents=True)
        (self.status_dir / "driver-ready").write_text(
            json.dumps({"libtpu": "/x/libcuda.so.1", "source": "host"}))
        (self.status_dir / "perf-ready").write_text(json.dumps({"passed": True}))

    def gather(self, out, **kw):
        kw.setdefault("status_dir", str(self.status_dir))
        return self.s.mg.MustGather(self.client, NS, str(self.tmp / out), **kw)

    def stop(self):
        self.srv.stop()


@pytest.fixture
def harnesses(monkeypatch, tmp_path):
    for env, image in (("DRIVER_IMAGE", "registry.example/d:1"),
                       ("VALIDATOR_IMAGE", "registry.example/v:1"),
                       ("DEVICE_PLUGIN_IMAGE", "registry.example/p:1")):
        monkeypatch.setenv(env, image)
    made = [Harness(REF, tmp_path), Harness(PORT, tmp_path)]
    yield made
    for h in made:
        h.stop()


def serve_metrics(text=b"gpu_count 4.0\n"):
    import http.server

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            self.wfile.write(text)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}/metrics"


def mapped_sections(sections):
    """A reference bundle's index as the port's: renamed files, the
    reference's /debug routes the port lacks left out, and the port's
    cluster/clusterinfo.txt."""
    left_out = {route.rsplit("/", 1)[-1] for route in DEBUG_ROUTES_LEFT_OUT}
    out = {}
    for section, files in sections.items():
        out[section] = [map_path(f) for f in files
                        if f.split("/")[-1].split(".")[0] not in left_out]
    out["cluster"].insert(1, "clusterinfo.txt")
    return out


def test_must_gather_collects_all_sections(harnesses):
    metrics_srv, metrics_url = serve_metrics()
    indexes = []
    try:
        for h in harnesses:
            indexes.append(h.gather("bundle", telemetry_urls=[metrics_url]).run())
    finally:
        metrics_srv.shutdown()
    ref, port = indexes
    assert port["errors"] == ref["errors"] == []
    assert port["sections"] == mapped_sections(ref["sections"])
    assert "gpudrivers.yaml" in port["sections"]["crs"]
    assert "pods/drv-0.yaml" in port["sections"]["operands"]
    assert "tpu-0.yaml" in port["sections"]["nodes"]
    assert {"barriers/driver-ready", "barriers/perf-ready", "upgrade-states.yaml"} <= \
        set(port["sections"]["validation"])

    out = harnesses[1].tmp / "bundle"
    with open(out / "telemetry" / "scrape-0.prom") as f:
        assert "gpu_count 4.0" in f.read()
    summary = (out / "cluster" / "node-summary.txt").read_text().splitlines()
    row = dict(zip(summary[0].split(), summary[1].split()))
    assert row["NODE"] == "tpu-0" and row[consts.UPGRADE_STATE_LABEL] == "upgrade-done"
    assert row[consts.GPU_PRESENT_LABEL] == "true" and row["CAPACITY"] == "4"
    assert (out / "cluster" / "clusterinfo.txt").read_text() == \
        "kubernetes: v1.31.0-fake  runtime: containerd  nodes: 1\n"
    with open(out / "manifest.json") as f:
        assert json.load(f)["sections"] == port["sections"]
    # the YAML it writes is the subset, and reads back as PyYAML reads it
    for section, files in port["sections"].items():
        for name in files:
            if name.endswith(".yaml"):
                text = (out / section / name).read_text()
                assert yamlsubset.parse(text) == yaml.safe_load(text), name
    # the same objects as the reference's bundle holds, mapped
    ref_out = harnesses[0].tmp / "bundle"
    ref_drivers = yaml.safe_load((ref_out / "crs" / "tpudrivers.yaml").read_text())
    drivers = yamlsubset.parse((out / "crs" / "gpudrivers.yaml").read_text())
    assert [d["spec"] for d in drivers] == [map_driver(d)["spec"] for d in ref_drivers]


def test_must_gather_shell_wrapper_harness_mode(harnesses):
    """``BASE=<url> hack/gpu-must-gather.sh`` runs the collector end to end and
    writes the tarball, as ``hack/must-gather.sh`` does for the reference."""
    names = []
    for h in harnesses:
        artifact = str(h.tmp / "shell-bundle")
        env = dict(os.environ, BASE=h.base, ARTIFACT_DIR=artifact,
                   STATUS_DIR_OVERRIDE=str(h.status_dir), PYTHONPATH=REPO)
        proc = subprocess.run(["bash", os.path.join(REPO, "hack", h.s.script)],
                              capture_output=True, text=True, env=env, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        with tarfile.open(artifact + ".tar.gz") as tar:
            names.append(tar.getnames())
    base = "shell-bundle"
    for section in must_gather.SECTIONS:
        assert any(n.startswith(f"{base}/{section}/") for n in names[1]), section
    assert f"{base}/manifest.json" in names[1]
    assert must_gather.SECTIONS == ref_mg.SECTIONS
    ref_files = {map_path(n) for n in names[0]}
    assert set(names[1]) - ref_files == {f"{base}/cluster/clusterinfo.txt"}


def test_must_gather_degrades_on_unreachable_endpoints(harnesses):
    """The collector finishes, with recorded errors, never crashes, when the
    telemetry endpoints are down and no status dir is reachable."""
    indexes = [h.gather("bundle2", status_dir=None,
                        telemetry_urls=["http://127.0.0.1:1/metrics"]).run()
               for h in harnesses]
    for index in indexes:
        assert "scrape-0.error.txt" in index["sections"]["telemetry"]
        assert "barriers/README.txt" in index["sections"]["validation"]
    assert indexes[1]["sections"] == mapped_sections(indexes[0]["sections"])


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_must_gather_operator_section(harnesses):
    """The operator's self-diagnostics: a live operator pod's /metrics and
    every /debug route of ``DEBUG_ROUTES`` (a route added there is collected
    without a second edit); an unreachable pod degrades to recorded errors."""
    files = {}
    for h in harnesses:
        app_label = "tpu-operator" if not h.s.port else must_gather.OPERATOR_APP
        h.client.create({"apiVersion": "v1", "kind": "Pod",
                         "metadata": {"name": "op-abc", "namespace": NS,
                                      "labels": {"app": app_label}},
                         "spec": {"containers": []},
                         "status": {"phase": "Running", "podIP": "127.0.0.1"}})
        index = h.gather("bundle3", operator_metrics_port=1, operator_health_port=1).run()
        down = index["sections"]["operator"]
        assert "op-abc/metrics.prom.error.txt" in down and "op-abc/threads.txt.error.txt" in down
        mport, hport = _free_port(), _free_port()
        app = h.s.App(h.s.Rest(base_url=h.base), metrics_port=mport, health_port=hport)
        app.start()
        try:
            index = h.gather("bundle4", operator_metrics_port=mport,
                             operator_health_port=hport).run()
        finally:
            app.stop()
        files[h.s.name] = (down, index["sections"]["operator"])
        out = h.tmp / "bundle4" / "operator" / "op-abc"
        assert "tpu_operator_workqueue" in (out / "metrics.prom").read_text()
        assert isinstance(json.loads((out / "informers.json").read_text()), list)
    down, up = files["port"]
    ref_down, ref_up = files["reference"]
    left_out = {r.rsplit("/", 1)[-1] for r in DEBUG_ROUTES_LEFT_OUT}

    def keep(names):
        return [n for n in names if n.split("/")[-1].split(".")[0] not in left_out]

    assert up == keep(ref_up) and down == keep(ref_down)
    # every route of the port's table, and its metrics, were collected
    wanted = {"op-abc/metrics.prom", "op-abc/sources.txt"} | {
        f"op-abc/{fname}" for _, fname in must_gather.debug_endpoint_files()}
    assert wanted == set(up) and len(must_gather.debug_endpoint_files()) == len(DEBUG_ROUTES)


# -- clusterinfo (the twins of tests/test_nodeinfo.py's two cases) ---------------------

def mk_node(name, runtime):
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": {}},
            "status": {"capacity": {},
                       "nodeInfo": {"containerRuntimeVersion": runtime,
                                    "kubeletVersion": "v1.31.0"}}}


def test_cluster_info():
    from tpu_operator.client import FakeClient as RefFake

    got = []
    for Fake, Info in ((RefFake, RefClusterInfo), (FakeClient, ClusterInfo)):
        client = Fake()
        for name, runtime in (("a", "containerd://1.7.13"), ("b", "containerd://1.7.13"),
                              ("c", "docker://24.0")):
            client.create(mk_node(name, runtime))
        info = Info(client)
        got.append((info.kubernetes_version(), info.container_runtime()))
    assert got[1] == got[0] == ("v1.31.0-fake", "containerd")


def test_cluster_info_empty_cluster():
    from tpu_operator.client import FakeClient as RefFake

    got = [Info(Fake()).container_runtime()
           for Fake, Info in ((RefFake, RefClusterInfo), (FakeClient, ClusterInfo))]
    assert got == ["containerd", "containerd"]


def test_cluster_info_falls_back_to_the_kubelet_versions():
    """Without a server version (a client that has none, or fails), the
    version is the first kubelet's, as in the reference."""
    class NoVersion:
        def __init__(self, inner):
            self.inner = inner

        def list(self, *a, **kw):
            return self.inner.list(*a, **kw)

        def server_version(self):
            raise RuntimeError("down")

    client = FakeClient()
    client.create(mk_node("a", "cri-o://1.30"))
    info = ClusterInfo(NoVersion(client), one_shot=True)
    assert info.kubernetes_version() == "v1.31.0"
    assert info.container_runtime() == "cri-o"
    client.create(mk_node("b", "containerd://1.7"))
    client.create(mk_node("c", "containerd://1.7"))
    assert info.container_runtime() == "cri-o"  # one-shot: cached


# -- the cluster harness as a process ----------------------------------------------------

def test_the_cluster_harness_process_serves_gpu_nodes_and_exits_0_on_sigterm(tmp_path):
    url_file = tmp_path / "cluster.url"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_operator_torch.testing.cluster", "--url-file",
         str(url_file), "--nodes", "3", "--gpus-per-node", "4", "--gpu-product",
         "nvidia-a100-80gb"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while not url_file.exists():
            assert proc.poll() is None, proc.stderr.read()
            assert time.monotonic() < deadline, "no URL file within 60 s"
            time.sleep(0.05)
        base = url_file.read_text()
        client = RestClient(base_url=base)
        nodes = client.list("v1", "Node")
        assert [n["metadata"]["name"] for n in nodes] == ["gpu-node-0", "gpu-node-1",
                                                        "gpu-node-2"]
        for n in nodes:
            labels = n["metadata"]["labels"]
            assert labels[consts.NFD_NVIDIA_PCI_LABEL] == "true"
            assert labels[consts.GKE_ACCELERATOR_LABEL] == "nvidia-a100-80gb"
            assert n["status"]["capacity"][consts.GPU_RESOURCE_NAME] == "4"
            assert n["status"]["nodeInfo"]["containerRuntimeVersion"].startswith("containerd://")
        info = ClusterInfo(client)
        assert (info.kubernetes_version(), info.container_runtime()) == \
            ("v1.31.0-fake", "containerd")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
