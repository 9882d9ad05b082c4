"""The port's operator over HTTP: ``gpu-operator`` in a subprocess against
the port's MiniApiServer, the REST client and its watches, and the whole
join chain run by the process kubelet on the CPU.

The operator labels the GPU node, creates every enabled DaemonSet and
reaches ``ready`` once the kubelet stand-in marks them available. The
process kubelet then runs the rendered validation chain (``driver`` ->
``plugin --prewarm`` -> ``workload`` and the pod it spawns) as processes,
with ``--device=cpu``; a workload pod whose status dir cannot be written
fails the barrier, which flips the ClusterPolicy to ``notReady``, and a
passing rerun restores ``ready``.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from tpu_operator.cmd.operator import build_parser as ref_parser
from tpu_operator_torch import consts
from tpu_operator_torch.client import (AlreadyExistsError, ConflictError, NotFoundError,
                                       RestClient)
from tpu_operator_torch.cmd.operator import build_parser
from tpu_operator_torch.testing.apiserver import MiniApiServer
from tpu_operator_torch.testing.kubelet import INIT, RUN, ProcessKubelet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "tpu_operator_torch", "manifests", "samples", "v1_clusterpolicy.json")
NS = "tpu-operator"
JOIN_TIMEOUT_S = 120
LEFT_OUT: set = set()


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_the_flag_set_is_the_references_minus_the_left_out():
    assert _flags(build_parser()) == _flags(ref_parser()) - LEFT_OUT
    ref = {a.dest: a.default for a in ref_parser()._actions}
    for action in build_parser()._actions:
        if action.dest not in ("help", "version"):
            assert action.default == ref[action.dest], action.dest


@pytest.mark.parametrize("flag", ["--help", "--version"])
def test_help_and_version_need_no_cluster(flag):
    env = {k: v for k, v in os.environ.items()
           if k not in ("KUBE_API_URL", "KUBERNETES_SERVICE_HOST")}
    out = subprocess.run([sys.executable, "-m", "tpu_operator_torch.cmd.operator", flag],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "gpu-operator" in out.stdout


@pytest.fixture
def server():
    srv = MiniApiServer(watch_idle_timeout_s=1.0)
    base = srv.start()
    yield srv, base
    srv.stop()


def _node(name="gpu-node", labels=None):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels or {consts.NFD_NVIDIA_PCI_LABEL: "true"}}}


def test_rest_client_round_trip(server):
    srv, base = server
    client = RestClient(base)
    client.create(_node())
    client.create(_node("cpu-node", {"role": "cpu"}))
    assert [n["metadata"]["name"] for n in client.list(
        "v1", "Node", label_selector={consts.NFD_NVIDIA_PCI_LABEL: "true"})] == ["gpu-node"]
    assert [n["metadata"]["name"] for n in client.list("v1", "Node",
                                                       label_selector={"role": None})] == \
        ["cpu-node"]
    ds = {"apiVersion": "apps/v1", "kind": "DaemonSet",
          "metadata": {"name": "d", "namespace": NS}, "spec": {"template": {}}}
    created = client.create(ds)
    with pytest.raises(AlreadyExistsError):
        client.create(ds)
    created["status"] = {"numberAvailable": 1}
    assert client.update_status(created)["status"] == {"numberAvailable": 1}
    assert client.get("apps/v1", "DaemonSet", "d", NS)["metadata"]["generation"] == 1
    patched = client.patch("v1", "Node", "gpu-node", {"metadata": {"labels": {"a": "1"}}})
    assert patched["metadata"]["labels"]["a"] == "1"
    stale = {"metadata": {"resourceVersion": "1", "labels": {"b": "2"}}}
    with pytest.raises(ConflictError):
        client.patch("v1", "Node", "gpu-node", stale)
    cp = json.load(open(SAMPLE))
    client.create(cp)
    assert client.list("tpu.ai/v1", "ClusterPolicy")[0]["spec"]["devicePlugin"][
        "resourceName"] == consts.GPU_RESOURCE_NAME
    client.delete("apps/v1", "DaemonSet", "d", NS)
    with pytest.raises(NotFoundError):
        client.get("apps/v1", "DaemonSet", "d", NS)
    assert client.server_version() == "v1.31.0-fake"
    client.stop()


def test_watch_streams_resumes_and_stops(server):
    """Events stream; when the server ends an idle stream, a write in the
    gap still arrives (the stale resume point relists), and a write after
    the reconnect streams; stop() ends the thread promptly."""
    srv, base = server
    client = RestClient(base)
    seen, lock = [], threading.Lock()

    def handler(event):
        with lock:
            seen.append((event.type, event.object["metadata"]["name"]))

    def watching():
        with srv.backend._lock:
            return len(srv.backend._watches)

    handle = client.watch("v1", "Node", handler=handler)
    _wait(lambda: watching() == 1, 10, "the watch")
    srv.backend.create(_node("a"))
    _wait(lambda: ("ADDED", "a") in seen, 10, "ADDED a")
    _wait(lambda: watching() == 0, 10, "the idle stream's end")
    srv.backend.create(_node("b"))  # in the gap, most likely
    _wait(lambda: ("ADDED", "b") in seen, 10, "ADDED b")
    _wait(lambda: watching() == 1, 10, "the reconnect")
    srv.backend.delete("v1", "Node", "a")
    _wait(lambda: ("DELETED", "a") in seen, 10, "DELETED a")
    t0 = time.monotonic()
    handle.stop()
    handle.join(timeout=10)
    assert not handle._thread.is_alive() and time.monotonic() - t0 < 5
    client.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Operator:
    """``gpu-operator`` in its own process group, logging to a file."""

    def __init__(self, base, log_path):
        self.metrics_port, self.health_port = _free_port(), _free_port()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        self.log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_operator_torch.cmd.operator", f"--api-server={base}",
             f"--namespace={NS}", f"--metrics-port={self.metrics_port}",
             f"--health-port={self.health_port}"],
            cwd=REPO, env=env, stdout=self.log, stderr=subprocess.STDOUT,
            start_new_session=True)

    def get(self, port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, r.read().decode()

    def stop(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, 9)
        self.proc.wait(timeout=30)
        self.log.close()


def _wait(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _state(srv):
    cp = srv.backend.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
    return (cp.get("status") or {}).get("state")


def test_the_operator_reconciles_the_sample_to_ready(server, tmp_path):
    srv, base = server
    srv.backend.create(_node())
    srv.backend.create(json.load(open(SAMPLE)))
    op = Operator(base, tmp_path / "operator.log")
    stop = threading.Event()

    def kubelet():  # every DaemonSet's pod available on the one node
        while not stop.wait(0.1):
            for ds in srv.backend.list("apps/v1", "DaemonSet", NS):
                want = {"desiredNumberScheduled": 1, "numberAvailable": 1,
                        "updatedNumberScheduled": 1,
                        "observedGeneration": ds["metadata"]["generation"]}
                if any((ds.get("status") or {}).get(k) != v for k, v in want.items()):
                    ds["status"] = want
                    srv.backend.update_status(ds)

    thread = threading.Thread(target=kubelet, daemon=True)
    try:
        labels = _wait(lambda: srv.backend.get("v1", "Node", "gpu-node")["metadata"]
                       .get("labels", {}).get(consts.GPU_PRESENT_LABEL), JOIN_TIMEOUT_S,
                       "the presence label")
        assert labels == "true"
        _wait(lambda: _state(srv) == "notReady", JOIN_TIMEOUT_S, "notReady")
        names = sorted(d["metadata"]["name"] for d in srv.backend.list("apps/v1", "DaemonSet"))
        assert names == ["gpu-device-plugin", "gpu-driver", "gpu-feature-discovery",
                         "gpu-node-status-exporter", "gpu-operator-validator",
                         "gpu-telemetry-exporter"]
        thread.start()
        _wait(lambda: _state(srv) == "ready", JOIN_TIMEOUT_S, "ready")
        assert op.get(op.health_port, "/healthz")[0] == 200
        assert op.get(op.health_port, "/readyz")[0] == 200
        _, text = op.get(op.metrics_port, "/metrics")
        total = float(next(line.split()[-1] for line in text.splitlines()
                           if line.startswith("tpu_operator_reconciliation_total ")))
        assert total >= 2
        assert "tpu_operator_tpu_nodes_total 1.0" in text
        assert "tpu_operator_reconciliation_status 1.0" in text
        # the operator process holds no torch
        with open(f"/proc/{op.proc.pid}/maps") as f:
            assert "libtorch" not in f.read()
    finally:
        stop.set()
        op.stop()


def _fake_driver_bundle(root):
    bundle = root / "bundle"
    bundle.mkdir()
    for name in consts.DRIVER_LIB_FILES:
        (bundle / name).write_bytes(b"\x7fELF" + bytes(60))
    return bundle


def test_the_process_kubelet_runs_the_join_chain_on_the_cpu(server, tmp_path):
    """The operator-ordered chain as processes: the driver installer and
    its startup probe, the validator's init chain with its spawned
    workload pod, the device plugin's driver wait (then the GPU capacity);
    a workload pod that fails flips the CR to notReady until a rerun
    passes."""
    srv, base = server
    srv.backend.create(_node())
    dev = tmp_path / "dev"
    dev.mkdir()
    (dev / "nvidia0").touch()
    cp = json.load(open(SAMPLE))
    cp["spec"]["hostPaths"] = {"validationStatusDir": str(tmp_path / "status"),
                               "partitionHandoffDir": str(tmp_path / "handoff"),
                               "driverInstallDir": str(tmp_path / "driver"),
                               "devGlobs": [str(dev / "nvidia0")]}
    op = Operator(base, tmp_path / "operator.log")
    env = {k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ}
    env.update(PYTHONPATH=REPO, KUBE_API_URL=base)
    kubelet = ProcessKubelet(
        srv.backend, "gpu-node", NS, str(tmp_path / "logs"), env,
        {"gpu-validator": [sys.executable, "-m", "tpu_operator_torch.cmd.validator",
                           "--device=cpu", "--matrix-dim=64"]},
        modes={"gpu-driver": RUN, "gpu-operator-validator": RUN, "gpu-device-plugin": INIT},
        image_env={"gpu-driver": {consts.DRIVER_SRC_ENV: str(_fake_driver_bundle(tmp_path)),
                                  consts.DRIVER_VERSION_ENV: "580.0"}},
        capacity_app="gpu-device-plugin",
        path_map={"/var/cache/gpu-kernels": str(tmp_path / "kernel-cache")}).start()
    try:
        t0 = time.time()
        srv.backend.create(cp)
        _wait(lambda: _state(srv) == "ready", JOIN_TIMEOUT_S, "ready")
        assert kubelet.first("init-exit", ds="gpu-operator-validator",
                             container="workload-validation")["rc"] == 0
        pod = kubelet.first("pod-exit")
        assert pod["phase"] == "Succeeded" and pod["pod"] == "gpu-workload-validation-gpu-node"
        order = [kubelet.first("init-exit", ds="gpu-operator-validator", container=c)["t"]
                 for c in ("driver-validation", "plugin-validation", "workload-validation")]
        assert order == sorted(order) and order[0] > t0
        assert kubelet.first("capacity")["t"] < order[1]  # the plugin barrier waited for it
        status = tmp_path / "status"
        for barrier in ("driver", "plugin", "workload"):
            assert (status / f"{barrier}-ready").exists(), barrier
        simulated = {e["ds"] for e in kubelet.events if e["kind"] == "simulated"}
        assert simulated == {"gpu-feature-discovery", "gpu-node-status-exporter",
                             "gpu-telemetry-exporter"}

        # a failing workload barrier flips the CR; a passing rerun restores it
        kubelet.pod_env = {"STATUS_DIR": os.devnull + "/status"}  # the sweep cannot write
        t1 = time.time()
        kubelet.restart("gpu-operator-validator")
        _wait(lambda: _state(srv) == "notReady", JOIN_TIMEOUT_S, "notReady")
        _wait(lambda: kubelet.first("pod-exit", phase="Failed"), JOIN_TIMEOUT_S, "a failed pod")
        _wait(lambda: json.loads((status / "workload-ready").read_text())["passed"] is False,
              JOIN_TIMEOUT_S, "the failed barrier")
        assert _state(srv) == "notReady"
        # the failed init holds the validator unavailable: its back-off
        # rerun fails too, and meanwhile the DaemonSet has no available pod
        failed = dict(kind="init-exit", ds="gpu-operator-validator",
                      container="workload-validation", rc=1)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while len(kubelet.matching(after=t1, **failed)) < 2:
            ds = srv.backend.get("apps/v1", "DaemonSet", "gpu-operator-validator", NS)
            assert ds["status"]["numberAvailable"] == 0 and _state(srv) == "notReady"
            assert time.monotonic() < deadline, "timed out waiting for a failed rerun"
            time.sleep(0.1)
        first = kubelet.matching(after=t1, **failed)[0]
        assert kubelet.first("init-start", after=first["t"], ds="gpu-operator-validator",
                             container="workload-validation")
        kubelet.pod_env = None
        _wait(lambda: _state(srv) == "ready", JOIN_TIMEOUT_S, "ready again")
        assert json.loads((status / "workload-ready").read_text())["passed"] is True
    finally:
        kubelet.stop()
        op.stop()


def test_the_console_script_and_the_manifests_ship():
    import tomllib
    from pathlib import Path

    pyproject = tomllib.loads((Path(REPO) / "pyproject.toml").read_text())
    assert pyproject["project"]["scripts"]["gpu-operator"] == \
        "tpu_operator_torch.cmd.operator:main"
    package = Path(REPO) / "tpu_operator_torch"
    shipped = {p for pattern in
               pyproject["tool"]["setuptools"]["package-data"]["tpu_operator_torch"]
               for p in package.glob(pattern)}
    manifests = {p for p in (package / "manifests").rglob("*")
                 if p.is_file() and "__pycache__" not in p.parts}
    assert manifests and manifests <= shipped
