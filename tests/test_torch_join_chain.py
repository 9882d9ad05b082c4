"""The rest of the validator's deployed join chain in the PyTorch port:
``plugin --prewarm``, ``prewarm``, the pod-spawned ``workload`` and the
apiserver client they use (tpu_operator_torch/validator/{main,workload}.py,
tpu_operator_torch/client.py), against the JAX package's
(tpu_operator/validator/{main,workload}.py) with the reference's
``FakeClient`` and ``MiniApiServer`` standing in for the apiserver.

There is no ``nvcc`` here, so every build is stubbed: the build itself runs
on the card (``chip_smoke.py``'s prewarm phase).
"""

import ast
import copy
import inspect
import json
import threading
import time

import pytest

from tpu_operator.testing import MiniApiServer
from tpu_operator.validator import status as ref_status
from tpu_operator.validator import workload as ref_workload
from tpu_operator_torch import consts
from tpu_operator_torch.client import ApiClient, ApiError, NotFoundError, is_not_found
from tpu_operator_torch.kernels import _build
from tpu_operator_torch.validator import main as vmain
from tpu_operator_torch.validator import workload
from tpu_operator_torch.validator.status import StatusFiles

NS = "gpu-operator"


def _node(name="n1", gpus="4"):
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name},
            "status": {"allocatable": {consts.GPU_RESOURCE_NAME: gpus}}}


@pytest.fixture
def api_server():
    srv = MiniApiServer()
    base = srv.start()
    try:
        yield srv, base
    finally:
        srv.stop()


@pytest.fixture
def stub_build(monkeypatch):
    """``_build.build_all`` replaced by a recorder of where it would build."""
    calls = []

    def build_all(timeout=600.0):
        calls.append(_build.library_path("stream_copy"))
        return {name: 0.0 for name in _build.sources()}

    monkeypatch.setattr(_build, "build_all", build_all)
    return calls


# -- prewarm ------------------------------------------------------------------

def _reference_prewarm_keys():
    """The keys of the dict the reference's prewarm returns, read from its
    source (running it would point this process's XLA cache elsewhere)."""
    tree = ast.parse(inspect.getsource(ref_workload.prewarm_compile_cache))
    (ret,) = [n for n in ast.walk(tree) if isinstance(n, ast.Return)
              and isinstance(n.value, ast.Dict)]
    return {k.value for k in ret.value.keys}


def test_prewarm_is_none_without_cache_dir(monkeypatch, stub_build):
    monkeypatch.delenv(consts.COMPILATION_CACHE_DIR_ENV, raising=False)
    assert workload.enable_compilation_cache() is None
    assert workload.prewarm_compile_cache(device="cpu") is None
    assert stub_build == []
    assert _build.build_dir() == _build.BUILD_DIR


def test_prewarm_builds_into_the_cache_dir(monkeypatch, tmp_path, stub_build):
    cache = tmp_path / "kernel-cache"
    monkeypatch.setenv(consts.COMPILATION_CACHE_DIR_ENV, str(cache))
    result = workload.prewarm_compile_cache(device="cpu")
    assert set(result) == _reference_prewarm_keys() == {"cache_dir", "compile_s", "n_devices"}
    assert result["cache_dir"] == str(cache) and cache.is_dir()
    assert result["n_devices"] == 1 and result["compile_s"] >= 0
    assert len(stub_build) == 1 and stub_build[0].parent == cache
    assert _build.library_path("stream_copy").parent == cache


def test_prewarm_needs_cuda_by_default(monkeypatch, tmp_path, stub_build):
    monkeypatch.setenv(consts.COMPILATION_CACHE_DIR_ENV, str(tmp_path))
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        workload.prewarm_compile_cache()


def test_prewarm_cli_prints_its_result(monkeypatch, tmp_path, stub_build, capsys):
    monkeypatch.setenv(consts.COMPILATION_CACHE_DIR_ENV, str(tmp_path / "c"))
    assert vmain.run(["-c", "prewarm", "--device=cpu",
                      f"--status-dir={tmp_path / 'st'}"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["cache_dir"] == str(tmp_path / "c")


@pytest.mark.parametrize("setup", ["build-raises", "no-cuda", "unset"])
def test_prewarm_cli_never_blocks_the_chain(monkeypatch, tmp_path, setup):
    """As the reference's (main.py:415-424): a failed or skipped warm-up
    exits 0 and writes no barrier."""
    def broken(timeout=600.0):
        raise RuntimeError("nvcc failed building stream_copy.cu")

    monkeypatch.setattr(_build, "build_all", broken)
    monkeypatch.setenv(consts.COMPILATION_CACHE_DIR_ENV, str(tmp_path / "c"))
    argv = ["-c", "prewarm", f"--status-dir={tmp_path / 'st'}", "--device=cpu"]
    if setup == "no-cuda":
        monkeypatch.setattr("torch.cuda.is_available", lambda: False)
        argv = argv[:-1]
    if setup == "unset":
        monkeypatch.delenv(consts.COMPILATION_CACHE_DIR_ENV)
    assert vmain.run(argv) == 0
    assert not (tmp_path / "st").exists()


# -- plugin --prewarm ---------------------------------------------------------

@pytest.mark.parametrize("warm", ["ok", "raises"])
def test_plugin_prewarm_joins_its_thread_and_passes(fake_client, monkeypatch, tmp_path,
                                                    warm):
    fake_client.create(_node(gpus="8"))
    monkeypatch.setenv("NODE_NAME", "n1")
    monkeypatch.setenv(consts.COMPILATION_CACHE_DIR_ENV, str(tmp_path / "c"))
    calls = []

    def build_all(timeout=600.0):
        calls.append(threading.current_thread().name)
        if warm == "raises":
            raise RuntimeError("nvcc not found")
        return {}

    monkeypatch.setattr(_build, "build_all", build_all)
    rc = vmain.run(["-c", "plugin", "--prewarm", "--device=cpu", "--timeout=5",
                    "--poll=0.05", f"--status-dir={tmp_path / 'st'}"], client=fake_client)
    assert rc == 0
    assert calls == ["prewarm-build"]
    assert not any(t.name == "prewarm-build" for t in threading.enumerate())
    assert ref_status.StatusFiles(str(tmp_path / "st")).read("plugin")["count"] == 8


def test_plugin_without_prewarm_builds_nothing(fake_client, monkeypatch, tmp_path,
                                               stub_build):
    fake_client.create(_node())
    monkeypatch.setenv("NODE_NAME", "n1")
    monkeypatch.setenv(consts.COMPILATION_CACHE_DIR_ENV, str(tmp_path / "c"))
    assert vmain.run(["-c", "plugin", "--timeout=5", f"--status-dir={tmp_path}"],
                     client=fake_client) == 0
    assert stub_build == []


# -- the apiserver client -----------------------------------------------------

def test_client_node_and_pod_round_trip(api_server):
    srv, base = api_server
    srv.backend.create(_node())
    client = ApiClient(base)
    assert client.get("v1", "Node", "n1")["status"]["allocatable"] == \
        {consts.GPU_RESOURCE_NAME: "4"}
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "p", "namespace": NS},
           "spec": {"containers": [{"name": "c", "image": "i"}]}}
    client.create(pod)
    assert client.get("v1", "Pod", "p", NS)["metadata"]["name"] == "p"
    client.delete("v1", "Pod", "p", NS)
    with pytest.raises(NotFoundError) as err:
        client.get("v1", "Pod", "p", NS)
    assert err.value.code == 404 and is_not_found(err.value)
    with pytest.raises(NotFoundError):
        client.delete("v1", "Pod", "p", NS)
    client.create(pod)
    with pytest.raises(ApiError) as err:
        client.create(pod)
    assert err.value.code == 409 and not is_not_found(err.value)
    with pytest.raises(ValueError, match="Nodes and Pods"):
        client.get("apps/v1", "DaemonSet", "x", NS)


def test_client_from_env(monkeypatch):
    monkeypatch.setenv("KUBE_API_URL", "http://127.0.0.1:1/")
    assert ApiClient.from_env().base_url == "http://127.0.0.1:1"
    monkeypatch.delenv("KUBE_API_URL")
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(RuntimeError, match="no apiserver"):
        ApiClient.from_env()


def test_reference_not_found_counts_as_not_found(fake_client):
    from tpu_operator.client.errors import NotFoundError as RefNotFound

    with pytest.raises(RefNotFound) as err:
        fake_client.delete("v1", "Pod", "absent", NS)
    assert is_not_found(err.value)


# -- spawn_workload_pod -------------------------------------------------------

def _finish_pods(lister, updater, phase, delay=0.2, wait=10.0):
    """A kubelet: once a pod exists in NS (polled from ``delay`` on, for
    at most ``wait`` s), mark every pod there with ``phase``."""
    def run():
        deadline = time.monotonic() + wait
        time.sleep(delay)
        while not (pods := lister()) and time.monotonic() < deadline:
            time.sleep(0.02)
        for pod in pods:
            pod["status"] = {"phase": phase}
            updater(pod)

    kubelet = threading.Thread(target=run, daemon=True)
    kubelet.start()
    return kubelet


@pytest.mark.parametrize("phase, expected", [("Succeeded", True), ("Failed", False),
                                             (None, None)])
def test_spawn_against_reference_fake_client(fake_client, phase, expected):
    fake_client.create(_node(gpus="8"))
    created = []
    original = fake_client.create

    def spy(obj):
        if obj["kind"] == "Pod":
            created.append(copy.deepcopy(obj))
        return original(obj)

    fake_client.create = spy
    timer = None
    if phase:
        timer = _finish_pods(lambda: fake_client.list("v1", "Pod", NS),
                             fake_client.update_status, phase)
    ok = workload.spawn_workload_pod(fake_client, NS, "n1", "img:1",
                                     timeout=5.0 if phase else 0.3, poll=0.05)
    if timer:
        timer.join(5)
    assert ok is expected
    assert fake_client.list("v1", "Pod", NS) == []  # deleted afterwards
    (pod,) = created
    assert pod["spec"]["containers"][0]["resources"]["limits"] == \
        {consts.GPU_RESOURCE_NAME: "8"}
    assert pod["spec"]["nodeName"] == "n1"


@pytest.mark.parametrize("phase, expected", [("Succeeded", True), ("Failed", False)])
def test_spawn_over_http(api_server, phase, expected):
    srv, base = api_server
    srv.backend.create(_node(gpus="2"))
    timer = _finish_pods(lambda: srv.backend.list("v1", "Pod", NS),
                         srv.backend.update_status, phase)
    ok = workload.spawn_workload_pod(ApiClient(base), NS, "n1", "img:1", timeout=5.0,
                                     poll=0.05)
    timer.join(5)
    assert ok is expected
    assert srv.backend.list("v1", "Pod", NS) == []


def test_spawn_replaces_a_leftover_pod(fake_client):
    fake_client.create(_node())
    fake_client.create({"apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": "gpu-workload-validation-n1", "namespace": NS},
                        "spec": {"containers": []}, "status": {"phase": "Failed"}})
    assert workload.spawn_workload_pod(fake_client, NS, "n1", "img:1", timeout=0.2,
                                       poll=0.05) is None
    assert fake_client.list("v1", "Pod", NS) == []


#: the reference's accelerator names -> the port's
NAME_MAP = {"google.com/tpu": "nvidia.com/gpu", "tpu-validator": "gpu-validator",
            "tpu-workload": "gpu-workload", "TPU_COMPILATION_CACHE_DIR":
            consts.COMPILATION_CACHE_DIR_ENV, "xla-cache": "kernel-cache",
            "/var/cache/tpu-xla": "/var/cache/gpu-kernels"}


def _mapped(obj):
    text = json.dumps(obj)
    for old, new in NAME_MAP.items():
        text = text.replace(old, new)
    return json.loads(text)


@pytest.mark.parametrize("cache", [None, "/var/cache/gpu-kernels"])
def test_pod_spec_equals_reference(fake_client, monkeypatch, cache):
    """The spawned pod is the reference's once the accelerator names are
    mapped: status and build-cache host paths, one GPU request per
    allocatable GPU, the validator's command; and it pins CUDA's device
    order to PCI."""
    from tpu_operator import consts as ref_consts

    pods = {}
    for key, module, env, resource in (
            ("port", workload, consts.COMPILATION_CACHE_DIR_ENV, consts.GPU_RESOURCE_NAME),
            ("ref", ref_workload, "TPU_COMPILATION_CACHE_DIR", ref_consts.TPU_RESOURCE_NAME)):
        client = type(fake_client)()
        client.create(_node() | {"status": {"allocatable": {resource: "4"}}})
        original = client.create
        client.create = lambda obj, original=original, key=key: (
            pods.__setitem__(key, copy.deepcopy(obj)) or original(obj))
        monkeypatch.delenv("TPU_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.delenv(consts.COMPILATION_CACHE_DIR_ENV, raising=False)
        if cache:
            monkeypatch.setenv(env, cache if key == "port" else "/var/cache/tpu-xla")
        module.spawn_workload_pod(client, NS, "n1", "img:1", timeout=0.05, poll=0.02,
                                  status_dir="/run/tpu/validations")
    # the one addition: the pod's sweep numbers GPUs in PCI order, as the
    # device plugin's units are (the reference has no device order to pin)
    order = {"name": consts.CUDA_DEVICE_ORDER_ENV, "value": "PCI_BUS_ID"}
    for pod in (pods["port"], workload.WORKLOAD_POD_TEMPLATE):
        env = pod["spec"]["containers"][0]["env"]
        assert env[1] == order
    without_order = copy.deepcopy(pods["port"])
    without_order["spec"]["containers"][0]["env"].remove(order)
    assert without_order == _mapped(pods["ref"])
    assert pods["port"]["spec"]["containers"][0]["command"] == ["gpu-validator"]
    template = copy.deepcopy(workload.WORKLOAD_POD_TEMPLATE)
    template["spec"]["containers"][0]["env"].remove(order)
    assert template == _mapped(ref_workload.WORKLOAD_POD_TEMPLATE)


# -- -c workload --------------------------------------------------------------

@pytest.mark.parametrize("in_pod_write", [False, True])
@pytest.mark.parametrize("phase", ["Succeeded", "Failed", None])
def test_workload_component_barrier(fake_client, monkeypatch, tmp_path, phase, in_pod_write):
    """The reference's rules (main.py:338-383): an in-pod barrier write is
    kept; without one a coarse ``passed: false`` is written only when the
    pod failed; a timeout leaves the previous barrier untouched."""
    status_dir = tmp_path / "st"
    status = StatusFiles(str(status_dir))
    status.write("workload", {"passed": True, "previous": True})
    monkeypatch.setenv("NODE_NAME", "n1")
    monkeypatch.setenv("VALIDATOR_IMAGE", "img:1")
    monkeypatch.setenv(consts.NAMESPACE_ENV, NS)
    fake_client.create(_node())

    def kubelet():
        for pod in fake_client.list("v1", "Pod", NS):
            if in_pod_write:
                status.write("workload", {"passed": phase == "Succeeded", "n_devices": 4,
                                          "failed_local_chips": []})
            if phase:
                pod["status"] = {"phase": phase}
                fake_client.update_status(pod)

    timer = threading.Timer(0.2, kubelet)
    timer.start()
    rc = vmain.run(["-c", "workload", f"--status-dir={status_dir}",
                    f"--timeout={5.0 if phase else 0.6}"], client=fake_client)
    timer.join(5)
    assert rc == (0 if phase == "Succeeded" else 1)
    barrier = ref_status.StatusFiles(str(status_dir)).read("workload")
    handshake = status.read("workload-handshake")
    assert handshake["node"] == "n1" and handshake["phase"] == "spawning"
    if in_pod_write:
        assert barrier["n_devices"] == 4 and "mode" not in barrier
    elif phase == "Succeeded":
        assert barrier["mode"] == "pod" and "passed" not in barrier
        assert ref_status.StatusFiles(str(status_dir)).is_ready("workload")
    elif phase == "Failed":
        assert barrier["mode"] == "pod" and barrier["passed"] is False
        assert not ref_status.StatusFiles(str(status_dir)).is_ready("workload")
    else:
        assert barrier["previous"] is True and "mode" not in barrier
    assert fake_client.list("v1", "Pod", NS) == []


def test_workload_component_needs_node_and_image(fake_client, monkeypatch, tmp_path):
    monkeypatch.delenv("NODE_NAME", raising=False)
    monkeypatch.setenv("VALIDATOR_IMAGE", "img:1")
    assert vmain.run(["-c", "workload", f"--status-dir={tmp_path}"],
                     client=fake_client) == 1
    assert not (tmp_path / "workload-ready").exists()


def test_workload_component_over_http(api_server, monkeypatch, tmp_path):
    srv, base = api_server
    srv.backend.create(_node())
    monkeypatch.setenv("KUBE_API_URL", base)
    monkeypatch.setenv("NODE_NAME", "n1")
    monkeypatch.setenv("VALIDATOR_IMAGE", "img:1")
    monkeypatch.setenv(consts.NAMESPACE_ENV, NS)
    timer = _finish_pods(lambda: srv.backend.list("v1", "Pod", NS),
                         srv.backend.update_status, "Succeeded")
    assert vmain.run(["-c", "workload", f"--status-dir={tmp_path}", "--timeout=5"]) == 0
    timer.join(5)
    assert ref_status.StatusFiles(str(tmp_path)).read("workload")["mode"] == "pod"


def test_gpu_validator_script_is_declared():
    import tomllib
    from pathlib import Path

    project = tomllib.loads((Path(__file__).resolve().parents[1] / "pyproject.toml")
                            .read_text())["project"]
    assert project["scripts"]["gpu-validator"] == "tpu_operator_torch.cmd.validator:main"
    assert workload.WORKLOAD_POD_TEMPLATE["spec"]["containers"][0]["command"] == \
        ["gpu-validator"]
