"""The PyTorch port's validator CLI (tpu_operator_torch/validator/main.py):
the node path's components on the CPU, with barriers that the JAX package's
readers (tpu_operator/validator/status.py, feature_discovery) parse."""

import json

import pytest
import torch

from tpu_operator.client import FakeClient
from tpu_operator.testing import MiniApiServer
from tpu_operator.validator import driver as ref_driver
from tpu_operator.validator import feature_discovery
from tpu_operator.validator import status as ref_status
from tpu_operator_torch.validator import main as vmain
from tpu_operator_torch.validator import perf


@pytest.fixture
def status_dir(tmp_path):
    return tmp_path / "validations"


@pytest.fixture
def gpu_devs(tmp_path, monkeypatch):
    devdir = tmp_path / "dev"
    devdir.mkdir()
    for i in range(4):
        (devdir / f"nvidia{i}").touch()
    (devdir / "nvidiactl").touch()  # not a per-GPU node: never counted
    monkeypatch.setenv("GPU_DEV_GLOBS", str(devdir / "nvidia[0-9]*"))
    return devdir


def _driver_lib(tmp_path, name="libcuda.so.1"):
    install = tmp_path / "lib"
    install.mkdir(exist_ok=True)
    (install / name).write_bytes(b"\x7fELF fake")
    return install


def _node(resource_count=None):
    node = {"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n1"},
            "status": {"capacity": {}, "allocatable": {}}}
    if resource_count is not None:
        node["status"]["allocatable"]["nvidia.com/gpu"] = resource_count
    return node


def test_driver_barrier_matches_reference_keys(tmp_path, status_dir, gpu_devs):
    install = _driver_lib(tmp_path)
    rc = vmain.run(["-c", "driver", f"--install-dir={install}",
                    f"--status-dir={status_dir}"])
    assert rc == 0
    ref = ref_status.StatusFiles(str(status_dir))
    assert ref.is_ready("driver")
    port_barrier = ref.read("driver")
    assert port_barrier["libtpu"] == str(install / "libcuda.so.1")
    assert [p.rsplit("/", 1)[1] for p in port_barrier["devices"]] == \
        [f"nvidia{i}" for i in range(4)]

    ref_root = tmp_path / "ref"
    ref_root.mkdir()
    ref_install = _driver_lib(ref_root, "libtpu.so")
    ref_dir = tmp_path / "ref-validations"
    assert ref_driver.validate(str(ref_install), ref_status.StatusFiles(str(ref_dir)),
                               require_devices=False)
    assert set(ref_status.StatusFiles(str(ref_dir)).read("driver")) == set(port_barrier)


def test_driver_fails_without_library_or_devices(tmp_path, status_dir, monkeypatch):
    monkeypatch.setenv("GPU_DEV_GLOBS", str(tmp_path / "none*"))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert vmain.run(["-c", "driver", f"--install-dir={empty}",
                      f"--status-dir={status_dir}"]) == 1
    install = _driver_lib(tmp_path)
    assert vmain.run(["-c", "driver", f"--install-dir={install}",
                      f"--status-dir={status_dir}"]) == 1
    assert not (status_dir / "driver-ready").exists()
    assert vmain.run(["-c", "driver", f"--install-dir={install}",
                      f"--status-dir={status_dir}", "--no-require-devices"]) == 0


def test_driver_adopts_host_install(tmp_path, status_dir, gpu_devs, monkeypatch):
    lib = _driver_lib(tmp_path) / "libcuda.so.1"
    monkeypatch.setenv("GPU_USE_HOST_DRIVER", "1")
    monkeypatch.setenv("GPU_HOST_DRIVER_PATHS", f"/nonexistent/libcuda.so.1:{lib}")
    assert vmain.run(["-c", "driver", f"--status-dir={status_dir}"]) == 0
    record = ref_status.StatusFiles(str(status_dir)).read("driver")
    assert record["source"] == "host" and record["libtpu"] == str(lib)


def test_plugin_waits_for_gpu_resource(status_dir, monkeypatch):
    client = FakeClient()
    client.create(_node("4"))
    monkeypatch.setenv("NODE_NAME", "n1")
    assert vmain.run(["-c", "plugin", f"--status-dir={status_dir}"], client=client) == 0
    record = ref_status.StatusFiles(str(status_dir)).read("plugin")
    assert record["resource"] == "nvidia.com/gpu" and record["count"] == 4


def test_plugin_times_out_without_resource(status_dir, monkeypatch):
    client = FakeClient()
    client.create(_node())
    monkeypatch.setenv("NODE_NAME", "n1")
    assert vmain.run(["-c", "plugin", f"--status-dir={status_dir}", "--timeout=0.2",
                      "--poll=0.05"], client=client) == 1
    assert not (status_dir / "plugin-ready").exists()


def test_plugin_reads_node_over_http(status_dir, monkeypatch):
    srv = MiniApiServer()
    base = srv.start()
    try:
        srv.backend.create(_node("8"))
        monkeypatch.setenv("KUBE_API_URL", base)
        monkeypatch.setenv("NODE_NAME", "n1")
        assert vmain.run(["-c", "plugin", f"--status-dir={status_dir}",
                          "--timeout=5"]) == 0
    finally:
        srv.stop()
    assert ref_status.StatusFiles(str(status_dir)).read("plugin")["count"] == 8


def test_workload_local_barrier_reads_through_reference(status_dir, capsys, monkeypatch,
                                                        tmp_path):
    rc = vmain.run(["-c", "workload-local", "--matrix-dim=64", "--device=cpu",
                    f"--status-dir={status_dir}"])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["passed"] and printed["platform"] == "cpu"
    ref = ref_status.StatusFiles(str(status_dir))
    assert ref.is_ready("workload")
    info = ref.read("workload")
    assert ref_status.failed_local_chips(info, 1) == frozenset()
    assert ref_status.partial_sweep(info, 1) is False
    devdir = tmp_path / "dev"
    devdir.mkdir()
    (devdir / "accel0").touch()
    monkeypatch.setenv("TPU_DEV_GLOBS", str(devdir / "accel*"))
    monkeypatch.setenv("STATUS_DIR", str(status_dir))
    assert feature_discovery.workload_health_verdict() == "passed"


def test_wait_component(status_dir):
    assert vmain.run(["-c", "wait", "--for=driver", "--timeout=0.1",
                      f"--status-dir={status_dir}"]) == 1
    ref_status.StatusFiles(str(status_dir)).write("driver", {"libtpu": "x"})
    assert vmain.run(["-c", "wait", "--for=driver", "--timeout=0.1",
                      f"--status-dir={status_dir}"]) == 0


def _patch_measures(monkeypatch):
    monkeypatch.setattr(perf, "measure_mxu_tflops", lambda *a, **k: (700.0, True, 1.0))
    monkeypatch.setattr(perf, "measure_hbm_gbps", lambda *a, **k: (2516.0, True))
    monkeypatch.setattr(perf, "measure_ici_allreduce_gbps", lambda *a, **k: (None, True))
    monkeypatch.setattr(perf, "measure_hbm_kernel_gbps", lambda *a, **k: (2790.0, True))
    monkeypatch.setattr(perf, "lookup_peaks", lambda kind: ("h100-sxm5", 989.0, 3350.0))


def test_perf_component_writes_barrier_on_pass(status_dir, monkeypatch):
    _patch_measures(monkeypatch)
    assert vmain.run(["-c", "perf", "--device=cpu", f"--status-dir={status_dir}"]) == 0
    record = ref_status.StatusFiles(str(status_dir)).read("perf")
    assert record["hbm_pallas_gbps"] == 2790.0 and record["ici_skipped"]


def test_perf_component_floor_fails_without_barrier(status_dir, monkeypatch):
    _patch_measures(monkeypatch)
    assert vmain.run(["-c", "perf", "--device=cpu", "--min-mxu-tflops=900",
                      f"--status-dir={status_dir}"]) == 1
    assert not (status_dir / "perf-ready").exists()


def test_multihost_needs_coordinator(status_dir, monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert vmain.run(["-c", "workload-multihost", "--device=cpu",
                      f"--status-dir={status_dir}"]) == 1


def test_parser_defaults_from_torch_distributed_env(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.1.2.3")
    monkeypatch.setenv("MASTER_PORT", "29501")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    args = vmain.build_parser().parse_args(["-c", "workload-multihost"])
    assert args.coordinator == "10.1.2.3:29501"
    assert (args.num_processes, args.process_id) == (4, 3)
    assert args.device == "cuda" and args.resource == "nvidia.com/gpu"


def test_workload_local_defaults_to_cuda(status_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs the sweep")
    with pytest.raises(RuntimeError, match="CUDA"):
        vmain.run(["-c", "workload-local", f"--status-dir={status_dir}"])
    assert not (status_dir / "workload-ready").exists()


def test_the_cli_offers_every_component_the_reference_offers():
    from tpu_operator.validator import main as ref_main

    def components(parser):
        (action,) = [a for a in parser._actions if a.dest == "component"]
        return sorted(action.choices)

    assert components(vmain.build_parser()) == components(ref_main.build_parser())
