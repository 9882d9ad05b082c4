"""The port's native binaries (tpu_operator_torch/native/, built by
tpu_operator_torch/validator/native.py): ``gpu-probe`` beside the
reference's ``tpu-probe`` and the port's Python file checks, and
``gpu-exporter`` beside the port's Python exporter, whose text it must
write byte for byte, the refresh timestamp aside. Modelled on
tests/test_native_probe.py and tests/test_native_exporter.py; ``g++`` is
on this machine, so they build and run here.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from tpu_operator_torch import consts
from tpu_operator_torch.validator import driver, metrics, native
from tpu_operator_torch.validator import main as vmain
from tpu_operator_torch.validator.status import StatusFiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFRESH = "tpu_operator_node_metrics_last_refresh_ts_seconds "


@pytest.fixture(scope="module")
def binaries():
    native.build()
    return {name: str(native.binary_path(name)) for name in native.BINARIES}


@pytest.fixture(scope="module")
def ref_probe(tmp_path_factory):
    build = tmp_path_factory.mktemp("tpu-probe-build")
    subprocess.run(["make", "-C", os.path.join(REPO, "native", "tpu-probe"), f"BUILD={build}"],
                   check=True, capture_output=True, timeout=120)
    return str(build / "tpu-probe")


@pytest.fixture
def gpu_devs(tmp_path, monkeypatch):
    dev = tmp_path / "dev"
    dev.mkdir()
    for minor in (0, 3, 5, 6):
        (dev / f"nvidia{minor}").touch()
    (dev / "nvidiactl").touch()  # not a GPU: never counted
    monkeypatch.setenv(consts.GPU_DEV_GLOBS_ENV, str(dev / "nvidia[0-9]*"))
    return dev


def run(binary, *args):
    return subprocess.run([binary, *args], capture_output=True, text=True, timeout=30)


def elf(path, payload=b"\x7fELF" + b"\x00" * 32):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(payload)
    return path


# -- gpu-probe ----------------------------------------------------------------------

def test_probe_healthy_and_unhealthy(binaries, tmp_path, gpu_devs):
    install = tmp_path / "lib"
    install.mkdir()
    assert run(binaries["gpu-probe"], f"--install-dir={install}").returncode == 1
    elf(install / "libcuda.so.1", b"not an elf at all")
    assert run(binaries["gpu-probe"], f"--install-dir={install}").returncode == 1
    elf(install / "libcuda.so.580.159.03")
    (install / "libcuda.so.1").unlink()
    os.symlink("libcuda.so.580.159.03", install / "libcuda.so.1")
    assert run(binaries["gpu-probe"], "--install-dir", str(install)).returncode == 0


def test_probe_device_requirement(binaries, tmp_path, monkeypatch):
    install = tmp_path / "lib"
    elf(install / "libcuda.so.1")
    monkeypatch.setenv(consts.GPU_DEV_GLOBS_ENV, str(tmp_path / "nothing*"))
    assert run(binaries["gpu-probe"], f"--install-dir={install}").returncode == 1
    assert run(binaries["gpu-probe"], f"--install-dir={install}",
               "--no-require-devices").returncode == 0


def test_probe_json_and_device_listing(binaries, tmp_path, gpu_devs):
    install = tmp_path / "lib"
    elf(install / "libcuda.so.1")
    out = run(binaries["gpu-probe"], f"--install-dir={install}", "--json")
    report = json.loads(out.stdout)
    assert report == {"ok": True, "libtpu": {"path": str(install / "libcuda.so.1"), "ok": True},
                      "devices": [str(gpu_devs / f"nvidia{m}") for m in (0, 3, 5, 6)]}
    listing = run(binaries["gpu-probe"], "devices")
    assert listing.returncode == 0 and listing.stdout.split() == report["devices"]


@pytest.mark.parametrize("args", [["--bogus"], ["-h"]])
def test_probe_usage_error(binaries, args):
    assert run(binaries["gpu-probe"], *args).returncode == 2


@pytest.mark.parametrize("case", ["healthy", "no-library", "not-elf", "no-devices",
                                  "no-devices-not-required", "no-library-not-required"])
def test_probe_agrees_with_the_reference_probe_and_the_python_checks(
        binaries, ref_probe, tmp_path, monkeypatch, case):
    """The same node, once as a TPU host and once as a GPU node: the
    reference's tpu-probe and the port's gpu-probe exit alike and report
    the same JSON, and the port's Python file checks agree."""
    lib, tpu = tmp_path / "lib", tmp_path / "libtpu"
    lib.mkdir()
    tpu.mkdir()
    if case != "no-library" and case != "no-library-not-required":
        payload = b"garbage" if case == "not-elf" else b"\x7fELF" + b"\x00" * 8
        elf(lib / "libcuda.so.1", payload)
        elf(tpu / "libtpu.so", payload)
    dev = tmp_path / "dev"
    dev.mkdir()
    if not case.startswith("no-devices"):
        for i in range(2):
            (dev / f"nvidia{i}").touch()
            (dev / f"accel{i}").touch()
    monkeypatch.setenv(consts.GPU_DEV_GLOBS_ENV, str(dev / "nvidia*"))
    monkeypatch.setenv("TPU_DEV_GLOBS", str(dev / "accel*"))
    extra = ["--no-require-devices"] if case.endswith("not-required") else []
    port = run(binaries["gpu-probe"], f"--install-dir={lib}", "--json", *extra)
    ref = run(ref_probe, f"--install-dir={tpu}", "--json", *extra)
    assert port.returncode == ref.returncode
    p, r = json.loads(port.stdout), json.loads(ref.stdout)
    assert (p["ok"], p["libtpu"]["ok"], len(p["devices"])) == \
        (r["ok"], r["libtpu"]["ok"], len(r["devices"]))
    monkeypatch.setenv(consts.PROBE_BIN_ENV, binaries["gpu-probe"])
    assert driver.probe(str(lib), require_devices=not extra) is p["ok"]
    monkeypatch.setenv(consts.PROBE_BIN_ENV, "")
    monkeypatch.setattr(native, "find_native_binary", lambda *a, **k: None)
    assert driver.probe(str(lib), require_devices=not extra) is p["ok"]


def test_find_native_binary_order(binaries, tmp_path, monkeypatch):
    monkeypatch.setenv(consts.PROBE_BIN_ENV, binaries["gpu-probe"])
    assert driver.find_probe_binary() == binaries["gpu-probe"]
    on_path = tmp_path / "bin"
    on_path.mkdir()
    (on_path / "gpu-probe").write_text("#!/bin/sh\nexit 0\n")
    (on_path / "gpu-probe").chmod(0o755)
    monkeypatch.delenv(consts.PROBE_BIN_ENV)
    monkeypatch.setenv("PATH", f"{on_path}{os.pathsep}{os.environ['PATH']}")
    assert driver.find_probe_binary() == str(on_path / "gpu-probe")
    monkeypatch.setenv("PATH", "/nonexistent")
    assert driver.find_probe_binary() == binaries["gpu-probe"]  # the build dir


def test_without_a_compiler_nothing_is_built(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv(consts.PROBE_BIN_ENV, raising=False)
    assert native.find_native_binary("gpu-probe", consts.PROBE_BIN_ENV) is None
    with pytest.raises(RuntimeError, match="not found"):
        native.build()


def test_a_failed_build_raises(monkeypatch, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "gpu_probe.cc").write_text("int main( {")
    monkeypatch.setattr(native, "SOURCES", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed building gpu-probe"):
        native.build(["gpu-probe"])
    assert not list((tmp_path / "build").glob("gpu-probe-*"))


@pytest.fixture(params=["failing-compiler", "unwritable-build-dir"])
def unbuildable(request, tmp_path, monkeypatch):
    """A node where the finder's build cannot succeed: a ``g++`` that fails,
    or a build directory that cannot be made (its parent is a file). Returns
    the build directory the component must use."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    if request.param == "failing-compiler":
        (bin_dir / "g++").write_text("#!/bin/sh\necho 'g++: internal error' >&2\nexit 1\n")
        (bin_dir / "g++").chmod(0o755)
        build_dir = tmp_path / "build"
    else:
        os.symlink(shutil.which("g++"), bin_dir / "g++")
        (tmp_path / "a-file").write_text("")
        build_dir = tmp_path / "a-file" / "build"
    monkeypatch.setenv("PATH", str(bin_dir))
    for var in (consts.PROBE_BIN_ENV, consts.EXPORTER_BIN_ENV, consts.NATIVE_EXPORTER_ENV):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    return build_dir


def test_a_failed_build_leaves_driver_probe_on_the_file_checks(unbuildable, tmp_path,
                                                                gpu_devs):
    assert native.find_native_binary("gpu-probe", consts.PROBE_BIN_ENV) is None
    lib = tmp_path / "lib"
    elf(lib / "libcuda.so.1")
    st = str(tmp_path / "st")
    assert vmain.run(["-c", "driver-probe", f"--install-dir={lib}", f"--status-dir={st}"]) == 0
    assert vmain.run(["-c", "driver-probe", f"--install-dir={tmp_path / 'none'}",
                      f"--status-dir={st}"]) == 1


def test_a_failed_build_leaves_metrics_on_the_python_server(unbuildable, tmp_path, gpu_devs):
    """``-c metrics`` in its own process, with the finder's build directory
    set as above: the Python server answers (it has no ``/healthz``)."""
    d = tmp_path / "validations"
    StatusFiles(str(d)).write("driver", {})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = ("import pathlib, sys\n"
              "from tpu_operator_torch.validator import main, native\n"
              f"native.BUILD_DIR = pathlib.Path({str(unbuildable)!r})\n"
              f"sys.exit(main.run(['-c', 'metrics', '--port={port}', '--status-dir={d}']))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen([sys.executable, "-c", script], cwd=REPO, env=env,
                            stderr=subprocess.PIPE)
    try:
        served = None
        for _ in range(400):
            assert proc.poll() is None, proc.stderr.read().decode()
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                    served = r.read().decode()
                break
            except OSError:
                time.sleep(0.05)
        assert without_refresh(served) == without_refresh(python_text(str(d)))
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2)
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    assert b"not built" in proc.stderr.read()


def test_the_makefile_builds_both(tmp_path):
    subprocess.run(["make", "-C", str(native.SOURCES), f"BUILD={tmp_path}"], check=True,
                   capture_output=True, timeout=240)
    assert run(str(tmp_path / "gpu-probe"), "--bogus").returncode == 2
    assert run(str(tmp_path / "gpu-exporter"), "--bogus").returncode == 2


# -- gpu-exporter ----------------------------------------------------------------------

def python_text(status_dir):
    m = metrics.NodeMetrics(status=StatusFiles(status_dir))
    m.refresh()
    return m.scrape().decode()


def without_refresh(text):
    return [ln for ln in text.splitlines() if not ln.startswith(REFRESH)]


#: (workload barrier: a dict to write, a raw string, or None; perf barrier)
EXPORTER_CASES = {
    "empty": (None, None),
    "attributed": ({"passed": False, "n_devices": 4, "local_chips": [0, 1, 2, 3],
                    "failed_local_chips": [2],
                    "details": {"ring": {"passed": False, "failed_chips": [2]},
                                "compute": {"passed": True, "failed_chips": []}}},
                   {"mxu_tflops": 612.5, "hbm_gbps": 3012.123456789, "passed": True}),
    "unattributable": ({"passed": False, "details": {"error": "rendezvous timed out"}}, None),
    "partial-pass": ({"passed": True, "n_devices": 3, "local_chips": [0, 1, 2],
                      "failed_local_chips": []}, None),
    "full-pass": ({"passed": True, "n_devices": 4, "local_chips": [0, 1, 2, 3],
                   "failed_local_chips": []},
                  {"mxu_tflops": 700, "hbm_gbps": 2995.5, "ici_allreduce_gbps": 339.229}),
    "torn": ('{"passed": false, "truncated', None),
    "garbage-without-passed": ('{"n_devices": 4, "garbage', None),
    "not-an-object": ("[1, 2]", None),
    "legacy-details": ({"passed": False, "n_devices": 4,
                        "details": {"ring": {"passed": False, "failed_chips": [2]},
                                    "compute": {"passed": True, "failed_chips": []}}}, None),
    "legacy-multihost": ({"passed": False, "n_devices": 16, "local_chips": [4, 5, 6, 7],
                          "details": {"ring": {"passed": False, "failed_chips": [6]}}}, None),
    "legacy-empty-chips": ({"passed": False, "n_devices": 4,
                            "details": {"ring": {"passed": False, "failed_chips": []},
                                        "compute": {"passed": False, "failed_chips": [2]}}},
                           None),
    "modern-without-map": ({"passed": False, "failed_local_chips": [2]}, None),
    "legacy-check-without-chips": ({"passed": False, "n_devices": 4,
                                    "details": {"ring": {"passed": False, "failed_chips": [2]},
                                                "init": {"passed": False}}}, None),
    "string-and-float-ordinals": ({"passed": False, "n_devices": 4,
                                   "local_chips": [0, 1, 2.0, 3],
                                   "failed_local_chips": ["1", 3.7]}, None),
    "bool-n-devices": ({"passed": True, "n_devices": True}, None),
    "duplicate-keys": ('{"passed": false, "n_devices": 4, "details": {"a": {"passed": false, '
                       '"failed_chips": [9]}, "a": {"passed": false, "failed_chips": [1]}}}',
                       None),
    "zero-is-not-false": ({"passed": 0, "n_devices": 4}, {"mxu_tflops": True,
                                                          "hbm_gbps": "fast"}),
    "numbers-to-format": (None, {"mxu_tflops": 12345678.9, "hbm_gbps": 1e-05,
                                 "ici_allreduce_gbps": 1e16}),
    "more-numbers": (None, {"mxu_tflops": -0.0, "hbm_gbps": 1234567.0,
                            "ici_allreduce_gbps": 0.1 + 0.2}),
    "nan-and-escapes": ('{"passed": false, "n_devices": 4, "note": "\\u00e9\\ud83d\\ude00\\n", '
                        '"failed_local_chips": [0], "local_chips": [0, 1, 2, 3]}',
                        '{"mxu_tflops": NaN, "hbm_gbps": Infinity, "ici_allreduce_gbps": null}'),
}


@pytest.mark.parametrize("case", sorted(EXPORTER_CASES))
def test_exporter_oneshot_is_the_python_scrape(binaries, tmp_path, gpu_devs, case):
    workload, perf = EXPORTER_CASES[case]
    d = tmp_path / "validations"
    status = StatusFiles(str(d))
    status.write("driver", {"libtpu_version": "580.159.03"})
    for component, body in (("workload", workload), ("perf", perf)):
        if isinstance(body, dict):
            status.write(component, body)
        elif isinstance(body, str):
            (d / f"{component}-ready").write_text(body)
    native_text = run(binaries["gpu-exporter"], "--oneshot", f"--status-dir={d}").stdout
    assert without_refresh(native_text) == without_refresh(python_text(str(d)))
    assert sum(ln.startswith(REFRESH) for ln in native_text.splitlines()) == 1


def test_exporter_reads_status_dir_from_the_environment(binaries, tmp_path, gpu_devs):
    d = tmp_path / "validations"
    StatusFiles(str(d)).write("plugin", {"count": 4})
    out = subprocess.run([binaries["gpu-exporter"], "--oneshot"], capture_output=True,
                         text=True, timeout=30, env=dict(os.environ, STATUS_DIR=str(d))).stdout
    assert "tpu_operator_node_plugin_ready 1.0" in out.splitlines()


def test_exporter_over_http(binaries, tmp_path, gpu_devs):
    d = tmp_path / "validations"
    StatusFiles(str(d)).write("workload", {"passed": True, "n_devices": 4,
                                           "local_chips": [0, 1, 2, 3]})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([binaries["gpu-exporter"], f"--port={port}", f"--status-dir={d}"],
                            stderr=subprocess.PIPE)
    try:
        payload = None
        for _ in range(100):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                    assert r.headers["Content-Type"].startswith("text/plain")
                    payload = r.read().decode()
                break
            except OSError:
                time.sleep(0.05)
        assert payload is not None, "the exporter never served"
        assert without_refresh(payload) == without_refresh(python_text(str(d)))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
            assert r.read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/other", timeout=2)
        assert err.value.code == 404
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_find_exporter_binary_env_toggle(binaries, monkeypatch):
    monkeypatch.setenv(consts.EXPORTER_BIN_ENV, binaries["gpu-exporter"])
    assert metrics.find_exporter_binary() == binaries["gpu-exporter"]
    monkeypatch.setenv(consts.NATIVE_EXPORTER_ENV, "0")
    assert metrics.find_exporter_binary() is None


def test_metrics_component_execs_the_native_exporter(binaries, tmp_path, gpu_devs):
    """``-c metrics`` replaces its process with gpu-exporter: the process
    that answers is the binary, and it serves what Python would."""
    d = tmp_path / "validations"
    StatusFiles(str(d)).write("driver", {})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, **{consts.EXPORTER_BIN_ENV: binaries["gpu-exporter"]})
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen([sys.executable, "-m", "tpu_operator_torch.cmd.validator",
                             "-c", "metrics", f"--port={port}", f"--status-dir={d}"],
                            cwd=REPO, env=env, stderr=subprocess.PIPE)
    try:
        payload = None
        for _ in range(200):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    payload = r.read()
                break
            except OSError:
                time.sleep(0.05)
        assert payload == b"ok\n"  # only the native exporter serves /healthz
        with open(f"/proc/{proc.pid}/cmdline", "rb") as f:
            assert f.read().split(b"\0")[0] == binaries["gpu-exporter"].encode()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_exec_failure_falls_back_to_python(tmp_path, monkeypatch):
    bogus = tmp_path / "gpu-exporter"
    bogus.write_bytes(b"\x00not-an-elf\x00")
    bogus.chmod(0o755)
    monkeypatch.setenv(consts.EXPORTER_BIN_ENV, str(bogus))
    monkeypatch.delenv(consts.NATIVE_EXPORTER_ENV, raising=False)
    metrics._exec_native_exporter(port=0)  # execv raises ENOEXEC; it returns
