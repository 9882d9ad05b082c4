"""The driver installer of the PyTorch port (``install``, ``daemon`` and
the ``driver-daemon`` / ``driver-probe`` components in
tpu_operator_torch/validator/driver.py and main.py) against the
reference's (tpu_operator/validator/driver.py): the same barrier keys and
heartbeats, an atomic install of the bundled driver libraries, and the
driver version from the flag, the environment or NVML.
"""

import os

import pytest

from tpu_operator.validator import driver as ref_driver
from tpu_operator.validator.status import StatusFiles as RefStatusFiles
from tpu_operator_torch import consts, nvml
from tpu_operator_torch.testing import fake_nvml
from tpu_operator_torch.validator import driver, native
from tpu_operator_torch.validator import main as vmain
from tpu_operator_torch.validator.status import StatusFiles

ELF = b"\x7fELF" + bytes(range(64))


@pytest.fixture
def bundle(tmp_path, monkeypatch):
    """An operand image's driver bundle: libcuda.so.1 a symlink to the
    versioned file, as the driver packages ship it."""
    src = tmp_path / "bundle"
    src.mkdir()
    (src / "libcuda.so.580.159.03").write_bytes(ELF + b"cuda")
    os.symlink("libcuda.so.580.159.03", src / "libcuda.so.1")
    (src / "libnvidia-ml.so.1").write_bytes(ELF + b"nvml")
    monkeypatch.setenv(consts.DRIVER_SRC_ENV, str(src))
    monkeypatch.delenv(consts.DRIVER_VERSION_ENV, raising=False)
    dev = tmp_path / "dev"
    dev.mkdir()
    (dev / "nvidia0").touch()
    monkeypatch.setenv(consts.GPU_DEV_GLOBS_ENV, str(dev / "nvidia[0-9]*"))
    monkeypatch.setattr(nvml, "_loaded", {"lib": fake_nvml.FakeNvml(
        fake_nvml.random_gpus(1, 0), driver_version="580.159.03")})
    return src


def test_install_copies_the_bundle_through_temporary_files(bundle, tmp_path, monkeypatch):
    target = tmp_path / "host-lib"
    replaced = []
    real_replace = os.replace

    def spy(src, dst):
        replaced.append((os.path.basename(src), os.path.basename(dst)))
        return real_replace(src, dst)

    monkeypatch.setattr(driver.os, "replace", spy)
    status = StatusFiles(str(tmp_path / "st"))
    assert driver.install(str(target), status=status)
    assert ("libcuda.so.1.tmp", "libcuda.so.1") in replaced
    assert ("libnvidia-ml.so.1.tmp", "libnvidia-ml.so.1") in replaced
    for name, tail in (("libcuda.so.1", b"cuda"), ("libnvidia-ml.so.1", b"nvml")):
        path = target / name
        assert path.is_file() and not path.is_symlink()
        assert path.read_bytes() == ELF + tail
    assert sorted(os.listdir(target)) == ["libcuda.so.1", "libnvidia-ml.so.1"]
    assert driver.is_valid_driver_lib(str(target / "libcuda.so.1"))


def test_the_barrier_has_the_reference_keys(bundle, tmp_path, monkeypatch):
    (bundle / "libtpu.so").write_bytes(ELF)
    monkeypatch.setenv("LIBTPU_SRC", str(bundle / "libtpu.so"))
    ref_status = RefStatusFiles(str(tmp_path / "ref"))
    assert ref_driver.install(str(tmp_path / "ref-lib"), "2025.1.0", ref_status)
    status = StatusFiles(str(tmp_path / "port"))
    assert driver.install(str(tmp_path / "port-lib"), "580.159.03", status)
    ref, port = ref_status.read("driver"), status.read("driver")
    assert set(port) == set(ref)
    assert port["libtpu"] == str(tmp_path / "port-lib" / "libcuda.so.1")
    assert port["libtpu_version"] == "580.159.03"
    assert port["devices"] == [os.environ[consts.GPU_DEV_GLOBS_ENV].replace("[0-9]*", "0")]
    # driver validation keeps the recorded version, as the reference's does
    assert driver.validate(str(tmp_path / "port-lib"), status)
    assert status.read("driver")["libtpu_version"] == "580.159.03"


@pytest.mark.parametrize("flag, env, nvml_ok, expected", [
    ("570.1", "560.2", True, "570.1"),
    (None, "560.2", True, "560.2"),
    (None, None, True, "580.159.03"),
    (None, None, False, "unknown"),
])
def test_the_version_from_the_flag_the_environment_or_nvml(bundle, tmp_path, monkeypatch,
                                                           flag, env, nvml_ok, expected):
    if env:
        monkeypatch.setenv(consts.DRIVER_VERSION_ENV, env)
    if not nvml_ok:
        nvml._loaded["lib"].fail["nvmlSystemGetDriverVersion"] = nvml.NOT_SUPPORTED
    status = StatusFiles(str(tmp_path / "st"))
    assert driver.install(str(tmp_path / "lib"), flag, status)
    assert status.read("driver")["libtpu_version"] == expected


def test_without_a_bundle_a_preinstalled_driver_is_kept(bundle, tmp_path, monkeypatch):
    monkeypatch.delenv(consts.DRIVER_SRC_ENV)
    status = StatusFiles(str(tmp_path / "st"))
    assert not driver.install(str(tmp_path / "empty"), status=status)
    assert status.read("driver") is None
    pre = tmp_path / "pre"
    pre.mkdir()
    (pre / "libcuda.so.1").write_bytes(ELF)
    assert driver.install(str(pre), status=status)
    assert (pre / "libcuda.so.1").read_bytes() == ELF
    assert status.read("driver")["libtpu"] == str(pre / "libcuda.so.1")


def test_an_install_into_the_bundle_itself_copies_nothing(bundle, tmp_path):
    before = sorted(os.listdir(bundle))
    assert driver.install(str(bundle), status=StatusFiles(str(tmp_path / "st")))
    assert sorted(os.listdir(bundle)) == before


def _beats(monkeypatch, module):
    sleeps = []
    monkeypatch.setattr(module.time, "sleep", sleeps.append)
    return sleeps


def test_the_daemon_heartbeats_as_the_reference_does(bundle, tmp_path, monkeypatch):
    (bundle / "libtpu.so").write_bytes(ELF)
    monkeypatch.setenv("LIBTPU_SRC", str(bundle / "libtpu.so"))
    port_sleeps = _beats(monkeypatch, driver)
    status = StatusFiles(str(tmp_path / "port"))
    assert driver.daemon(str(tmp_path / "lib"), status=status, heartbeat_interval=0.5,
                         max_beats=2) == 0
    ref_sleeps = _beats(monkeypatch, ref_driver)
    ref_status = RefStatusFiles(str(tmp_path / "ref"))
    assert ref_driver.daemon(str(tmp_path / "ref-lib"), status=ref_status,
                             heartbeat_interval=0.5, max_beats=2) == 0
    assert port_sleeps == ref_sleeps == [0.5, 0.5]
    beat = status.read("driver-heartbeat")
    ref_beat = ref_status.read("driver-heartbeat")
    assert beat["beat"] == ref_beat["beat"] == 1 and set(beat) == set(ref_beat)
    assert status.is_ready("driver")


def test_a_failed_install_is_a_failed_daemon(bundle, tmp_path, monkeypatch):
    monkeypatch.delenv(consts.DRIVER_SRC_ENV)
    _beats(monkeypatch, driver)
    status = StatusFiles(str(tmp_path / "st"))
    assert driver.daemon(str(tmp_path / "empty"), status=status, max_beats=1) == 1
    assert status.read("driver-heartbeat") is None


def test_the_daemon_writes_the_cdi_spec_when_enabled(bundle, tmp_path, monkeypatch):
    _beats(monkeypatch, driver)
    monkeypatch.setenv(consts.CDI_ENABLED_ENV, "1")
    monkeypatch.setenv(consts.CDI_DIR_ENV, str(tmp_path / "cdi"))
    assert driver.daemon(str(tmp_path / "lib"), status=StatusFiles(str(tmp_path / "st")),
                         max_beats=0) == 0
    assert os.listdir(tmp_path / "cdi")


def test_the_components(bundle, tmp_path, monkeypatch):
    """``-c driver-daemon`` installs and heartbeats until stopped;
    ``-c driver-probe`` answers on that install and on an empty one."""
    class Stop(Exception):
        pass

    beats = []

    def sleep(_):
        if len(beats) == 2:
            raise Stop
        beats.append(1)

    real_sleep = driver.time.sleep
    monkeypatch.setattr(driver.time, "sleep", sleep)
    lib, st = tmp_path / "lib", tmp_path / "st"
    with pytest.raises(Stop):
        vmain.run(["-c", "driver-daemon", f"--install-dir={lib}", "--driver-version=570.9",
                   f"--status-dir={st}"])
    # the patch is the global time.sleep, which subprocess's wait for the
    # native probe also calls when the probe has not exited yet
    monkeypatch.setattr(driver.time, "sleep", real_sleep)
    status = StatusFiles(str(st))
    assert status.read("driver")["libtpu_version"] == "570.9"
    assert status.read("driver-heartbeat")["beat"] == 1
    native.build(["gpu-probe"])
    # the Python file checks, then the native probe
    for binary in (None, str(native.binary_path("gpu-probe"))):
        monkeypatch.setattr(driver, "find_probe_binary", lambda b=binary: b)
        assert vmain.run(["-c", "driver-probe", f"--install-dir={lib}",
                          f"--status-dir={st}"]) == 0
        assert vmain.run(["-c", "driver-probe", f"--install-dir={tmp_path / 'none'}",
                          f"--status-dir={st}"]) == 1
        assert vmain.run(["-c", "driver-probe", f"--install-dir={tmp_path / 'none'}",
                          "--no-require-devices", f"--status-dir={st}"]) == 1
