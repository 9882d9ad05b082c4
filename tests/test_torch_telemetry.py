"""The port's telemetry exporter against the reference's, and its NVML
source, on the CPU with a fake NVML.

The same runtime-endpoint text (the reference tests' ``RUNTIME_TEXT``),
records and config go to both exporters: the text must be the same line
for line, HELP/TYPE and samples, but for the ``_created`` timestamps of
counters. The port writes the text format itself (no
``prometheus_client``) and reads its config through its own YAML subset
(no ``yaml``); that reader is held against ``yaml.safe_load``.

The twin of tests/test_telemetry.py.
"""

import dataclasses
import json
import logging
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from test_telemetry import RUNTIME_TEXT, serve_text
from tpu_operator.partitioner.partitioner import write_handoff
from tpu_operator.validator import telemetry as ref
from tpu_operator_torch import consts, yamlsubset
from tpu_operator_torch.testing.fake_nvml import GIB, FakeNvml, random_gpus
from tpu_operator_torch.validator import telemetry as port

SEED = 20261017
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _without_created(text: str) -> list:
    return [ln for ln in text.splitlines() if "_created" not in ln]


def _exporters(url, handoff_dir, config=None):
    ref_config = ref.MetricsConfig(**config) if config else None
    port_config = port.MetricsConfig(**config) if config else None
    return (ref.TelemetryMetrics(config=ref_config, sources=[
                ref.RuntimeEndpointSource(url, timeout=1.0), ref.RecordsSource(handoff_dir)]),
            port.TelemetryMetrics(config=port_config, sources=[
                port.RuntimeEndpointSource(url, timeout=1.0), port.RecordsSource(handoff_dir)]))


CONFIGS = {
    "defaults": None,
    "rename-exclude-labels": {"rename": {"weird_vendor_name": "tpu_duty_cycle_percent"},
                              "exclude": ["tpu_runtime_uptime_seconds"],
                              "labels": {"pool": "h100-8", "zone": "a"}},
    "no-derived-families": {"exclude": ["tpu_chip_up", "tpu_chips_total"]},
    "include": {"include": ["tpu_hbm_used_bytes", "tpu_chip_up"]},
}


@pytest.mark.parametrize("partition", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_exposition_matches_reference(tmp_path, config, partition):
    if partition:
        write_handoff([{"topology": "1x2", "chips": [0, 1]}, {"topology": "2x2",
                                                             "chips": [2, 3, 4, 5]}],
                      "split", str(tmp_path))
    srv, url = serve_text(RUNTIME_TEXT + 'weird_vendor_name{chip="3"} 55\n')
    try:
        ref_m, port_m = _exporters(url, str(tmp_path), CONFIGS[config])
        for m in (ref_m, port_m):
            m.refresh()
        texts = [m.scrape().decode() for m in (ref_m, port_m)]
    finally:
        srv.shutdown()
    assert _without_created(texts[1]) == _without_created(texts[0])
    assert 'tpu_exporter_source_up{source="runtime_endpoint"} 1.0' in texts[1]


def test_a_source_that_dies_matches_reference(tmp_path):
    """Its samples stop, its up gauge reads 0, its error counter counts."""
    srv, url = serve_text(RUNTIME_TEXT)
    ref_m, port_m = _exporters(url, str(tmp_path))
    for m in (ref_m, port_m):
        m.refresh()
    srv.shutdown()
    texts = []
    for m in (ref_m, port_m):
        m.sources[0].url = "http://127.0.0.1:1/metrics"
        m.sources[0].timeout = 0.2
        m.refresh()
        m.refresh()
        texts.append(m.scrape().decode())
    assert _without_created(texts[1]) == _without_created(texts[0])
    assert 'tpu_exporter_scrape_errors_total{source="runtime_endpoint"} 2.0' in texts[1]
    assert "tpu_hbm_used_bytes" not in texts[1]
    created = [ln for ln in texts[1].splitlines() if ln.startswith("tpu_exporter_scrape_errors_c")]
    assert len(created) == 1 and abs(float(created[0].split()[-1]) - time.time()) < 60


def test_families_are_the_reference_families():
    assert port.FAMILIES == ref.FAMILIES
    assert port.parse_prometheus(RUNTIME_TEXT) == ref.parse_prometheus(RUNTIME_TEXT)


def test_sysfs_and_records_sources_match_reference(tmp_path, monkeypatch):
    hw = tmp_path / "class" / "hwmon" / "hwmon3"
    hw.mkdir(parents=True)
    (hw / "name").write_text("tpu_board\n")
    (hw / "temp1_input").write_text("45500\n")
    (hw / "power1_input").write_text("92000000\n")
    dev = tmp_path / "dev"
    dev.mkdir()
    for i in range(3):
        (dev / f"accel{i}").touch()
        (dev / f"nvidia{i}").touch()
    monkeypatch.setenv("TPU_DEV_GLOBS", str(dev / "accel*"))
    monkeypatch.setenv(consts.GPU_DEV_GLOBS_ENV, str(dev / "nvidia[0-9]*"))
    assert port.SysfsSource(str(tmp_path)).collect() == ref.SysfsSource(str(tmp_path)).collect()
    write_handoff([{"topology": "2x2x2", "chips": list(range(8))}], "cube", str(tmp_path))
    assert port.RecordsSource(str(tmp_path)).collect() == \
        ref.RecordsSource(str(tmp_path)).collect()


# -- the NVML source ----------------------------------------------------------------

def _samples(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def test_nvml_source_scales_units_and_drops_a_lost_gpu():
    fake = FakeNvml(random_gpus(4, SEED))
    metrics = port.TelemetryMetrics(sources=[port.NvmlSource(fake)])
    metrics.refresh()
    got = _samples(metrics.scrape().decode())
    pci = sorted(fake.gpus, key=lambda g: g.pci_bus_id)
    for i, g in enumerate(pci):
        chip = f'{{chip="{i}"}}'
        assert got["tpu_hbm_used_bytes" + chip] == g.memory_used
        assert got["tpu_hbm_total_bytes" + chip] == g.memory_total == 80 * GIB
        assert got["tpu_duty_cycle_percent" + chip] == g.gpu_util
        assert got["tpu_membw_utilization_percent" + chip] == g.memory_util
        assert got[f'tpu_power_watts{{sensor="nvml/gpu{i}"}}'] == g.power_mw / 1000
        assert got[f'tpu_temperature_celsius{{sensor="nvml/gpu{i}"}}'] == g.temperature_c
        assert got["tpu_chip_up" + chip] == 1.0
    assert got["tpu_chips_total"] == 4.0
    assert got['tpu_exporter_source_up{source="nvml"}'] == 1.0
    fake.gpus.remove(pci[3])  # a GPU falls off the bus: its series stop
    metrics.refresh()
    got = _samples(metrics.scrape().decode())
    assert not [k for k in got if 'chip="3"' in k or "gpu3" in k]
    assert got["tpu_chips_total"] == 3.0
    fake.fail["nvmlInit_v2"] = 9  # the driver goes: no stale GPU numbers
    metrics.refresh()
    got = _samples(metrics.scrape().decode())
    assert not [k for k in got if k.startswith(("tpu_hbm", "tpu_chip", "tpu_power"))]
    assert got['tpu_exporter_source_up{source="nvml"}'] == 0.0
    assert got['tpu_exporter_scrape_errors_total{source="nvml"}'] == 1.0
    assert fake.open_sessions == 0


def test_dcgm_fields_are_scaled_to_the_families_units():
    """dcgm-exporter's tensor-pipe activity is a ratio in 0-1 and its
    framebuffer use is MiB; the families are percent and bytes."""
    text = ('DCGM_FI_PROF_PIPE_TENSOR_ACTIVE{gpu="0",UUID="GPU-a",device="nvidia3",'
            'modelName="NVIDIA H100 80GB HBM3",Hostname="n"} 0.62\n'
            'DCGM_FI_DEV_FB_USED{gpu="0",UUID="GPU-a",device="nvidia3"} 1024\n')
    srv, url = serve_text(text)
    try:
        metrics = port.TelemetryMetrics(sources=[port.RuntimeEndpointSource(url)])
        metrics.refresh()
        got = _samples(metrics.scrape().decode())
    finally:
        srv.shutdown()
    assert got['tpu_tensorcore_utilization_percent{chip="0"}'] == 62.0
    assert got['tpu_hbm_used_bytes{chip="0"}'] == 1024 * 2 ** 20


def test_runtime_endpoint_only_when_configured_and_never_itself(monkeypatch):
    monkeypatch.delenv(consts.RUNTIME_METRICS_URL_ENV, raising=False)
    fake = FakeNvml(random_gpus(2, SEED))
    assert [s.name for s in port.TelemetryMetrics(nvml_lib=fake).sources] == [
        "nvml", "sysfs", "records"]
    for url in ("http://localhost:9400/metrics", "http://127.0.0.1:9400/metrics",
                f"http://{socket.gethostname()}:9400/metrics"):
        source = port.RuntimeEndpointSource(url, own_port=9400)
        assert source.scrapes_itself()
        with pytest.raises(ValueError, match="own port"):
            source.collect()
    assert not port.RuntimeEndpointSource("http://localhost:9401/metrics",
                                          own_port=9400).scrapes_itself()
    monkeypatch.setenv(consts.RUNTIME_METRICS_URL_ENV, "http://localhost:9400/metrics")
    metrics = port.TelemetryMetrics(nvml_lib=fake, listen_port=9400)
    metrics.refresh()
    got = _samples(metrics.scrape().decode())
    assert got['tpu_exporter_source_up{source="runtime_endpoint"}'] == 0.0
    assert got['tpu_exporter_scrape_errors_total{source="runtime_endpoint"}'] == 1.0
    assert got['tpu_exporter_source_up{source="nvml"}'] == 1.0


# -- the metrics config: JSON, else the YAML subset ------------------------------------

REFERENCE_CONFIGS = [
    # the reference tests' configs
    json.dumps({"rename": {"weird_vendor_name": "tpu_duty_cycle_percent"},
                "exclude": ["tpu_runtime_uptime_seconds"], "labels": {"pool": "v5e-16"}}),
    "- tpu_hbm_used_bytes\n- tpu_chip_up\n",
    "healthIntervalS: 3\nabsenceGraceS: 120\n",
    # the documented keys, as a ConfigMap holds them
    "# custom metrics\nrename:\n  DCGM_FI_DEV_GPU_TEMP: tpu_temperature_celsius\n"
    "include: []\nexclude:\n- tpu_runtime_uptime_seconds\n- tpu_ici_link_up\n"
    "labels:\n  pool: h100-8   # node pool\n  tier: 'yes'\n"
    "runtime_url: http://localhost:9401/metrics\n",
    "---\nlabels: {}\nrename:\n  'a b': \"c\"\n",
    # one-line flow lists, which PyYAML reads too
    "exclude: [tpu_runtime_uptime_seconds, tpu_ici_link_up]  # noisy\ninclude: []\n",
    "include: ['tpu_chip_up', \"tpu_hbm_used_bytes\"]\nlabels:\n  pool: [a, b]\n",
]


def _fields(config):
    return (config.rename, config.include, config.exclude, config.labels, config.runtime_url)


@pytest.mark.parametrize("text", REFERENCE_CONFIGS)
def test_config_loads_as_the_reference_loads_it(tmp_path, text):
    path = tmp_path / "config.yaml"
    path.write_text(text)
    mine, theirs = port.MetricsConfig.load(str(path)), ref.MetricsConfig.load(str(path))
    theirs.rename.update({k: v for k, v in port.DEFAULT_RENAME.items()
                          if k not in ref.DEFAULT_RENAME})  # the dcgm-exporter names
    assert _fields(mine) == _fields(theirs)
    assert yamlsubset.parse(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["{rename: {a: b}}", "labels: &x\n  a: 1\nl2: *x\n",
                                  "labels:\n  a: !!str 1\n", "runtime_url: |\n  http://x\n",
                                  "labels:\n\ta: 1\n", "labels:\n  a: 0x1F\n"])
def test_config_outside_the_subset_gives_defaults_with_an_error(tmp_path, caplog, text):
    path = tmp_path / "config.yaml"
    path.write_text(text)
    with caplog.at_level(logging.ERROR):
        config = port.MetricsConfig.load(str(path))
    assert _fields(config) == _fields(port.MetricsConfig())
    assert "unparseable" in caplog.text
    with pytest.raises(yamlsubset.SubsetError):
        yamlsubset.parse(text)


_KEYS = st.text(st.sampled_from("abcxyzAZ_-09./"), min_size=1, max_size=8)
_SAFE_TEXT = st.text(st.sampled_from("abcxyz ABZ019_-./:#'\""), max_size=12)
_SCALARS = (st.integers(-10 ** 6, 10 ** 6) | st.booleans() | st.none()
            | st.floats(allow_nan=False, allow_infinity=False, width=32) | _SAFE_TEXT)
_DOCS = st.recursive(_SCALARS, lambda inner: st.lists(inner, max_size=4)
                     | st.dictionaries(_KEYS, inner, max_size=4), max_leaves=12)


@settings(max_examples=150, deadline=None)
@given(doc=st.dictionaries(_KEYS, _DOCS, max_size=5))
def test_the_subset_reads_what_pyyaml_reads(doc):
    """Block-style YAML as PyYAML writes it: the subset reads it to what
    ``yaml.safe_load`` reads, or refuses it (never a different value)."""
    for indent in (2, 4):
        text = yaml.safe_dump(doc, default_flow_style=False, indent=indent, sort_keys=False)
        try:
            value = yamlsubset.parse(text)
        except yamlsubset.SubsetError:
            continue
        assert value == yaml.safe_load(text) == doc


@settings(max_examples=100, deadline=None)
@given(doc=st.dictionaries(st.text(st.sampled_from("abcxyz_"), min_size=1, max_size=6),
                           st.integers(-999, 999) | st.booleans() | st.none()
                           | st.text(st.sampled_from("abcxyz_."), min_size=1, max_size=6)
                           | st.lists(st.text(st.sampled_from("abcxyz_"), min_size=1,
                                              max_size=6), max_size=3),
                           max_size=6))
def test_the_subset_reads_every_flat_config(doc):
    """What the configs use (flat scalars, lists of names, one level of
    mapping) always parses, to PyYAML's value."""
    text = yaml.safe_dump({"labels": doc, "exclude": sorted(doc)}, default_flow_style=False)
    assert yamlsubset.parse(text) == yaml.safe_load(text)


# -- out of band, and the CLI ---------------------------------------------------------

def _fake_script(gpus):
    return ("from tpu_operator_torch.testing import fake_nvml as f\n"
            f"fake = f.FakeNvml([f.FakeGpu(**g) for g in {gpus!r}])\n"
            "f.install(fake)\n")


def test_the_daemons_never_import_torch_or_jax(tmp_path):
    """THE out-of-band guarantee, the GPU form of the reference's "never
    imports jax": the plugin's inventory, a telemetry refresh and a CDI
    spec, in one fresh process, import neither torch nor jax (and so open
    no CUDA context)."""
    gpus = [dataclasses.asdict(g) for g in random_gpus(2, SEED)]
    script = _fake_script(gpus) + (
        "import json, sys\n"
        "from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin\n"
        "from tpu_operator_torch.validator import cdi, telemetry\n"
        f"p = GPUDevicePlugin(plugin_dir={str(tmp_path / 'k')!r}, "
        f"status_dir={str(tmp_path / 's')!r}, handoff_dir={str(tmp_path / 'h')!r})\n"
        "p.refresh_units()\n"
        "m = telemetry.TelemetryMetrics()\n"
        "m.refresh()\n"
        "text = m.scrape().decode()\n"
        f"cdi.write_spec(cdi.generate_spec(), {str(tmp_path / 'cdi')!r})\n"
        "print(json.dumps({'units': len(p._snapshot()), 'nvml_up': "
        "'tpu_exporter_source_up{source=\"nvml\"} 1.0' in text,\n"
        "                  'torch': 'torch' in sys.modules, 'jax': 'jax' in sys.modules}))\n")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": REPO}
    result = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                            text=True, timeout=120, cwd=str(tmp_path))
    assert result.returncode == 0, result.stderr[-2000:]
    assert json.loads(result.stdout.strip().splitlines()[-1]) == {
        "units": 2, "nvml_up": True, "torch": False, "jax": False}


def test_telemetry_cli_serves_one_refresh(tmp_path):
    """``-c telemetry --port=0`` with a fake NVML: its first refresh, over
    HTTP, on the port its log names."""
    gpus = [dataclasses.asdict(g) for g in random_gpus(2, SEED)]
    script = _fake_script(gpus) + (
        "import sys\n"
        "from tpu_operator_torch.validator.main import main\n"
        f"sys.exit(main(['-c', 'telemetry', '--port=0', "
        f"'--handoff-dir={tmp_path}', '--status-dir={tmp_path}']))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(consts.RUNTIME_METRICS_URL_ENV, None)
    proc = subprocess.Popen([sys.executable, "-c", script], env=env, cwd=str(tmp_path),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stderr:  # the log names the port it bound
            served = re.search(r"telemetry exporter on :(\d+)", line)
            if served:
                break
        assert served, "telemetry exited without serving"
        with urllib.request.urlopen(f"http://127.0.0.1:{served.group(1)}/metrics",
                                    timeout=10) as r:
            text = r.read().decode()
    finally:
        proc.kill()
        proc.wait(timeout=30)
    got = _samples(text)
    pci = sorted(random_gpus(2, SEED), key=lambda g: g.pci_bus_id)
    assert got['tpu_hbm_used_bytes{chip="1"}'] == pci[1].memory_used
    assert got['tpu_exporter_source_up{source="nvml"}'] == 1.0
    assert "runtime_endpoint" not in text


def test_telemetry_cli_without_nvml_exits_nonzero(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-m", "tpu_operator_torch.cmd.validator", "-c",
                             "telemetry", "--port=0"], env=env, capture_output=True, text=True,
                            timeout=120, cwd=str(tmp_path))
    assert result.returncode == 1
    assert "libnvidia-ml.so.1" in result.stderr
