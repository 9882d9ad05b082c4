"""Out-of-band GPU telemetry exporter (counterpart of
tpu_operator/validator/telemetry.py; the reference's own model is DCGM and
dcgm-exporter).

Never opens a CUDA context and never imports torch: a context pins device
memory on every GPU for the exporter's life and, in ``EXCLUSIVE_PROCESS``
compute mode, locks out the very workload it watches. Collection layers:

1. **NVML** (:class:`NvmlSource`): per GPU, memory used and total,
   utilisation (the share of time a kernel ran; the share of time memory
   was read or written), power and temperature. The GPU's counterpart of
   libtpu's per-chip runtime counters and of hwmon's sensors.
2. **A runtime metrics endpoint**, only when one is configured
   (``runtime_url`` or ``$GPU_RUNTIME_METRICS_URL``), such as
   dcgm-exporter's: its Prometheus text re-mapped, unit-scaled where the
   source's unit differs. The reference scrapes libtpu's port by default;
   a GPU has no such port, and the DaemonSet's own port (9400) is
   dcgm-exporter's, so no default, and a URL naming the exporter's own
   listen port is refused (it would scrape its own output).
3. **sysfs / devfs**: device-node count; the hwmon walk (NVIDIA registers
   no hwmon sensor, NVML has them).
4. **Operator records**: the partitioner's handoff file.

The families are the reference's ``tpu_*`` names, labels and HELP text,
so one set of dashboards reads both; the GPU's ``chip`` label is its
position in PCI bus-id order, the device plugin's unit index. The text
format is written here (``metrics.py``): the port has no
``prometheus_client``. The metrics config is read by ``yamlsubset.parse``:
the port has no ``yaml``.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import socket
import threading
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Tuple

from .. import consts, nvml, yamlsubset
from ..partitioner.partitioner import DEFAULT_HANDOFF_DIR, HANDOFF_FILE
from .driver import discover_devices
from .metrics import Counter, Gauge, http_server

log = logging.getLogger(__name__)

REFRESH_INTERVAL = 15.0

#: source-family -> target-family defaults; extended/overridden by the
#: ``rename:`` section of the metrics config
DEFAULT_RENAME = {
    "memory_usage": "tpu_hbm_used_bytes",
    "hbm_memory_usage_bytes": "tpu_hbm_used_bytes",
    "memory_total": "tpu_hbm_total_bytes",
    "hbm_memory_total_bytes": "tpu_hbm_total_bytes",
    "duty_cycle_pct": "tpu_duty_cycle_percent",
    "dutycycle_percent": "tpu_duty_cycle_percent",
    "tensorcore_utilization": "tpu_tensorcore_utilization_percent",
    "accelerator_utilization": "tpu_tensorcore_utilization_percent",
    "memory_bandwidth_utilization": "tpu_membw_utilization_percent",
    "uptime": "tpu_runtime_uptime_seconds",
    # dcgm-exporter: tensor-pipe activity has no NVML source
    "DCGM_FI_PROF_PIPE_TENSOR_ACTIVE": "tpu_tensorcore_utilization_percent",
    "DCGM_FI_DEV_FB_USED": "tpu_hbm_used_bytes",
}

#: source families whose unit is not the target's: the factor to it
DEFAULT_SCALE = {
    "DCGM_FI_PROF_PIPE_TENSOR_ACTIVE": 100.0,  # a ratio in 0-1 -> percent
    "DCGM_FI_DEV_FB_USED": float(2 ** 20),  # MiB -> bytes
}

#: labels carrying the chip identity in source metrics, normalised to "chip"
_CHIP_LABELS = ("chip", "accelerator_id", "device_id", "core", "gpu")

_PROM_LINE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([^\s]+)')
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prometheus(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """(family, labels, value) triples from Prometheus exposition text."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if not m:
            continue
        name, raw_labels, raw_value = m.groups()
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = dict(_PROM_LABEL.findall(raw_labels)) if raw_labels else {}
        out.append((name, labels, value))
    return out


class MetricsConfig:
    """Custom-metrics configuration (the ConfigMap surface).

    JSON or the YAML subset of :mod:`~tpu_operator_torch.yamlsubset`, with
    keys: ``rename`` (source->target family map, extends defaults),
    ``include`` (target allowlist; empty = all), ``exclude`` (target
    denylist), ``labels`` (static labels on every sample), ``runtime_url``
    (the endpoint to scrape)."""

    def __init__(self, rename: Optional[dict] = None,
                 include: Optional[list] = None,
                 exclude: Optional[list] = None,
                 labels: Optional[dict] = None,
                 runtime_url: Optional[str] = None):
        self.rename = {**DEFAULT_RENAME, **(rename or {})}
        self.include = set(include or [])
        self.exclude = set(exclude or [])
        self.labels = dict(labels or {})
        self.runtime_url = runtime_url

    @classmethod
    def load(cls, path: Optional[str]) -> "MetricsConfig":
        if not path or not os.path.exists(path):
            return cls()
        with open(path) as f:
            text = f.read()
        try:
            data = yamlsubset.parse(text)
        except yamlsubset.SubsetError as e:
            log.error("metrics config %s unparseable (%s); using defaults", path, e)
            return cls()
        if not isinstance(data, dict):
            # a list/scalar config must degrade to defaults, not crashloop
            # the exporter DaemonSet
            log.warning("metrics config %s is not a mapping "
                        "(got %s); using defaults", path, type(data).__name__)
            return cls()
        return cls(rename=data.get("rename"), include=data.get("include"),
                   exclude=data.get("exclude"), labels=data.get("labels"),
                   runtime_url=data.get("runtime_url"))

    def allows(self, family: str) -> bool:
        if family in self.exclude:
            return False
        return not self.include or family in self.include


#: host names of this host, for the self-scrape check
_LOCAL_HOSTS = {"localhost", "0.0.0.0", "::", "::1", "ip6-localhost"}


class RuntimeEndpointSource:
    """Scrape a metrics endpoint the node's workload runtime serves (such
    as dcgm-exporter's) — out-of-band by construction: we read localhost
    HTTP. Refuses, on every collection, a URL naming this exporter's own
    listen port on this host."""

    name = "runtime_endpoint"

    def __init__(self, url: Optional[str] = None, timeout: float = 2.0,
                 own_port: Optional[int] = None):
        self.url = url or os.environ.get(consts.RUNTIME_METRICS_URL_ENV)
        if not self.url:
            raise ValueError(f"no runtime metrics URL (runtime_url or "
                             f"${consts.RUNTIME_METRICS_URL_ENV})")
        self.timeout = timeout
        self.own_port = own_port

    def scrapes_itself(self) -> bool:
        parts = urllib.parse.urlsplit(self.url)
        port = parts.port or (443 if parts.scheme == "https" else 80)
        host = (parts.hostname or "").lower()
        local = host in _LOCAL_HOSTS or host.startswith("127.") or \
            host == socket.gethostname().lower()
        return self.own_port is not None and port == self.own_port and local

    def collect(self) -> List[Tuple[str, Dict[str, str], float]]:
        if self.scrapes_itself():
            raise ValueError(f"{self.url} is this exporter's own port {self.own_port}: "
                             "refusing to scrape its own output")
        with urllib.request.urlopen(self.url, timeout=self.timeout) as resp:
            return parse_prometheus(resp.read().decode("utf-8", "replace"))


class NvmlSource:
    """Per-GPU counters from NVML, without a CUDA context. ``chip`` is the
    GPU's position in PCI bus-id order (the device plugin's unit index);
    power and temperature take the reference's ``sensor`` label."""

    name = "nvml"

    def __init__(self, lib=None):
        self.lib = lib

    def collect(self) -> List[Tuple[str, Dict[str, str], float]]:
        samples: List[Tuple[str, Dict[str, str], float]] = []
        with nvml.session(self.lib) as s:
            for i, gpu in enumerate(s.gpus()):
                x = s.sample(gpu)
                chip = {"chip": str(i)}
                sensor = {"sensor": f"nvml/gpu{i}"}
                samples += [
                    ("tpu_hbm_used_bytes", chip, float(x.memory_used_bytes)),
                    ("tpu_hbm_total_bytes", chip, float(x.memory_total_bytes)),
                    ("tpu_duty_cycle_percent", chip, float(x.gpu_utilization_percent)),
                    ("tpu_membw_utilization_percent", chip,
                     float(x.memory_utilization_percent)),
                    ("tpu_power_watts", sensor, x.power_mw / 1000.0),
                    ("tpu_temperature_celsius", sensor, float(x.temperature_c)),
                ]
        return samples


class SysfsSource:
    """Device nodes + hwmon temperature/power sensors; no runtime calls."""

    name = "sysfs"

    def __init__(self, sys_root: str = "/sys"):
        self.sys_root = sys_root

    def collect(self) -> List[Tuple[str, Dict[str, str], float]]:
        samples: List[Tuple[str, Dict[str, str], float]] = []
        samples.append(("tpu_device_nodes_total", {},
                        float(len(discover_devices()))))
        for hw in sorted(glob.glob(os.path.join(
                self.sys_root, "class", "hwmon", "hwmon*"))):
            hw_name = self._read(os.path.join(hw, "name"))
            if not hw_name or not any(
                    k in hw_name.lower() for k in ("tpu", "accel", "apex")):
                continue
            for tf in sorted(glob.glob(os.path.join(hw, "temp*_input"))):
                raw = self._read(tf)
                if raw is not None:
                    sensor = os.path.basename(tf).replace("_input", "")
                    samples.append(("tpu_temperature_celsius",
                                    {"sensor": f"{hw_name}/{sensor}"},
                                    float(raw) / 1000.0))
            for pf in sorted(glob.glob(os.path.join(hw, "power*_input"))):
                raw = self._read(pf)
                if raw is not None:
                    sensor = os.path.basename(pf).replace("_input", "")
                    samples.append(("tpu_power_watts",
                                    {"sensor": f"{hw_name}/{sensor}"},
                                    float(raw) / 1e6))
        return samples

    @staticmethod
    def _read(path: str) -> Optional[str]:
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            return None


class RecordsSource:
    """Operator-written records: the partitioner's handoff (GPU count,
    topology, partition layout)."""

    name = "records"

    def __init__(self, handoff_dir: Optional[str] = None):
        self.path = os.path.join(handoff_dir
                                 or os.environ.get(consts.HANDOFF_DIR_ENV)
                                 or DEFAULT_HANDOFF_DIR,
                                 HANDOFF_FILE)

    def collect(self) -> List[Tuple[str, Dict[str, str], float]]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            handoff = json.load(f)
        samples: List[Tuple[str, Dict[str, str], float]] = []
        groups = handoff.get("groups", [])
        samples.append(("tpu_slice_partitions_total", {}, float(len(groups))))
        chips = sum(len(g.get("chips", [])) for g in groups)
        if chips:
            samples.append(("tpu_chips_total", {}, float(chips)))
        name = handoff.get("partition")
        if name:
            samples.append(("tpu_slice_partition_info",
                            {"partition": str(name)}, 1.0))
        # link capacity from the recorded topology: a torus of N chips
        # carries N undirected links per dimension (wraparound rings),
        # degenerate 1-sized dimensions contributing none
        links = 0
        for g in groups:
            dims = str(g.get("topology", "")).split("x")
            try:
                real_dims = sum(1 for d in dims if int(d) > 1)
            except ValueError:
                continue
            links += real_dims * len(g.get("chips", []))
        if links:
            samples.append(("tpu_ici_links_total", {}, float(links)))
        return samples


#: supported output families: name -> (help text, label names), the
#: reference's, so its dashboards read a GPU node
FAMILIES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "tpu_chip_up": ("1 when the chip is known present", ("chip",)),
    "tpu_chips_total": ("TPU chips on this node", ()),
    "tpu_device_nodes_total": ("TPU device nodes on the host", ()),
    "tpu_hbm_used_bytes": ("HBM bytes in use", ("chip",)),
    "tpu_hbm_total_bytes": ("HBM capacity bytes", ("chip",)),
    "tpu_duty_cycle_percent":
        ("TensorCore duty cycle over the sample window", ("chip",)),
    "tpu_tensorcore_utilization_percent":
        ("TensorCore utilization", ("chip",)),
    "tpu_membw_utilization_percent":
        ("HBM bandwidth utilization", ("chip",)),
    "tpu_runtime_uptime_seconds": ("libtpu runtime uptime", ()),
    "tpu_temperature_celsius": ("Chip/board temperature", ("sensor",)),
    "tpu_power_watts": ("Board power draw", ("sensor",)),
    "tpu_ici_link_up": ("1 when the ICI link is healthy", ("chip", "link")),
    "tpu_ici_links_total": ("ICI links on this node", ()),
    "tpu_slice_partitions_total": ("Active slice partitions", ()),
    "tpu_slice_partition_info": ("Active partition layout", ("partition",)),
}


class TelemetryMetrics:
    """Out-of-band sources -> Prometheus exposition.

    Each refresh builds FRESH sample families and swaps them in at once,
    dcgm-exporter-style: a source that stops responding or a GPU that
    disappears stops being exported instead of serving stale values
    forever. Only exporter self-telemetry (per-source up gauges and error
    counters) persists across refreshes."""

    def __init__(self, config: Optional[MetricsConfig] = None,
                 sources: Optional[list] = None,
                 handoff_dir: Optional[str] = None,
                 listen_port: Optional[int] = None,
                 nvml_lib=None):
        self.config = config or MetricsConfig()
        if sources is None:
            sources = []
            url = self.config.runtime_url or os.environ.get(consts.RUNTIME_METRICS_URL_ENV)
            if url:
                sources.append(RuntimeEndpointSource(url, own_port=listen_port))
            sources += [NvmlSource(nvml_lib), SysfsSource(), RecordsSource(handoff_dir)]
        self.sources = sources
        self.families = {name: spec for name, spec in FAMILIES.items()
                         if self.config.allows(name)}
        self._static_names = sorted(self.config.labels)
        self._static_values = [str(self.config.labels[k]) for k in self._static_names]
        #: persistent self-telemetry (counters must survive the swap)
        self.source_up = Gauge("tpu_exporter_source_up",
                               "1 when the collection source responded", ("source",))
        self.scrape_errors = Counter("tpu_exporter_scrape_errors_total",
                                     "Collection failures per source", ("source",))
        self._samples: List[Gauge] = []

    def _normalise(self, name: str, labels: Dict[str, str], value: float
                   ) -> Tuple[str, Dict[str, str], float]:
        target = self.config.rename.get(name, name)
        out = dict(labels)
        for cl in _CHIP_LABELS:
            if cl in out:
                out["chip"] = out.pop(cl)
                break
        return target, out, value * DEFAULT_SCALE.get(name, 1.0)

    def refresh(self) -> None:
        collected: List[Tuple[str, Dict[str, str], float]] = []
        chips_seen: set = set()
        chips_total_known = False
        for source in self.sources:
            try:
                samples = source.collect()
            except Exception as e:
                log.debug("telemetry source %s failed: %s", source.name, e)
                self.source_up.set(0, source=source.name)
                self.scrape_errors.inc(source=source.name)
                continue
            self.source_up.set(1, source=source.name)
            for name, labels, value in samples:
                target, norm, value = self._normalise(name, labels, value)
                if target not in self.families:
                    continue
                collected.append((target, norm, value))
                if "chip" in norm:
                    chips_seen.add(norm["chip"])
                if target == "tpu_chips_total":
                    chips_total_known = True
        # chip presence from whatever per-chip samples any source produced
        if "tpu_chip_up" in self.families:
            for chip in sorted(chips_seen):
                collected.append(("tpu_chip_up", {"chip": chip}, 1.0))
        if chips_seen and not chips_total_known \
                and "tpu_chips_total" in self.families:
            collected.append(("tpu_chips_total", {}, float(len(chips_seen))))

        gauges: Dict[str, Gauge] = {}
        for target, labels, value in collected:
            doc, label_names = self.families[target]
            g = gauges.get(target)
            if g is None:
                g = gauges[target] = Gauge(target, doc,
                                           tuple(label_names) + tuple(self._static_names))
            values = [labels.get(ln, "") for ln in label_names] + self._static_values
            g.set(value, **dict(zip(g.labelnames, values)))
        self._samples = list(gauges.values())  # one swap

    def scrape(self) -> bytes:
        families = [*self._samples, self.source_up, self.scrape_errors]
        return "".join(f.expose() for f in families).encode("utf-8")


def serve(port: int, metrics: Optional[TelemetryMetrics] = None,
          refresh_interval: float = REFRESH_INTERVAL,
          ready_event: Optional[threading.Event] = None,
          stop_event: Optional[threading.Event] = None,
          config_path: Optional[str] = None,
          handoff_dir: Optional[str] = None) -> int:
    """Serve ``/metrics`` on ``port`` (0: any free port), refreshing every
    ``refresh_interval`` s until ``stop_event`` is set (forever without).
    Without ``metrics``, checks NVML first: raises
    :class:`~tpu_operator_torch.nvml.NvmlError` without it, since the GPUs
    are what this exporter is for."""
    stop = stop_event or threading.Event()
    if metrics is None:
        nvml.gpus()
    # the server binds first: the runtime source refuses its own port
    server = http_server(port, lambda: metrics.scrape())
    try:
        if metrics is None:
            config = MetricsConfig.load(
                config_path or os.environ.get(consts.TELEMETRY_CONFIG_ENV))
            metrics = TelemetryMetrics(config=config, handoff_dir=handoff_dir,
                                       listen_port=server.server_address[1])
        metrics.refresh()
    except BaseException:
        server.server_close()
        raise
    threading.Thread(target=server.serve_forever, daemon=True).start()
    if ready_event:
        ready_event.set()
    log.info("telemetry exporter on :%d", server.server_address[1])
    try:
        while not stop.wait(refresh_interval):
            metrics.refresh()
    finally:
        server.shutdown()
        server.server_close()
    return 0
