"""``gpu-validator -c info``: the node's at-a-glance status
(counterpart of tpu_operator/validator/info.py).

What this node has and how far through validation it is: GPUs, device
nodes, the CUDA driver library, the barriers, and measured throughput if
perf validation has run. ``--json`` emits the same data machine-readable.

Chip rows come from CUDA enumeration, with memory from
``torch.cuda.mem_get_info`` (which creates a context; ``info`` runs once).
``hbm_used_bytes`` is the device's total less its free memory: what every
process on the GPU holds, this one's context included. The TPU
operator's is the runtime's ``bytes_in_use``, which is device-wide only
because libtpu holds a TPU exclusively.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import torch

from .. import consts
from ..device import DeviceLike, resolve_device
from .driver import discover_devices, driver_lib_path, is_valid_driver_lib
from .status import StatusFiles, failed_local_chips

log = logging.getLogger(__name__)

CHECK = "ok"
MISS = "--"


def chip_rows() -> list:
    """One row per visible GPU: id, name, total and used device memory."""
    rows = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        free, total = torch.cuda.mem_get_info(i)
        rows.append({"id": i, "kind": props.name, "hbm_used_bytes": total - free,
                     "hbm_total_bytes": props.total_memory})
    return rows


def collect(install_dir: str = consts.DEFAULT_DRIVER_LIB_DIR,
            status: Optional[StatusFiles] = None,
            device: DeviceLike = None) -> dict:
    """The node's status. On ``cuda`` (the default) the GPUs are enumerated
    and the call raises without CUDA; ``device="cpu"`` enumerates nothing
    and shows device nodes only. The keys are the TPU operator's (the
    driver library under ``libtpu``, as in the driver barrier)."""
    dev = resolve_device(device)
    status = status or StatusFiles(os.environ.get("STATUS_DIR", consts.VALIDATION_STATUS_DIR))
    lib = driver_lib_path(install_dir)
    info: dict = {
        "device_nodes": discover_devices(),
        "libtpu": {"path": lib, "valid": is_valid_driver_lib(lib)},
        "chips": [],
        "validations": {c: status.is_ready(c)
                        for c in ("driver", "plugin", "workload", "perf", "serving")},
    }
    driver_record = status.read("driver") or {}
    if driver_record.get("libtpu_version"):
        info["libtpu"]["version"] = driver_record["libtpu_version"]
    # per-GPU verdict from the workload barrier (the signal behind the
    # device plugin's per-unit gate and the chip_healthy exporter series)
    workload = status.read("workload")
    if workload is None and os.path.exists(status.path("workload")):
        # present but unparsable: the plugin and exporters fail safe here,
        # so say why every GPU reads unhealthy
        info["failed_chips"] = "corrupt barrier (all chips suspect)"
    elif workload is not None and workload.get("passed") is False:
        failed = failed_local_chips(workload, len(info["device_nodes"]))
        if failed is None:
            info["failed_chips"] = "unattributed (all chips suspect)"
        elif not failed:
            # a multihost sweep that failed wholly on another host
            info["failed_chips"] = "none local (failure on another slice host)"
        else:
            info["failed_chips"] = sorted(failed)
    perf = status.read("perf") or {}
    if perf:
        # ici_allreduce_gbps stays None when the sweep skipped it (one GPU):
        # 0.0 would read as a dead fabric
        info["perf"] = {k: perf.get(k, 0.0) for k in ("mxu_tflops", "hbm_gbps")}
        info["perf"]["ici_allreduce_gbps"] = perf.get("ici_allreduce_gbps")
        info["perf"]["ici_skipped"] = bool(perf.get("ici_skipped"))
    serving = status.read("serving") or {}
    if serving:
        info["serving"] = {
            "passed": serving.get("passed"),
            "decode_p99_ms": serving.get("decode_p99_ms"),
            "throughput_tokens_per_s": serving.get("throughput_tokens_per_s"),
            "slo_attainment": serving.get("slo_attainment"),
            "skipped_reason": serving.get("skipped_reason"),
        }
    if dev.type == "cuda":
        info["chips"] = chip_rows()
    return info


def _gib(n: float) -> str:
    return f"{n / (1 << 30):.1f}"


def render(info: dict) -> str:
    lines = ["gpu-info"]
    chips = info["chips"]
    if chips:
        lines.append(f"  chips:        {len(chips)} x {chips[0].get('kind', 'gpu')}")
        for chip in chips:
            lines.append(f"    chip {chip['id']}: HBM {_gib(chip.get('hbm_used_bytes', 0))}/"
                         f"{_gib(chip['hbm_total_bytes'])} GiB")
    else:
        lines.append(f"  chips:        {len(info['device_nodes'])} (device nodes; "
                     "no CUDA enumeration in this process)")
    lines.append("  device nodes: " + (", ".join(info["device_nodes"]) or "none"))
    lib = info["libtpu"]
    version = f" ({lib['version']})" if lib.get("version") else ""
    state = "ok" if lib["valid"] else "MISSING"
    lines.append(f"  driver:       {lib['path']}{version} [{state}]")
    marks = "  ".join(f"{c}={CHECK if ready else MISS}"
                      for c, ready in info["validations"].items())
    lines.append(f"  validations:  {marks}")
    if "failed_chips" in info:
        failed = info["failed_chips"]
        detail = (", ".join(f"chip {c}" for c in failed)
                  if isinstance(failed, list) else failed)
        lines.append(f"  UNHEALTHY:    workload sweep failed — {detail}")
    if "perf" in info:
        p = info["perf"]
        if p.get("ici_skipped"):
            ici = "skipped (single chip)"  # not measured, which is not 0
        elif p.get("ici_allreduce_gbps") is not None:
            ici = f"{p['ici_allreduce_gbps']:.0f} GB/s"
        else:
            ici = MISS
        lines.append(f"  perf:         GEMM {p['mxu_tflops']:.0f} TFLOP/s · "
                     f"HBM {p['hbm_gbps']:.0f} GB/s · NVLink {ici}")
    if "serving" in info:
        s = info["serving"]
        if s.get("skipped_reason"):
            lines.append(f"  serving:      FAILED CLOSED ({s['skipped_reason']})")
        else:
            verdict = "pass" if s.get("passed") else "FAIL"
            lines.append(
                f"  serving:      {verdict} · p99 "
                f"{(s.get('decode_p99_ms') or 0):.2f} ms · "
                f"{(s.get('throughput_tokens_per_s') or 0):.0f} tok/s · "
                f"attainment {(s.get('slo_attainment') or 0):.2f}")
    return "\n".join(lines)


def run(install_dir: str, as_json: bool = False, status: Optional[StatusFiles] = None,
        device: DeviceLike = None) -> int:
    info = collect(install_dir, status, device)
    print(json.dumps(info) if as_json else render(info))
    # nonzero when the stack is unhealthy, as nvidia-smi's
    return 0 if info["libtpu"]["valid"] and (info["chips"] or info["device_nodes"]) else 1
