"""GPU validator CLI: ``-c <component>`` dispatch (counterpart of
tpu_operator/validator/main.py), for the node path of a GPU node.

Components:

==================  =========================================================
driver              validate the CUDA driver library + device nodes; barrier
plugin              wait for the GPU extended resource on this node
workload-local      run the GPU health sweep in-process, one rank per GPU
workload-multihost  one rank of a sweep spanning hosts (torch.distributed)
perf                measured GEMM TFLOP/s, HBM GB/s (probe and hand-written
                    streaming kernel), NVLink all-reduce GB/s; optional
                    floors turn it into a gate
wait                block on another component's barrier (--for)
==================  =========================================================

Everything runs on ``cuda`` unless ``--device=cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .. import consts
from .status import StatusFiles

log = logging.getLogger("gpu-validator")


def _default_coordinator() -> str:
    addr = os.environ.get("MASTER_ADDR", "")
    return f"{addr}:{os.environ.get('MASTER_PORT', '29500')}" if addr else ""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpu-validator")
    p.add_argument("-c", "--component", required=True,
                   choices=["driver", "plugin", "workload-local",
                            "workload-multihost", "perf", "wait"])
    p.add_argument("--device", default="cuda",
                   help="torch device to validate on (cuda; cpu for tests)")
    p.add_argument("--install-dir", default=consts.DEFAULT_DRIVER_LIB_DIR)
    p.add_argument("--status-dir", default=os.environ.get("STATUS_DIR", consts.VALIDATION_STATUS_DIR))
    p.add_argument("--resource", default=consts.GPU_RESOURCE_NAME)
    p.add_argument("--for", dest="wait_for", default="driver", help="barrier to wait on")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--poll", type=float, default=None,
                   help="plugin: resource poll period in seconds (default 5)")
    p.add_argument("--matrix-dim", type=int, default=512)
    p.add_argument("--perf-matrix-dim", type=int, default=4096)
    p.add_argument("--perf-hbm-mib", type=int, default=512)
    p.add_argument("--perf-ici-mib", type=int, default=64)
    p.add_argument("--min-mxu-tflops", type=float,
                   default=float(os.environ.get("MIN_MXU_TFLOPS", "0")))
    p.add_argument("--min-hbm-gbps", type=float,
                   default=float(os.environ.get("MIN_HBM_GBPS", "0")))
    p.add_argument("--min-ici-gbps", type=float,
                   default=float(os.environ.get("MIN_ICI_GBPS", "0")))
    p.add_argument("--coordinator", default=_default_coordinator(),
                   help="rendezvous: host:port (TCP) or a file:// URL")
    p.add_argument("--num-processes", type=int,
                   default=int(os.environ.get("WORLD_SIZE", "1")))
    p.add_argument("--process-id", type=int,
                   default=int(os.environ.get("RANK", "0")))
    p.add_argument("--init-timeout", type=float,
                   default=float(os.environ.get("GPU_INIT_TIMEOUT", "0")),
                   help="multihost rendezvous budget in seconds (0 = torch "
                        "default); a worker that never joins fails "
                        "validation closed within this budget")
    p.add_argument("--no-require-devices", action="store_true",
                   help="skip /dev checks (CI or pre-provisioned nodes)")
    p.add_argument("--log-level", default="info")
    return p


def run(argv=None, client=None) -> int:
    """Run one component; ``client`` is the apiserver client the plugin
    component reads the node through (see :mod:`.plugin`)."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper()),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    return _dispatch(args, StatusFiles(args.status_dir), client)


def _dispatch(args, status, client) -> int:
    component = args.component
    require_devices = not args.no_require_devices

    if component == "driver":
        from . import driver

        if os.environ.get("GPU_USE_HOST_DRIVER") == "1":
            ok = driver.validate_host(status, require_devices)
        else:
            ok = driver.validate(args.install_dir, status, require_devices)
        return 0 if ok else 1

    if component == "plugin":
        from . import plugin

        if client is None:
            client = plugin.ApiNodeReader.from_env()
        kwargs = {} if args.poll is None else {"poll": args.poll}
        ok = plugin.validate(client, resource=args.resource, status=status,
                             timeout=args.timeout, **kwargs)
        return 0 if ok else 1

    if component == "workload-local":
        from .workload import ici_health_check

        report = ici_health_check(matrix_dim=args.matrix_dim, device=args.device)
        print(json.dumps(report.to_dict()))
        # a FAILED sweep is recorded too (passed: false), so health gates
        # see a regression instead of a stale pass
        status.write("workload", report.to_dict())
        return 0 if report.passed else 1

    if component == "workload-multihost":
        from .workload import run_multihost

        if not args.coordinator:
            log.error("workload-multihost: --coordinator required")
            return 1
        try:
            report = run_multihost(args.coordinator, args.num_processes,
                                   args.process_id, matrix_dim=args.matrix_dim,
                                   init_timeout=args.init_timeout, device=args.device)
        except Exception as e:
            # fail CLOSED: no barrier file, nonzero exit — a worker that
            # missed the rendezvous must never mark the slice validated
            log.error("workload-multihost: rendezvous/sweep failed: %s", e)
            print(json.dumps({"passed": False, "n_devices": 0,
                              "platform": "unknown", "elapsed_s": 0.0,
                              "compile_s": 0.0,
                              "details": {"error": str(e)[:500]}}))
            return 1
        print(json.dumps(report.to_dict()))
        status.write("workload", report.to_dict())
        return 0 if report.passed else 1

    if component == "perf":
        from .perf import run_perf

        report = run_perf(
            matrix_dim=args.perf_matrix_dim, hbm_mib=args.perf_hbm_mib,
            ici_mib=args.perf_ici_mib,
            thresholds={"mxu_tflops": args.min_mxu_tflops,
                        "hbm_gbps": args.min_hbm_gbps,
                        "ici_allreduce_gbps": args.min_ici_gbps},
            device=args.device)
        print(json.dumps(report.to_dict()))
        if report.passed:
            status.write("perf", report.to_dict())
        return 0 if report.passed else 1

    if component == "wait":
        ok = status.wait_for(args.wait_for, timeout=args.timeout)
        if not ok:
            log.error("timed out waiting for %s barrier", args.wait_for)
        return 0 if ok else 1

    raise AssertionError(f"unhandled component {component}")


def main(argv=None) -> int:
    return run(argv)


if __name__ == "__main__":
    sys.exit(main())
