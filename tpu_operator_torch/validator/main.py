"""GPU validator CLI: ``-c <component>`` dispatch (counterpart of
tpu_operator/validator/main.py), for the node path of a GPU node.

Components:

==================  =========================================================
driver              validate the CUDA driver library + device nodes; barrier
driver-daemon       installer DaemonSet main: place the bundled driver
                    libraries ($GPU_DRIVER_SRC) on the host path, record
                    the driver version, heartbeat the barrier
driver-probe        the installer's startup probe (exit code only; the
                    native gpu-probe when found)
plugin              wait for the GPU extended resource on this node;
                    ``--prewarm`` builds the CUDA sources into the build
                    cache in a background thread meanwhile
workload            spawn a pod on this node that requests every GPU and
                    runs ``workload-local``; write barrier
workload-local      run the GPU health sweep in-process, one rank per GPU
workload-multihost  this node's share of a sweep spanning hosts: one rank
                    per local GPU, every node's in one world
prewarm             build the CUDA sources into ``$GPU_COMPILATION_CACHE_DIR``
                    (never blocks: a failed warm-up just means the first
                    validation builds them)
perf                measured GEMM TFLOP/s, HBM GB/s (probe and hand-written
                    streaming kernel), NVLink all-reduce GB/s; optional
                    floors turn it into a gate
serving             decode-step SLO probe, the step as one CUDA graph
                    (p50/p99 latency, tokens/s over a batch ladder);
                    health-gated — a quarantined node fails closed; writes
                    its barrier on pass AND fail
info                at-a-glance node status (the nvidia-smi analog): GPUs,
                    device nodes, driver library, barriers, perf, serving
wait                block on another component's barrier (--for)
sleep               validator DS main container: re-runs the local sweep
                    every ``--revalidate-interval`` s (a busy GPU skips the
                    cycle, barrier untouched) and acks planned re-tiles
metrics             node-status exporter (status files -> Prometheus text)
feature-discovery   GPU type/count/memory node labeler loop; mirrors the
                    barrier verdicts, drain ack and span log to the node
device-plugin       kubelet device plugin for ``nvidia.com/gpu``: one unit
                    per GPU from NVML (PCI order), health gated on the
                    workload barrier, Allocate by UUID and own device node
cdi                 write the CDI spec of the node's GPUs
telemetry           out-of-band GPU exporter (NVML, an optional runtime
                    endpoint, sysfs, operator records -> Prometheus text)
slice-partitioner   apply the node's partition (``tpu.ai/slice.config``):
                    GPU groups over NVML's link topology, handed to the
                    device plugin
migrate-agent       node side of a migration: transparent snapshots on the
                    operator's request, restores of inbound checkpoints
==================  =========================================================

Everything that touches a device runs on ``cuda`` unless ``--device=cpu``
is given; ``device-plugin``, ``cdi``, ``telemetry``, ``slice-partitioner``,
``driver-daemon``, ``driver-probe`` and ``migrate-agent`` touch none (NVML
answers them without a CUDA context) and import no torch; the first three
exit non-zero without NVML, the partitioner records ``failed``.
Every process starts with ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` unless its
caller chose an order. Every component runs under a root span ``operand.<component>``
continuing the operator's join trace from ``$GPU_TRACE_PARENT``, written to
the span log in the status dir.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import threading
import time

from .. import consts, tracing
from ..utils import pin_device_order
from .status import StatusFiles

log = logging.getLogger("gpu-validator")


def _default_coordinator() -> str:
    addr = os.environ.get("MASTER_ADDR", "")
    return f"{addr}:{os.environ.get('MASTER_PORT', '29500')}" if addr else ""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpu-validator")
    p.add_argument("-c", "--component", required=True,
                   choices=["driver", "driver-daemon", "driver-probe", "plugin",
                            "workload", "workload-local", "workload-multihost", "prewarm",
                            "perf", "serving", "wait", "info", "sleep", "metrics",
                            "feature-discovery", "device-plugin", "cdi", "telemetry",
                            "slice-partitioner", "migrate-agent"])
    p.add_argument("--device", default="cuda",
                   help="torch device to validate on (cuda; cpu for tests)")
    p.add_argument("--json", action="store_true", help="info: machine-readable output")
    p.add_argument("--install-dir", default=consts.DEFAULT_DRIVER_LIB_DIR,
                   help="the driver library's directory")
    p.add_argument("--driver-version", default=None,
                   help="driver-daemon: the version to record (default "
                        f"${consts.DRIVER_VERSION_ENV}, else NVML's)")
    p.add_argument("--cdi-dir", default="/etc/cdi")
    p.add_argument("--status-dir", default=os.environ.get("STATUS_DIR", consts.VALIDATION_STATUS_DIR))
    p.add_argument("--resource", default=consts.GPU_RESOURCE_NAME)
    p.add_argument("--for", dest="wait_for", default="driver", help="barrier to wait on")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--poll", type=float, default=None,
                   help="plugin: resource poll period in seconds (default 5)")
    p.add_argument("--prewarm", action="store_true",
                   help="plugin: build the CUDA sources into the build cache "
                        "in a background thread while polling for the "
                        "resource, so the build rides a wait window")
    p.add_argument("--port", type=int, default=8000, help="metrics, telemetry: listen port")
    p.add_argument("--sleep-interval", type=float, default=60.0)
    p.add_argument("--revalidate-interval", type=float,
                   default=float(os.environ.get(consts.REVALIDATE_INTERVAL_ENV, "300")),
                   help="sleep: re-run the local sweep every N seconds and "
                        "refresh the workload barrier (0 = off). A busy GPU "
                        "skips the cycle without touching the barrier.")
    p.add_argument("--matrix-dim", type=int, default=512)
    p.add_argument("--metrics-config", default=os.environ.get(consts.TELEMETRY_CONFIG_ENV),
                   help="telemetry custom-metrics config file (from the "
                        "spec.telemetry.config ConfigMap)")
    p.add_argument("--perf-matrix-dim", type=int, default=4096)
    p.add_argument("--perf-hbm-mib", type=int, default=512)
    p.add_argument("--perf-ici-mib", type=int, default=64)
    p.add_argument("--min-mxu-tflops", type=float,
                   default=float(os.environ.get("MIN_MXU_TFLOPS", "0")))
    p.add_argument("--min-hbm-gbps", type=float,
                   default=float(os.environ.get("MIN_HBM_GBPS", "0")))
    p.add_argument("--min-ici-gbps", type=float,
                   default=float(os.environ.get("MIN_ICI_GBPS", "0")))
    p.add_argument("--serving-batch-sizes",
                   default=os.environ.get("SERVING_BATCH_SIZES", "1,4,8"),
                   help="comma-separated batch ladder for the serving probe")
    p.add_argument("--serving-steps", type=int,
                   default=int(os.environ.get("SERVING_STEPS", "32")))
    p.add_argument("--max-decode-p99-ms", type=float,
                   default=float(os.environ.get("MAX_DECODE_P99_MS", "200")))
    p.add_argument("--min-tokens-per-s", type=float,
                   default=float(os.environ.get("MIN_TOKENS_PER_S", "0")))
    p.add_argument("--min-slo-attainment", type=float,
                   default=float(os.environ.get("MIN_SLO_ATTAINMENT", "0.99")))
    p.add_argument("--serving-interval", type=float,
                   default=float(os.environ.get("SERVING_PROBE_INTERVAL", "0")),
                   help="serving: re-probe every N seconds (the DS main "
                        "container's continuous mode); 0 = one shot")
    p.add_argument("--coordinator", default=_default_coordinator(),
                   help="rendezvous: host:port (TCP) or a file:// URL")
    p.add_argument("--num-processes", type=int,
                   default=int(os.environ.get("WORLD_SIZE", "1")))
    p.add_argument("--process-id", type=int,
                   default=int(os.environ.get("RANK", "0")))
    p.add_argument("--local-ranks", type=int, default=None,
                   help="workload-multihost: ranks this process runs, one per GPU "
                        "(default every visible GPU; on cuda another count is "
                        "refused); with --device=cpu, gloo ranks that stand in "
                        "for GPUs (default 1)")
    p.add_argument("--init-timeout", type=float,
                   default=float(os.environ.get("GPU_INIT_TIMEOUT", "0")),
                   help="multihost rendezvous budget in seconds (0 = torch "
                        "default); a worker that never joins fails "
                        "validation closed within this budget")
    p.add_argument("--config", default=os.environ.get(consts.PARTITION_CONFIG_ENV),
                   help="slice-partitioner: the partition table file (default: the "
                        "port's own table)")
    p.add_argument("--handoff-dir",
                   default=os.environ.get(consts.HANDOFF_DIR_ENV, consts.DEFAULT_HANDOFF_DIR),
                   help="host dir through which the partitioner hands applied "
                        "partitions to the device plugin and telemetry")
    p.add_argument("--no-require-devices", action="store_true",
                   help="skip /dev checks (CI or pre-provisioned nodes)")
    p.add_argument("--log-level", default="info")
    return p


def make_client():
    """The validator's apiserver client (:class:`~tpu_operator_torch.client.ApiClient`)."""
    from ..client import ApiClient

    return ApiClient.from_env()


#: the revalidation subprocess imports the package from this checkout or
#: install, whatever its working directory
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def revalidate_local(status, matrix_dim: int, timeout: float = 600.0,
                     device: str = "cuda"):
    """Re-run the local sweep in a subprocess and refresh the workload
    barrier with its verdict; returns the verdict, or None when no sweep
    reported.

    Only a sweep that ran and reported writes. A GPU busy with a workload
    can refuse the sweep at set-up (out of memory at the context, cuBLAS or
    NCCL, or ``cudaErrorDevicesUnavailable`` in exclusive mode): that is
    no health verdict, so the cycle is skipped (None) and the barrier left
    alone. Writing ``passed: false`` there would fence a healthy node that
    is serving traffic. A subprocess, so that its context and memory go
    when it exits, leaving nothing held in the resident parent."""
    script = (
        "import json\n"
        "from tpu_operator_torch.validator.workload import ici_health_check\n"
        f"print(json.dumps(ici_health_check(matrix_dim={int(matrix_dim)}, "
        f"device={str(device)!r}).to_dict()))\n")
    env = pin_device_order(dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p)))
    try:
        result = subprocess.run([sys.executable, "-c", script], capture_output=True,
                                text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        log.warning("revalidation timed out after %ss; barrier untouched", timeout)
        return None
    report = None
    for line in reversed(result.stdout.splitlines()):
        if line.startswith("{"):
            try:
                report = json.loads(line)
            except ValueError:
                pass  # log noise or a truncated write: keep looking
            else:
                break
    if not isinstance(report, dict):
        errors = [ln for ln in result.stderr.splitlines() if "Error" in ln]
        log.info("revalidation skipped: the sweep produced no report (GPU "
                 "busy?): %s", errors[-1][-300:] if errors else result.stderr[-200:])
        return None
    # the drain-ack stamp is protocol state, not verdict state: a refresh
    # mid-drain must not un-ack the plan (the partitioner reads the ack from
    # this barrier); the drain watch retires it once the plan is gone
    prior = status.read("workload") or {}
    if isinstance(prior.get("drain_ack"), dict):
        report.setdefault("drain_ack", prior["drain_ack"])
    status.write("workload", report)
    if not report.get("passed"):
        log.error("periodic revalidation FAILED: %s", report.get("details"))
    return bool(report.get("passed"))


def drain_watch(client, status):
    """One best-effort drain pass for the long-running loops (sleep mode,
    serving re-probe): if the operator published a ``tpu.ai/planned-retile``
    plan for this node, checkpoint and stamp the drain ack into the barrier
    (``health/drain.maybe_ack_plan``). Returns the client, built lazily, for
    the caller to keep. Never raises: a missed pass retries next interval,
    and the operator's deadline keeps the drain moving regardless."""
    node_name = os.environ.get("NODE_NAME", "")
    if not node_name:
        return client
    if client is None:
        try:
            client = make_client()
        except Exception as e:
            log.debug("drain watch: no apiserver client (%s)", e)
            return None
    try:
        from ..health import drain as drainproto

        drainproto.maybe_ack_plan(client, node_name, status)
    except Exception:
        log.exception("drain watch pass failed; retrying next interval")
    return client


def run(argv=None, client=None) -> int:
    """Run one component; ``client`` is the apiserver client the ``plugin``,
    ``workload``, ``serving``, ``sleep`` and ``feature-discovery`` components
    use (default :func:`make_client`)."""
    from ..joinprofile.records import SpanLog

    args = build_parser().parse_args(argv)
    # before this process's first CUDA call: its ordinals are PCI order
    pin_device_order(os.environ)
    logging.basicConfig(level=getattr(logging, args.log_level.upper()),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    # the operator stamps the join trace's context into every operand pod;
    # this root continues it, and every record lands in the span log that
    # feature discovery mirrors to the node (a no-op without the env)
    with tracing.remote_trace(
            f"operand.{args.component}",
            traceparent=os.environ.get(consts.TRACE_PARENT_ENV),
            sink=SpanLog(args.status_dir).sink(),
            component=args.component,
            node=os.environ.get("NODE_NAME", "")) as root:
        rc = _dispatch(args, StatusFiles(args.status_dir), client)
        root.set_attribute("exit_code", rc)
        return rc


def _dispatch(args, status, client) -> int:
    component = args.component
    require_devices = not args.no_require_devices

    if component == "driver":
        from . import driver

        with tracing.span("driver.validate") as sp:
            if os.environ.get("GPU_USE_HOST_DRIVER") == "1":
                ok = driver.validate_host(status, require_devices)
            else:
                ok = driver.validate(args.install_dir, status, require_devices)
            sp.set_attribute("passed", ok)
        return 0 if ok else 1

    if component == "driver-daemon":
        from . import driver

        return driver.daemon(args.install_dir, args.driver_version, status)

    if component == "driver-probe":
        from . import driver

        return 0 if driver.probe(args.install_dir, require_devices) else 1

    if component == "plugin":
        from . import plugin

        if client is None:
            client = make_client()
        # concurrent prewarm: the resource poll below blocks on the
        # device-plugin DS rolling out, so the cold nvcc build runs in this
        # thread's shadow instead of as its own serial init container
        warm: dict = {}

        def _prewarm() -> None:
            from .workload import prewarm_compile_cache

            warm["start"] = time.time()
            try:
                warm["result"] = prewarm_compile_cache(device=args.device)
            except Exception as e:  # never fail the plugin gate over a warm-up
                warm["error"] = str(e)

        warm_thread = None
        if args.prewarm:
            warm_thread = threading.Thread(target=_prewarm, daemon=True,
                                           name="prewarm-build")
            warm_thread.start()
        with tracing.span("plugin.validate", resource=args.resource) as sp:
            kwargs = {} if args.poll is None else {"poll": args.poll}
            ok = plugin.validate(client, resource=args.resource, status=status,
                                 timeout=args.timeout, **kwargs)
            sp.set_attribute("passed", ok)
        if warm_thread is not None:
            # bounded join: an exited poll must not hang behind a wedged
            # build — the first validation would just build the sources
            warm_thread.join(timeout=max(30.0, args.timeout))
            result = warm.get("result")
            if result:
                # recorded from this thread, which holds the trace, so the
                # join profiler charges the build window to xla-compile
                tracing.record_span("xla-compile", warm["start"], result["compile_s"])
                log.info("build cache warmed in %.2fs (%s), inside the plugin "
                         "poll window", result["compile_s"], result["cache_dir"])
            elif "error" in warm:
                log.warning("concurrent prewarm failed (%s); the first "
                            "validation builds the sources", warm["error"])
        return 0 if ok else 1

    if component == "workload":
        from .workload import spawn_workload_pod

        if client is None:
            client = make_client()
        node_name = os.environ.get("NODE_NAME", "")
        namespace = os.environ.get(consts.NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
        image = os.environ.get("VALIDATOR_IMAGE", "")
        if not node_name or not image:
            log.error("workload: NODE_NAME and VALIDATOR_IMAGE required")
            return 1
        # a status record (NOT the workload barrier, which waiters would
        # take as satisfied) that the handshake is open before the spawn,
        # and an early span flush, so feature discovery can mirror the
        # handshake while the pod still pulls its image
        with tracing.span("workload.handshake", node=node_name):
            status.write("workload-handshake", {"node": node_name, "phase": "spawning"})
        tracing.flush_spans()
        spawn_start = time.time()
        with tracing.span("workload.spawn-pod", node=node_name) as sp:
            ok = spawn_workload_pod(client, namespace, node_name, image,
                                    resource_name=args.resource, timeout=args.timeout,
                                    status_dir=args.status_dir)
            sp.set_attribute("passed", bool(ok))
        # the pod mounts the status hostPath and its in-pod sweep writes the
        # DETAILED barrier (per-GPU failed_chips) itself; a barrier stamped
        # after spawn is that write — preserve it, the parent only knows the
        # coarse pod phase
        fresh = status.read("workload")
        in_pod_wrote = bool(fresh) and fresh.get("timestamp", 0) >= spawn_start
        if ok:
            if not in_pod_wrote:
                status.write("workload", {"mode": "pod"})
            return 0
        if ok is False and not in_pod_wrote:
            # the pod RAN and failed without a detailed write: record the
            # coarse regression. ok is None on timeout (scheduling or image
            # trouble, not a GPU verdict): leave the previous barrier alone
            status.write("workload", {"mode": "pod", "passed": False})
        return 1

    if component == "workload-local":
        from .workload import ici_health_check

        sweep_start = time.time()
        with tracing.span("ici-sweep", matrix_dim=args.matrix_dim) as sp:
            report = ici_health_check(matrix_dim=args.matrix_dim, device=args.device)
            sp.set_attribute("passed", report.passed)
            # the sweep's own set-up time (CUDA context, cuBLAS, NCCL) as a
            # child the join profiler charges to xla-compile
            if report.compile_s:
                tracing.record_span("xla-compile", sweep_start, report.compile_s)
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
        sweep_start = time.time()
        try:
            with tracing.span("multihost.ici-sweep", num_processes=args.num_processes) as sp:
                report = run_multihost(args.coordinator, args.num_processes,
                                       args.process_id, matrix_dim=args.matrix_dim,
                                       init_timeout=args.init_timeout, device=args.device,
                                       local_ranks=args.local_ranks)
                sp.set_attribute("passed", report.passed)
                if report.compile_s:
                    tracing.record_span("xla-compile", sweep_start, report.compile_s)
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

    if component == "prewarm":
        from .workload import prewarm_compile_cache

        warm_start = time.time()
        with tracing.span("prewarm.compile", matrix_dim=args.matrix_dim) as sp:
            try:
                result = prewarm_compile_cache(device=args.device)
            except Exception as e:
                # prewarm is an optimisation: a failed warm-up must never
                # block the init chain — the first validation builds the sources
                log.warning("build-cache prewarm failed (%s); the first validation "
                            "builds the sources", e)
                sp.set_attribute("failed", True)
                return 0
            if result is None:
                log.info("prewarm skipped: %s unset", consts.COMPILATION_CACHE_DIR_ENV)
                sp.set_attribute("skipped", True)
                return 0
            sp.set_attribute("compile_s", result["compile_s"])
            # the nvcc build (or cache load) as the join profiler's xla-compile
            tracing.record_span("xla-compile", warm_start, result["compile_s"])
        print(json.dumps(result))
        log.info("build cache warmed in %.2fs (%s)", result["compile_s"], result["cache_dir"])
        return 0

    if component == "info":
        from . import info

        return info.run(args.install_dir, as_json=args.json, status=status,
                        device=args.device)

    if component == "perf":
        from .perf import run_perf

        with tracing.span("perf.sweep") as sp:
            report = run_perf(
                matrix_dim=args.perf_matrix_dim, hbm_mib=args.perf_hbm_mib,
                ici_mib=args.perf_ici_mib,
                thresholds={"mxu_tflops": args.min_mxu_tflops,
                            "hbm_gbps": args.min_hbm_gbps,
                            "ici_allreduce_gbps": args.min_ici_gbps},
                device=args.device)
            sp.set_attribute("passed", report.passed)
        with tracing.mark("validator.report"):
            print(json.dumps(report.to_dict()))
            if report.passed:
                status.write("perf", report.to_dict())
        return 0 if report.passed else 1

    if component == "serving":
        from .serving import run_serving

        batch_sizes = [int(b) for b in str(args.serving_batch_sizes).split(",") if b.strip()]
        # the health gate reads the node's health-state label through the
        # apiserver; off-cluster the client cannot be built, and the gate
        # falls back to the GPU_HEALTH_STATE env alone
        if client is None:
            try:
                client = make_client()
            except Exception as e:
                log.warning("serving: no apiserver client (%s); health gate "
                            "limited to %s", e, consts.HEALTH_STATE_ENV)

        def probe_once() -> int:
            with tracing.span("serving.probe") as sp:
                rc = run_serving(
                    status, batch_sizes=batch_sizes or [1],
                    steps_per_batch=args.serving_steps,
                    max_decode_p99_ms=args.max_decode_p99_ms,
                    min_throughput_tokens_per_s=args.min_tokens_per_s,
                    min_slo_attainment=args.min_slo_attainment,
                    client=client, device=args.device)
                sp.set_attribute("exit_code", rc)
            # the continuous loop never exits: publish each probe's spans now
            tracing.flush_spans()
            return rc

        rc = probe_once()
        # continuous mode (DS main container): a decode tail that regresses
        # after pod start flips the barrier and the label
        while args.serving_interval > 0:
            time.sleep(args.serving_interval)
            # the serving agent acks a planned re-tile between probes
            client = drain_watch(client, status)
            try:
                rc = probe_once()
            except Exception:
                # never crash-loop the serving DS over one probe; the barrier
                # keeps its last real verdict
                log.exception("serving re-probe failed; retrying next interval")
        return rc

    if component == "wait":
        with tracing.span(f"barrier-wait.{args.wait_for}") as sp:
            ok = status.wait_for(args.wait_for, timeout=args.timeout)
            sp.set_attribute("passed", ok)
        if not ok:
            log.error("timed out waiting for %s barrier", args.wait_for)
        return 0 if ok else 1

    if component == "sleep":
        if args.revalidate_interval > 0:
            # the one-shot init-container sweep certifies the GPUs at pod
            # start only; re-running the LOCAL sweep keeps the barrier (and
            # the device plugin's health gate reading it) current for a GPU
            # that degrades afterwards. Fails closed here without a card.
            from ..device import resolve_device

            resolve_device(args.device)
            log.info("validations complete; revalidating every %ss",
                     args.revalidate_interval)
            while True:
                time.sleep(args.revalidate_interval)
                # ack a planned re-tile BEFORE revalidating, so the ack rides
                # the barrier the sweep then rewrites
                client = drain_watch(client, status)
                try:
                    with tracing.span("revalidate.ici-sweep"):
                        revalidate_local(status, args.matrix_dim, device=args.device)
                except Exception:
                    # never crash-loop the validator DS over one cycle
                    log.exception("revalidation cycle failed; retrying next interval")
                tracing.flush_spans()
        log.info("all validations complete; sleeping")
        while True:
            time.sleep(args.sleep_interval)
            client = drain_watch(client, status)

    if component == "metrics":
        from . import metrics

        return metrics.serve(args.port, refresh_interval=min(args.sleep_interval, 60.0),
                             status_dir=args.status_dir)

    if component == "feature-discovery":
        from . import feature_discovery

        if client is None:
            client = make_client()
        return feature_discovery.run(client, sleep_interval=args.sleep_interval,
                                     device=args.device, status_dir=args.status_dir)

    if component in ("device-plugin", "cdi", "telemetry"):
        from ..nvml import NvmlError

        try:
            return _device_plumbing(args)
        except (NvmlError, ImportError) as e:
            # no NVML, or no grpc for the plugin's wire layer: never an empty
            # inventory, spec or exporter
            log.error("%s: %s", component, e)
            return 1

    if component == "slice-partitioner":
        from ..partitioner import run as partitioner_run

        if client is None:
            client = make_client()
        return partitioner_run(client, config_path=args.config, handoff_dir=args.handoff_dir,
                               status_dir=args.status_dir)

    if component == "migrate-agent":
        from ..migrate import agent as migrate_agent

        node_name = os.environ.get("NODE_NAME", "")
        if not node_name:
            log.error("migrate-agent: NODE_NAME required")
            return 1
        if client is None:
            client = make_client()
        return migrate_agent.run(client, node_name, status, sleep_interval=args.sleep_interval)

    raise AssertionError(f"unhandled component {component}")


def _plugin_tunables() -> dict:
    """The device plugin's tunables from ``$GPU_PLUGIN_CONFIG`` (the
    spec.devicePlugin.config ConfigMap): ``healthIntervalS``,
    ``absenceGraceS``. Text that does not parse, or values that are not
    numbers, give the defaults with an error: a ConfigMap typo must never
    crash-loop the plugin off the kubelet."""
    from ..yamlsubset import SubsetError, parse

    path = os.environ.get(consts.PLUGIN_CONFIG_ENV)
    if not path or not os.path.exists(path):
        return {}
    tunables = {}
    try:
        with open(path) as f:
            raw = parse(f.read()) or {}
        for src, dst in (("healthIntervalS", "health_interval"),
                         ("absenceGraceS", "absence_grace_s")):
            if src in raw:
                tunables[dst] = float(raw[src])
    except (SubsetError, TypeError, ValueError) as e:
        log.error("device-plugin config %s invalid (%s); using defaults", path, e)
        return {}
    return tunables


def _device_plumbing(args) -> int:
    if args.component == "cdi":
        from . import cdi

        return cdi.run(install_dir=args.install_dir, cdi_dir=args.cdi_dir)

    if args.component == "telemetry":
        from . import telemetry

        return telemetry.serve(args.port, refresh_interval=min(args.sleep_interval, 60.0),
                               config_path=args.metrics_config,
                               handoff_dir=args.handoff_dir)

    from ..deviceplugin.plugin import GPUDevicePlugin

    plugin = GPUDevicePlugin(resource_name=args.resource, install_dir=args.install_dir,
                             status_dir=args.status_dir, handoff_dir=args.handoff_dir,
                             **_plugin_tunables())
    try:
        return plugin.run_forever()
    finally:
        plugin.stop()


def main(argv=None) -> int:
    return run(argv)


if __name__ == "__main__":
    sys.exit(main())
