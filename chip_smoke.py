#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_operator_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. environment: the card's name and power limit (nvidia-smi), torch, CUDA
2. build every CUDA source of the port with nvcc, then the native probe
   and exporter with g++ (each timed)
3. each kernel against its plain PyTorch version on the card, bit-exact
   (K1: the main shape, ragged lengths, chunk boundaries, every relative
   alignment of the two ends with their neighbours untouched, and a plan
   the C entry must refuse)
4. each kernel's time beside its plain version, its library call and its
   bound, at the shapes the main path gives it; K1 also beside the HBM
   probe's one op, which must run as one device kernel
5. main path: the validator's ``workload-local`` sweep (matrix 512), then
   ``perf`` at the CLI defaults (4096 / 512 MiB); kernel launch counts are
   zeroed before and read after, and every kernel must have launched
6. the graft entry points (single-GPU check, 1-rank mesh dry run)
7. serving: the decode step's CUDA graph replay against the eager step,
   bit-equal on seeded integer inputs at batch 8, dim 256; both steps
   timed; then ``serving`` at the CLI defaults (ladder 1, 4, 8, 32 steps,
   dim 256) must pass with a three-point frontier on platform ``gpu``.
   The serving path launches no hand-written kernel: its two products are
   cuBLAS, as the reference's are XLA dots
8. prewarm: in subprocesses (so the earlier phases' K1 stays the one built
   in phase 2), ``prewarm`` builds K1 into a fresh
   ``$GPU_COMPILATION_CACHE_DIR``; a second process with no ``nvcc``
   reachable loads it from there and runs it bit-exact
9. steady state and node identity, on the status dir phases 5-8 wrote
   (with ``$GPU_TRACE_PARENT`` set from the start, so every component
   logged its spans there): ``info --json``; a feature-discovery pass
   against an in-memory apiserver, and the same pass in a fresh process
   that must hold no CUDA context; ``revalidate_local`` on the idle card
   (rewrites the barrier, keeps a planted drain ack) and on a card held
   all but 256 MiB (skips, barrier bytes unchanged); ``-c sleep`` until
   two revalidations; five re-probes in one process with
   ``memory_reserved`` flat, then ``-c serving --serving-interval=1`` in a
   fresh process for three probes; the Python metrics exporter, in
   process and as ``-c metrics`` over HTTP with ``GPU_NATIVE_EXPORTER=0``
   (phase 11 drives the native one). This path launches no hand-written
   kernel
10. device plumbing, on a copy of that status dir: NVML against
   ``nvidia-smi -q`` in a fresh process that must import no torch and hold
   no primary context; the device plugin's inventory (one unit per GPU,
   its node the GPU's own minor) and its health gate on a failed barrier;
   Allocate, then ``workload-local`` in a child whose environment is the
   plan's alone (it must see exactly the allocated UUID); the CDI spec;
   the plugin served over gRPC in a fresh process (where grpc imports);
   the telemetry exporter in a fresh process scraped against
   ``nvidia-smi`` while a child holds 8 GiB and runs GEMMs, and after. No
   hand-written kernel
11. the validator's last components, on another copy of that status dir,
   each daemon in a fresh process that must import no torch and hold no
   primary context: the native ``gpu-probe`` and ``gpu-exporter`` (built
   with ``g++`` in phase 2); ``driver-daemon`` installing
   the machine's own ``libcuda.so.1`` and ``libnvidia-ml.so.1`` from a
   bundle assembled from the host's driver paths, its barrier's version
   against ``nvidia-smi``, two heartbeats and the CDI spec; ``driver-probe``
   (the native binary's ``--json``, exit 0 on that install and 1 on an
   empty one, 50 timed execs beside the Python component's process);
   ``slice-partitioner`` passes (``single-gpu`` applied; the plugin's
   ``gpu-part-0``, Allocate and ``workload-local`` in a child with the
   plan's env alone; a barrier failing GPU 0 deferred for the drain ack
   with the handoff intact, forced at the plan's deadline, then restored
   by a passing barrier), with NVML's answer for the GPU paired with itself
   recorded; ``gpu-exporter --oneshot`` and ``-c metrics`` (which execs it)
   against the Python exporter; the migrate agent's loop taking a snapshot
   and then restoring it on the same node, its manifest re-mapped over
   NVML's links. No hand-written kernel

12. the operator's join on the card: an in-process MiniApiServer whose one
   Node is this machine (NVIDIA's feature-discovery PCI label, no GPU
   capacity yet); ``gpu-operator`` in a subprocess that must map neither
   torch nor libcuda; the port's sample ClusterPolicy with its host paths
   in a temp dir and its device globs the card's; a process kubelet
   (``tpu_operator_torch/testing/kubelet.py``) running what the operator
   renders: the driver installer (from a bundle of the machine's driver
   libraries) until its startup probe passes, the validator's init chain
   ``driver`` -> ``plugin --prewarm`` -> ``workload`` and the pod that
   ``workload`` spawns, on the card, the device plugin's driver wait (then
   the node's ``nvidia.com/gpu``; its gRPC server is not run), feature
   discovery, telemetry and the exporter. Printed: seconds from the CR's
   creation to each join milestone, each process's wall time, the sweep's
   own ``elapsed_s``/``compile_s``, the reconcile count. Then the validator
   pod is recycled with its workload pod allocated no GPU: the recycle
   makes the validator DaemonSet unavailable, so the ClusterPolicy goes
   ``notReady`` at once (that time measures the recycle, not the barrier);
   the failed ``workload`` barrier then holds the DaemonSet at no available
   pod and the ClusterPolicy ``notReady`` across a back-off rerun that
   fails again, and the kubelet's next rerun, with the GPU, restores
   ``ready``. The operator runs its full client chain (informer cache on);
   the apiserver's requests to ``ready`` (GET, LIST, WATCH, writes, from
   the operator and the node agents) are printed, and so is the join's
   critical path as the operator's join profiler attributes it
   (``/debug/join-traces`` on its health port: seconds per phase, coverage,
   window), which must cover the smoke's CR-to-``ready`` interval within a
   sweep and sum to at most it, with a ``tpu_operator_join_phase_seconds``
   sample on ``/metrics``. The ClusterPolicy keeps its health machine off
   (phase 14 turns it on). No hand-written kernel runs in this phase (K1's
   count under ``operator`` is 0).
13. on that cluster, once ``ready`` again (:func:`gpudriver_phase`): the
   sample ``GPUDriver`` (empty selector) takes the driver DaemonSet over
   (the ClusterPolicy's deleted, ``gpu-driver-default-<pool>`` created
   for the node's GPU model, its installer run by the kubelet on the card,
   the GPUDriver ``ready`` with one pool of one node); ``gpuop-cfg
   status``; a second GPUDriver selecting the node puts both in
   ``ConflictingNodeSelector`` with one Warning Event each, and its
   deletion restores the first; two invalid GPUDrivers are refused with
   422 and not stored; deleting the GPUDriver hands the driver back; then
   two ``gpu-operator --leader-elect`` replicas: one holds the Lease, the
   other takes over from it stopped (SIGSTOP) within the lease plus a
   retry period, and the old leader, resumed with a write to make while
   the new one is stopped and its Lease read is held, has that write
   refused by the fence (``tpu_operator_fenced_writes_total``) and exits;
   ``gpuop-cfg status`` and ``validate``; no operator process and no
   ``gpuop-cfg`` maps torch or libcuda. Seconds to each step are printed.
   No hand-written kernel (K1's count under ``gpudriver`` is 0).
14. on that cluster (:func:`health_phase`): a fresh ``gpu-operator`` with
   the ClusterPolicy's health machine turned on (cordon on quarantine, two
   attempts 30 s apart, a 5 s drain window) and feature discovery's
   interval at 2 s. Episode A: the workload pod gets no GPU, the node goes
   degraded, quarantined and cordoned, the drain plan expires unacked
   (``RetileDeadlineExpired``), the operator recycles the validator pod and
   the cleared fault lets the kubelet's rerun pass on the card: recovered,
   healthy. Episode B: the fault stays through attempt 1 and attempt 2
   (the driver pod too, its installer rerun) to sticky ``failed``, with
   ``NodeHealthDegraded`` on the ClusterPolicy; then the fault and the
   health label are cleared. ``gpuop-cfg explain node`` prints the two
   episodes (4 and 5 decision records), ``/debug/timeline`` the same
   records, one ``prov-*`` ConfigMap each, no orphan in the causality audit
   of the operator's writes, the metric families' counts; seconds from each
   fault to each state are printed. No hand-written kernel (K1's count
   under ``health`` is 0).
15. on that cluster (:func:`upgrade_phase`): a fresh ``gpu-operator`` with
   the health machine off and ``driver.upgradePolicy`` on (one node at a
   time, 10 s forced budgets), so the driver DaemonSet is ``OnDelete``.
   U1: a user Pod requesting one ``nvidia.com/gpu`` holds 1 GiB on the card
   and runs GEMMs, a PodDisruptionBudget covers it, the node is cordoned by
   hand, and an env var added to ``spec.driver.env`` rolls the template:
   the eviction is refused with 429 and retried on its ``Retry-After``, the
   Pod force-deleted at the 10 s budget (its memory gone from ``nvidia-smi``
   when the driver pod is deleted), the installer rerun, the validator
   recycled and its chain passed on the card, ``upgrade-done`` with the
   admin's cordon kept. U2: a bundle the installer cannot read crash-loops
   the new driver to ``upgrade-failed`` (``DriverUpgradeFailed``, the failed
   gauge at 1); U1's template restored retries it to ``upgrade-done``,
   uncordoned by the machine. ``gpuop-cfg status`` and ``explain node`` (the
   two upgrade episodes apart from the health ones), the gauges, the
   apiserver's evictions and seconds from each template change to each
   state are printed. No hand-written kernel (K1's count under ``upgrade``
   is 0).

Then one ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Needs a CUDA device and the rest of the repository beside this file.
"""

import contextlib
import copy
import glob
import io
import json
import os
import queue
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
import uuid
import warnings

import torch


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


_T0 = time.monotonic()


def phase(name: str) -> None:
    print(f"== {name} (at {time.monotonic() - _T0:.1f} s)", flush=True)


def cuda_ms(fn, x, reps: int) -> float:
    """Mean milliseconds of ``fn(x)`` over ``reps`` launches, CUDA events."""
    fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def step_wall_ms(step, load, n: int) -> list:
    """Per-step wall milliseconds as the probe times a step: the buffers
    are written and the card idle before the clock starts, and the window
    ends with a synchronize."""
    out = []
    for i in range(n):
        load(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def serving_phase(dev, gen, card, status_dir) -> dict:
    from tpu_operator_torch.device import set_numerics
    from tpu_operator_torch.serving import probe
    from tpu_operator_torch.validator import main as vmain
    from tpu_operator_torch.validator.status import StatusFiles

    set_numerics()
    batch, dim = 8, 256  # the deepest rung and the width of the CLI defaults
    engine = probe.DecodeEngine(batch, dim, dev)
    engine.w.copy_(torch.randint(-2, 3, (dim, dim), generator=gen, device=dev))
    engine.tokens.copy_(torch.randint(-2, 3, (batch, dim), generator=gen, device=dev))
    t0 = time.perf_counter()
    engine.capture()
    capture_s = time.perf_counter() - t0
    # the eager step, run under the sync debugger: any op that waits on the
    # host would also have refused capture
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            probe.engine_step(*engine.args())
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sorted({str(w.message).splitlines()[0] for w in caught
                    if "called a synchronizing" in str(w.message)})
    print(json.dumps({"capture_s": capture_s, "host_syncs_in_eager_step": syncs}))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.graph.replay()
        torch.cuda.synchronize()
    print(json.dumps({"graph_replay_kernels_us": [
        (e.key[:80], round(e.device_time_total, 3))
        for e in prof.key_averages() if e.device_time_total > 0]}))

    n_pages = batch + 1
    for trial in range(4):
        pages = torch.randint(-8, 9, (n_pages, probe.PAGE_SIZE, dim), generator=gen,
                              device=dev).float()
        table = torch.randperm(n_pages, generator=gen, device=dev)[:batch]
        active = torch.randint(0, 2, (batch,), generator=gen, device=dev).float()
        active[trial] = 0.0
        admit = torch.randint(0, 2, (batch,), generator=gen, device=dev).float()
        eager_pages = pages.clone()
        eager_out, _ = probe.engine_step(engine.tokens, eager_pages, table, active, admit,
                                         engine.w)
        engine.pages.copy_(pages)
        engine.page_table.copy_(table)
        engine.active.copy_(active)
        engine.admit.copy_(admit)
        out = engine.step()
        torch.cuda.synchronize()
        check(torch.equal(out, eager_out), f"graph argmax differs from the eager step ({trial})")
        check(bits_equal(engine.pages, eager_pages),
              f"graph cache differs from the eager step ({trial})")
    print("graph replay == eager step: argmax and cache bit-equal on 4 seeded integer inputs")

    # time both at batch 8: the probe's per-step window, in turns (eager,
    # graph, graph, eager), and back-to-back device time by CUDA events
    engine.pages.zero_()
    engine.set_depth(batch)
    host_gen = torch.Generator().manual_seed(0)
    tables = [torch.randperm(n_pages, generator=host_gen)[:batch].tolist() for _ in range(64)]

    def load(i):
        engine.load(tables[i % 64], admit_slot=i % batch)

    eager = lambda: probe.engine_step(*engine.args())  # noqa: E731
    wall = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        wall[name] += step_wall_ms(eager if name == "eager" else engine.step, load, 200)
    device_ms = {"eager": cuda_ms(lambda _: eager(), None, reps=500),
                 "graph": cuda_ms(lambda _: engine.graph.replay(), None, reps=500)}
    steps = {name: {"wall_p50_ms": statistics.median(v),
                    "wall_p99_ms": probe._percentile(sorted(v), 0.99),
                    "device_ms": device_ms[name], "samples": len(v)}
             for name, v in wall.items()}
    print(json.dumps({"serving_step": steps, "batch": batch, "dim": dim, "card": card}))
    del engine

    rc = vmain.run(["-c", "serving", f"--status-dir={status_dir}"])
    report = StatusFiles(status_dir).read("serving")
    check(rc == 0, f"serving exited {rc}: {report and report.get('failures')}")
    check(report.get("passed") is True and report.get("platform") == "gpu",
          f"serving barrier {report}")
    check(report["failures"] == [], f"serving failures {report['failures']}")
    points = report["frontier"]["points"]
    check([p["batch"] for p in points] == [1, 4, 8] and
          all(p["samples"] >= probe.MIN_FRONTIER_SAMPLES for p in points),
          f"frontier {points}")
    check(report["frontier"]["model_dim"] == 256, "probe width")
    print(json.dumps({"serving": {k: report[k] for k in (
        "compile_s", "elapsed_s", "decode_p50_ms", "decode_p99_ms",
        "throughput_tokens_per_s", "slo_attainment", "n_devices")},
        "rungs": [{k: r[k] for k in ("batch", "samples", "p50_ms", "p99_ms", "mean_ms",
                                     "tokens_per_s")} for r in report["batches"]],
        "card": card}))
    return report


def prewarm_phase(card, status_dir) -> None:
    """``prewarm`` in a fresh cache dir, then a process that cannot reach
    ``nvcc`` loads and runs K1 from it."""
    with tempfile.TemporaryDirectory(prefix="chip-smoke-kernel-cache-") as cache:
        env = dict(os.environ, GPU_COMPILATION_CACHE_DIR=cache)
        cold = subprocess.run([sys.executable, "-m", "tpu_operator_torch.cmd.validator",
                               "-c", "prewarm", f"--status-dir={status_dir}"], env=env,
                              capture_output=True, text=True, timeout=300)
        check(cold.returncode == 0, f"prewarm exited {cold.returncode}: {cold.stderr[-2000:]}")
        lines = [ln for ln in cold.stdout.splitlines() if ln.startswith("{")]
        check(bool(lines), f"prewarm printed no result: {cold.stderr[-2000:]}")
        cold_result = json.loads(lines[-1])
        built = glob.glob(os.path.join(cache, "libstream_copy-*.so"))
        check(len(built) == 1, f"K1 not built into the cache dir: {os.listdir(cache)}")

        no_nvcc = [d for d in os.environ.get("PATH", "").split(os.pathsep)
                   if d and not os.access(os.path.join(d, "nvcc"), os.X_OK)]
        env.update(PATH=os.pathsep.join(no_nvcc), CUDA_HOME=os.path.join(cache, "no-cuda"))
        script = (
            "import json, torch\n"
            "from tpu_operator_torch.kernels import _build, stream_copy as k1\n"
            "from tpu_operator_torch.validator.workload import prewarm_compile_cache\n"
            "try:\n"
            "    _build.find_nvcc()\n"
            "    reachable = True\n"
            "except RuntimeError:\n"
            "    reachable = False\n"
            "warm = prewarm_compile_cache()\n"
            "x = torch.randn(1_000_003, device='cuda')\n"
            "y = k1.stream_copy(x)\n"
            "torch.cuda.synchronize()\n"
            "print(json.dumps({'nvcc_reachable': reachable, 'warm': warm,\n"
            "                  'lib': str(_build.library_path('stream_copy')),\n"
            "                  'launches': k1.launches, 'equal': torch.equal(x, y)}))\n")
        warm = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                              text=True, timeout=300)
        check(warm.returncode == 0, f"warm load failed: {warm.stderr[-2000:]}")
        warm_result = json.loads(warm.stdout.strip().splitlines()[-1])
        check(warm_result["nvcc_reachable"] is False, "nvcc was reachable in the warm process")
        check(warm_result["lib"] == built[0], f"warm process loaded {warm_result['lib']}")
        check(warm_result["equal"] and warm_result["launches"] == 1,
              f"K1 from the cache: {warm_result}")
        print(json.dumps({"prewarm_cold": cold_result, "prewarm_warm": warm_result["warm"],
                          "card": card}))


class DictClient:
    """An in-memory apiserver for v1 Nodes: get, and JSON merge patch with
    the resourceVersion precondition (409 on a stale version)."""

    class Conflict(Exception):
        code = 409

    def __init__(self, node: dict):
        self.nodes = {node["metadata"]["name"]: copy.deepcopy(node)}
        self.nodes[node["metadata"]["name"]]["metadata"]["resourceVersion"] = "1"
        self.patches = []

    def get(self, api_version, kind, name, namespace=None) -> dict:
        return copy.deepcopy(self.nodes[name])

    @staticmethod
    def _merge(target: dict, patch: dict) -> None:
        for key, value in patch.items():
            if value is None:
                target.pop(key, None)
            elif isinstance(value, dict):
                DictClient._merge(target.setdefault(key, {}), value)
            else:
                target[key] = value

    def patch(self, api_version, kind, name, patch, namespace=None) -> dict:
        node = self.nodes[name]
        patch = copy.deepcopy(patch)
        sent = patch.get("metadata", {}).pop("resourceVersion", None)
        if sent is not None and sent != node["metadata"]["resourceVersion"]:
            raise DictClient.Conflict(f"resourceVersion {sent} is stale")
        self.patches.append(copy.deepcopy(patch))
        self._merge(node, patch)
        node["metadata"]["resourceVersion"] = str(int(node["metadata"]["resourceVersion"]) + 1)
        return copy.deepcopy(node)


class FileClient:
    """An apiserver for processes that must not import torch (so not this
    module): one Node in a JSON file, JSON merge patch with the
    resourceVersion precondition, no Pods, and Events kept in the file.
    Its source is handed to such processes (``inspect.getsource``)."""

    class Conflict(Exception):
        code = 409

    def __init__(self, path: str):
        self.path = path

    def _load(self) -> dict:
        with open(self.path) as f:
            return json.load(f)

    def _save(self, state: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.path)

    @staticmethod
    def _merge(target: dict, patch: dict) -> None:
        for key, value in patch.items():
            if value is None:
                target.pop(key, None)
            elif isinstance(value, dict):
                FileClient._merge(target.setdefault(key, {}), value)
            else:
                target[key] = value

    def get(self, api_version, kind, name, namespace=None) -> dict:
        return self._load()["node"]

    def list(self, api_version, kind, namespace=None, field_selector=None) -> list:
        return self._load()["events"] if kind == "Event" else []

    def create(self, obj: dict) -> dict:
        state = self._load()
        if any(e["metadata"]["name"] == obj["metadata"]["name"] for e in state["events"]):
            raise FileClient.Conflict(obj["metadata"]["name"])
        state["events"].append(obj)
        self._save(state)
        return obj

    def patch(self, api_version, kind, name, patch, namespace=None) -> dict:
        state = self._load()
        node = state["node"]
        patch = json.loads(json.dumps(patch))
        sent = patch.get("metadata", {}).pop("resourceVersion", None)
        if sent is not None and sent != node["metadata"]["resourceVersion"]:
            raise FileClient.Conflict(f"resourceVersion {sent} is stale")
        self._merge(node, patch)
        node["metadata"]["resourceVersion"] = str(int(node["metadata"]["resourceVersion"]) + 1)
        self._save(state)
        return node


def primary_contexts_active() -> list:
    """Whether this process holds each GPU's primary context, from the
    driver API itself (``cuDevicePrimaryCtxGetState``)."""
    from tpu_operator_torch.cuda_driver import primary_contexts_active as active

    return active()


def compute_app_pids() -> list:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi --query-compute-apps failed: {out.stderr}")
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def scrape_samples(text: str) -> dict:
    """``{'name{labels}': value}`` from Prometheus text, comments skipped."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class CliProcess:
    """A validator component (or a ``python -c`` script, when ``script`` is
    given) run in its own process group (its revalidation sweeps are
    children of it), stdout read line by line on a thread, and the whole
    group killed by :meth:`stop`."""

    def __init__(self, argv: list, script: str = None, env: dict = None):
        command = ([sys.executable, "-c", script] if script is not None else
                   [sys.executable, "-m", "tpu_operator_torch.cmd.validator", *argv])
        self.started = time.perf_counter()
        self.proc = subprocess.Popen(
            command, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True, cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, **(env or {})))
        self.lines: "queue.Queue[str]" = queue.Queue()
        self.stderr: list = []
        threading.Thread(target=self._pump, args=(self.proc.stdout, self.lines.put),
                         daemon=True).start()
        threading.Thread(target=self._pump, args=(self.proc.stderr, self.stderr.append),
                         daemon=True).start()

    @staticmethod
    def _pump(stream, sink) -> None:
        for line in stream:
            sink(line)

    def json_lines(self, n: int, timeout: float) -> list:
        out, deadline = [], time.monotonic() + timeout
        while len(out) < n:
            check(self.proc.poll() is None,
                  f"component exited {self.proc.returncode}: {''.join(self.stderr)[-2000:]}")
            try:
                line = self.lines.get(timeout=max(0.01, min(1.0, deadline - time.monotonic())))
            except queue.Empty:
                check(time.monotonic() < deadline,
                      f"no result within {timeout}s: {''.join(self.stderr)[-2000:]}")
                continue
            if line.startswith("{"):
                out.append(json.loads(line))
        return out

    def stop(self) -> None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait(timeout=60)


def steady_state_phase(dev, card, status_dir, trace_id, serving_report) -> None:
    from tpu_operator_torch import consts
    from tpu_operator_torch.health import drain
    from tpu_operator_torch.joinprofile.records import decode_annotation
    from tpu_operator_torch.serving import frontier
    from tpu_operator_torch.validator import feature_discovery as fd
    from tpu_operator_torch.validator import main as vmain
    from tpu_operator_torch.validator.metrics import NodeMetrics
    from tpu_operator_torch.validator.serving import run_serving
    from tpu_operator_torch.validator.status import StatusFiles

    status = StatusFiles(status_dir)
    props = torch.cuda.get_device_properties(0)
    numbers = {"card": card}

    # 1. info --json, through the CLI
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        info_rc = vmain.run(["-c", "info", "--json", f"--status-dir={status_dir}"])
    collected = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(len(collected["chips"]) == torch.cuda.device_count(), f"info chips {collected}")
    chip = collected["chips"][0]
    check(chip["kind"] == torch.cuda.get_device_name(0), f"info kind {chip}")
    check(chip["hbm_total_bytes"] == props.total_memory, f"info total {chip}")
    written = {c: status.read(c) is not None for c in collected["validations"]}
    check(collected["validations"] == written and written == {
        "driver": False, "plugin": False, "workload": True, "perf": True, "serving": True},
        f"info validations {collected['validations']} vs barriers {written}")
    numbers["info"] = {"rc": info_rc, "chip": chip}
    print(json.dumps({"info": collected}))

    # 2. one feature-discovery pass, in process and in a fresh process
    node = {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "smoke-node", "labels": {}, "annotations": {}}}
    client = DictClient(node)
    t0 = time.perf_counter()
    fd.sync_node_labels(client, "smoke-node", status_dir=status_dir)
    numbers["fd_pass_ms"] = (time.perf_counter() - t0) * 1e3
    meta = client.get("v1", "Node", "smoke-node")["metadata"]
    labels, ann = meta["labels"], meta["annotations"]
    check(labels.get(consts.TPU_CHIP_TYPE_LABEL) == fd.chip_type_from_kind(props.name),
          f"chip-type label {labels}")
    if props.name == "NVIDIA H100 80GB HBM3":
        check(labels[consts.TPU_CHIP_TYPE_LABEL] == "nvidia-h100-80gb", f"labels {labels}")
    check(labels.get(consts.TPU_CHIP_COUNT_LABEL) == str(torch.cuda.device_count()),
          f"count label {labels}")
    check(labels.get(consts.TPU_MEMORY_LABEL) == f"{round(props.total_memory / 2**30)}Gi",
          f"memory label {labels}")
    check(ann.get(consts.WORKLOAD_HEALTH_ANNOTATION) == "passed", f"workload-health {ann}")
    check(labels.get(consts.SERVING_SLO_LABEL) == "passed", f"serving-slo {labels}")
    mirrored = frontier.decode_annotation(ann.get(consts.SERVING_FRONTIER_ANNOTATION))
    check(mirrored is not None and
          [(p.batch, p.p99_ms, p.samples) for p in mirrored.points] ==
          [(r["batch"], r["p99_ms"], r["samples"]) for r in serving_report["batches"]],
          f"frontier annotation {ann.get(consts.SERVING_FRONTIER_ANNOTATION)}")
    spans = decode_annotation(ann.get(consts.TRACE_SPANS_ANNOTATION))
    names = {r["n"] for r in spans if r["t"] == trace_id}
    wanted = {"operand.workload-local", "ici-sweep", "xla-compile", "perf.sweep",
              "serving.probe"}
    check(wanted <= names, f"trace-spans under the smoke's trace hold {sorted(names)}")
    print(json.dumps({"feature_discovery": {"labels": labels, "annotations": {
        k: v for k, v in ann.items() if k != consts.TRACE_SPANS_ANNOTATION},
        "span_names": sorted(names), "pass_ms": numbers["fd_pass_ms"]}}))

    node_file = os.path.join(status_dir, "smoke-node.json")
    with open(node_file, "w") as f:
        json.dump(node, f)
    script = (
        "import json, os, time\n"
        "from chip_smoke import DictClient, compute_app_pids, primary_contexts_active\n"
        "from tpu_operator_torch.validator import feature_discovery as fd\n"
        f"client = DictClient(json.load(open({node_file!r})))\n"
        "t0 = time.perf_counter()\n"
        f"fd.sync_node_labels(client, 'smoke-node', status_dir={status_dir!r})\n"
        "ms = (time.perf_counter() - t0) * 1e3\n"
        "print(json.dumps({'pid': os.getpid(), 'apps': compute_app_pids(),\n"
        "                  'active': primary_contexts_active(), 'pass_ms': ms,\n"
        "                  'meta': client.get('v1', 'Node', 'smoke-node')['metadata']}))\n")
    fresh = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                           timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(fresh.returncode == 0, f"feature discovery in a fresh process: {fresh.stderr[-2000:]}")
    sub = json.loads(fresh.stdout.strip().splitlines()[-1])
    check(str(sub["pid"]) not in sub["apps"], f"the FD process holds a context: {sub['apps']}")
    check(sub["active"] == [False] * torch.cuda.device_count(),
          f"the FD process holds a primary context: {sub['active']}")
    check(primary_contexts_active()[0], "the context check does not see this process's context")
    own_pid_listed = str(os.getpid()) in compute_app_pids()
    sub_meta = sub["meta"]
    check(sub_meta["labels"] == labels and sub_meta["annotations"] == ann,
          "the fresh process's pass differs from the in-process one")
    numbers["fd_fresh_process_pass_ms"] = sub["pass_ms"]
    print(json.dumps({"feature_discovery_fresh_process": {
        "pid": sub["pid"], "compute_apps": sub["apps"], "primary_contexts": sub["active"],
        "this_process_listed_by_nvidia_smi": own_pid_listed, "pass_ms": sub["pass_ms"]}}))

    # 3. revalidation: on the idle card, then on a card held all but 256 MiB
    drain.write_drain_ack(status, "smoke-plan", step=3, checkpoint="/smoke")
    planted = status.read("workload")
    t0 = time.perf_counter()
    verdict = vmain.revalidate_local(status, 512, timeout=120)
    cycle_s = time.perf_counter() - t0
    fresh_barrier = status.read("workload")
    check(verdict is True, f"revalidation on the idle card returned {verdict}")
    check(fresh_barrier["timestamp"] > planted["timestamp"] and
          fresh_barrier["platform"] == "gpu", f"barrier not rewritten: {fresh_barrier}")
    check(fresh_barrier.get("drain_ack") == planted["drain_ack"],
          f"the drain ack was lost: {fresh_barrier.get('drain_ack')}")
    numbers["revalidation"] = {
        "cycle_s": cycle_s, "compile_s": fresh_barrier["compile_s"],
        "sweep_s": fresh_barrier["elapsed_s"] - fresh_barrier["compile_s"],
        "process_start_s": cycle_s - fresh_barrier["elapsed_s"]}
    before = open(status.path("workload"), "rb").read()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    hold = torch.empty(free - 256 * 2**20, dtype=torch.uint8, device=dev)
    held_free = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    busy = vmain.revalidate_local(status, 512, timeout=120)
    busy_s = time.perf_counter() - t0
    del hold
    torch.cuda.empty_cache()
    check(busy is None, f"revalidation on a full card returned {busy}")
    check(open(status.path("workload"), "rb").read() == before,
          "revalidation on a full card touched the barrier")
    numbers["revalidation_full_card"] = {"free_mib_while_held": held_free / 2**20,
                                         "skip_s": busy_s}
    print(json.dumps({"revalidation": numbers["revalidation"],
                      "revalidation_full_card": numbers["revalidation_full_card"]}))

    # 4. -c sleep --revalidate-interval=2 until the barrier is rewritten twice
    stamps = [status.read("workload")["timestamp"]]
    sleeper = CliProcess(["-c", "sleep", "--revalidate-interval=2",
                          f"--status-dir={status_dir}"])
    try:
        deadline = time.monotonic() + 120
        while len(stamps) < 3:
            check(sleeper.proc.poll() is None,
                  f"sleep exited {sleeper.proc.returncode}: {''.join(sleeper.stderr)[-2000:]}")
            check(time.monotonic() < deadline, "sleep did not revalidate twice in 120 s")
            barrier = status.read("workload")
            if barrier and barrier["timestamp"] != stamps[-1]:
                check(barrier.get("platform") == "gpu" and barrier.get("passed") is True,
                      f"sleep's revalidation wrote {barrier}")
                stamps.append(barrier["timestamp"])
            time.sleep(0.05)
    finally:
        sleeper.stop()
    numbers["sleep_rewrite_gaps_s"] = [b - a for a, b in zip(stamps[1:], stamps[2:])]
    print(json.dumps({"sleep": {"rewrites": len(stamps) - 1,
                                "gap_s": numbers["sleep_rewrite_gaps_s"]}}))

    # 5. five re-probes in this process, then the loop in a fresh process
    reserved, compile_s = [], []
    for _ in range(5):
        with contextlib.redirect_stdout(io.StringIO()):
            rc = run_serving(status, batch_sizes=[1, 4, 8], steps_per_batch=32, device=dev)
        check(rc == 0, f"re-probe failed: {status.read('serving').get('failures')}")
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
        compile_s.append(status.read("serving")["compile_s"])
    check(reserved[1:] == [reserved[0]] * 4, f"memory_reserved across re-probes {reserved}")
    prober = CliProcess(["-c", "serving", "--serving-interval=1",
                         f"--status-dir={status_dir}"])
    try:
        probes = prober.json_lines(3, timeout=120)
    finally:
        prober.stop()
    check(all(p["passed"] for p in probes), f"loop probes {[p['failures'] for p in probes]}")
    numbers["serving_in_process"] = {"memory_reserved": reserved, "compile_s": compile_s}
    numbers["serving_loop_compile_s"] = [p["compile_s"] for p in probes]
    print(json.dumps({"serving_reprobes": numbers["serving_in_process"],
                      "serving_loop_fresh_process": {
                          "compile_s": numbers["serving_loop_compile_s"],
                          "elapsed_s": [p["elapsed_s"] for p in probes],
                          "decode_p99_ms": [p["decode_p99_ms"] for p in probes]}}))

    # 6. the Python metrics exporter, in process and as -c metrics over
    # HTTP: the native exporter is off here (phase 11 drives it)
    perf = status.read("perf")
    exporter = NodeMetrics(status)
    exporter.refresh()
    text = exporter.scrape().decode()
    samples = scrape_samples(text)
    check(samples.get('tpu_operator_node_chip_healthy{chip="0"}') == 1.0,
          f"chip_healthy: {[k for k in samples if 'chip_healthy' in k]}")
    check(samples["tpu_operator_node_mxu_tflops"] == perf["mxu_tflops"] and
          samples["tpu_operator_node_hbm_gbps"] == perf["hbm_gbps"], "perf gauges")
    if torch.cuda.device_count() == 1:
        check("ici_allreduce" not in text, "an all-reduce series on one GPU")
    port = free_port()
    server = CliProcess(["-c", "metrics", f"--port={port}", f"--status-dir={status_dir}"],
                        env={consts.NATIVE_EXPORTER_ENV: "0"})
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                    served = r.read().decode()
                break
            except OSError:
                check(server.proc.poll() is None and time.monotonic() < deadline,
                      f"metrics never served: {''.join(server.stderr)[-2000:]}")
                time.sleep(0.1)
        exe = os.path.realpath(f"/proc/{server.proc.pid}/exe")
    finally:
        server.stop()
    check(exe == os.path.realpath(sys.executable), f"-c metrics runs {exe}, not Python")
    refresh = "tpu_operator_node_metrics_last_refresh_ts_seconds"
    check({k: v for k, v in scrape_samples(served).items() if k != refresh} ==
          {k: v for k, v in samples.items() if k != refresh},
          "the exporter over HTTP serves other samples than in process")
    check([ln for ln in served.splitlines() if ln.startswith("#")] ==
          [ln for ln in text.splitlines() if ln.startswith("#")], "the families differ")
    print(json.dumps({"metrics": {k: v for k, v in samples.items() if k != refresh}}))
    print(json.dumps({"steady_state": numbers}))


def smi_gpus() -> list:
    """(UUID, minor number, PCI bus id or None for N/A) per GPU, in
    nvidia-smi's (NVML's index) order, from ``nvidia-smi -q``."""
    out = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi -q failed: {out.stderr}")
    uuids = re.findall(r"GPU UUID\s*:\s*(\S+)", out.stdout)
    minors = [int(m) for m in re.findall(r"Minor Number\s*:\s*(\d+)", out.stdout)]
    buses = [None if b == "N/A" else b for b in re.findall(r"\n\s*Bus Id\s*:\s*(\S+)", out.stdout)]
    check(len(uuids) == len(minors) == len(buses), f"nvidia-smi -q: {uuids} {minors} {buses}")
    return list(zip(uuids, minors, buses))


def smi_sample() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used,utilization.gpu,power.draw,"
                          "temperature.gpu", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi --query-gpu failed: {out.stderr}")
    used, util, power, temp = (float(v) for v in out.stdout.splitlines()[0].split(","))
    return {"memory_used_bytes": used * 2 ** 20, "utilization_gpu": util, "power_w": power,
            "temperature_c": temp}


def check_beside(value, before, after, key, rel=0.0, tol=0.0) -> None:
    """``value`` lies in the band nvidia-smi's two samples ``before`` and
    ``after`` span, widened by ``rel`` of it and by ``tol``."""
    lo, hi = sorted((before[key], after[key]))
    check(lo * (1 - rel) - tol <= value <= hi * (1 + rel) + tol,
          f"{key}: the exporter's {value} against nvidia-smi's {before[key]} and "
          f"{after[key]} around it")


def scrape(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
        return scrape_samples(r.read().decode())


#: a torch-free process's own check, once ``trigger`` exists: has it
#: imported torch or jax, and does it hold a primary context
_SELF_CHECK = (
    "import json, os, sys, threading, time\n"
    "def _self_check(trigger):\n"
    "    while not os.path.exists(trigger):\n"
    "        time.sleep(0.05)\n"
    "    from tpu_operator_torch.cuda_driver import primary_contexts_active\n"
    "    print(json.dumps({'torch': 'torch' in sys.modules, 'jax': 'jax' in sys.modules,\n"
    "                      'contexts': primary_contexts_active()}), flush=True)\n")


def pod_sweep(plan, pod_status: str) -> dict:
    """What a pod handed ``plan`` runs: ``workload-local`` in a child whose
    environment is the plan's alone, which must see exactly the one GPU
    the plan names. Returns the child's barrier."""
    from tpu_operator_torch.validator.status import StatusFiles

    pod = subprocess.run([sys.executable, "-c", (
        "import json, sys, torch\n"
        "props = torch.cuda.get_device_properties(0)\n"
        "print(json.dumps({'count': torch.cuda.device_count(), 'uuid': 'GPU-' + str(props.uuid)}),\n"
        "      flush=True)\n"
        "from tpu_operator_torch.validator.main import main\n"
        f"sys.exit(main(['-c', 'workload-local', '--status-dir={pod_status}']))\n")],
        env=dict(plan.envs, PATH=os.environ["PATH"],
                 PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
                 **{k: os.environ[k] for k in ("TMPDIR", "HOME") if k in os.environ}),
        capture_output=True, text=True, timeout=300)
    check(pod.returncode == 0, f"workload-local with the plan's env: {pod.stderr[-2000:]}")
    seen = json.loads([ln for ln in pod.stdout.splitlines() if ln.startswith("{")][0])
    uuid = plan.envs["CUDA_VISIBLE_DEVICES"]
    check(seen == {"count": 1, "uuid": uuid}, f"the pod saw {seen}, allocated {uuid}")
    barrier = StatusFiles(pod_status).read("workload")
    check(barrier["passed"] and barrier["n_devices"] == 1, f"pod barrier {barrier}")
    return barrier


def plumbing_phase(card, status_dir) -> dict:
    """Phase 10: NVML, the device plugin, CDI and telemetry on the card."""
    import shutil
    import stat

    from tpu_operator_torch import consts, nvml
    from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin, plan_container
    from tpu_operator_torch.validator import cdi, telemetry
    from tpu_operator_torch.validator.status import StatusFiles

    numbers = {"card": card}
    work = tempfile.mkdtemp(prefix="chip-smoke-plumbing-")
    status_copy = os.path.join(work, "status")
    shutil.copytree(status_dir, status_copy)
    handoff = os.path.join(work, "handoff")
    n_cuda = torch.cuda.device_count()

    # 1. NVML against nvidia-smi -q, in a fresh process without torch
    trigger = os.path.join(work, "nvml-check")
    open(trigger, "w").close()
    script = _SELF_CHECK + (
        "import dataclasses\n"
        "t0 = time.perf_counter()\n"
        "from tpu_operator_torch import nvml\n"
        "with nvml.session() as s:\n"
        "    gpus = [s.gpu(i) for i in range(s.count())]\n"
        "nvml_ms = (time.perf_counter() - t0) * 1e3\n"
        "from tpu_operator_torch import cuda_driver\n"
        "cuda_order = cuda_driver.uuids_by_ordinal()\n"
        "from tpu_operator_torch.validator import telemetry\n"
        "from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin\n"
        f"m = telemetry.TelemetryMetrics(handoff_dir={handoff!r})\n"
        "t1 = time.perf_counter()\n"
        "m.refresh()\n"
        "refresh_ms = (time.perf_counter() - t1) * 1e3\n"
        f"p = GPUDevicePlugin(status_dir={status_copy!r}, handoff_dir={handoff!r})\n"
        "t2 = time.perf_counter()\n"
        "p.refresh_units()\n"
        "plugin_ms = (time.perf_counter() - t2) * 1e3\n"
        "print(json.dumps({'gpus': [dataclasses.asdict(g) for g in gpus], 'nvml_ms': nvml_ms,\n"
        "                  'cuda_order': cuda_order,\n"
        "                  'telemetry_refresh_ms': refresh_ms, 'plugin_refresh_ms': plugin_ms,\n"
        "                  'units': [u.id for u in p._snapshot()]}), flush=True)\n"
        f"_self_check({trigger!r})\n")
    t0 = time.perf_counter()
    fresh = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                           timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall_s = time.perf_counter() - t0
    check(fresh.returncode == 0, f"the NVML process failed: {fresh.stderr[-2000:]}")
    result, self_check = [json.loads(ln) for ln in fresh.stdout.splitlines() if ln.startswith("{")]
    got = [(g["uuid"], g["minor"], g["pci_bus_id"]) for g in result["gpus"]]
    check(got == smi_gpus(), f"NVML {got} != nvidia-smi -q {smi_gpus()}")
    check(len(got) == n_cuda, f"NVML lists {len(got)} GPUs, CUDA sees {n_cuda}")
    torch_uuids = ["GPU-" + str(torch.cuda.get_device_properties(i).uuid) for i in range(n_cuda)]
    check(sorted(result["cuda_order"]) == sorted(torch_uuids) == sorted(u for u, _, _ in got),
          f"the CUDA driver's ordinals {result['cuda_order']}, torch's {torch_uuids}")
    check(self_check == {"torch": False, "jax": False, "contexts": [False] * n_cuda},
          f"the NVML process: {self_check}")
    numbers["nvml_process"] = {"wall_s": wall_s, **{k: result[k] for k in (
        "nvml_ms", "telemetry_refresh_ms", "plugin_refresh_ms")}}
    print(json.dumps({"nvml": {"gpus": result["gpus"], "cuda_order": result["cuda_order"],
                               **numbers["nvml_process"],
                               "self_check": self_check}}))

    # 2. inventory and health: one unit per GPU, its node the GPU's own minor
    smi = smi_gpus()
    plugin = GPUDevicePlugin(plugin_dir=os.path.join(work, "kubelet"), status_dir=status_copy,
                             handoff_dir=handoff)
    plugin.refresh_units()
    units = plugin._snapshot()
    check([u.id for u in units] == [f"gpu-{i}" for i in range(n_cuda)], f"units {units}")
    gpus = nvml.gpus()
    status = StatusFiles(status_copy)
    for i, unit in enumerate(units):
        node = plugin.allocation_plan([unit.id]).devices[0][1]
        check(node == f"/dev/nvidia{smi[i][1]}", f"{unit.id}'s node {node}, minor {smi[i][1]}")
        check(stat.S_ISCHR(os.stat(node).st_mode), f"{node} is not a character device")
    check(all(u.health == "Healthy" for u in units), f"health {units}")
    kept = open(status.path("workload"), "rb").read()
    status.write("workload", {"passed": False, "n_devices": n_cuda,
                              "local_chips": list(range(n_cuda)), "failed_local_chips": [0],
                              "details": {"compute": {"passed": False, "failed_chips": [0]}}})
    check(plugin.refresh_units(), "a failed barrier changed nothing")
    health = [u.health for u in plugin._snapshot()]
    check(health == ["Unhealthy"] + ["Healthy"] * (n_cuda - 1), f"after the failure: {health}")
    with open(status.path("workload"), "wb") as f:
        f.write(kept)
    check(plugin.refresh_units(), "the restored barrier changed nothing")
    check(all(u.health == "Healthy" for u in plugin._snapshot()), "not restored")
    print(json.dumps({"inventory": [(u.id, plugin.allocation_plan([u.id]).devices[0][1])
                                    for u in units],
                      "gate": "gpu-0 Unhealthy on failed_local_chips [0], restored"}))

    # 3. Allocate, then what a pod would run, with only the plan's env
    t0 = time.perf_counter()
    plan = plugin.allocation_plan(["gpu-0"])
    numbers["allocate_plan_ms"] = (time.perf_counter() - t0) * 1e3
    for _, host, _ in plan.devices:
        check(stat.S_ISCHR(os.stat(host).st_mode), f"{host} is not a character device")
    for _, host, read_only in plan.mounts:
        check(os.path.exists(host) and read_only, f"mount {host}")
    uuid = plan.envs["CUDA_VISIBLE_DEVICES"]
    check(uuid == gpus[0].uuid == plan.envs["NVIDIA_VISIBLE_DEVICES"], f"plan envs {plan.envs}")
    barrier = pod_sweep(plan, os.path.join(work, "pod-status"))
    numbers["pod_sweep_elapsed_s"] = barrier["elapsed_s"]
    print(json.dumps({"allocate": {"devices": plan.devices, "mounts": plan.mounts,
                                   "env_names": sorted(plan.envs),
                                   "plan_ms": numbers["allocate_plan_ms"]},
                      "pod": {"saw_one_gpu_with_the_allocated_uuid": True,
                              "elapsed_s": barrier["elapsed_s"]}}))

    # 4. CDI
    path = cdi.write_spec(cdi.generate_spec(), os.path.join(work, "cdi"))
    spec = json.load(open(path))
    nodes = [n["path"] for d in spec["devices"] for n in d["containerEdits"]["deviceNodes"]]
    nodes += [n["path"] for n in spec["containerEdits"].get("deviceNodes", [])]
    check(all(stat.S_ISCHR(os.stat(n).st_mode) for n in nodes), f"CDI nodes {nodes}")
    check(all(os.path.exists(m["hostPath"]) for m in spec["containerEdits"]["mounts"]),
          "CDI mounts")
    names = [f"{spec['kind']}={d['name']}" for d in spec["devices"][:-1]]
    check(names == plan_container(units, gpus, consts.DEFAULT_DRIVER_LIB_DIR,
                                  use_cdi=True).cdi_devices,
          f"CDI names {names}")
    print(json.dumps({"cdi": {"path": path, "devices": [d["name"] for d in spec["devices"]],
                              "nodes": sorted(set(nodes))}}))

    # 5. the wire layer, where grpc and protobuf import
    try:
        import grpc
        from tpu_operator_torch.deviceplugin import grpc_api
        from tpu_operator_torch.deviceplugin.proto import deviceplugin_pb2 as pb
    except ImportError as e:
        print(f"grpc or protobuf missing on this machine ({e}): the device plugin's wire "
              "layer is covered only by the CPU tests")
        rc = subprocess.run([sys.executable, "-m", "tpu_operator_torch.cmd.validator", "-c",
                             "device-plugin", f"--status-dir={status_copy}"],
                            capture_output=True, text=True, timeout=120)
        check(rc.returncode != 0 and "grpc" in rc.stderr, f"device-plugin without grpc: {rc}")
    else:
        trigger = os.path.join(work, "plugin-check")
        server = CliProcess([], script=_SELF_CHECK + (
            "from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin\n"
            f"p = GPUDevicePlugin(plugin_dir={os.path.join(work, 'served')!r}, "
            f"status_dir={status_copy!r}, handoff_dir={handoff!r})\n"
            "t0 = time.perf_counter()\n"
            "socket_path = p.start()\n"
            "print(json.dumps({'socket': socket_path,\n"
            "                  'start_ms': (time.perf_counter() - t0) * 1e3}), flush=True)\n"
            f"_self_check({trigger!r})\n"
            "p.stop()\n"))
        try:
            ready = server.json_lines(1, timeout=120)[0]
            numbers["plugin_process_to_inventory_s"] = time.perf_counter() - server.started
            numbers["plugin_start_ms"] = ready["start_ms"]
            with grpc.insecure_channel(f"unix://{ready['socket']}") as channel:
                stub = grpc_api.DevicePluginStub(channel)
                first = next(stub.ListAndWatch(pb.Empty(), timeout=30))
                check([(d.ID, d.health) for d in first.devices] ==
                      [(u.id, "Healthy") for u in units], f"ListAndWatch {first}")
                t0 = time.perf_counter()
                resp = stub.Allocate(pb.AllocateRequest(container_requests=[
                    pb.ContainerAllocateRequest(devicesIDs=["gpu-0"])]), timeout=30)
                numbers["allocate_rpc_ms"] = (time.perf_counter() - t0) * 1e3
            c = resp.container_responses[0]
            check(dict(c.envs) == plan.envs and
                  [(d.container_path, d.host_path, d.permissions) for d in c.devices] ==
                  plan.devices and
                  [(m.container_path, m.host_path, m.read_only) for m in c.mounts] ==
                  plan.mounts, f"Allocate over the wire {c} != plan {plan}")
            open(trigger, "w").close()
            plugin_check = server.json_lines(1, timeout=60)[0]
        finally:
            server.stop()
        check(plugin_check == {"torch": False, "jax": False, "contexts": [False] * n_cuda},
              f"the plugin process: {plugin_check}")
        from google import protobuf
        print(json.dumps({"grpc": grpc.__version__, "protobuf": protobuf.__version__, "wire": {
            "list_and_watch": [(d.ID, d.health) for d in first.devices],
            "allocate_rpc_ms": numbers["allocate_rpc_ms"], "start_ms": ready["start_ms"],
            "process_to_inventory_s": numbers["plugin_process_to_inventory_s"],
            "self_check": plugin_check}}))

    # 6. telemetry under load: a child holds 8 GiB and runs GEMMs. The
    # exporter refreshes every 0.1 s and each scrape is bracketed by two
    # nvidia-smi samples: under a 700 W load the die's reading moves by a
    # degree or two within a second, so the exporter's value is held to
    # the band the two samples span, widened by the tolerance
    refresh_s = 0.1
    port = free_port()
    trigger = os.path.join(work, "exporter-check")
    exporter = CliProcess([], script=_SELF_CHECK + (
        f"threading.Thread(target=_self_check, args=({trigger!r},), daemon=True).start()\n"
        "from tpu_operator_torch.validator.main import main\n"
        f"sys.exit(main(['-c', 'telemetry', '--port={port}', '--sleep-interval={refresh_s}',\n"
        f"               '--handoff-dir={handoff}', '--status-dir={status_copy}']))\n"))
    stop_file = os.path.join(work, "stop-load")
    load = CliProcess([], script=(
        "import os, sys, time, torch\n"
        "hold = torch.empty(8 * 2 ** 30, dtype=torch.uint8, device='cuda')\n"
        "a = torch.randn(8192, 8192, device='cuda', dtype=torch.bfloat16)\n"
        "b = a @ a\n"
        "torch.cuda.synchronize()\n"
        "print('{\"loaded\": true}', flush=True)\n"
        "t0 = time.time()\n"
        f"while not os.path.exists({stop_file!r}) and time.time() - t0 < 60:\n"
        "    for _ in range(20):\n"
        "        b = a @ a\n"
        "    torch.cuda.synchronize()\n"))
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                scrape(port)
                break
            except OSError:
                check(exporter.proc.poll() is None and time.monotonic() < deadline,
                      f"telemetry never served: {''.join(exporter.stderr)[-2000:]}")
                time.sleep(0.1)
        load.json_lines(1, timeout=120)
        time.sleep(3.0)
        pairs = []
        for _ in range(3):
            before, got, after = smi_sample(), scrape(port), smi_sample()
            pairs.append((got, [before, after]))
            used = got['tpu_hbm_used_bytes{chip="0"}']
            check(used >= 8 * 2 ** 30, f"hbm used {used} under an 8 GiB hold")
            check_beside(used, before, after, "memory_used_bytes", rel=0.05)
            check(got['tpu_duty_cycle_percent{chip="0"}'] >= 50, f"duty cycle {got}")
            check_beside(got['tpu_power_watts{sensor="nvml/gpu0"}'], before, after, "power_w",
                         rel=0.15)
            check_beside(got['tpu_temperature_celsius{sensor="nvml/gpu0"}'], before, after,
                         "temperature_c", tol=2)
            time.sleep(0.5)
        loaded_used = pairs[-1][0]['tpu_hbm_used_bytes{chip="0"}']
        metrics = telemetry.TelemetryMetrics(handoff_dir=handoff)
        refresh_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            metrics.refresh()
            refresh_ms.append((time.perf_counter() - t0) * 1e3)
        open(stop_file, "w").close()
        load.proc.wait(timeout=120)
        gone = time.perf_counter()
        while True:
            left = scrape(port)['tpu_hbm_used_bytes{chip="0"}']
            if loaded_used - left >= 7 * 2 ** 30:
                break
            check(time.perf_counter() - gone < 2 * refresh_s + 0.5,
                  f"used bytes {left} two refreshes after the hold went ({loaded_used} held)")
            time.sleep(0.1)
        fall_s = time.perf_counter() - gone
        open(trigger, "w").close()
        exporter_check = exporter.json_lines(1, timeout=60)[0]
    finally:
        load.stop()
        exporter.stop()
    check(exporter_check == {"torch": False, "jax": False, "contexts": [False] * n_cuda},
          f"the exporter process: {exporter_check}")
    numbers["telemetry_refresh_ms_under_load"] = refresh_ms
    numbers["hbm_used_fall_s"] = fall_s
    print(json.dumps({"telemetry_under_load": [
        {"exporter": {k: v for k, v in got.items() if k.startswith(
            ("tpu_hbm", "tpu_duty", "tpu_membw", "tpu_power", "tpu_temp"))},
         "nvidia_smi_before_after": smi} for got, smi in pairs],
        "refresh_ms": refresh_ms, "after_hold": {"used_bytes": left, "fall_s": fall_s},
        "self_check": exporter_check, "card": card}))
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"device_plumbing": numbers}))
    return numbers


def _go(work: str, name: str, payload: dict) -> None:
    """Hand a runner process its next step: an atomic write of
    ``<work>/<name>``, which it polls for."""
    tmp = os.path.join(work, name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, os.path.join(work, name))


def _wait_for(predicate, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while True:
        value = predicate()
        if value:
            return value
        check(time.monotonic() < deadline, f"{what} within {timeout}s")
        time.sleep(0.02)


def last_components_phase(card, status_dir, native_build_s) -> dict:
    """Phase 11: the native binaries, driver-daemon, driver-probe,
    slice-partitioner, metrics through the native exporter, and the
    migrate agent."""
    import ctypes
    import filecmp
    import inspect
    import shutil
    import stat

    from tpu_operator_torch import consts, nvml
    from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin
    from tpu_operator_torch.health import drain
    from tpu_operator_torch.partitioner import partitioner
    from tpu_operator_torch.validator import driver, native
    from tpu_operator_torch.validator.feature_discovery import chip_type_from_kind
    from tpu_operator_torch.validator.metrics import NodeMetrics
    from tpu_operator_torch.validator.status import StatusFiles

    numbers = {"card": card}
    n_cuda = torch.cuda.device_count()
    no_context = {"torch": False, "jax": False, "contexts": [False] * n_cuda}
    work = tempfile.mkdtemp(prefix="chip-smoke-last-")
    node_name = "smoke-node"
    # the status dir is named for the node: the migrate agent's transfer
    # dir then holds this node's checkpoint at <work>/<node>/
    status_copy = os.path.join(work, node_name)
    shutil.copytree(status_dir, status_copy)
    status = StatusFiles(status_copy)
    handoff = os.path.join(work, "handoff")
    node_file = os.path.join(work, "apiserver.json")
    with open(node_file, "w") as f:
        json.dump({"node": {"apiVersion": "v1", "kind": "Node", "metadata": {
            "name": node_name, "resourceVersion": "1", "annotations": {},
            "labels": {consts.TPU_SLICE_CONFIG_LABEL: "single-gpu",
                       consts.TPU_CHIP_TYPE_LABEL: chip_type_from_kind(
                           torch.cuda.get_device_name(0))}}}, "events": []}, f)
    apiserver = FileClient(node_file)
    client_src = "import json, os\n" + inspect.getsource(FileClient)
    with nvml.session() as s:
        gpus = s.gpus()
    own_nodes = [driver.gpu_node(g.minor) for g in gpus]

    # 1. the native binaries, built with g++ in phase 2
    binaries = {name: str(native.binary_path(name)) for name in native.BINARIES}
    for name, path in binaries.items():
        check(os.access(path, os.X_OK), f"{name} was not built: {path}")
        deps = subprocess.run(["ldd", path], capture_output=True, text=True, timeout=60).stdout
        check(not re.search(r"libcuda|libnvidia|torch|python", deps), f"{name} links {deps}")
    numbers["native_build_s"] = native_build_s
    print(json.dumps({"native_build": {"seconds": native_build_s, "binaries": binaries}}))

    # 2. driver-daemon: the machine's own driver libraries, bundled as an
    # operand image would bundle them, installed into a fresh dir
    host_dir = os.path.dirname(driver.find_host_driver() or fail("no host libcuda.so.1"))
    bundle = os.path.join(work, "bundle")
    os.makedirs(bundle)
    for name in consts.DRIVER_LIB_FILES:
        real = os.path.realpath(os.path.join(host_dir, name))
        check(os.path.isfile(real), f"the host's {name}: {real}")
        os.symlink(real, os.path.join(bundle, name))
    install_dir = os.path.join(work, "driver-install")
    cdi_dir = os.path.join(work, "cdi")
    smi_version = subprocess.run(["nvidia-smi", "--query-gpu=driver_version",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60).stdout.split()[0]
    trigger = os.path.join(work, "daemon-check")
    daemon = CliProcess([], script=_SELF_CHECK + (
        f"os.environ.update({{{consts.DRIVER_SRC_ENV!r}: {bundle!r}, "
        f"{consts.CDI_ENABLED_ENV!r}: '1', {consts.CDI_DIR_ENV!r}: {cdi_dir!r}}})\n"
        f"os.environ.pop({consts.DRIVER_VERSION_ENV!r}, None)\n"
        "from tpu_operator_torch.validator import driver\n"
        "from tpu_operator_torch.validator.status import StatusFiles\n"
        "start = time.time()\n"
        "t0 = time.perf_counter()\n"
        f"rc = driver.daemon({install_dir!r}, status=StatusFiles({status_copy!r}), "
        "heartbeat_interval=0.2, max_beats=2)\n"
        "print(json.dumps({'rc': rc, 'start': start, 'daemon_s': time.perf_counter() - t0}),\n"
        "      flush=True)\n"
        f"_self_check({trigger!r})\n"))
    try:
        ran = daemon.json_lines(1, timeout=120)[0]
        open(trigger, "w").close()
        daemon_check = daemon.json_lines(1, timeout=60)[0]
    finally:
        daemon.stop()
    check(ran["rc"] == 0, f"driver-daemon exited {ran['rc']}: {''.join(daemon.stderr)[-2000:]}")
    barrier = status.read("driver")
    check(barrier["libtpu"] == os.path.join(install_dir, consts.DRIVER_LIB), f"{barrier}")
    check(barrier["libtpu_version"] == smi_version,
          f"the barrier's driver version {barrier['libtpu_version']}, nvidia-smi's {smi_version}")
    check(barrier["devices"] == own_nodes, f"the barrier's devices {barrier['devices']}")
    check(status.read("driver-heartbeat")["beat"] == 1, "two heartbeats")
    copied = 0
    for name in consts.DRIVER_LIB_FILES:
        dst = os.path.join(install_dir, name)
        check(os.path.isfile(dst) and not os.path.islink(dst), f"{dst} is not a file")
        check(filecmp.cmp(dst, os.path.join(bundle, name), shallow=False), f"{dst} differs")
        copied += os.path.getsize(dst)
    check(sorted(os.listdir(install_dir)) == sorted(consts.DRIVER_LIB_FILES),
          f"left in the install dir: {os.listdir(install_dir)}")
    check(len(os.listdir(cdi_dir)) == 1, f"the daemon's CDI spec: {os.listdir(cdi_dir)}")
    check(daemon_check == no_context, f"the driver-daemon process: {daemon_check}")
    numbers["driver_daemon"] = {"install_s": barrier["timestamp"] - ran["start"],
                                "bytes_copied": copied, "daemon_s": ran["daemon_s"]}
    print(json.dumps({"driver_daemon": {**numbers["driver_daemon"], "version": smi_version,
                                        "self_check": daemon_check}}))

    # 3. driver-probe: the native binary, then the component's process
    probe = binaries["gpu-probe"]
    out = subprocess.run([probe, f"--install-dir={install_dir}", "--json"],
                         capture_output=True, text=True, timeout=30)
    answer = json.loads(out.stdout)
    check(out.returncode == 0 and answer == {
        "ok": True, "libtpu": {"path": os.path.join(install_dir, consts.DRIVER_LIB), "ok": True},
        "devices": own_nodes}, f"gpu-probe --json: {out.returncode} {out.stdout}")
    empty = os.path.join(work, "empty")
    os.makedirs(empty)
    check(subprocess.run([probe, f"--install-dir={empty}"], capture_output=True,
                         timeout=30).returncode == 1, "gpu-probe on an empty dir")
    native_ms = []
    for _ in range(50):
        t0 = time.perf_counter()
        rc = subprocess.run([probe, f"--install-dir={install_dir}"], timeout=30).returncode
        native_ms.append((time.perf_counter() - t0) * 1e3)
        check(rc == 0, f"gpu-probe exited {rc}")
    cli = [sys.executable, "-m", "tpu_operator_torch.cmd.validator", "-c", "driver-probe",
           f"--status-dir={status_copy}"]
    python_ms = []
    for target, want in ((install_dir, 0),) * 5 + ((empty, 1),):
        t0 = time.perf_counter()
        rc = subprocess.run(cli + [f"--install-dir={target}"], capture_output=True,
                            timeout=120, cwd=os.path.dirname(os.path.abspath(__file__))).returncode
        if want == 0:
            python_ms.append((time.perf_counter() - t0) * 1e3)
        check(rc == want, f"-c driver-probe on {target} exited {rc}, not {want}")
    # the same execs from a process without torch and a CUDA context, as a
    # kubelet's probe is not forked from one
    probe_check = subprocess.run([sys.executable, "-c", _SELF_CHECK + (
        "import statistics, subprocess\n"
        "ms = []\n"
        "for _ in range(50):\n"
        "    t0 = time.perf_counter()\n"
        f"    rc = subprocess.run([{probe!r}, '--install-dir={install_dir}']).returncode\n"
        "    ms.append((time.perf_counter() - t0) * 1e3)\n"
        "    assert rc == 0, rc\n"
        "print(json.dumps({'native_ms': ms}), flush=True)\n"
        "from tpu_operator_torch.validator.main import main\n"
        f"rc = main(['-c', 'driver-probe', '--install-dir={install_dir}', "
        f"'--status-dir={status_copy}'])\n"
        f"open({trigger + '-probe'!r}, 'w').close()\n"
        f"_self_check({trigger + '-probe'!r})\n")], capture_output=True, text=True,
        timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(probe_check.returncode == 0, f"the probe process: {probe_check.stderr[-2000:]}")
    light, probe_self = [json.loads(ln) for ln in probe_check.stdout.splitlines()
                         if ln.startswith("{")]
    check(probe_self == no_context, f"the driver-probe process: {probe_self}")
    numbers["driver_probe"] = {
        "native_median_ms": statistics.median(native_ms),
        "native_ms_min_max": [min(native_ms), max(native_ms)],
        "native_from_torch_free_median_ms": statistics.median(light["native_ms"]),
        "native_from_torch_free_min_max": [min(light["native_ms"]), max(light["native_ms"])],
        "python_process_median_ms": statistics.median(python_ms)}
    print(json.dumps({"driver_probe": {**numbers["driver_probe"], "json": answer,
                                       "self_check": probe_self}}))

    # 4. slice-partitioner passes in one fresh process, each on a go file
    lib = nvml.library()
    with nvml.session() as s:
        h0 = s.handle(0)
        level, p2p = ctypes.c_int(-1), ctypes.c_int(-1)
        ancestor_rc = lib.nvmlDeviceGetTopologyCommonAncestor(h0, h0, ctypes.byref(level))
        p2p_rc = lib.nvmlDeviceGetP2PStatus(h0, h0, nvml.P2P_CAPS_INDEX_NVLINK,
                                            ctypes.byref(p2p))
        links = s.links(s.gpus())
    numbers["nvml_gpu_with_itself"] = {
        "topology_common_ancestor": {"return": ancestor_rc, "level": level.value},
        "p2p_nvlink": {"return": p2p_rc, "status": p2p.value}}
    mig = subprocess.run(["nvidia-smi", "--query-gpu=mig.mode.current", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.split()
    print(json.dumps({"nvml_links": links, **numbers["nvml_gpu_with_itself"], "mig_mode": mig}))
    trigger = os.path.join(work, "partitioner-check")
    runner = CliProcess([], script=_SELF_CHECK + client_src + (
        "from tpu_operator_torch.partitioner import partitioner\n"
        f"client = FileClient({node_file!r})\n"
        "step = 0\n"
        "while True:\n"
        f"    go = os.path.join({work!r}, f'partition-{{step}}')\n"
        "    while not os.path.exists(go):\n"
        "        time.sleep(0.01)\n"
        "    args = json.load(open(go))\n"
        "    if args.get('stop'):\n"
        "        break\n"
        "    t0 = time.perf_counter()\n"
        f"    state = partitioner.sync_once(client, {node_name!r}, None, {handoff!r},\n"
        f"                                  status_dir={status_copy!r},\n"
        "                                  drain_deadline_s=args['drain_deadline_s'])\n"
        "    print(json.dumps({'state': state, 'ms': (time.perf_counter() - t0) * 1e3}),\n"
        "          flush=True)\n"
        "    step += 1\n"
        f"_self_check({trigger!r})\n"))
    plugin = GPUDevicePlugin(plugin_dir=os.path.join(work, "kubelet"), status_dir=status_copy,
                             handoff_dir=handoff)
    passes = []

    def partition_pass(drain_deadline_s: int, want: str) -> dict:
        _go(work, f"partition-{len(passes)}", {"drain_deadline_s": drain_deadline_s})
        result = runner.json_lines(1, timeout=60)[0]
        passes.append(result)
        label = apiserver.get("v1", "Node", node_name)["metadata"]["labels"].get(
            consts.TPU_SLICE_STATE_LABEL)
        check(result["state"] == want == label,
              f"partition pass {len(passes)}: {result['state']}, label {label}, not {want}")
        plugin.refresh_units()
        return partitioner.read_handoff(handoff)

    singles = [{"topology": "single", "chips": [i]} for i in range(n_cuda)]
    kept = open(status.path("workload"), "rb").read()
    try:
        applied = partition_pass(0, "success")
        check(applied["groups"] == singles and "blocked" not in applied, f"handoff {applied}")
        units = plugin._snapshot()
        check([(u.id, u.health) for u in units] ==
              [(f"gpu-part-{i}", "Healthy") for i in range(n_cuda)], f"units {units}")
        plan = plugin.allocation_plan(["gpu-part-0"])
        check(plan.devices[0][1] == own_nodes[0] and
              stat.S_ISCHR(os.stat(plan.devices[0][1]).st_mode), f"devices {plan.devices}")
        check(plan.envs["CUDA_VISIBLE_DEVICES"] == gpus[0].uuid, f"envs {plan.envs}")
        pod = pod_sweep(plan, os.path.join(work, "pod-status"))
        # a barrier failing GPU 0, with the coordinated drain on: deferred
        # for the workload's ack, the handoff intact
        status.write("workload", {"passed": False, "n_devices": n_cuda,
                                  "local_chips": list(range(n_cuda)), "failed_local_chips": [0],
                                  "details": {"compute": {"passed": False, "failed_chips": [0]}}})
        before = open(os.path.join(handoff, partitioner.HANDOFF_FILE), "rb").read()
        partition_pass(60, "pending")
        check(open(os.path.join(handoff, partitioner.HANDOFF_FILE), "rb").read() == before,
              "the deferred pass touched the handoff")
        gated = [(u.id, u.health) for u in plugin._snapshot()]
        check(gated[0] == ("gpu-part-0", "Unhealthy"), f"units while deferred {gated}")
        # the published plan's deadline passed: the re-tile is forced; with
        # count "all" the reference's semantics scale the layout down to
        # the healthy GPUs, here none, and the plugin falls back to one
        # gated unit per GPU
        apiserver.patch("v1", "Node", node_name, {"metadata": {"annotations": {
            consts.RETILE_PLAN_ANNOTATION: drain.RetilePlan(
                fingerprint=drain.plan_fingerprint("single-gpu", [0]),
                deadline=time.time() - 1, reason="retile", blocked=[0]).to_json()}}})
        retiled = partition_pass(60, "retiled")
        check(retiled["blocked"] == [0] and retiled["groups"] == singles[1:],
              f"re-tiled handoff {retiled}")
        forced = [(u.id, u.health) for u in plugin._snapshot()]
        check(forced == ([(f"gpu-part-{i}", "Healthy") for i in range(n_cuda - 1)]
                         if n_cuda > 1 else [("gpu-0", "Unhealthy")]),
              f"units after the re-tile {forced}")
        # recovery: the barrier passes again
        with open(status.path("workload"), "wb") as f:
            f.write(kept)
        restored = partition_pass(60, "success")
        check(restored["groups"] == singles and "blocked" not in restored,
              f"restored handoff {restored}")
        check([(u.id, u.health) for u in plugin._snapshot()] ==
              [(f"gpu-part-{i}", "Healthy") for i in range(n_cuda)], "units not restored")
        _go(work, f"partition-{len(passes)}", {"stop": True})
        open(trigger, "w").close()
        partitioner_check = runner.json_lines(1, timeout=60)[0]
    finally:
        runner.stop()
    check(partitioner_check == no_context, f"the partitioner process: {partitioner_check}")
    numbers["partitioner"] = {"pass_ms": [p["ms"] for p in passes],
                              "states": [p["state"] for p in passes],
                              "pod_sweep_elapsed_s": pod["elapsed_s"]}
    print(json.dumps({"slice_partitioner": {**numbers["partitioner"], "applied": applied,
                                            "retiled": retiled, "units_forced": forced,
                                            "self_check": partitioner_check}}))

    # 5. metrics: gpu-exporter beside the Python exporter, then -c metrics,
    # which execs it
    refresh = "tpu_operator_node_metrics_last_refresh_ts_seconds "

    def lines(text: str) -> list:
        return [ln for ln in text.splitlines() if not ln.startswith(refresh)]

    exporter = binaries["gpu-exporter"]
    oneshot = subprocess.run([exporter, "--oneshot", f"--status-dir={status_copy}"],
                             capture_output=True, text=True, timeout=30)
    python = NodeMetrics(status)
    python.refresh()
    check(oneshot.returncode == 0 and lines(oneshot.stdout) == lines(python.scrape().decode()),
          f"gpu-exporter --oneshot differs:\n{oneshot.stdout}\n--\n{python.scrape().decode()}")
    port = free_port()
    served_by = CliProcess(["-c", "metrics", f"--port={port}", f"--status-dir={status_copy}"])
    try:
        text = _wait_for(lambda: _try_scrape(port), 60, "-c metrics serving")
        exe = os.path.realpath(f"/proc/{served_by.proc.pid}/exe")
        maps = open(f"/proc/{served_by.proc.pid}/maps").read()
    finally:
        served_by.stop()
    python.refresh()
    check(lines(text) == lines(python.scrape().decode()), "-c metrics serves other text")
    check(exe == os.path.realpath(exporter), f"-c metrics runs {exe}, not {exporter}")
    check(not re.search(r"libcuda|libnvidia|libtorch|libpython", maps),
          "the exporter process maps a CUDA, torch or Python library")
    numbers["metrics_families"] = sum(ln.startswith("# TYPE") for ln in text.splitlines())
    print(json.dumps({"metrics": {"native_equals_python": True, "exec": exe,
                                  "families": numbers["metrics_families"]}}))

    # 6. the migrate agent's loop: a snapshot, then a restore on this node
    with open(os.path.join(status_copy, consts.MIGRATE_PROCESS_STATE_FILE), "w") as f:
        json.dump({"step": 123, "rng_state": [1, 2, 3], "partition": "single-gpu",
                   "blocked": [], "groups": singles}, f)
    trigger = os.path.join(work, "migrate-check")
    agent_proc = CliProcess([], script=_SELF_CHECK + client_src + (
        f"os.environ['GPU_MIGRATE_TRANSFER_DIR'] = {work!r}\n"
        f"threading.Thread(target=_self_check, args=({trigger!r},), daemon=True).start()\n"
        "from tpu_operator_torch.migrate import agent\n"
        "from tpu_operator_torch.validator.status import StatusFiles\n"
        f"agent.run(FileClient({node_file!r}), {node_name!r}, StatusFiles({status_copy!r}),\n"
        "          sleep_interval=0.05)\n"))

    def annotation(key):
        raw = apiserver.get("v1", "Node", node_name)["metadata"]["annotations"].get(key)
        return json.loads(raw) if raw else None

    try:
        t0 = time.perf_counter()
        apiserver.patch("v1", "Node", node_name, {"metadata": {"annotations": {
            consts.MIGRATE_SNAPSHOT_REQUEST_ANNOTATION: json.dumps({"plan": "smoke-snapshot"})}}})
        snap = _wait_for(lambda: annotation(consts.MIGRATE_SNAPSHOT_RESULT_ANNOTATION), 120,
                         "the snapshot result")
        snapshot_s = time.perf_counter() - t0
        taken = drain.load_checkpoint(drain.checkpoint_path(status_copy))
        t0 = time.perf_counter()
        apiserver.patch("v1", "Node", node_name, {"metadata": {"annotations": {
            consts.MIGRATION_INBOUND_ANNOTATION: json.dumps(
                {"plan": "smoke-restore", "src": node_name, "step": 123})}}})
        restore = _wait_for(lambda: annotation(consts.MIGRATION_RESTORE_ANNOTATION), 60,
                            "the restore result")
        restore_s = time.perf_counter() - t0
        open(trigger, "w").close()
        agent_check = agent_proc.json_lines(1, timeout=60)[0]
    finally:
        agent_proc.stop()
    check(snap["ok"] and snap["step"] == 123 and snap["plan"] == "smoke-snapshot", f"{snap}")
    check(taken["step"] == 123 and taken["transparent"] is True and taken["version"] == 2,
          f"the snapshot's checkpoint {taken}")
    check(restore == {"plan": "smoke-restore", "ok": True, "step": 123, "src": node_name},
          f"the restore's result {restore}")
    landed = drain.load_checkpoint(drain.checkpoint_path(status_copy))
    check(landed["step"] == 123 and landed["migrated_from"] == node_name and
          [sh["chips"] for sh in landed["manifest"]["shards"]] == [[i] for i in range(n_cuda)] and
          landed["manifest"]["layout"] == drain.plan_fingerprint("single-gpu", []),
          f"the restored checkpoint {landed}")
    stamps = status.read("workload")
    check(stamps["migrate_snapshot"]["step"] == stamps["migrate_restore"]["step"] == 123,
          f"the barrier's migration stamps {stamps}")
    check(agent_check == no_context, f"the migrate-agent process: {agent_check}")
    numbers["migrate"] = {"snapshot_s": snapshot_s, "restore_s": restore_s}
    print(json.dumps({"migrate_agent": {**numbers["migrate"], "manifest": landed["manifest"],
                                        "self_check": agent_check, "card": card}}))
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"last_components": numbers}))
    return numbers


class Milestones:
    """The first time, in seconds from ``t0``, each named predicate held,
    polled on a thread every 50 ms."""

    def __init__(self, t0: float, predicates: dict):
        self.t0 = t0
        self.predicates = predicates
        self.seen: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self) -> None:
        while not self._stop.wait(0.05):
            for name, predicate in self.predicates.items():
                if name not in self.seen:
                    try:
                        if predicate():
                            self.seen[name] = round(time.time() - self.t0, 3)
                    except Exception:  # a read racing a write: try again
                        pass

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=10)
        return dict(self.seen)


def _report_line(text: str, key: str):
    """The last JSON object line of a component's log that holds ``key``."""
    for line in reversed(text.splitlines()):
        if line.startswith("{") and key in line:
            with contextlib.suppress(ValueError):
                return json.loads(line)
    return None


def operator_phase(card, then=None) -> dict:
    """Phase 12: ``gpu-operator`` reconciles the port's sample ClusterPolicy
    onto this machine as a one-node cluster, and a process kubelet runs the
    DaemonSets it renders, the validation chain and its spawned workload pod
    on the card. ``then(ctx)``, when given, runs on that cluster once it is
    ``ready`` again (phase 13, :func:`gpudriver_phase`)."""
    import shutil

    from tpu_operator_torch import consts, nvml
    from tpu_operator_torch.testing.apiserver import MiniApiServer
    from tpu_operator_torch.testing.kubelet import INIT, RUN, ProcessKubelet
    from tpu_operator_torch.validator import driver

    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip-smoke-operator-")
    node_name = re.sub(r"[^a-z0-9.-]", "-", socket.gethostname().lower()).strip("-.") or "node"
    with nvml.session() as s:
        gpu_count = len(s.gpus())
    # the driver image's content: the machine's own driver libraries
    host_dir = os.path.dirname(driver.find_host_driver() or fail("no host libcuda.so.1"))
    bundle = os.path.join(work, "bundle")
    os.makedirs(bundle)
    for name in consts.DRIVER_LIB_FILES:
        os.symlink(os.path.realpath(os.path.join(host_dir, name)), os.path.join(bundle, name))
    status_dir = os.path.join(work, "status")
    cp = json.load(open(os.path.join(repo, "tpu_operator_torch", "manifests", "samples",
                                     "v1_clusterpolicy.json")))
    cp["spec"]["hostPaths"] = {
        "validationStatusDir": status_dir,
        "partitionHandoffDir": os.path.join(work, "handoff"),
        "driverInstallDir": os.path.join(work, "driver-install"),
        "devGlobs": os.environ["GPU_DEV_GLOBS"].split(","),
    }
    cp["spec"]["validator"]["revalidateIntervalS"] = 0
    # the health machine stays off until phase 14: the flip below measures
    # the barrier's own path, with no health writes mixed in
    cp["spec"]["health"] = {"enabled": False}
    # feature discovery mirrors the node's spans on its interval: 5 s in
    # place of 60, so the operator's join trace holds them soon after ready
    cp["spec"]["featureDiscovery"]["sleepInterval"] = "5s"
    cp["spec"]["telemetry"]["metricsPort"] = free_port()
    cp["spec"]["nodeStatusExporter"]["metricsPort"] = free_port()

    srv = MiniApiServer()
    base = srv.start()
    srv.backend.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": node_name, "labels": {consts.NFD_NVIDIA_PCI_LABEL: "true",
                                      "kubernetes.io/hostname": node_name}}})
    metrics_port, health_port = free_port(), free_port()
    operator_log = os.path.join(work, "operator.log")
    operator = subprocess.Popen(
        [sys.executable, "-m", "tpu_operator_torch.cmd.operator", f"--api-server={base}",
         f"--namespace={consts.DEFAULT_NAMESPACE}", f"--metrics-port={metrics_port}",
         f"--health-port={health_port}"],
        cwd=repo, stdout=open(operator_log, "w"), stderr=subprocess.STDOUT,
        start_new_session=True,
        env={k: v for k, v in os.environ.items() if not k.startswith("GPU_")})
    # the join's apiserver load: the operator's (through its informer cache)
    # and the node agents'; the kubelet reads the backend in process
    srv.requests.clear()
    base_env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LD_LIBRARY_PATH",
                                           "CUDA_HOME") if k in os.environ}
    base_env.update(PYTHONPATH=repo, KUBE_API_URL=base)
    kubelet = ProcessKubelet(
        srv.backend, node_name, consts.DEFAULT_NAMESPACE, os.path.join(work, "logs"), base_env,
        {"gpu-validator": [sys.executable, "-m", "tpu_operator_torch.cmd.validator"]},
        modes={"gpu-driver": RUN, "gpu-operator-validator": RUN, "gpu-device-plugin": INIT,
               "gpu-feature-discovery": RUN, "gpu-telemetry-exporter": RUN,
               "gpu-node-status-exporter": RUN},
        image_env={"gpu-driver": {consts.DRIVER_SRC_ENV: bundle}},
        capacity_app="gpu-device-plugin", gpu_count=gpu_count,
        path_map={"/var/cache/gpu-kernels": os.path.join(work, "kernel-cache")})

    def policy_state():
        live = srv.backend.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        return (live.get("status") or {}).get("state")

    def node():
        return srv.backend.get("v1", "Node", node_name)

    def barrier(name):
        path = os.path.join(status_dir, f"{name}-ready")
        return os.path.exists(path)

    enabled = 6  # driver, validator, device plugin, feature discovery, telemetry, exporter
    numbers = {"card": card, "node": node_name, "gpus": gpu_count}
    try:
        kubelet.start()
        t0 = time.time()
        srv.backend.create(cp)
        milestones = Milestones(t0, {
            "node labelled": lambda: node()["metadata"].get("labels", {}).get(
                consts.GPU_PRESENT_LABEL) == "true",
            "DaemonSets created": lambda: len(srv.backend.list(
                "apps/v1", "DaemonSet", consts.DEFAULT_NAMESPACE)) >= enabled,
            "driver barrier": lambda: barrier("driver"),
            "nvidia.com/gpu allocatable": lambda: int(node().get("status", {}).get(
                "allocatable", {}).get(consts.GPU_RESOURCE_NAME, 0)) > 0,
            "plugin barrier": lambda: barrier("plugin"),
            "workload barrier": lambda: barrier("workload"),
            "workload pod Succeeded": lambda: kubelet.first("pod-exit", phase="Succeeded"),
            "ClusterPolicy ready": lambda: policy_state() == "ready",
        })
        _wait_for(lambda: "ClusterPolicy ready" in milestones.seen, 600, "ClusterPolicy ready")
        seen = milestones.stop()
        for name in milestones.predicates:
            check(name in seen, f"no time for {name!r}: {seen}")
        # the in-pod sweep writes the workload barrier, then its pod exits
        order = ["node labelled", "DaemonSets created", "driver barrier",
                 "nvidia.com/gpu allocatable", "plugin barrier", "workload barrier",
                 "workload pod Succeeded", "ClusterPolicy ready"]
        check([seen[k] for k in order] == sorted(seen[k] for k in order),
              f"join out of order: {seen}")
        status = {name: json.load(open(os.path.join(status_dir, f"{name}-ready")))
                  for name in ("driver", "plugin", "workload")}
        check(status["workload"].get("passed") and status["workload"].get("platform") == "gpu",
              f"workload barrier {status['workload']}")
        check(status["plugin"].get("count") == gpu_count, f"plugin barrier {status['plugin']}")
        check(status["driver"].get("libtpu") == os.path.join(
            cp["spec"]["hostPaths"]["driverInstallDir"], consts.DRIVER_LIB),
            f"driver barrier {status['driver']}")
        simulated = sorted(e["ds"] for e in kubelet.events if e["kind"] == "simulated")
        partial = [(e["ds"], e["simulated_containers"]) for e in kubelet.events
                   if e["kind"] == "ready" and e.get("simulated_containers")]
        print(f"simulated (not run): DaemonSets {simulated}; main containers {partial}")
        # each validator process's own numbers, from its output
        spawned = kubelet.spawned_logs()
        sweep = next((r for r in (_report_line(t, '"elapsed_s"') for t in spawned.values())
                      if r), None)
        check(sweep is not None, f"no sweep report from the workload pod: {spawned}")
        logs = kubelet.logs("gpu-operator-validator")
        warmed = re.search(r"build cache warmed in ([0-9.]+)s", logs.get("plugin-validation", ""))
        processes = {}
        for e in kubelet.events:
            if e["kind"] == "init-exit":
                start = max(x["t"] for x in kubelet.events if x["kind"] == "init-start"
                            and x["ds"] == e["ds"] and x["container"] == e["container"]
                            and x["t"] <= e["t"])
                processes[f"{e['ds']}/{e['container']}"] = round(e["t"] - start, 3)
        text = _try_scrape(metrics_port) or ""
        reconciles = scrape_samples(text).get("tpu_operator_reconciliation_total")
        with open(f"/proc/{operator.pid}/maps") as f:
            maps = f.read()
        operator_torch = "libtorch" in maps
        operator_cuda = "libcuda" in maps
        check(not operator_torch and not operator_cuda,
              f"the operator process maps torch ({operator_torch}) or libcuda ({operator_cuda})")
        requests = srv.request_counts()
        numbers.update({
            "apiserver_requests_to_ready": {k: requests.get(k, 0) for k in (
                "GET", "LIST", "WATCH", "write")},
            "apiserver_requests_by_kind": {f"{verb} {kind}": n for (verb, kind), n in
                                           sorted(srv.requests.items())},
            "join_s": seen,
            "process_wall_s": processes,
            "workload_pod": {"elapsed_s": sweep.get("elapsed_s"),
                             "compile_s": sweep.get("compile_s"),
                             "platform": sweep.get("platform"),
                             "n_devices": sweep.get("n_devices")},
            "prewarm_compile_s": float(warmed.group(1)) if warmed else None,
            "reconciles_to_ready": reconciles,
            "operator_maps_torch": operator_torch, "operator_maps_libcuda": operator_cuda,
            "simulated": simulated,
        })
        print(json.dumps({"operator_join": numbers}))
        numbers["critical_path"] = join_critical_path(
            health_port, metrics_port, node_name, t0, seen["ClusterPolicy ready"], card)

        # a failing workload barrier holds the CR notReady; a passing rerun
        # restores it. The recycle alone makes the validator DaemonSet
        # unavailable, so notReady comes at once (not_ready_s times the
        # recycle, not the barrier); what the failed barrier shows is that
        # the failed init holds the DaemonSet at no available pod, and the
        # CR notReady, across a back-off rerun that fails again
        t1 = time.time()
        kubelet.pod_env = {"CUDA_VISIBLE_DEVICES": ""}  # the pod is allocated no GPU
        kubelet.restart("gpu-operator-validator")
        _wait_for(lambda: policy_state() == "notReady", 300, "notReady after the recycle")
        t_not_ready = round(time.time() - t1, 3)
        _wait_for(lambda: kubelet.first("pod-exit", after=t1, phase="Failed"), 300,
                  "a failed workload pod")
        _wait_for(lambda: json.load(open(os.path.join(status_dir, "workload-ready")))
                  .get("passed") is False, 300, "the failed workload barrier")
        check(policy_state() == "notReady", "ready with a failed workload barrier")
        t_failed = round(time.time() - t1, 3)
        failed = dict(kind="init-exit", ds="gpu-operator-validator",
                      container="workload-validation", rc=1)
        held = 0
        deadline = time.monotonic() + 300
        while len(kubelet.matching(after=t1, **failed)) < 2:
            ds = srv.backend.get("apps/v1", "DaemonSet", "gpu-operator-validator",
                                 consts.DEFAULT_NAMESPACE)
            available = (ds.get("status") or {}).get("numberAvailable")
            check(available == 0 and policy_state() == "notReady",
                  f"after the failed barrier: numberAvailable {available}, "
                  f"state {policy_state()}")
            check(time.monotonic() < deadline, "a failed back-off rerun within 300s")
            held += 1
            time.sleep(0.05)
        first = kubelet.matching(after=t1, **failed)[0]
        check(kubelet.first("init-start", after=first["t"], ds="gpu-operator-validator",
                            container="workload-validation"), "no back-off rerun")
        t_rerun_failed = round(time.time() - t1, 3)
        kubelet.pod_env = None
        _wait_for(lambda: policy_state() == "ready", 300, "ready after a passing rerun")
        t_ready = round(time.time() - t1, 3)
        restored = json.load(open(os.path.join(status_dir, "workload-ready")))
        check(restored.get("passed") and restored.get("platform") == "gpu",
              f"restored barrier {restored}")
        text = _try_scrape(metrics_port) or ""
        numbers["flip"] = {"not_ready_s": t_not_ready, "failed_barrier_s": t_failed,
                           "rerun_failed_s": t_rerun_failed, "held_polls": held,
                           "ready_again_s": t_ready,
                           "reconciles_total": scrape_samples(text).get(
                               "tpu_operator_reconciliation_total")}
        print(json.dumps({"operator_flip": numbers["flip"], "card": card}))
        if then is not None:
            then(types.SimpleNamespace(
                srv=srv, base=base, kubelet=kubelet, namespace=consts.DEFAULT_NAMESPACE,
                node_name=node_name, repo=repo, work=work, card=card, operator=operator,
                operator_env={k: v for k, v in os.environ.items() if not k.startswith("GPU_")},
                driver_env={consts.DRIVER_SRC_ENV: bundle}))
    except SystemExit:
        print(f"-- operator log:\n{open(operator_log).read()[-6000:]}", file=sys.stderr)
        for ds in ("gpu-driver", "gpu-operator-validator", "gpu-device-plugin"):
            for name, text in kubelet.logs(ds).items():
                print(f"-- {ds}/{name}:\n{text[-3000:]}", file=sys.stderr)
        for name, text in kubelet.spawned_logs().items():
            print(f"-- pod {name}:\n{text[-3000:]}", file=sys.stderr)
        print(f"-- kubelet events: {kubelet.events}", file=sys.stderr)
        raise
    finally:
        kubelet.stop()
        with contextlib.suppress(ProcessLookupError):
            os.killpg(operator.pid, signal.SIGKILL)
        operator.wait(timeout=60)
        srv.stop()
        shutil.rmtree(work, ignore_errors=True)
    return numbers


class _Operator:
    """``gpu-operator`` in its own process group, logging to a file."""

    def __init__(self, ctx, log_path: str, extra: tuple = ()):
        self.metrics_port, self.health_port = free_port(), free_port()
        self.log_path = log_path
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_operator_torch.cmd.operator", f"--api-server={ctx.base}",
             f"--namespace={ctx.namespace}", f"--metrics-port={self.metrics_port}",
             f"--health-port={self.health_port}", *extra],
            cwd=ctx.repo, stdout=open(log_path, "w"), stderr=subprocess.STDOUT,
            start_new_session=True, env=ctx.operator_env)

    def readyz(self) -> dict:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.health_port}/readyz",
                                        timeout=2) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            return json.loads(e.read())
        except (OSError, ValueError):
            return {}

    def is_leader(self) -> bool:
        return bool((self.readyz().get("leader") or {}).get("is_leader"))

    def maps(self) -> tuple:
        return _maps(self.proc.pid)

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def stop(self) -> None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGCONT)
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait(timeout=60)


def _maps(pid: int) -> tuple:
    """Whether a process maps torch's and the CUDA driver's libraries."""
    with open(f"/proc/{pid}/maps") as f:
        text = f.read()
    return "libtorch" in text, "libcuda" in text


def _gpuop_cfg(ctx, *argv) -> dict:
    """``gpuop-cfg`` in a fresh process that reports, as it exits, whether
    it maps torch or libcuda."""
    script = ("import sys\n"
              "from tpu_operator_torch.cmd.cfg import main\n"
              "rc = main(sys.argv[1:])\n"
              "maps = open('/proc/self/maps').read()\n"
              "print('MAPS', 'libtorch' in maps, 'libcuda' in maps)\n"
              "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", script, *argv], cwd=ctx.repo,
                         env=ctx.operator_env, capture_output=True, text=True, timeout=120)
    last = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    return {"rc": out.returncode, "out": out.stdout, "err": out.stderr, "maps_line": last}


def gpudriver_phase(ctx) -> dict:
    """Phase 13, on phase 12's cluster once it is ``ready`` again: the
    sample GPUDriver takes the driver DaemonSet over from the ClusterPolicy
    (one DaemonSet for the node's GPU-model pool, its installer run by the
    kubelet), a second GPUDriver selecting the same node conflicts, two
    invalid GPUDrivers are refused with 422, deleting the GPUDriver hands
    the driver back, then two ``gpu-operator --leader-elect`` replicas: the
    standby takes over from a stopped leader, and the old leader, resumed,
    has its writes refused by the fence and exits. ``gpuop-cfg status``
    and ``validate``; no operator process and no ``gpuop-cfg`` maps torch
    or libcuda.

    ``ctx``: the running cluster (``srv``, ``base``, ``kubelet``,
    ``namespace``, ``node_name``, ``repo``, ``work``, ``card``), phase 12's
    operator process (``operator``, stopped here), the env operator
    processes run with (``operator_env``) and the env the driver image
    gives its installer (``driver_env``)."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.client.errors import NotFoundError
    from tpu_operator_torch.conditions import ERROR, get_condition
    from tpu_operator_torch.controllers.gpudriver_controller import pool_app_name
    from tpu_operator_torch.state.nodepool import get_node_pools
    from tpu_operator_torch.testing.kubelet import RUN

    srv, kubelet, ns, backend = ctx.srv, ctx.kubelet, ctx.namespace, ctx.srv.backend
    numbers = {"card": ctx.card}
    started = time.monotonic()

    def get(api_version, kind, name, namespace=None):
        try:
            return backend.get(api_version, kind, name, namespace)
        except NotFoundError:
            return None

    def cp_state():
        return ((get("tpu.ai/v1", "ClusterPolicy", "cluster-policy") or {}).get("status")
                or {}).get("state")

    def driver_status(name):
        return (get("tpu.ai/v1alpha1", "GPUDriver", name) or {}).get("status") or {}

    def ds(name):
        return get("apps/v1", "DaemonSet", name, ns)

    def available(name):
        return ((ds(name) or {}).get("status") or {}).get("numberAvailable") == 1

    def since(t0, predicate, timeout, what) -> float:
        _wait_for(predicate, timeout, what)
        return round(time.time() - t0, 3)

    sample = json.load(open(os.path.join(ctx.repo, "tpu_operator_torch", "manifests", "samples",
                                         "v1alpha1_gpudriver.json")))
    name = sample["metadata"]["name"]
    check(sample["spec"].get("nodeSelector") == {}, "the sample GPUDriver selects every GPU node")
    pools = get_node_pools([backend.get("v1", "Node", ctx.node_name)])
    check(len(pools) == 1 and pools[0].node_names == [ctx.node_name], f"pools {pools}")
    pool = pools[0].name
    app = pool_app_name(name, pool)
    kubelet.modes[app] = RUN
    kubelet.image_env[app] = ctx.driver_env
    check(cp_state() == "ready", f"phase 13 starts from ready, not {cp_state()}")

    # 1. hand-over
    t0 = time.time()
    backend.create(sample)
    hand = {
        "clusterpolicy_driver_deleted_s": since(t0, lambda: ds("gpu-driver") is None, 120,
                                                "the ClusterPolicy's driver DaemonSet deleted"),
        "pool_daemonset_created_s": since(t0, lambda: ds(app) is not None, 120,
                                          f"DaemonSet {app}"),
    }
    labels = ds(app)["metadata"].get("labels") or {}
    check(labels.get(consts.DRIVER_INSTANCE_LABEL) == name
          and labels.get(consts.NODE_POOL_LABEL) == pool, f"{app} labels {labels}")
    args = ds(app)["spec"]["template"]["spec"]["containers"][0]["args"]
    check(args[:2] == ["-c", "driver-daemon"], f"{app} runs {args}")
    hand["installer_probe_passed_s"] = since(
        t0, lambda: kubelet.first("startup-probe-passed", after=t0, ds=app), 180,
        f"{app}'s installer passing its startup probe")
    check(kubelet.first("pod-stop", after=t0, ds="gpu-driver"),
          "the ClusterPolicy's driver pod was not stopped")
    hand["gpudriver_ready_s"] = since(t0, lambda: driver_status(name).get("state") == "ready",
                                      180, f"GPUDriver {name} ready")
    check(driver_status(name).get("pools") == {pool: 1},
          f"GPUDriver pools {driver_status(name).get('pools')}")
    hand["clusterpolicy_ready_s"] = since(t0, lambda: cp_state() == "ready", 180,
                                          "the ClusterPolicy ready with the GPUDriver")
    numbers["handover"] = dict(hand, pool=pool, daemonset=app)
    print(json.dumps({"gpudriver_handover": numbers["handover"], "card": ctx.card}))
    cfg_status = _gpuop_cfg(ctx, "status", "--base-url", ctx.base)
    check(cfg_status["rc"] == 0, f"gpuop-cfg status exited {cfg_status['rc']}: "
                                 f"{cfg_status['out']}{cfg_status['err'][-2000:]}")
    for want in ("ClusterPolicy/cluster-policy: ready",
                 f"GPUDriver/{name}: ready pools={{'{pool}': 1}}", ctx.node_name):
        check(want in cfg_status["out"], f"gpuop-cfg status lacks {want!r}: {cfg_status['out']}")
    print(cfg_status["out"])

    # 2. a second instance selecting the same node
    other = copy.deepcopy(sample)
    other["metadata"]["name"] = "conflicting"
    other["spec"]["nodeSelector"] = {consts.GPU_PRESENT_LABEL: "true"}
    t1 = time.time()
    backend.create(other)

    def conflicted(n):
        cond = get_condition(get("tpu.ai/v1alpha1", "GPUDriver", n) or {}, ERROR) or {}
        return (driver_status(n).get("state") == "notReady"
                and cond.get("reason") == "ConflictingNodeSelector")

    conflict = {"both_conflicted_s": since(t1, lambda: conflicted(name) and conflicted("conflicting"),
                                           60, "both GPUDrivers ConflictingNodeSelector")}
    time.sleep(6.0)  # past one requeue of each (5 s): no second Event
    warnings = {}
    for event in backend.list("v1", "Event", ns):
        if event.get("reason") == "ConflictingNodeSelector" and event.get("type") == "Warning":
            involved = event["involvedObject"]["name"]
            warnings[involved] = warnings.get(involved, 0) + int(event.get("count") or 1)
    check(warnings == {name: 1, "conflicting": 1}, f"conflict Events {warnings}")
    t2 = time.time()
    backend.delete("tpu.ai/v1alpha1", "GPUDriver", "conflicting")
    conflict["ready_again_s"] = since(t2, lambda: driver_status(name).get("state") == "ready", 60,
                                      f"GPUDriver {name} ready after the conflict")
    numbers["conflict"] = dict(conflict, warning_events=warnings)
    print(json.dumps({"gpudriver_conflict": numbers["conflict"]}))

    # 3. the schema, over HTTP
    refused = {}
    for label, spec in (("typo", {"nodeSelectr": {}}), ("driverType", {"driverType": "vgpu"})):
        body = json.dumps({"apiVersion": "tpu.ai/v1alpha1", "kind": "GPUDriver",
                           "metadata": {"name": f"invalid-{label.lower()}"}, "spec": spec})
        request = urllib.request.Request(f"{ctx.base}/apis/tpu.ai/v1alpha1/gpudrivers",
                                         data=body.encode(), method="POST",
                                         headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(request, timeout=10) as r:
                refused[label] = r.status
        except urllib.error.HTTPError as e:
            refused[label] = e.code
    stored = sorted(d["metadata"]["name"] for d in backend.list("tpu.ai/v1alpha1", "GPUDriver"))
    check(refused == {"typo": 422, "driverType": 422} and stored == [name],
          f"invalid GPUDrivers: {refused}, stored {stored}")
    numbers["schema"] = refused

    # 4. hand-back
    t3 = time.time()
    backend.delete("tpu.ai/v1alpha1", "GPUDriver", name)
    back = {"pool_daemonset_gone_s": since(t3, lambda: ds(app) is None, 60,
                                           f"{app} deleted by owner reference"),
            "clusterpolicy_driver_back_s": since(t3, lambda: ds("gpu-driver") is not None, 120,
                                                 "the ClusterPolicy's driver DaemonSet back")}
    back["clusterpolicy_ready_s"] = since(
        t3, lambda: available("gpu-driver") and cp_state() == "ready", 180,
        "the ClusterPolicy ready with its driver DaemonSet")
    check(kubelet.first("pod-stop", after=t3, ds=app), f"{app}'s pod was not stopped")
    numbers["handback"] = back
    print(json.dumps({"gpudriver_handback": back}))

    # 5. two replicas under leader election
    maps = {"phase12_operator": _maps(ctx.operator.pid)}
    with contextlib.suppress(ProcessLookupError):
        os.killpg(ctx.operator.pid, signal.SIGKILL)
    ctx.operator.wait(timeout=60)
    replicas = [_Operator(ctx, os.path.join(ctx.work, f"operator-{i}.log"), ("--leader-elect",))
                for i in range(2)]
    held = threading.Event()
    release = threading.Event()
    real_get = backend.get

    def get_holding_leases(api_version, kind, name_, namespace=None):
        # a slow apiserver for Lease reads while ``held`` is set
        if kind == "Lease" and held.is_set():
            release.wait(30)
        return real_get(api_version, kind, name_, namespace)

    leader_numbers = {}
    try:
        t4 = time.time()
        _wait_for(lambda: sum(r.is_leader() for r in replicas) == 1, 120, "one leader")
        leader_numbers["first_leader_s"] = round(time.time() - t4, 3)
        time.sleep(1.0)
        check(sum(r.is_leader() for r in replicas) == 1, "two leaders")
        old = next(r for r in replicas if r.is_leader())
        new = next(r for r in replicas if r is not old)
        lease = real_get("coordination.k8s.io/v1", "Lease", "gpu-operator-leader", ns)
        check(lease["spec"]["holderIdentity"] == old.readyz()["leader"]["identity"],
              f"lease {lease['spec']}")
        for i, r in enumerate(replicas):
            maps[f"replica_{i}"] = r.maps()
        _wait_for(lambda: cp_state() == "ready", 60, "ready under the elected leader")
        t5 = time.time()
        os.killpg(old.proc.pid, signal.SIGSTOP)
        leader_numbers["takeover_s"] = since(t5, new.is_leader, 60, "the standby taking over")
        check(leader_numbers["takeover_s"] <= 15.0 + 2.0 + 1.0,
              f"takeover {leader_numbers['takeover_s']} s, past the lease plus a retry period")
        check(cp_state() == "ready", f"the CR {cp_state()} after the takeover")
        # the old leader resumes with a write to make: the new one is stopped,
        # the node lost its presence label, and Lease reads are slow
        os.killpg(new.proc.pid, signal.SIGSTOP)
        backend.get = get_holding_leases
        held.set()
        backend.patch("v1", "Node", ctx.node_name,
                      {"metadata": {"labels": {consts.GPU_PRESENT_LABEL: None}}})
        t6 = time.time()
        os.killpg(old.proc.pid, signal.SIGCONT)

        def fenced_writes():
            text = _try_scrape(old.metrics_port) or ""
            return sum(v for k, v in scrape_samples(text).items()
                       if k.startswith("tpu_operator_fenced_writes_total{"))

        leader_numbers["fenced_writes"] = _wait_for(fenced_writes, 8, "a fenced write")
        leader_numbers["first_fenced_s"] = round(time.time() - t6, 3)
        held.clear()
        release.set()
        backend.get = real_get
        rc = old.proc.wait(timeout=60)
        leader_numbers["old_leader_exit"] = rc
        leader_numbers["old_leader_exit_s"] = round(time.time() - t6, 3)
        log_text = old.log()
        check(rc == 1 and "fenced write rejected" in log_text
              and "leadership lost" in log_text,
              f"the deposed leader exited {rc}: {log_text[-3000:]}")
        os.killpg(new.proc.pid, signal.SIGCONT)
        leader_numbers["relabelled_s"] = since(
            t6, lambda: backend.get("v1", "Node", ctx.node_name)["metadata"]["labels"].get(
                consts.GPU_PRESENT_LABEL) == "true", 60, "the new leader relabelling the node")
        check(new.is_leader() and cp_state() == "ready",
              f"after the fence: leader {new.is_leader()}, CR {cp_state()}")
        numbers["leader"] = leader_numbers
        print(json.dumps({"leader_election": leader_numbers}))

        # 6. gpuop-cfg
        final = _gpuop_cfg(ctx, "status", "--base-url", ctx.base)
        check(final["rc"] == 0 and ctx.node_name in final["out"],
              f"gpuop-cfg status exited {final['rc']}: {final['out']}{final['err'][-2000:]}")
        samples = sorted(glob.glob(os.path.join(ctx.repo, "tpu_operator_torch", "manifests",
                                                "samples", "*.json")))
        validated = _gpuop_cfg(ctx, "validate", *samples)
        check(validated["rc"] == 0 and validated["out"].count(": OK") == len(samples),
              f"gpuop-cfg validate: {validated['out']}{validated['err'][-2000:]}")

        # 7. neither torch nor libcuda in any operator process or gpuop-cfg
        for run_ in (cfg_status, final, validated):
            check(run_["maps_line"] == "MAPS False False", f"gpuop-cfg {run_['maps_line']}")
        maps["gpuop_cfg"] = (False, False)
        check(not any(a or b for a, b in maps.values()), f"maps torch/libcuda: {maps}")
        numbers["maps_torch_or_libcuda"] = maps
        numbers["gpuop_cfg"] = {"status_rc": [cfg_status["rc"], final["rc"]],
                                "validate_rc": validated["rc"]}
        numbers["phase_s"] = round(time.monotonic() - started, 3)
        print(json.dumps({"gpudriver_phase": {k: numbers[k] for k in (
            "handover", "conflict", "schema", "handback", "leader", "gpuop_cfg", "phase_s")},
            "card": ctx.card}))
    except SystemExit:
        for r in replicas:
            print(f"-- {r.log_path}:\n{r.log()[-4000:]}", file=sys.stderr)
        raise
    finally:
        backend.get = real_get
        release.set()
        for r in replicas:
            r.stop()
    return numbers


def _debug_json(port: int, path: str):
    """A ``/debug`` page of an operator's health port, or None."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return json.loads(r.read())
    except (OSError, ValueError):
        return None


def join_critical_path(health_port: int, metrics_port: int, node_name: str, t0: float,
                       ready_s: float, card: str) -> dict:
    """Phase 12's join as the operator's join profiler attributes it
    (``/debug/join-traces``): seconds per phase of the critical path, its
    coverage and its window, beside the smoke's own clock. The window must
    cover the CR-to-``ready`` interval the smoke measured, give or take one
    sweep (5 s), the phases must sum to at most the window, and
    ``tpu_operator_join_phase_seconds`` must have a sample."""

    def complete():
        # complete, with the workload barrier's closed span mirrored in
        # (feature discovery mirrors the node's span log every 5 s)
        body = _debug_json(health_port, f"/debug/join-traces?node={node_name}") or {}
        traces = [t for t in body.get("traces") or [] if t["window"]["complete"]
                  and any(s["n"] == "operand.workload" and s.get("d") is not None
                          for s in t["node_spans"])]
        return traces[0] if traces else None

    trace = _wait_for(complete, 40, "a complete join trace with the workload's closed span")
    window, att = trace["window"], trace["attribution"]
    out = {
        "window_from_cr_s": [round(window["start_unix"] - t0, 3),
                             round(window["end_unix"] - t0, 3)],
        "window_s": att["window_s"], "coverage": att["coverage"],
        "phases_s": att["phases"], "unattributed_s": att["unattributed_s"],
        "operator_sweeps": trace["operator_sweeps"], "node_spans": len(trace["node_spans"]),
        "orphan_spans": len(trace["orphan_spans"]), "smoke_ready_s": ready_s,
        "node_span_s": {s["n"]: None if s.get("d") is None else round(s["d"], 3)
                        for s in trace["node_spans"]},
    }
    check(window["start_unix"] <= t0 + NOT_READY_SWEEP_S
          and window["end_unix"] >= t0 + ready_s - NOT_READY_SWEEP_S,
          f"the join window {out['window_from_cr_s']} does not cover the CR to ready "
          f"(0, {ready_s}) within a sweep")
    check(sum(att["phases"].values()) <= att["window_s"] + 1e-3,
          f"the phases sum past the window: {att}")

    def sampled():
        return any(k.startswith("tpu_operator_join_phase_seconds_count{")
                   for k in scrape_samples(_try_scrape(metrics_port) or ""))

    _wait_for(sampled, 30, "a tpu_operator_join_phase_seconds sample")
    print(json.dumps({"join_critical_path": out, "card": card}))
    return out


#: the operator's requeue while a ClusterPolicy is not ready, its sweep
#: cadence during a join
NOT_READY_SWEEP_S = 5.0

#: phase 14's ClusterPolicy health settings: the schema's shortest
#: remediation wait, two attempts, a 5 s drain window, cordon on quarantine
HEALTH_SPEC = {"enabled": True, "cordonOnQuarantine": True, "maxRemediationAttempts": 2,
               "remediationWaitS": 30, "drainDeadlineS": 5}
#: what each health episode's decision chain holds, in order
EPISODE_A = ["drain-plan", "drain-force", "remediate", "health-recover"]
EPISODE_B = ["drain-plan", "drain-force", "remediate", "remediate", "health-failed"]


class NodeTrail:
    """Every change of a node's health label, cordon, plan annotation and
    published verdict, timed, from the apiserver backend's own watch: a
    state the next sweep leaves at once lasts less than any poll.
    ``on_change(entry)`` runs on the writer's thread and must not block."""

    def __init__(self, backend, node_name: str, on_change=None, label: str = None,
                 empty: str = "healthy"):
        from tpu_operator_torch import consts

        self.node_name = node_name
        self.on_change = on_change
        #: the state label followed (the health machine's unless given),
        #: and what its absence reads as
        self.label = label or consts.HEALTH_STATE_LABEL
        self.empty = empty
        self.changes: list = []
        self._lock = threading.Lock()
        self._handle = backend.watch("v1", "Node", None, handler=self._on)
        self._on(types.SimpleNamespace(object=backend.get("v1", "Node", node_name)))

    def _on(self, event) -> None:
        from tpu_operator_torch import consts

        meta = event.object.get("metadata") or {}
        if meta.get("name") != self.node_name:
            return
        anns = meta.get("annotations") or {}
        entry = {"state": (meta.get("labels") or {}).get(self.label) or self.empty,
                 "cordoned": bool((event.object.get("spec") or {}).get("unschedulable")),
                 "plan": consts.RETILE_PLAN_ANNOTATION in anns,
                 "verdict": anns.get(consts.WORKLOAD_HEALTH_ANNOTATION)}
        with self._lock:
            if self.changes and all(self.changes[-1][k] == v for k, v in entry.items()):
                return
            self.changes.append(dict(entry, t=time.time()))
        if self.on_change is not None:
            self.on_change(entry)

    def first(self, after: float, **match):
        with self._lock:
            return next((c for c in self.changes if c["t"] > after
                         and all(c[k] == v for k, v in match.items())), None)

    def states(self, after: float) -> list:
        """The distinct health states after ``after``, in order."""
        out = []
        with self._lock:
            for c in self.changes:
                if c["t"] > after and (not out or out[-1] != c["state"]):
                    out.append(c["state"])
        return out

    def stop(self) -> None:
        self._handle.stop()


def _node_events(backend, namespace: str, name: str) -> dict:
    """Each reason's Event count on an object."""
    out: dict = {}
    for e in backend.list("v1", "Event", namespace):
        if e["involvedObject"]["name"] == name:
            out[e["reason"]] = out.get(e["reason"], 0) + int(e.get("count") or 1)
    return out


def _events_since(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _explain_episodes(text: str) -> list:
    """``gpuop-cfg explain``'s episodes: (id, [subsystem/kind, ...]) in order."""
    episodes = []
    for line in text.splitlines():
        head = re.match(r"episode (ep-[0-9a-f]+) ", line)
        if head:
            episodes.append((head.group(1), []))
            continue
        step = re.match(r"  \[\d+\] (\S+)  trigger=", line)
        if step and episodes:
            episodes[-1][1].append(step.group(1))
    return episodes


def health_phase(ctx) -> dict:
    """Phase 14, on phases 12-13's cluster: a fresh ``gpu-operator`` with a
    health port, the ClusterPolicy's health machine turned on, and two
    episodes on the node. Episode A, a transient fault: the workload pod
    gets no GPU (``ctx.fault_env``), the node walks degraded and
    quarantined (cordoned), the drain plan waits out its 5 s deadline with
    no ack, the operator recycles the validator pod, and the fault, cleared
    at once, lets the kubelet's rerun pass: recovered, then healthy. Episode
    B, a persistent fault: attempt 1, attempt 2 (the driver pod too) 30 s
    later, sticky ``failed`` 30 s after that, with ``NodeHealthDegraded``
    on the ClusterPolicy; then the fault and the health label are cleared,
    as an admin would. Checked: the states, cordon, plans and Events of
    each episode; ``gpuop-cfg explain`` and ``/debug/timeline`` with two
    episodes of 4 and 5 records; one ``prov-*`` ConfigMap per record; no
    orphan in the causality audit of every write the operator made over
    HTTP (an ``ActuationObserver`` on the apiserver's backend); the metric
    families; neither torch nor libcuda in the operator or ``gpuop-cfg``.

    ``ctx``: as :func:`gpudriver_phase` has it, and ``fault_env``, the env
    that fails the workload pod (default: no visible GPU)."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.provenance import ActuationObserver, DecisionJournal, causality_audit

    raw, kubelet, ns, node_name = ctx.srv.backend, ctx.kubelet, ctx.namespace, ctx.node_name
    fault = dict(getattr(ctx, "fault_env", None) or {"CUDA_VISIBLE_DEVICES": ""})
    observer = ctx.srv.backend = ActuationObserver(raw)  # the HTTP handlers write through it
    numbers = {"card": ctx.card}
    started = time.monotonic()

    def policy():
        return raw.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")

    def cp_state():
        return (policy().get("status") or {}).get("state")

    def condition():
        return next((c for c in (policy().get("status") or {}).get("conditions") or []
                     if c.get("type") == "NodeHealthDegraded"), {})

    def verdict():
        return (raw.get("v1", "Node", node_name)["metadata"].get("annotations") or {}).get(
            consts.WORKLOAD_HEALTH_ANNOTATION)

    def since(t, predicate, timeout, what):
        found = _wait_for(predicate, timeout, what)
        return round((found["t"] if isinstance(found, dict) else time.time()) - t, 3)

    op = _Operator(ctx, os.path.join(ctx.work, "operator-health.log"))
    episode = {"name": None}

    def on_change(entry):
        # episode A's fault is transient: it clears as the remediation
        # recycles the validator, before the kubelet's rerun starts
        if episode["name"] == "A" and entry["state"] == "remediating":
            kubelet.pod_env = None

    trail = None
    try:
        _wait_for(lambda: op.readyz().get("status") == "ok", 120, "the phase-14 operator ready")
        _wait_for(lambda: cp_state() == "ready", 120, "the ClusterPolicy ready under it")
        t_patch = time.time()
        body = json.dumps({"spec": {"health": HEALTH_SPEC,
                                    "featureDiscovery": {"sleepInterval": "2s"}}}).encode()
        request = urllib.request.Request(
            f"{ctx.base}/apis/tpu.ai/v1/clusterpolicies/cluster-policy", data=body,
            method="PATCH", headers={"Content-Type": "application/merge-patch+json"})
        with urllib.request.urlopen(request, timeout=10) as r:
            check(r.status == 200, f"the health patch: {r.status}")
        check(policy()["spec"]["health"]["drainDeadlineS"] == 5, "the health patch not stored")
        _wait_for(lambda: kubelet.first("pod-start", after=t_patch, ds="gpu-feature-discovery"),
                  60, "feature discovery restarted with its 2 s interval")
        _wait_for(lambda: cp_state() == "ready" and verdict() == "passed", 120,
                  "ready, with a passing verdict published")
        trail = NodeTrail(raw, node_name, on_change)

        # -- episode A: a transient fault ----------------------------------------
        before = _node_events(raw, ns, node_name)
        episode["name"] = "A"
        t_a = time.time()
        kubelet.pod_env = dict(fault)
        kubelet.restart("gpu-operator-validator")
        a = {"verdict_failed_s": since(t_a, lambda: trail.first(t_a, verdict="failed"), 120,
                                       "the failed verdict published (A)"),
             "degraded_s": since(t_a, lambda: trail.first(t_a, state="degraded"), 60,
                                 "degraded (A)"),
             "quarantined_s": since(t_a, lambda: trail.first(t_a, state="quarantined"), 60,
                                    "quarantined (A)"),
             "cordoned_s": since(t_a, lambda: trail.first(t_a, state="quarantined",
                                                         cordoned=True), 60, "cordoned (A)"),
             "plan_s": since(t_a, lambda: trail.first(t_a, state="quarantined", plan=True), 60,
                             "the drain plan (A)"),
             "remediating_s": since(t_a, lambda: trail.first(t_a, state="remediating"), 60,
                                    "remediating (A)")}
        t_rem = t_a + a["remediating_s"]
        a["validator_pod_deleted_s"] = since(
            t_a, lambda: kubelet.first("pod-deleted", after=t_rem - 1.0,
                                       ds="gpu-operator-validator"), 30,
            "the validator pod deleted by the operator (A)")
        a["recovered_s"] = since(t_a, lambda: trail.first(t_a, state="recovered"), 120,
                                 "recovered (A)")
        a["healthy_s"] = since(t_a, lambda: trail.first(t_a + a["recovered_s"], state="healthy"),
                               60, "healthy (A)")
        check(trail.states(t_a) == ["healthy", "degraded", "quarantined", "remediating",
                                    "recovered", "healthy"], f"episode A walked {trail.states(t_a)}")
        recovered = trail.first(t_a, state="recovered")
        check(not recovered["cordoned"] and not recovered["plan"],
              f"recovered still cordoned or planned: {recovered}")
        rerun = _wait_for(lambda: kubelet.first("init-exit", after=t_rem,
                                                ds="gpu-operator-validator",
                                                container="workload-validation"), 60,
                          "the validator's rerun after the recycle (A)")
        check(rerun["rc"] == 0, f"the rerun after the recycle: {rerun}")
        a["rerun_passed_s"] = round(rerun["t"] - t_a, 3)
        a["events"] = _events_since(before, _node_events(raw, ns, node_name))
        for reason in ("NodeHealthDegraded", "NodeHealthQuarantined", "RetilePlanned",
                       "RetileDeadlineExpired", "NodeHealthRemediating",
                       "NodeHealthRecovered"):
            check(a["events"].get(reason) == 1, f"episode A's {reason} Events: {a['events']}")
        numbers["episode_a"] = a
        print(json.dumps({"health_episode_a": a, "card": ctx.card}))

        # -- episode B: a persistent fault ----------------------------------------
        episode["name"] = "B"
        _wait_for(lambda: verdict() == "passed", 60, "a passing verdict before episode B")
        before = _node_events(raw, ns, node_name)
        cp_before = _node_events(raw, ns, "cluster-policy")
        t_b = time.time()
        kubelet.pod_env = dict(fault)
        kubelet.restart("gpu-operator-validator")
        b = {"verdict_failed_s": since(t_b, lambda: trail.first(t_b, verdict="failed"), 120,
                                       "the failed verdict published (B)"),
             "quarantined_s": since(t_b, lambda: trail.first(t_b, state="quarantined"), 60,
                                    "quarantined (B)"),
             "remediating_s": since(t_b, lambda: trail.first(t_b, state="remediating"), 60,
                                    "remediating (B)")}
        t_rem = t_b + b["remediating_s"]
        b["attempt_2_s"] = since(t_b, lambda: kubelet.first("pod-deleted", after=t_rem + 1.0,
                                                            ds="gpu-driver"), 90,
                                 "attempt 2 restarting the driver pod (B)")
        t_two = t_b + b["attempt_2_s"]
        b["driver_reinstalled_s"] = since(
            t_b, lambda: kubelet.first("startup-probe-passed", after=t_two, ds="gpu-driver"), 60,
            "the driver installer past its probe again (B)")
        b["failed_s"] = since(t_b, lambda: trail.first(t_b, state="failed"), 90, "failed (B)")
        check(trail.states(t_b) == ["healthy", "degraded", "quarantined", "remediating",
                                    "failed"], f"episode B walked {trail.states(t_b)}")
        message = "node GPU health: 1 failed"
        b["condition_s"] = since(t_b, lambda: condition().get("status") == "True"
                                 and condition().get("message") == message, 30,
                                 "NodeHealthDegraded True on the ClusterPolicy")
        warnings = [e for e in raw.list("v1", "Event", ns)
                    if e["involvedObject"]["name"] == "cluster-policy"
                    and e["reason"] == "NodeHealthDegraded" and e["message"] == message]
        check(len(warnings) == 1 and int(warnings[0].get("count") or 1) == 1
              and warnings[0]["type"] == "Warning", f"the condition's Warning Events {warnings}")
        b["events"] = _events_since(before, _node_events(raw, ns, node_name))
        for reason, n in (("NodeHealthQuarantined", 1), ("RetilePlanned", 1),
                          ("RetileDeadlineExpired", 1), ("NodeHealthRemediating", 2),
                          ("NodeHealthFailed", 1)):
            check(b["events"].get(reason) == n, f"episode B's {reason} Events: {b['events']}")
        b["policy_events"] = _events_since(cp_before, _node_events(raw, ns, "cluster-policy"))

        # the admin's way out: the fault cleared, a passing verdict, the label removed
        t_c = time.time()
        kubelet.pod_env = None
        b["passing_again_s"] = since(t_c, lambda: trail.first(t_c, verdict="passed"), 120,
                                     "a passing verdict after the fault cleared")
        check(trail.states(t_c) == ["failed"], f"sticky failed left: {trail.states(t_c)}")
        t_d = time.time()
        raw.patch("v1", "Node", node_name, {"metadata": {"labels": {
            consts.HEALTH_STATE_LABEL: None}}})
        health_keys = (consts.HEALTH_STATE_SINCE_ANNOTATION, consts.HEALTH_ATTEMPTS_ANNOTATION,
                       consts.HEALTH_FLAP_HISTORY_ANNOTATION, consts.HEALTH_FLAP_STICKY_ANNOTATION,
                       consts.HEALTH_FAILED_TEMPLATE_ANNOTATION, consts.RETILE_PLAN_ANNOTATION,
                       consts.PROVENANCE_EPISODE_ANNOTATION)

        def wiped():
            anns = raw.get("v1", "Node", node_name)["metadata"].get("annotations") or {}
            return not any(k in anns for k in health_keys)

        b["wiped_s"] = since(t_d, wiped, 30, "every health annotation wiped after the clear")
        b["condition_false_s"] = since(t_d, lambda: condition().get("status") == "False", 30,
                                       "NodeHealthDegraded False")
        check(trail.states(t_d) == ["healthy"], f"after the clear: {trail.states(t_d)}")
        b["cordoned_after_clear"] = bool(raw.get("v1", "Node", node_name).get(
            "spec", {}).get("unschedulable"))
        numbers["episode_b"] = b
        print(json.dumps({"health_episode_b": b, "card": ctx.card}))

        # -- the records ------------------------------------------------------------
        explain = _gpuop_cfg(ctx, "explain", "node", node_name, "--base-url", ctx.base)
        check(explain["rc"] == 0, f"gpuop-cfg explain exited {explain['rc']}: "
                                  f"{explain['out']}{explain['err'][-2000:]}")
        print(explain["out"])
        episodes = _explain_episodes(explain["out"])
        check([kinds for _, kinds in episodes] == [[f"health/{k}" for k in EPISODE_A],
                                                   [f"health/{k}" for k in EPISODE_B]]
              and episodes[0][0] != episodes[1][0], f"explain's episodes {episodes}")
        timeline = _debug_json(op.health_port, f"/debug/timeline?node={node_name}&limit=1000")
        mirrors = [json.loads(cm["data"]["record"]) for cm in raw.list("v1", "ConfigMap", ns)
                   if consts.PROVENANCE_LABEL in (cm["metadata"].get("labels") or {})]
        check(sorted(r["record_id"] for r in timeline["records"])
              == sorted(r["record_id"] for r in mirrors)
              and len(mirrors) == timeline["stats"]["records"]
              == sum(len(k) for _, k in episodes) == 9,
              f"timeline {timeline['count']}, journal {timeline['stats']}, "
              f"ConfigMaps {len(mirrors)}, explain {episodes}")
        journal_path = os.path.join(ctx.work, "journal-from-configmaps.jsonl")
        with open(journal_path, "w") as f:
            for r in mirrors:
                f.write(json.dumps(r, sort_keys=True) + "\n")
        audit = causality_audit(DecisionJournal(path=journal_path), observer.observed)
        check(audit["ok"] and not audit["orphans"] and audit["observed"] >= 2,
              f"causality audit {audit}")
        numbers["records"] = {"episodes": [[e, len(k)] for e, k in episodes],
                              "configmaps": len(mirrors), "journal": timeline["stats"],
                              "audit": {k: audit[k] for k in ("observed", "covered",
                                                              "episodes", "complete_episodes",
                                                              "ok")}}

        # -- the metric families ------------------------------------------------------
        samples = scrape_samples(_try_scrape(op.metrics_port) or "")
        states = {k.split('"')[1]: v for k, v in samples.items()
                  if k.startswith("tpu_operator_node_health_state{")}
        durations = sum(v for k, v in samples.items()
                        if k.startswith("tpu_operator_episode_duration_seconds_count{"))
        metrics = {
            "remediation_attempts_total": samples.get("tpu_operator_remediation_attempts_total"),
            "drain_deadline_missed_total": samples.get(
                "tpu_operator_drain_deadline_missed_total"),
            "decision_records_total_health": samples.get(
                'tpu_operator_decision_records_total{subsystem="health"}'),
            "episode_durations": durations, "node_health_state": states,
        }
        check(metrics["remediation_attempts_total"] == 3
              and metrics["drain_deadline_missed_total"] == 2
              and metrics["decision_records_total_health"] == 9 and durations == 2
              and states.get("healthy") == 1
              and not any(v for k, v in states.items() if k != "healthy"),
              f"the health metrics {metrics}")
        numbers["metrics"] = metrics

        # -- isolation ------------------------------------------------------------------
        maps = {"operator": op.maps(), "gpuop_cfg": explain["maps_line"]}
        check(maps["operator"] == (False, False) and explain["maps_line"] == "MAPS False False",
              f"maps torch/libcuda: {maps}")
        numbers["maps_torch_or_libcuda"] = maps
        _wait_for(lambda: cp_state() == "ready", 120, "the ClusterPolicy ready at the end")
        numbers["phase_s"] = round(time.monotonic() - started, 3)
        print(json.dumps({"health_phase": {k: numbers[k] for k in (
            "records", "metrics", "phase_s")}, "card": ctx.card}))
    except SystemExit:
        print(f"-- {op.log_path}:\n{op.log()[-6000:]}", file=sys.stderr)
        if trail is not None:
            print(f"-- node trail: {trail.changes}", file=sys.stderr)
        raise
    finally:
        kubelet.pod_env = None
        if trail is not None:
            trail.stop()
        ctx.srv.backend = raw
        op.stop()
    return numbers


#: phase 15's driver upgrade policy on the ClusterPolicy: one node at a
#: time, 10 s budgets for the GPU-consumer deletion and the drain, forced
UPGRADE_POLICY = {"autoUpgrade": True, "maxParallelUpgrades": 1,
                  "podDeletion": {"force": True, "timeoutSeconds": 10},
                  "drain": {"enable": True, "force": True, "timeoutSeconds": 10}}
#: U1's driver template: one env var more than the DaemonSet's
U1_ENV = [{"name": "GPU_UPGRADE_ROUND", "value": "u1"}]
#: the GPU consumer U1 drains: 1 GiB held on the card and GEMMs until killed
CONSUMER_SCRIPT = (
    "import time, torch\n"
    "hold = torch.empty(1 << 28, device='cuda')\n"
    "a = torch.randn(2048, 2048, device='cuda')\n"
    "print('holding', hold.numel() * 4, flush=True)\n"
    "while True:\n"
    "    for _ in range(10):\n"
    "        a = torch.tanh(a @ a)\n"
    "    torch.cuda.synchronize()\n"
    "    time.sleep(0.01)\n")
#: what each upgrade episode's decision chain holds, in order
EPISODE_U1 = ["upgrade", "drain-force", "upgrade-done"]
EPISODE_U2 = ["upgrade", "upgrade-failed", "upgrade", "upgrade-done"]
UPGRADE_GAUGES = ("pending", "in_progress", "done", "failed", "available")


def _smi_used_mib():
    """The card's used memory in MiB as ``nvidia-smi`` reads it, None on a
    query that fails (called from an apiserver thread: it must not exit).
    A sandboxed runtime may list no process under ``--query-compute-apps``,
    so a process's memory is read as the card's used memory around it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(out.stdout.splitlines()[0])
    except (IndexError, ValueError):
        return None


def _upgrade_gauges(port: int) -> dict:
    samples = scrape_samples(_try_scrape(port) or "")
    return {g: samples.get(f"tpu_operator_nodes_upgrades_{g}") for g in UPGRADE_GAUGES}


def upgrade_phase(ctx) -> dict:
    """Phase 15, on phases 12-14's cluster: a fresh ``gpu-operator``, its
    ClusterPolicy with the health machine off and ``driver.upgradePolicy``
    on (:data:`UPGRADE_POLICY`), and two rolling upgrades of the node.

    U1, a clean upgrade of an admin-cordoned node past a PodDisruptionBudget:
    a user Pod requesting one ``nvidia.com/gpu`` runs on the card as a
    process holding 1 GiB and running GEMMs (``ctx.consumer_script``), a
    budget with ``minAvailable: 1`` selects it, the node is cordoned by hand,
    and one env var is added to ``spec.driver.env``. The machine's eviction
    is refused with 429 and retried on its ``Retry-After``; at the 10 s
    budget the Pod is force-deleted; the consumer's memory is gone from
    ``nvidia-smi`` when the driver pod is deleted; the installer reruns on
    the new template, the validator pod is recycled and its init chain
    passes; ``upgrade-done``, the label cleared, and the node still
    unschedulable (the admin's cordon), which the smoke then lifts.

    U2, a crash-looping driver: the bundle the installer copies from holds
    a directory where ``libcuda.so.1`` should be, so the new driver pod
    crash-loops: ``upgrade-failed``, ``DriverUpgradeFailed``, the failed
    gauge at 1, the node cordoned. U1's template restored retries the node
    out of ``upgrade-failed`` to ``upgrade-done``, uncordoned by the machine.

    Printed: seconds from each template change to each state, the Events,
    the five gauges after each episode, ``gpuop-cfg status`` and ``explain
    node`` (the upgrade's two episodes apart from the health episodes), the
    apiserver's eviction requests and their 429s."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.utils import deep_get

    raw, kubelet, ns, node_name = ctx.srv.backend, ctx.kubelet, ctx.namespace, ctx.node_name
    on_gpu = getattr(ctx, "consumer_script", None) is None
    numbers = {"card": ctx.card}
    started = time.monotonic()

    def cp_state():
        return (raw.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy").get("status")
                or {}).get("state")

    def node():
        return raw.get("v1", "Node", node_name)

    def cordoned():
        return bool((node().get("spec") or {}).get("unschedulable"))

    def driver_ds():
        return next((d for d in raw.list("apps/v1", "DaemonSet", ns)
                     if (d["spec"]["template"]["metadata"].get("labels") or {}).get(
                         "app.kubernetes.io/component") == "gpu-driver"), {})

    def patch_policy(spec):
        body = json.dumps({"spec": spec}).encode()
        request = urllib.request.Request(
            f"{ctx.base}/apis/tpu.ai/v1/clusterpolicies/cluster-policy", data=body,
            method="PATCH", headers={"Content-Type": "application/merge-patch+json"})
        with urllib.request.urlopen(request, timeout=10) as r:
            check(r.status == 200, f"the ClusterPolicy patch: {r.status}")

    def since(t, predicate, timeout, what):
        found = _wait_for(predicate, timeout, what)
        return round((found["t"] if isinstance(found, dict) else time.time()) - t, 3)

    # the driver pods' deletions as the apiserver takes them, with what
    # nvidia-smi shows at that instant (the handler runs inside the delete)
    driver_deleted = []

    def on_pod(event):
        labels = (event.object.get("metadata") or {}).get("labels") or {}
        if event.type == "DELETED" and labels.get("app.kubernetes.io/component") == "gpu-driver":
            driver_deleted.append({"t": time.time(),
                                   "used_mib": _smi_used_mib() if on_gpu else None})

    op = _Operator(ctx, os.path.join(ctx.work, "operator-upgrade.log"))
    trail = watch = None
    try:
        _wait_for(lambda: op.readyz().get("status") == "ok", 120, "the phase-15 operator ready")
        t_patch = time.time()
        patch_policy({"health": {"enabled": False}, "driver": {"upgradePolicy": UPGRADE_POLICY}})
        _wait_for(lambda: deep_get(driver_ds(), "spec", "updateStrategy", "type") == "OnDelete",
                  120, "the driver DaemonSet OnDelete")
        _wait_for(lambda: cp_state() == "ready", 240, "the ClusterPolicy ready with autoUpgrade")
        check(not (node()["metadata"].get("labels") or {}).get(consts.UPGRADE_STATE_LABEL),
              f"an upgrade began without a template change: {node()['metadata']}")
        driver_pod = next(p for p in raw.list("v1", "Pod", ns)
                          if (p["metadata"].get("labels") or {}).get(
                              "app.kubernetes.io/component") == "gpu-driver")
        check(any(c["type"] == "Ready" and c["status"] == "True"
                  for c in driver_pod["status"].get("conditions") or []),
              f"the driver pod not Ready: {driver_pod['status']}")
        numbers["setup_s"] = round(time.time() - t_patch, 3)
        trail = NodeTrail(raw, node_name, label=consts.UPGRADE_STATE_LABEL, empty="")
        watch = raw.watch("v1", "Pod", ns, handler=on_pod)

        # -- U1: a clean upgrade of an admin-cordoned node, past a PDB -----------------
        before = _node_events(raw, ns, node_name)
        u1 = {}
        if on_gpu:
            u1["baseline_used_mib"] = _smi_used_mib()
        raw.create({"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": "gpu-consumer", "namespace": "default",
                                 "labels": {"app": "gpu-consumer"}},
                    "spec": {"nodeName": node_name, "containers": [{
                        "name": "gemm", "command": [sys.executable, "-c",
                                                    getattr(ctx, "consumer_script", None)
                                                    or CONSUMER_SCRIPT],
                        "resources": {"limits": {consts.GPU_RESOURCE_NAME: "1"}}}]},
                    "status": {"phase": "Pending"}})
        uid = raw.get("v1", "Pod", "gpu-consumer", "default")["metadata"]["uid"]
        _wait_for(lambda: any("holding" in text for name, text in kubelet.spawned_logs().items()
                              if name.endswith("@" + uid)), 120, "the consumer holding")
        if on_gpu:
            held = _wait_for(lambda: (lambda used: used if used and used - u1[
                "baseline_used_mib"] >= 1024 else None)(_smi_used_mib()), 60,
                "the consumer's 1 GiB in nvidia-smi")
            u1["consumer_mib"] = held - u1["baseline_used_mib"]
        raw.create({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                    "metadata": {"name": "gpu-consumer", "namespace": "default"},
                    "spec": {"selector": {"matchLabels": {"app": "gpu-consumer"}},
                             "minAvailable": 1}})
        raw.patch("v1", "Node", node_name, {"spec": {"unschedulable": True}})  # the admin
        evictions_before = len(ctx.srv.evictions)
        t_u1 = time.time()
        patch_policy({"driver": {"env": U1_ENV}})
        for state in ("upgrade-required", "pod-deletion-required", "pod-restart-required",
                      "validation-required", "upgrade-done"):
            u1[f"{state}_s"] = since(t_u1, lambda: trail.first(t_u1, state=state), 180,
                                     f"{state} (U1)")
        u1["cleared_s"] = since(t_u1, lambda: trail.first(t_u1 + u1["upgrade-done_s"], state=""),
                                60, "the label cleared (U1)")
        states = trail.states(t_u1)
        check(states[0] == "upgrade-required" and states[-2:] == ["upgrade-done", ""]
              and "pod-deletion-required" in states and "upgrade-failed" not in states,
              f"U1 walked {states}")
        u1["states"] = states
        check(all(c["cordoned"] for c in trail.changes if c["t"] > t_u1),
              "the admin's cordon lifted during U1")
        check(cordoned(), "the admin's cordon lifted by the upgrade")
        evictions = [e for e in ctx.srv.evictions[evictions_before:] if e[2] == "gpu-consumer"]
        refused = [t for t, _, _, code in evictions if code == 429]
        u1["evictions"] = [[round(t - t_u1, 3), code] for t, _, _, code in evictions]
        gaps = [round(b - a, 3) for a, b in zip(refused, refused[1:])]
        u1["retry_gaps_s"] = gaps
        check(len(refused) >= 2 and max(gaps) <= 10.0,
              f"the refused evictions {u1['evictions']}: no retry on the Retry-After hint")
        killed = _wait_for(lambda: kubelet.first("pod-killed", after=t_u1, pod="gpu-consumer"),
                           60, "the consumer's process killed")
        u1["consumer_killed_s"] = round(killed["t"] - t_u1, 3)
        deleted = [d for d in driver_deleted if d["t"] > t_u1]
        check(deleted, "the old driver pod never deleted (U1)")
        u1["driver_pod_deleted_s"] = round(deleted[0]["t"] - t_u1, 3)
        check(killed["t"] < deleted[0]["t"], "the driver pod deleted before the consumer went")
        if on_gpu:
            u1["used_mib_at_driver_deletion"] = deleted[0]["used_mib"]
            check(deleted[0]["used_mib"] is not None
                  and deleted[0]["used_mib"] - u1["baseline_used_mib"] < 256,
                  f"the consumer's memory still held as the driver pod went: "
                  f"{deleted[0]['used_mib']} MiB used, {u1['baseline_used_mib']} before it")
        # the budget runs from the state's whole-second since stamp: up to a
        # second before the trail saw the state
        force_after = u1["consumer_killed_s"] - u1["pod-deletion-required_s"]
        check(force_after >= 9.0, f"forced {force_after} s into the 10 s budget")
        u1["installer_started_s"] = since(t_u1, lambda: kubelet.first(
            "pod-start", after=t_u1, ds="gpu-driver"), 60, "the installer rerun (U1)")
        u1["installer_ready_s"] = since(t_u1, lambda: kubelet.first(
            "startup-probe-passed", after=t_u1, ds="gpu-driver"), 60, "the installer's probe (U1)")
        t_val = t_u1 + u1["validation-required_s"]
        recycled = _wait_for(lambda: kubelet.first("pod-deleted", after=t_val - 1.0,
                                                   ds="gpu-operator-validator"), 30,
                             "the validator pod recycled (U1)")
        u1["validator_recycled_s"] = round(recycled["t"] - t_u1, 3)
        for container in ("driver-validation", "plugin-validation", "workload-validation"):
            ran = _wait_for(lambda: kubelet.first("init-exit", after=recycled["t"],
                                                  ds="gpu-operator-validator",
                                                  container=container), 120,
                            f"{container} after the recycle (U1)")
            check(ran["rc"] == 0, f"{container} failed after the upgrade: {ran}")
            u1[f"{container}_s"] = round(ran["t"] - t_u1, 3)
        check(len(kubelet.matching("pod-deleted", after=t_u1, ds="gpu-operator-validator")) == 1,
              "the validator recycled more than once (U1)")
        u1["events"] = _events_since(before, _node_events(raw, ns, node_name))
        check(u1["events"].get("UpgradeDrainForced") == 1, f"U1's Events {u1['events']}")
        u1["gauges"] = _wait_for(lambda: (lambda g: g if g["available"] == 1 else None)(
            _upgrade_gauges(op.metrics_port)), 30, "the gauges after U1")
        check(u1["gauges"] == {"pending": 0, "in_progress": 0, "done": 0, "failed": 0,
                               "available": 1}, f"the gauges after U1: {u1['gauges']}")
        numbers["u1"] = u1
        print(json.dumps({"upgrade_u1": u1, "card": ctx.card}))
        raw.patch("v1", "Node", node_name, {"spec": {"unschedulable": None}})  # the admin again
        _wait_for(lambda: cp_state() == "ready", 120, "ready after U1")

        # -- U2: a crash-looping driver, then its recovery -------------------------------
        broken = os.path.join(ctx.work, "broken-bundle")
        os.makedirs(os.path.join(broken, consts.DRIVER_LIB), exist_ok=True)
        before = _node_events(raw, ns, node_name)
        t_u2 = time.time()
        patch_policy({"driver": {"env": [{"name": consts.DRIVER_SRC_ENV, "value": broken}]}})
        u2 = {}
        for state in ("upgrade-required", "pod-restart-required", "upgrade-failed"):
            u2[f"{state}_s"] = since(t_u2, lambda: trail.first(t_u2, state=state), 180,
                                     f"{state} (U2)")
        crashed = kubelet.first("main-failed", after=t_u2, ds="gpu-driver")
        check(crashed is not None and crashed["t"] < t_u2 + u2["upgrade-failed_s"],
              f"no crash of the new driver before upgrade-failed: {crashed}")
        u2["driver_crashed_s"] = round(crashed["t"] - t_u2, 3)
        check(cordoned(), "the node not cordoned at upgrade-failed")
        u2["events"] = _events_since(before, _node_events(raw, ns, node_name))
        check(u2["events"].get("DriverUpgradeFailed") == 1, f"U2's Events {u2['events']}")
        u2["gauges_failed"] = _wait_for(lambda: (lambda g: g if g["failed"] == 1 else None)(
            _upgrade_gauges(op.metrics_port)), 30, "tpu_operator_nodes_upgrades_failed 1")
        status = _gpuop_cfg(ctx, "status", "--base-url", ctx.base)
        print(status["out"])
        check("upgrade-failed" in status["out"], "gpuop-cfg status shows no upgrade-failed")
        # sticky while the pod crash-loops in place, ready between its crashes
        time.sleep(3.0)
        check(trail.states(t_u2)[-1] == "upgrade-failed", f"U2 left upgrade-failed: "
                                                          f"{trail.states(t_u2)}")
        t_r = time.time()
        u2["failed_held_s"] = round(t_r - t_u2 - u2["upgrade-failed_s"], 3)
        patch_policy({"driver": {"env": U1_ENV}})
        # the retry leaves upgrade-failed and cordons in one sweep: its
        # upgrade-required may not reach the apiserver as a state of its own
        for state in ("pod-restart-required", "validation-required", "upgrade-done"):
            u2[f"retry_{state}_s"] = since(t_r, lambda: trail.first(t_r, state=state), 180,
                                           f"{state} (U2's retry)")
        u2["retry_cleared_s"] = since(t_r, lambda: trail.first(
            t_r + u2["retry_upgrade-done_s"], state=""), 60, "the label cleared (U2)")
        check(not cordoned(), "the machine left its own cordon after U2's retry")
        done = trail.first(t_r, state="upgrade-done")
        check(not done["cordoned"], f"upgrade-done still cordoned: {done}")
        u2["states"] = trail.states(t_u2)
        u2["gauges"] = _wait_for(lambda: (lambda g: g if g["available"] == 1 else None)(
            _upgrade_gauges(op.metrics_port)), 30, "the gauges after U2")
        check(u2["gauges"]["failed"] == 0, f"the gauges after U2: {u2['gauges']}")
        numbers["u2"] = u2
        print(json.dumps({"upgrade_u2": u2, "card": ctx.card}))

        # -- the records ----------------------------------------------------------------
        status = _gpuop_cfg(ctx, "status", "--base-url", ctx.base)
        print(status["out"])
        explain = _gpuop_cfg(ctx, "explain", "node", node_name, "--base-url", ctx.base)
        check(explain["rc"] == 0, f"gpuop-cfg explain exited {explain['rc']}: "
                                  f"{explain['out']}{explain['err'][-2000:]}")
        print(explain["out"])
        episodes = _explain_episodes(explain["out"])
        check(all(len({k.split("/")[0] for k in kinds}) == 1 for _, kinds in episodes),
              f"an episode mixes subsystems: {episodes}")
        upgrades = [kinds for _, kinds in episodes if kinds[0].startswith("upgrade/")]
        check(upgrades == [[f"upgrade/{k}" for k in EPISODE_U1],
                           [f"upgrade/{k}" for k in EPISODE_U2]],
              f"explain's upgrade episodes {episodes}")
        numbers["episodes"] = [[e, kinds] for e, kinds in episodes]
        numbers["evictions"] = {"requests": len(ctx.srv.evictions),
                                "refused_429": sum(1 for e in ctx.srv.evictions if e[3] == 429)}
        maps = {"operator": op.maps(), "gpuop_cfg": explain["maps_line"]}
        check(maps["operator"] == (False, False) and explain["maps_line"] == "MAPS False False",
              f"maps torch/libcuda: {maps}")
        _wait_for(lambda: cp_state() == "ready", 120, "the ClusterPolicy ready at the end")
        numbers["phase_s"] = round(time.monotonic() - started, 3)
        print(json.dumps({"upgrade_phase": {k: numbers[k] for k in (
            "setup_s", "episodes", "evictions", "phase_s")}, "card": ctx.card}))
    except SystemExit:
        print(f"-- {op.log_path}:\n{op.log()[-6000:]}", file=sys.stderr)
        if trail is not None:
            print(f"-- node trail: {trail.changes}", file=sys.stderr)
        print(f"-- evictions: {ctx.srv.evictions}", file=sys.stderr)
        for name, text in kubelet.logs("gpu-driver").items():
            print(f"-- gpu-driver/{name}:\n{text[-3000:]}", file=sys.stderr)
        raise
    finally:
        if watch is not None:
            watch.stop()
        if trail is not None:
            trail.stop()
        for api_version, kind in (("v1", "Pod"), ("policy/v1", "PodDisruptionBudget")):
            with contextlib.suppress(Exception):
                raw.delete(api_version, kind, "gpu-consumer", "default")
        op.stop()
    return numbers


def _try_scrape(port: int):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
            return r.read().decode()
    except OSError:
        return None


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs an NVIDIA GPU")
    try:
        from tpu_operator_torch.kernels import _build
        from tpu_operator_torch.kernels import stream_copy as k1
        from tpu_operator_torch.validator import main as vmain
        from tpu_operator_torch.validator import native
        from tpu_operator_torch.validator.perf import (HBM_STREAMING_BAND, lookup_peaks,
                                                       scale_add, stream_rows)
        from tpu_operator_torch.validator.status import StatusFiles
        from tpu_operator_torch import graft_entry
    except ImportError as e:
        fail(f"tpu_operator_torch not importable ({e}): run from the repository root")

    # the operator's join trace context, as the operand template stamps it:
    # every component below (and every subprocess) logs its spans into the
    # status dir, which feature discovery mirrors in phase 9
    trace_id = uuid.uuid4().hex
    os.environ["GPU_TRACE_PARENT"] = f"{trace_id}-{uuid.uuid4().hex[:16]}"

    phase("environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    # the device node of each GPU this process sees, as a pod holding those
    # GPUs has them: the machine may show other GPUs' nodes as well, which
    # the exporter and info would count
    query = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True, timeout=60)
    minors = re.findall(r"Minor Number\s*:\s*(\d+)", query.stdout)
    check(len(minors) == torch.cuda.device_count(), f"minor numbers {minors}")
    os.environ["GPU_DEV_GLOBS"] = ",".join(f"/dev/nvidia{m}" for m in minors)
    print(f"GPU device nodes: {os.environ['GPU_DEV_GLOBS']}")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}")
    peaks = lookup_peaks(kind)
    check(peaks is not None, f"no peak-table row for {kind!r}")
    chip, _, hbm_peak_gbps = peaks
    print(f"peaks: {chip} HBM {hbm_peak_gbps} GB/s (data sheet)")

    phase("build")
    t0 = time.perf_counter()
    built = _build.build_all()
    nvcc_s = round(time.perf_counter() - t0, 3)
    native_s = native.build()  # the native probe and exporter, with g++
    print(json.dumps({"build_s": nvcc_s, "per_source_s": built, "native_s": native_s,
                      "native_build_s": round(time.perf_counter() - t0 - nvcc_s, 3)}))
    for name, log in _build.build_logs.items():
        print(f"-- ptxas {name}:\n{log.strip()}")
    print(f"K1: bulk copies of {k1.CHUNK_BYTES} B, two per CTA, dynamic shared memory "
          f"raised to cap residency at two CTAs per SM (csrc/stream_copy.cu)")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    phase("K1 stream_copy against its plain version")
    rows = stream_rows(512)  # the perf component's default 512 MiB
    x_main = torch.randn((rows, 1024), generator=gen, device=dev)
    ragged = torch.randn((1_000_003,), generator=gen, device=dev)
    base = torch.randn((1_000_005,), generator=gen, device=dev)
    cases = {
        "main (131072, 1024)": x_main,
        "ragged 1000003": ragged,
        "view at element 1": base[1:],
    }
    before = k1.launches
    max_err = 0.0
    for label, x in cases.items():
        y = k1.stream_copy(x)
        ref = k1.stream_copy_reference(x)
        torch.cuda.synchronize()
        check(bits_equal(y, ref), f"stream_copy differs from its plain version: {label}")
        max_err = max(max_err, (y - ref).abs().max().item())
        print(f"{label}: bit-exact")
    # chunk boundaries: a body of one chunk, one chunk +- 16 B, two chunks,
    # and more chunks than CTAs with a ragged tail, each at element offsets
    # 0 and 1 of both ends (scalar head, bulk body, scalar tail)
    chunk = k1.CHUNK_BYTES // 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lengths = [chunk, chunk - 4, chunk + 4, chunk + 3, 2 * chunk,
               3 * sms * chunk + 4 * 7 + 3]
    pool = torch.randn((max(lengths) + 8,), generator=gen, device=dev)
    sentinel = -12345.0
    expected = len(cases)

    def placed(n: int, src_off: int, dst_off: int, label: str) -> None:
        dst = torch.full((n + 8,), sentinel, device=dev)
        k1.launch(pool[src_off:src_off + n], dst[dst_off:dst_off + n])
        torch.cuda.synchronize()
        check(bits_equal(dst[dst_off:dst_off + n], pool[src_off:src_off + n]),
              f"stream_copy differs from its plain version: {label}")
        check(bool((dst[:dst_off] == sentinel).all()) and
              bool((dst[dst_off + n:] == sentinel).all()),
              f"stream_copy wrote outside its destination: {label}")

    for n in lengths:
        for off in (0, 1):
            placed(n, off, off, f"n={n} at element {off}")
            expected += 1
    print(f"chunk boundaries {lengths} at element offsets 0 and 1: bit-exact, "
          f"neighbours untouched")
    # every relative alignment of the two ends (element offsets 0-3 each)
    for src_off in range(4):
        for dst_off in range(4):
            placed(1_000_003, src_off, dst_off, f"offsets src {src_off} dst {dst_off}")
            expected += 1
    print("every relative alignment (offsets 0-3 x 0-3): bit-exact, neighbours untouched")
    bad = k1.launch_plan(x_main.data_ptr(), x_main.data_ptr(), x_main.numel())
    try:
        k1.run_plan(x_main, torch.empty_like(x_main), bad._replace(tail=bad.tail + 1))
        fail("stream_copy accepted a plan that does not cover the tensor")
    except RuntimeError as e:
        print(f"inconsistent plan refused: {e}")
    check(k1.launches == before + expected,
          f"launch count {k1.launches - before}, expected {expected}")

    phase("K1 timing")
    out = torch.empty_like(x_main)
    bytes_moved = 2 * x_main.numel() * 4
    fns = {"kernel": k1.stream_copy, "plain": k1.stream_copy_reference,
           "library": lambda t: out.copy_(t), "probe": scale_add}
    samples = {name: [] for name in fns}
    order = list(fns)
    for name in order + order[::-1]:
        samples[name].append(cuda_ms(fns[name], x_main, reps=50))
    timing = {name: statistics.median(v) for name, v in samples.items()}
    gbps = {name: bytes_moved / ms / 1e6 for name, ms in timing.items()}
    bound_ms = bytes_moved / (hbm_peak_gbps * 1e9) * 1e3
    print(json.dumps({"kernel": "stream_copy", "shape": list(x_main.shape),
                      "kernel_ms": timing["kernel"], "plain_ms": timing["plain"],
                      "library_ms": timing["library"], "probe_ms": timing["probe"],
                      "bound_ms": bound_ms, "gbps": gbps, "card": card}))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scale_add(x_main)
        torch.cuda.synchronize()
    probe_kernels = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    print(f"probe device kernels (torch.profiler): {probe_kernels}")
    check(len(probe_kernels) == 1, f"the HBM probe ran {len(probe_kernels)} device kernels")
    del x_main, out, fns

    phase("main path: workload-local, then perf")
    status_dir = tempfile.mkdtemp(prefix="chip-smoke-status-")
    k1.launches = 0
    rc = vmain.run(["-c", "workload-local", "--matrix-dim=512",
                    f"--status-dir={status_dir}"])
    check(rc == 0, f"workload-local exited {rc}")
    status = StatusFiles(status_dir)
    barrier = status.read("workload")
    check(status.is_ready("workload"), f"workload barrier not ready: {barrier}")
    check(barrier.get("platform") == "gpu", f"workload platform {barrier.get('platform')}")
    perf_before = k1.launches
    rc = vmain.run(["-c", "perf", f"--status-dir={status_dir}"])
    k1_main_launches = k1.launches
    check(rc == 0, f"perf exited {rc}")
    report = status.read("perf")
    check(report is not None and report.get("hbm_pallas_gbps", 0) > 0,
          f"perf barrier without a streaming-kernel reading: {report}")
    check(k1_main_launches > perf_before, "stream_copy was not launched by perf")
    print(json.dumps({"perf_report": report, "card": card}))
    ratio = report.get("hbm_streaming_cross_check_ratio")
    check(ratio is not None and HBM_STREAMING_BAND[0] <= ratio <= HBM_STREAMING_BAND[1],
          f"probe/K1 ratio {ratio} outside {HBM_STREAMING_BAND}")
    probe_vs_copy = report["hbm_gbps"] / gbps["library"]
    print(f"perf hbm_gbps {report['hbm_gbps']} / copy_ {gbps['library']:.3f} GB/s "
          f"= {probe_vs_copy:.4f}")
    check(abs(probe_vs_copy - 1.0) <= 0.05,
          f"the HBM probe streams at {probe_vs_copy:.4f} of copy_'s rate, not within 5%")

    phase("graft entry")
    fn, args = graft_entry.entry()
    c, checks = fn(*args)
    check(bool(checks.all()) and tuple(c.shape) == (512, 512), f"entry checks {checks}")
    graft_entry.dryrun_multichip(1)
    print("entry ok, dryrun_multichip(1) ok")

    phase("serving: the decode step as a CUDA graph")
    k1.launches = 0
    serving_report = serving_phase(dev, gen, card, status_dir)
    serving_launches = k1.launches
    check(serving_launches == 0, f"the serving path launched K1 {serving_launches} times")

    phase("prewarm: K1 into a fresh build cache, then loaded without nvcc")
    prewarm_phase(card, status_dir)

    phase("steady state and node identity")
    k1.launches = 0
    steady_state_phase(dev, card, status_dir, trace_id, serving_report)
    steady_state_launches = k1.launches
    check(steady_state_launches == 0,
          f"the steady-state path launched K1 {steady_state_launches} times")

    phase("device plumbing: NVML, the device plugin, CDI, telemetry")
    k1.launches = 0
    plumbing_phase(card, status_dir)
    plumbing_launches = k1.launches
    check(plumbing_launches == 0, f"the device plumbing launched K1 {plumbing_launches} times")

    phase("the validator's last components: driver, probe, partitioner, exporter, migrate")
    k1.launches = 0
    last_components_phase(card, status_dir, native_s)
    last_launches = k1.launches
    check(last_launches == 0, f"the last components launched K1 {last_launches} times")

    phase("the operator's join on the card: gpu-operator, a process kubelet, the chain")
    k1.launches = 0
    counts = {}

    def phases_13_to_15(ctx):
        counts["operator"] = k1.launches
        phase("GPUDriver hand-over and back, the CRD schema, leader election and the fence")
        k1.launches = 0
        gpudriver_phase(ctx)
        counts["gpudriver"] = k1.launches
        phase("the GPU-health loop and its black box: two episodes, explain, the audit")
        k1.launches = 0
        health_phase(ctx)
        counts["health"] = k1.launches
        phase("the rolling driver upgrade: U1 past a PDB, U2 crash-looping and retried")
        k1.launches = 0
        upgrade_phase(ctx)
        counts["upgrade"] = k1.launches

    operator_phase(card, then=phases_13_to_15)
    operator_launches, gpudriver_launches = counts["operator"], counts["gpudriver"]
    health_launches, upgrade_launches = counts["health"], counts["upgrade"]
    check(operator_launches == 0, f"the operator path launched K1 {operator_launches} times")
    check(gpudriver_launches == 0, f"phase 13 launched K1 {gpudriver_launches} times")
    check(health_launches == 0, f"phase 14 launched K1 {health_launches} times")
    check(upgrade_launches == 0, f"phase 15 launched K1 {upgrade_launches} times")

    print(json.dumps({"smoke_s": round(time.monotonic() - _T0, 1), "card": card}))
    print(json.dumps({"kernels": [{
        "name": "stream_copy",
        "route": "cuda",
        "source": "tpu_operator_torch/csrc/stream_copy.cu",
        "replaces": "tpu_operator/validator/perf.py:302",
        "launches": k1_main_launches,
        "max_abs_err": max_err,
        "ms": timing["kernel"],
        "plain_ms": timing["plain"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": timing["library"],
        # the paths without K1 launch it no time: serving (7), the steady
        # state (9), the device plumbing (10), the last components (11), the
        # operator (12), the GPUDriver and leader phase (13), the health
        # loop (14) and the rolling upgrade (15) are checked at 0 above
        "launches_by_phase": {"perf": k1_main_launches, "serving": serving_launches,
                              "steady_state": steady_state_launches,
                              "device_plumbing": plumbing_launches,
                              "last_components": last_launches,
                              "operator": operator_launches,
                              "gpudriver": gpudriver_launches,
                              "health": health_launches,
                              "upgrade": upgrade_launches},
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
