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

12. the operator's join on the card, installed from the port's chart
   (``deployments/gpu-operator``, rendered by the port's helmlite with the
   phase's settings as chart values), its ClusterPolicy the shipped
   bare-metal sample (``config/gpu/samples/v1_clusterpolicy_baremetal.yaml``,
   read with the port's YAML reader) with only what this machine and the
   smoke force over it, each override printed (:func:`sample_policy`): an
   in-process MiniApiServer whose one Node is this machine (NVIDIA's
   feature-discovery PCI label, no GPU capacity yet) given every rendered
   object but the chart's ClusterPolicy (the CRDs, the release Namespace,
   the RBAC, the Deployment); ``gpu-operator``
   started from the rendered Deployment's container (its console script as
   ``python -m`` of the module ``[project.scripts]`` names, its args, its
   env with the downward-API namespace resolved to the release's, plus only
   ``--api-server`` and two free ports) in a subprocess that must map
   neither torch nor libcuda; the ClusterPolicy's host paths in a temp dir
   and its device globs the card's; a process kubelet
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
   (phase 14 turns it on). Once ``ready``, the quickstart's pass
   (``docs/gpu/quickstart.md``, :func:`quickstart_pass`), each step timed:
   telemetry disabled and enabled again by the document's patch (its
   DaemonSet gone, then back and available), the node's telemetry
   kill-switch label set (its pod leaves the node) and removed (it comes
   back), the document's workload Pod requesting one ``nvidia.com/gpu``
   bound to the node and run by the kubelet, which allocates it one GPU in
   ``CUDA_VISIBLE_DEVICES`` by NVML's UUID, as the device plugin's Allocate
   would (it sees exactly that GPU), and ``gpuop-cfg status`` exiting 0. No hand-written kernel runs
   in this phase (K1's count under ``operator`` is 0).
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
16. on that cluster (:func:`autoscale_phase`): the capacity loop under
   chaos. A fresh operator in this process, its ``RestClient`` over the
   chaos transport (seed 1729, 10% of requests refused or answered 429/503,
   20% of watch streams chopped). The card's node carries the serving
   frontier feature discovery published from the serving probe on the card
   (run first when the node has none), and the capacity collector's tokens
   per node, ``/debug/capacity`` and the pool's metric must equal its best
   tokens/s at the SLO. A traffic snapshot at 2.5 times that makes the
   autoscaler register two nodes with the pool's template (a simulated
   kubelet animates them alone); at 0.5 times, after the cooldown, it
   scales down by migration: a simulated training job on the victim (never
   the card's node) acks the drain, the migration goes draining,
   transferring, restoring, done onto another node, the victim is deleted
   and the tenant resumes at its acked step. Every chaos kind injected,
   the retries and the breaker's transitions, the terminal state the one a
   run without chaos reaches, no orphan actuation, ``gpuop-cfg status``
   mid-migration (AUTOSCALE, MIGRATION) and the operator's modules in fresh
   processes mapping neither torch nor libcuda. No hand-written kernel
   (K1's count under ``autoscale`` is 0).
17. after phase 16 (:func:`simulator_phase`): the fleet simulator
   (``gpu-sim``) on the card's frontier. The curve phase 16 checked on the
   card's node (the serving probe's, on the card) and the per-GPU rate a
   simulated node derives from it; the five committed scenarios
   (``tests/cases/scenarios/``) each through ``gpu-sim run --double-run
   --json`` in a fresh process that maps neither torch nor libcuda (every
   oracle green, the two canonical logs byte-identical); the same cases in
   this process on the card's curve, whose canonical logs must be the
   processes' (a card's scale changes no decision); a 3-scenario fuzz sweep
   at the pinned seed 20260806, double-run (the scenario-fuzz gate's 25 cut
   to 3 for time); the serving-traffic mix twice over phase 11's partition
   handoff from the card's NVML (equal dicts, no unhandled error, no request
   lost). No hand-written kernel (K1's count under ``simulator`` is 0).
18. after phase 17 (:func:`must_gather_phase`): the support bundle. A fresh
   ``gpu-operator`` from the chart's rendered Deployment (and its Pod, as a
   ReplicaSet makes it, at this machine's address); ``gpu-must-gather``
   in a fresh process against the live cluster, the operator's metrics
   and health ports, phase 12's status directory and the exporters' URLs;
   its tarball must hold a file in every section, every route of the
   operator's ``DEBUG_ROUTES``, the card's node at NVML's GPU count of
   ``nvidia.com/gpu``, phase 12's barrier files and a scrape of the port's
   exporters. Then ``gpuop-cfg validate-csv`` of the OLM bundle and
   ``schema_gen --check`` in torch-free processes, each exiting 0. No
   hand-written kernel (K1's count under ``must_gather`` is 0).
19. after phase 18, outside the operator's cluster (:func:`lint_phase`):
   the port's static checker, ``gpuop-lint`` (its console script), in
   fresh processes that must map neither torch nor libcuda, over this
   tree: exit 0 with no new, baselined or stale finding, under the
   reference's 30 s budget; ``--list-rules`` names the reference's 17
   rules; ``--format json`` and ``--format sarif`` parse and the SARIF run
   names ``gpuop-lint``; and a copy of the tree with the in-place
   suppression in ``client/rest.py`` removed exits 1, naming that rule and
   file. ``--changed`` needs a git checkout, which this tree need not be:
   it is tested on the CPU. No hand-written kernel (K1's count under
   ``lint`` is 0).
20. after phase 19 (:func:`opsan_phase`): a sanitized join. A fresh
   one-node cluster as phase 12's (:func:`join_cluster`), its
   ``gpu-operator`` run under the race sanitizer (``GPU_OPERATOR_OPSAN``,
   its schedule perturber, ``OPSAN_SEED=20260807``, a report directory),
   the validators on the card. At ``ready``: ``/debug/opsan`` answers
   enabled, tracking the structures the join reaches, with no race, and
   ``/metrics`` counts tracked accesses and no race; the operator maps
   neither torch nor libcuda. SIGTERM: it exits 0 through its shutdown path
   and dumps one report. A 3-scenario ``gpu-sim fuzz`` under the same
   switches adds its own. ``python -m tpu_operator_torch.cmd.opsan check``
   over both exits 0 (no race, no dynamic-only lock edge without its
   committed fixture) in a process that maps neither; over a planted race
   (two threads writing one registered dict with no lock) it exits 1,
   naming the variable. The sanitized ``ready`` seconds print beside phase
   12's. No hand-written kernel (K1's count under ``opsan`` is 0).
21. after phase 20 (:func:`lanes_phase`): the port's test lanes on the
   card's machine, with its own ``python3``, ``bash`` and ``curl`` (the
   phase fails naming whichever is missing). The shell e2e
   (``tests/scripts/torch/end-to-end.sh``: the cluster harness,
   ``gpu-operator --leader-elect`` as a process, the seven cases of
   ``tests/cases/torch/``) must print a PASS for every case; each case's
   seconds and the total print. The envtest driver
   (``tests/torch_envtest_driver.py --mini-apiserver``) must pass all five
   steps. ``tests/e2e-envtest-gpu.sh`` and ``tests/e2e-kind-gpu.sh`` must
   exit 77 with their skip records written into a temp dir, where the
   machine has no ``kube-apiserver``/``etcd`` or ``kind``/``docker``/
   ``kubectl`` (where it has them, they run and must exit 0). No
   hand-written kernel (K1's count under ``lanes`` is 0).
22. after phase 21 (:func:`outage_phase`): a join through an apiserver
   outage. A fresh one-node cluster as phase 12's whose ``gpu-operator``
   keeps the chart's ``--leader-elect`` (a 15 s lease, a 5 s renew). Once
   the validation chain runs on the card (the driver barrier written, the
   node's GPUs advertised, the ClusterPolicy not yet ``ready``) the
   apiserver stops, cutting every live connection, for 6 s; meanwhile the
   ``gpu-device-plugin`` DaemonSet is deleted from its store and the
   process kubelet takes the node's GPUs back. A new apiserver over the
   same store then listens on the same port. The same operator process
   must still hold the Lease under the same epoch; the DaemonSet comes
   back and its pod runs, the node advertises NVML's GPU count again, the
   workload barrier passes and the ClusterPolicy is ``ready``, within the
   phase's 120 s. The outage's length, the seconds from the restart to
   each milestone, the operator's counters and the workload's
   ``elapsed_s`` print. No hand-written kernel (K1's count under
   ``outage`` is 0).
23. after phase 22 (:func:`pipelined_join_phase`): the pipelined join, the
   reference's join attribution. The operator in this process over a 20 ms
   MiniApiServer, the in-memory kubelet without pods (each DaemonSet's
   image pulled on its own clock per node from the labeller's pre-pull
   stamp: 10 ticks of 0.5 s for the validator's, 7 for the device
   plugin's, 5 for the rest; each pod gated on the barriers its rendered
   init containers wait on), and the node agent: the validator's
   ``driver``, ``plugin --prewarm`` and ``workload-local`` on the card in
   subprocesses, one after another, beside a ``wait --for workload``.
   Every step exits 0, the barriers are stamped in order, the pre-pull is
   attributed, the join profiler covers at least 95% of the window with no
   orphan span, within 120 s. ``join_s``, each DaemonSet's tick, the
   seconds per phase and the serial sum of the pulls print. No
   hand-written kernel (K1's count under ``pipelined`` is 0).
24. after phase 23 (:func:`multihost_phase`): the multi-node sweep.
   ``workload-multihost`` as a world of one process over every visible GPU
   through a TCP coordinator on 127.0.0.1 (``n_devices`` the GPU count,
   ``local_chips`` contiguous, no partial sweep, the barrier written); then
   a world of two with only process 0 started, at a 5 s rendezvous budget:
   a non-zero exit and no barrier; then ``make -f gpu.mk graft-check``.
   Each run's seconds print. The sweep is cuBLAS and NCCL, as the
   reference's is XLA dots and ``psum``: no hand-written kernel (K1's count
   under ``multihost`` is 0).

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
import shutil
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


#: the first failure's message, repeated as the last line of standard error
#: (the phases print their logs after it)
_FAILURES: list = []


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    _FAILURES.append(msg)
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


def check_beside(value, before, after, key, rel=0.0, tol=0.0, between=()) -> None:
    """``value`` lies in the band nvidia-smi's two samples ``before`` and
    ``after`` span, and the readings ``between`` them, widened by ``rel`` of
    it and by ``tol``."""
    lo, hi = min(before[key], after[key], *between), max(before[key], after[key], *between)
    check(lo * (1 - rel) - tol <= value <= hi * (1 + rel) + tol,
          f"{key}: the exporter's {value} against nvidia-smi's {before[key]} and "
          f"{after[key]} around it, {list(between)} between")


class SmiWatch:
    """``nvidia-smi``'s temperature reading every 20 ms, each stamped when
    it arrives (line-buffered through ``stdbuf``): what the die read between
    two samples."""

    def __init__(self):
        self.readings: list = []
        line_buffered = ["stdbuf", "-oL"] if shutil.which("stdbuf") else []
        self.proc = subprocess.Popen(
            [*line_buffered, "nvidia-smi", "--query-gpu=temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            start_new_session=True)
        self._thread = threading.Thread(target=self._read, daemon=True, name="smi-watch")
        self._thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            with contextlib.suppress(ValueError):
                self.readings.append((time.monotonic(), float(line.split(",")[0])))

    def between(self, t0: float, t1: float) -> list:
        return [v for t, v in list(self.readings) if t0 <= t <= t1]

    def stop(self) -> None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait(timeout=30)
        self._thread.join(timeout=10)


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
    # few degrees within a second, so the exporter's temperature is held to
    # the band the two samples and a 20 ms watch between them span, widened
    # by the tolerance
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
    watch = None
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
        watch = SmiWatch()
        for _ in range(3):
            t0 = time.monotonic()
            before, got, after = smi_sample(), scrape(port), smi_sample()
            temps = watch.between(t0, time.monotonic())
            pairs.append((got, [before, after, temps]))
            used = got['tpu_hbm_used_bytes{chip="0"}']
            check(used >= 8 * 2 ** 30, f"hbm used {used} under an 8 GiB hold")
            check_beside(used, before, after, "memory_used_bytes", rel=0.05)
            check(got['tpu_duty_cycle_percent{chip="0"}'] >= 50, f"duty cycle {got}")
            check_beside(got['tpu_power_watts{sensor="nvml/gpu0"}'], before, after, "power_w",
                         rel=0.15)
            check_beside(got['tpu_temperature_celsius{sensor="nvml/gpu0"}'], before, after,
                         "temperature_c", tol=2, between=temps)
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
        if watch is not None:
            watch.stop()
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


def _wait_for(predicate, timeout: float, what: str, explain=None):
    """``predicate()`` once truthy, polled until ``timeout``; then a
    failure naming ``what`` and, when given, ``explain()`` read at that
    moment."""
    deadline = time.monotonic() + timeout
    while True:
        value = predicate()
        if value:
            return value
        if time.monotonic() >= deadline:
            fail(f"{what} within {timeout}s" + (f": {explain()}" if explain else ""))
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
    numbers["handoff"] = restored  # phase 17 plays the traffic mix over it
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


def chart_values(work: str, status_dir: str) -> dict:
    """Phase 12's chart values over ``values.yaml``: the host paths in the
    work dir and the card's device nodes, revalidation off, the health
    machine off until phase 14 (the flip below measures the barrier's own
    path, with no health writes mixed in), feature discovery's interval at
    5 s in place of 60 (the operator's join trace holds the node's spans
    soon after ready), free exporter ports, and one operator without the
    election (phase 13 runs two that elect)."""
    return {
        "operator": {"leaderElect": False},
        "hostPaths": {"validationStatusDir": status_dir,
                      "partitionHandoffDir": os.path.join(work, "handoff"),
                      "driverInstallDir": os.path.join(work, "driver-install"),
                      "devGlobs": os.environ["GPU_DEV_GLOBS"].split(",")},
        "validator": {"revalidateIntervalS": 0},
        "health": {"enabled": False},
        "featureDiscovery": {"sleepInterval": "5s"},
        "telemetry": {"metricsPort": free_port()},
        "nodeStatusExporter": {"metricsPort": free_port()},
    }


def install_from_chart(repo: str, values: dict, namespace: str) -> list:
    """``helm install --create-namespace`` of the port's chart, rendered by
    the port's helmlite: every object, in install order; the ClusterPolicy
    must pass the CRD's schema."""
    from tpu_operator_torch.api import schema_gen, schema_validate
    from tpu_operator_torch.testing import helmlite

    helm = helmlite.HelmLite(os.path.join(repo, "deployments", "gpu-operator"), values=values,
                             release_namespace=namespace)
    rendered = helmlite.install_order(helm.render_all(create_namespace=True))
    cp = next(o for o in rendered if o["kind"] == "ClusterPolicy")
    errors = schema_validate.validate_cr(cp, schema_gen.clusterpolicy_crd())
    check(errors == [], f"the chart's ClusterPolicy fails its schema: {errors}")
    return rendered


def console_script(repo: str, name: str) -> list:
    """``[python, -m, module]`` for a console script of ``[project.scripts]``."""
    import tomllib

    with open(os.path.join(repo, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    check(name in scripts, f"no console script {name!r} in pyproject.toml")
    return [sys.executable, "-m", scripts[name].split(":")[0]]


def deployment_process(repo: str, deployment: dict) -> tuple:
    """The rendered Deployment's one container as a process here: its
    command (a console script) as ``python -m`` of its module, its args,
    and its env, the downward API's namespace resolved to the release's."""
    [ctr] = deployment["spec"]["template"]["spec"]["containers"]
    [script] = ctr["command"]
    env = {}
    for item in ctr.get("env") or []:
        field = ((item.get("valueFrom") or {}).get("fieldRef") or {}).get("fieldPath")
        if "value" in item:
            env[item["name"]] = str(item["value"])
        elif field == "metadata.namespace":
            env[item["name"]] = deployment["metadata"]["namespace"]
        else:
            fail(f"the Deployment's env {item} has no value to give a process")
    return [*console_script(repo, script), *ctr.get("args", [])], env


def card_node(work: str) -> dict:
    """This machine as a one-node cluster's node for :func:`join_cluster`:
    its name (the host's), its GPU count and UUIDs (NVML's), the validator's command
    line, the kubelet's modes (every operand run, the device plugin's init
    alone) and the driver image's content (the machine's own driver
    libraries, linked into ``work``)."""
    from tpu_operator_torch import consts, nvml
    from tpu_operator_torch.testing.kubelet import INIT, RUN
    from tpu_operator_torch.validator import driver

    node_name = re.sub(r"[^a-z0-9.-]", "-", socket.gethostname().lower()).strip("-.") or "node"
    with nvml.session() as s:
        gpu_uuids = [g.uuid for g in s.gpus()]
    gpu_count = len(gpu_uuids)
    host_dir = os.path.dirname(driver.find_host_driver() or fail("no host libcuda.so.1"))
    bundle = os.path.join(work, "bundle")
    os.makedirs(bundle)
    for name in consts.DRIVER_LIB_FILES:
        os.symlink(os.path.realpath(os.path.join(host_dir, name)), os.path.join(bundle, name))
    return {"node_name": node_name, "gpu_count": gpu_count, "gpu_uuids": gpu_uuids,
            "validator": [sys.executable, "-m", "tpu_operator_torch.cmd.validator"],
            "modes": {"gpu-driver": RUN, "gpu-operator-validator": RUN,
                      "gpu-device-plugin": INIT, "gpu-feature-discovery": RUN,
                      "gpu-telemetry-exporter": RUN, "gpu-node-status-exporter": RUN},
            "driver_env": {consts.DRIVER_SRC_ENV: bundle}}


#: the shipped sample phase 12 joins the card from
BAREMETAL_SAMPLE = os.path.join("config", "gpu", "samples", "v1_clusterpolicy_baremetal.yaml")


def sample_policy(repo: str, work: str, status_dir: str) -> tuple:
    """Phase 12's ClusterPolicy: the shipped bare-metal sample, read with
    the port's YAML reader, with only what this machine or the smoke forces
    set over it. Returns the CR and its overrides, ``{spec path: (value,
    why)}``."""
    from tpu_operator_torch import yamlsubset

    with open(os.path.join(repo, BAREMETAL_SAMPLE)) as f:
        cp = yamlsubset.parse(f.read())
    shared = "every pod of this machine shares its host network"
    overrides = {
        "hostPaths.validationStatusDir": (status_dir, "the run's own directory"),
        "hostPaths.driverInstallDir": (os.path.join(work, "driver-install"),
                                       "the installer must not write the host's driver"),
        "hostPaths.partitionHandoffDir": (os.path.join(work, "handoff"),
                                          "the run's own directory"),
        "hostPaths.devGlobs": (os.environ["GPU_DEV_GLOBS"].split(","),
                               "this machine's GPU device nodes"),
        "telemetry.metricsPort": (free_port(), shared),
        "nodeStatusExporter.metricsPort": (free_port(), shared),
        "health.enabled": (False, "phase 14 turns the health machine on; the barrier flip "
                                  "below would count toward its flap window"),
        "featureDiscovery.sleepInterval": ("5s", "the join trace must hold the node's "
                                                 "spans within its 40 s wait"),
    }
    for path, (value, _) in overrides.items():
        *parents, leaf = path.split(".")
        section = cp["spec"]
        for key in parents:
            section = section.setdefault(key, {})
        section[leaf] = value
    return cp, overrides


def join_cluster(repo: str, work: str, node: dict, leader_elect: bool = False,
                 policy: dict = None) -> types.SimpleNamespace:
    """The one-node cluster of phases 12, 20 and 22: the port's chart
    rendered with :func:`chart_values` (its ClusterPolicy, or ``policy`` in
    its place, must pass the CRD's schema), a MiniApiServer holding the node
    (``node`` as :func:`card_node` gives it) and every rendered object but the
    ClusterPolicy (``helm install``; the join starts when the caller creates
    it), and a process kubelet on the node, not yet started, which runs the
    DaemonSets the operator renders, the validation chain and its spawned
    workload pod, and a user's Pod (``python3`` is this interpreter).
    Returns ``srv``, ``base``, ``kubelet``, ``cp``, ``deployment``, ``argv``
    and ``env`` (the Deployment's process here), ``rendered`` and
    ``status_dir``. ``leader_elect`` keeps the chart's default,
    ``--leader-elect`` on the Deployment (phase 22)."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.api import schema_gen, schema_validate
    from tpu_operator_torch.testing import helmlite
    from tpu_operator_torch.testing.apiserver import MiniApiServer
    from tpu_operator_torch.testing.kubelet import ProcessKubelet

    status_dir = os.path.join(work, "status")
    values = chart_values(work, status_dir)
    values["operator"]["leaderElect"] = leader_elect
    rendered = install_from_chart(repo, values, consts.DEFAULT_NAMESPACE)
    cp = next(o for o in rendered if o["kind"] == "ClusterPolicy")
    if policy is not None:
        errors = schema_validate.validate_cr(policy, schema_gen.clusterpolicy_crd())
        check(errors == [], f"the ClusterPolicy fails its schema: {errors}")
        cp = policy
    deployment = next(o for o in rendered if o["kind"] == "Deployment")
    argv, deployment_env = deployment_process(repo, deployment)
    srv = MiniApiServer()
    base = srv.start()
    srv.backend.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": node["node_name"], "labels": {consts.NFD_NVIDIA_PCI_LABEL: "true",
                                              "kubernetes.io/hostname": node["node_name"]}}})
    helmlite.apply(srv.backend, rendered, skip_kinds=("ClusterPolicy",))
    base_env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LD_LIBRARY_PATH",
                                           "CUDA_HOME") if k in os.environ}
    base_env.update(PYTHONPATH=repo, KUBE_API_URL=base)
    kubelet = ProcessKubelet(
        srv.backend, node["node_name"], consts.DEFAULT_NAMESPACE, os.path.join(work, "logs"),
        base_env, {"gpu-validator": node["validator"], "python3": [sys.executable]},
        modes=node["modes"],
        image_env={"gpu-driver": node["driver_env"]},
        capacity_app="gpu-device-plugin", gpu_count=node["gpu_count"],
        path_map={"/var/cache/gpu-kernels": os.path.join(work, "kernel-cache")},
        gpu_ids=node.get("gpu_uuids"))
    return types.SimpleNamespace(srv=srv, base=base, kubelet=kubelet, cp=cp,
                                 deployment=deployment, argv=argv, env=deployment_env,
                                 rendered=rendered, status_dir=status_dir)


#: the quickstart whose steps phase 12 takes on its cluster
QUICKSTART_DOC = os.path.join("docs", "gpu", "quickstart.md")
#: the namespace a user's workload Pod runs in
WORKLOAD_NAMESPACE = "default"


def quickstart_manifests(repo: str) -> dict:
    """What the quickstart has a user apply, as the document gives it: the
    workload ``pod`` (its ``yaml`` block of kind Pod) and the telemetry
    ``disable`` and ``enable`` patches (each ``kubectl patch ... -p`` JSON)."""
    from tpu_operator_torch import yamlsubset

    with open(os.path.join(repo, QUICKSTART_DOC)) as f:
        text = f.read()
    blocks = [yamlsubset.parse(b) for b in re.findall(r"```yaml\n(.*?)```", text, re.S)]
    pods = [b for b in blocks if b.get("kind") == "Pod"]
    patches = [json.loads(p) for p in re.findall(r"--type merge -p '(\{.*?\})'", text)]
    telemetry = {p["spec"]["telemetry"]["enabled"]: p for p in patches
                 if "telemetry" in p.get("spec", {})}
    check(len(pods) == 1 and set(telemetry) == {False, True},
          f"{QUICKSTART_DOC}: {len(pods)} workload Pods, telemetry patches {telemetry}")
    return {"pod": pods[0], "disable": telemetry[False], "enable": telemetry[True]}


def quickstart_pass(ctx) -> dict:
    """The quickstart's day-one steps on a ``ready`` cluster, each timed and
    checked: (a) telemetry disabled by the document's patch (its DaemonSet
    and pod gone) and enabled by the other (back and available); (b) the
    node's telemetry kill-switch label set to ``false`` (the pod leaves the
    node) and removed (the labeller restores the gate, the pod comes back);
    (c) the document's workload Pod, bound to the node as a scheduler would
    (its node selector and its ``nvidia.com/gpu`` limit fit), run by the
    kubelet, which allocates it as many of the node's GPUs as it asked for
    in ``CUDA_VISIBLE_DEVICES`` (NVML's UUIDs, as the device plugin's
    Allocate would): on ``cuda`` it sees exactly the GPUs allocated, each
    one NVML reports, on ``cpu`` none; (d) ``gpuop-cfg status`` exits 0.

    ``ctx``: ``srv``, ``base``, ``kubelet``, ``namespace``, ``node_name``,
    ``repo``, ``card``, ``operator_env`` and ``device``."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.client import NotFoundError

    raw, kubelet, node_name = ctx.srv.backend, ctx.kubelet, ctx.node_name
    docs = quickstart_manifests(ctx.repo)
    ds_name = "gpu-telemetry-exporter"
    pod_name = f"{ds_name}-{node_name}"
    started = time.monotonic()
    numbers = {"card": ctx.card}

    def get(*key):
        try:
            return raw.get(*key)
        except NotFoundError:
            return None

    def ds_status():
        return (get("apps/v1", "DaemonSet", ds_name, ctx.namespace) or {}).get("status") or {}

    def telemetry_back(t0):
        # a pod the kubelet started after t0 and then saw ready ("simulated"
        # for a DaemonSet it does not run): a status the old pod wrote does
        # not count
        started = kubelet.first("pod-start", after=t0, ds=ds_name)
        return (started is not None
                and (kubelet.first("ready", after=started["t"], ds=ds_name)
                     or kubelet.first("simulated", after=started["t"], ds=ds_name))
                and ds_status().get("numberAvailable") == 1
                and get("v1", "Pod", pod_name, ctx.namespace) is not None
                and (get("tpu.ai/v1", "ClusterPolicy", "cluster-policy").get("status")
                     or {}).get("state") == "ready")

    def timed(key, what, run):
        t0 = time.monotonic()
        run()
        numbers[key] = round(time.monotonic() - t0, 3)
        print(json.dumps({"quickstart_step": key, "what": what, "s": numbers[key],
                          "card": ctx.card}))

    def toggle():
        t0 = time.time()
        _patch_policy(ctx, docs["disable"]["spec"])
        # gone from the apiserver, and its pod stopped by the kubelet
        _wait_for(lambda: get("apps/v1", "DaemonSet", ds_name, ctx.namespace) is None
                  and get("v1", "Pod", pod_name, ctx.namespace) is None
                  and kubelet.first("pod-stop", after=t0, ds=ds_name), 60,
                  "the telemetry DaemonSet and its pod gone after the disable patch")
        t1 = time.time()
        _patch_policy(ctx, docs["enable"]["spec"])
        _wait_for(lambda: telemetry_back(t1), 120,
                  "telemetry back and available after the enable patch")

    def kill_switch():
        key = consts.deploy_label("telemetry")
        raw.patch("v1", "Node", node_name, {"metadata": {"labels": {key: "false"}}})
        _wait_for(lambda: ds_status().get("desiredNumberScheduled") == 0
                  and get("v1", "Pod", pod_name, ctx.namespace) is None, 60,
                  "the telemetry pod off the kill-switched node")
        check(raw.get("v1", "Node", node_name)["metadata"]["labels"].get(key) == "false",
              "the operator overwrote the node's kill switch")
        t1 = time.time()
        raw.patch("v1", "Node", node_name, {"metadata": {"labels": {key: None}}})
        _wait_for(lambda: raw.get("v1", "Node", node_name)["metadata"]["labels"].get(key)
                  == "true" and telemetry_back(t1), 120,
                  "the gate restored and telemetry back after the kill switch's removal")

    def workload():
        pod = copy.deepcopy(docs["pod"])
        pod["metadata"]["namespace"] = WORKLOAD_NAMESPACE
        node = raw.get("v1", "Node", node_name)
        labels = node["metadata"].get("labels") or {}
        selector = pod["spec"].get("nodeSelector") or {}
        [container] = pod["spec"]["containers"]
        want = int(container["resources"]["limits"][consts.GPU_RESOURCE_NAME])
        allocatable = int((node.get("status") or {}).get("allocatable", {}).get(
            consts.GPU_RESOURCE_NAME, 0))
        check(all(labels.get(k) == v for k, v in selector.items()) and want <= allocatable,
              f"the workload Pod does not fit the node: selector {selector}, "
              f"{want} of {allocatable} GPUs")
        pod["spec"]["nodeName"] = node_name  # the scheduler's binding
        t0 = time.time()
        raw.create(pod)
        name = pod["metadata"]["name"]
        done = _wait_for(lambda: kubelet.first("pod-exit", after=t0, pod=name), 180,
                         "the quickstart's workload Pod to finish")
        text = "\n".join(t for k, t in kubelet.spawned_logs().items()
                         if k.startswith(container["name"] + "@"))
        report = _report_line(text, '"device_count"')
        check(done["rc"] == 0 and report is not None,
              f"the workload Pod exited {done['rc']}: {text[-2000:]}")
        # the kubelet's allocation, as the device plugin's Allocate hands it:
        # as many GPUs as the limit, in the container's CUDA_VISIBLE_DEVICES
        allocated = (kubelet.first("gpu-allocated", after=t0, pod=name) or {}).get("ids", [])
        check(len(allocated) == want, f"the workload Pod was allocated {allocated} "
                                      f"for its limit of {want}")
        if ctx.device == "cuda":
            from tpu_operator_torch import nvml

            with nvml.session() as session:
                uuids = [g.uuid for g in session.gpus()]
            seen = [f"GPU-{u}" for u in report["uuids"]]
            check(report["device_count"] == want and sorted(seen) == sorted(allocated)
                  and all(u in uuids for u in seen),
                  f"the workload Pod saw {report}, was allocated {allocated}, "
                  f"NVML reports {uuids}")
        else:
            check(report["device_count"] == 0, f"the workload Pod saw {report} on the CPU")
        numbers["workload_pod"] = dict(report, limit=want, allocated=allocated)
        raw.delete("v1", "Pod", name, WORKLOAD_NAMESPACE)

    def status():
        out = _gpuop_cfg(ctx, "status", "--base-url", ctx.base)
        print(out["out"])
        check(out["rc"] == 0, f"gpuop-cfg status exited {out['rc']}: {out['err'][-2000:]}")

    timed("a_telemetry_toggle_s", "telemetry disabled and enabled by the quickstart's patches",
          toggle)
    timed("b_kill_switch_s", "the node's telemetry kill switch set and removed", kill_switch)
    timed("c_workload_pod_s", "the quickstart's workload Pod requesting nvidia.com/gpu",
          workload)
    timed("d_gpuop_cfg_status_s", "gpuop-cfg status", status)
    numbers["pass_s"] = round(time.monotonic() - started, 3)
    print(json.dumps({"quickstart": numbers}))
    return numbers


def operator_phase(card, then=None) -> dict:
    """Phase 12: ``gpu-operator`` reconciles the shipped bare-metal sample
    (:func:`sample_policy`) onto this machine as a one-node cluster
    (:func:`join_cluster`), and a process kubelet runs the DaemonSets it
    renders, the validation chain and its spawned workload pod on the card;
    at ``ready``, the quickstart's pass (:func:`quickstart_pass`).
    ``then(ctx)``, when given, runs on that cluster once it is ``ready``
    again (phase 13, :func:`gpudriver_phase`)."""
    import shutil

    from tpu_operator_torch import consts

    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip-smoke-operator-")
    machine = card_node(work)
    node_name, gpu_count = machine["node_name"], machine["gpu_count"]
    cp, overrides = sample_policy(repo, work, os.path.join(work, "status"))
    print(f"phase 12's ClusterPolicy: {BAREMETAL_SAMPLE}, with {len(overrides)} overrides")
    for path, (value, why) in overrides.items():
        print(f"override spec.{path} = {json.dumps(value)} ({why})")
    cluster = join_cluster(repo, work, machine, policy=cp)
    srv, base, kubelet, cp = cluster.srv, cluster.base, cluster.kubelet, cluster.cp
    deployment, argv, deployment_env = cluster.deployment, cluster.argv, cluster.env
    status_dir = cluster.status_dir
    print(json.dumps({"chart_install": {
        "objects": [f"{o['kind']}/{o['metadata']['name']}" for o in cluster.rendered],
        "operator_argv": argv[1:], "operator_env": deployment_env}}))

    metrics_port, health_port = free_port(), free_port()
    operator_log = os.path.join(work, "operator.log")
    operator_env = dict({k: v for k, v in os.environ.items() if not k.startswith("GPU_")},
                        **deployment_env)
    operator = subprocess.Popen(
        [*argv, f"--api-server={base}", f"--metrics-port={metrics_port}",
         f"--health-port={health_port}"],
        cwd=repo, stdout=open(operator_log, "w"), stderr=subprocess.STDOUT,
        start_new_session=True, env=operator_env)
    # the join's apiserver load: the operator's (through its informer cache)
    # and the node agents'; the kubelet reads the backend in process
    srv.requests.clear()

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
        numbers["quickstart"] = quickstart_pass(types.SimpleNamespace(
            srv=srv, base=base, kubelet=kubelet, namespace=consts.DEFAULT_NAMESPACE,
            node_name=node_name, repo=repo, card=card, operator_env=operator_env,
            device="cuda"))

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
            spec = cp["spec"]
            then(types.SimpleNamespace(
                srv=srv, base=base, kubelet=kubelet, namespace=consts.DEFAULT_NAMESPACE,
                node_name=node_name, repo=repo, work=work, card=card, operator=operator,
                operator_env=operator_env, driver_env=machine["driver_env"],
                deployment=deployment, gpu_count=gpu_count, status_dir=status_dir,
                exporter_urls=[f"http://127.0.0.1:{spec[key]['metricsPort']}/metrics"
                               for key in ("nodeStatusExporter", "telemetry")]))
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


def _patch_policy(ctx, spec: dict) -> None:
    """A merge patch of the ClusterPolicy's spec over HTTP, as an admin's."""
    body = json.dumps({"spec": spec}).encode()
    request = urllib.request.Request(
        f"{ctx.base}/apis/tpu.ai/v1/clusterpolicies/cluster-policy", data=body,
        method="PATCH", headers={"Content-Type": "application/merge-patch+json"})
    with urllib.request.urlopen(request, timeout=10) as r:
        check(r.status == 200, f"the ClusterPolicy patch: {r.status}")


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
    # the kubelet stops the old pod on the pass after it sees its DaemonSet
    # gone, which may come after the new installer's probe (the native probe
    # passes in milliseconds)
    _wait_for(lambda: kubelet.first("pod-stop", after=t0, ds="gpu-driver"), 30,
              "the ClusterPolicy's driver pod stopped")
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
        time.sleep(0.5)  # a renewal in flight at the stop lands meanwhile
        renewed = real_get("coordination.k8s.io/v1", "Lease", "gpu-operator-leader", ns)["spec"]
        leader_numbers["takeover_s"] = since(t5, new.is_leader, 60, "the standby taking over")
        acquired = real_get("coordination.k8s.io/v1", "Lease", "gpu-operator-leader", ns)["spec"]
        check(acquired["holderIdentity"] == new.readyz()["leader"]["identity"],
              f"lease after the takeover {acquired}")
        # the takeover as the Lease records it (whole seconds): from the old
        # leader's last renewal to the new one's acquisition
        leader_numbers["takeover_lease_s"] = (_stamp_s(acquired["acquireTime"])
                                              - _stamp_s(renewed["renewTime"]))
        check(leader_numbers["takeover_lease_s"] <= 15.0 + 2.0 + 1.0,
              f"takeover {leader_numbers['takeover_lease_s']} s by the Lease, past the lease "
              f"plus a retry period")
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
            samples = scrape_samples(_try_scrape(old.metrics_port) or "")
            count = sum(v for k, v in samples.items()
                        if k.startswith("tpu_operator_fenced_writes_total{"))
            first = min((v for k, v in samples.items()
                         if k.startswith("tpu_operator_fenced_writes_created{")), default=None)
            return (count, first) if count else None

        # polled over a minute (a loaded machine answers scrapes late); the
        # bound is on the counter's own creation stamp, the first refusal
        leader_numbers["fenced_writes"], first = _wait_for(fenced_writes, 60, "a fenced write")
        leader_numbers["first_fenced_s"] = round(first - t6, 3)
        check(leader_numbers["first_fenced_s"] <= 8.0,
              f"the first fenced write {leader_numbers['first_fenced_s']} s after the resume")
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
#: remediation wait (episode B's), two attempts, a 5 s drain window, cordon
#: on quarantine
HEALTH_SPEC = {"enabled": True, "cordonOnQuarantine": True, "maxRemediationAttempts": 2,
               "remediationWaitS": 30, "drainDeadlineS": 5}
#: episode A's remediation wait: attempt 1 must have time to produce its
#: verdict, and the validator's rerun on the card (the init chain and the
#: workload pod) takes 24 s to over 30 s, so the schema's shortest wait
#: raced it and a second attempt could fire on a node already passing
EPISODE_A_REMEDIATION_WAIT_S = 90
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
                 "verdict": anns.get(consts.WORKLOAD_HEALTH_ANNOTATION),
                 # the health machine's own stamps: when it entered the state
                 # (whole seconds), and its remediation attempts
                 "since": anns.get(consts.HEALTH_STATE_SINCE_ANNOTATION),
                 "attempts": anns.get(consts.HEALTH_ATTEMPTS_ANNOTATION)}
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


def _stamp_s(stamp: str) -> float:
    """An RFC 3339 stamp (a health machine's since, a Lease's times) as unix
    seconds, its fraction dropped."""
    import calendar

    return float(calendar.timegm(time.strptime(stamp.split(".")[0].rstrip("Z"),
                                               "%Y-%m-%dT%H:%M:%S")))


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
    at once, lets the kubelet's rerun pass within the episode's 90 s
    remediation wait: recovered, then healthy. Episode B, with the wait
    patched to the schema's shortest, a persistent fault: attempt 1,
    attempt 2 (the driver pod too) 30 s later, sticky ``failed`` 30 s after that, with ``NodeHealthDegraded``
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
        _patch_policy(ctx, {"health": {**HEALTH_SPEC,
                                       "remediationWaitS": EPISODE_A_REMEDIATION_WAIT_S},
                            "featureDiscovery": {"sleepInterval": "2s"}})
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
        # the rerun of the pod the operator recreated: the deleted pod's
        # back-off rerun, started under the fault, may exit failed after
        # remediating and before its deletion
        deleted = kubelet.first("pod-deleted", after=t_rem - 1.0, ds="gpu-operator-validator")
        rerun = _wait_for(lambda: kubelet.first("init-exit", after=deleted["t"],
                                                ds="gpu-operator-validator",
                                                container="workload-validation"), 60,
                          "the validator's rerun after the recycle (A)")
        check(rerun["rc"] == 0, f"the rerun after the recycle: {rerun}")
        a["rerun_passed_s"] = round(rerun["t"] - t_a, 3)
        a["remediation_wait_s"] = EPISODE_A_REMEDIATION_WAIT_S
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
        _patch_policy(ctx, {"health": {"remediationWaitS": HEALTH_SPEC["remediationWaitS"]}})
        check(policy()["spec"]["health"]["remediationWaitS"] == HEALTH_SPEC["remediationWaitS"],
              "episode B's remediation wait not stored")
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
        # each 30 s wait as the machine counts it: from the since stamp it
        # wrote entering the state to the one it wrote leaving it
        stamps = [_stamp_s(trail.first(t_b, state="remediating", attempts=n)["since"])
                  for n in ("1", "2")] + [_stamp_s(trail.first(t_b, state="failed")["since"])]
        b["remediation_waits_s"] = [stamps[1] - stamps[0], stamps[2] - stamps[1]]
        check(all(w >= HEALTH_SPEC["remediationWaitS"] for w in b["remediation_waits_s"]),
              f"the remediation waits by the machine's stamps: {b['remediation_waits_s']}")
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
    gauge at 1, the node cordoned, and never ``upgrade-done`` while the
    broken bundle is set. U1's template restored retries the node out of
    ``upgrade-failed`` to ``upgrade-done``, uncordoned by the machine.

    For U1 and U2's retry, from the apiserver's own pod events: the uids of
    the validator pods the machine deleted and of those Ready when it
    certified the node, which must be disjoint (a recycled validator a
    cache still lists never certifies), and the recycled validator's
    ``plugin --prewarm`` line (its build or load of K1).

    Printed: seconds from each template change to each state, the Events,
    the five gauges after each episode, ``gpuop-cfg status`` and ``explain
    node`` (the upgrade's two episodes apart from the health episodes), the
    apiserver's eviction requests and their 429s."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.state.skel import is_pod_ready
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

    def since(t, predicate, timeout, what, explain=None):
        found = _wait_for(predicate, timeout, what, explain)
        return round((found["t"] if isinstance(found, dict) else time.time()) - t, 3)

    # the driver pods' deletions as the apiserver takes them, with what
    # nvidia-smi shows at that instant (the handler runs inside the delete)
    driver_deleted = []
    # every driver pod event with its template hash, readiness and restarts:
    # what a U2 that leaves upgrade-failed early is read against
    driver_events = []
    # every validator pod event with its uid and readiness: which pods the
    # machine deleted, and which were Ready when it certified the node
    validator_events = []

    def on_validator(event_type, pod):
        validator_events.append({"t": time.time(), "type": event_type,
                                 "pod": pod["metadata"]["name"],
                                 "uid": pod["metadata"].get("uid"), "ready": is_pod_ready(pod)})

    def on_pod(event):
        labels = (event.object.get("metadata") or {}).get("labels") or {}
        component = labels.get("app.kubernetes.io/component")
        if component == "gpu-operator-validator":
            on_validator(event.type, event.object)
            return
        if component != "gpu-driver":
            return
        status = event.object.get("status") or {}
        driver_events.append({
            "t": time.time(), "type": event.type, "pod": event.object["metadata"]["name"],
            "hash": labels.get(consts.TEMPLATE_HASH_LABEL), "phase": status.get("phase"),
            "ready": is_pod_ready(event.object),
            "restarts": [c.get("restartCount") for c in status.get("containerStatuses") or []]})
        if event.type == "DELETED":
            driver_deleted.append({"t": time.time(),
                                   "used_mib": _smi_used_mib() if on_gpu else None})

    def certification(after, what):
        """The validator pods the machine deleted from the episode's
        ``pod-restart-required`` on, and those Ready when the node entered
        ``uncordon-required`` (one sweep may write it and ``upgrade-done``
        together, so the first of the two), by uid."""
        start = trail.first(after, state="pod-restart-required")
        check(start is not None, f"no pod-restart-required ({what})")
        entered = [c for c in (trail.first(start["t"], state=state)
                               for state in ("uncordon-required", "upgrade-done")) if c]
        check(bool(entered), f"never certified ({what}): {trail.states(after)}")
        t_cert = min(c["t"] for c in entered)
        deleted = sorted({e["uid"] for e in validator_events
                          if e["type"] == "DELETED" and start["t"] <= e["t"] <= t_cert})
        last = {}
        for e in validator_events:
            if e["t"] <= t_cert:
                last[e["uid"]] = e
        ready = sorted(uid for uid, e in last.items() if e["type"] != "DELETED" and e["ready"])
        found = {"deleted_validator_uids": deleted, "certifying_validator_uids": ready,
                 "certified_s": round(t_cert - after, 3)}
        print(json.dumps({f"validators_{what}": found, "card": ctx.card}))
        check(deleted, f"no validator pod deleted before the certification ({what}): "
                       f"{validator_events}")
        check(ready, f"no validator pod Ready at the certification ({what}): {validator_events}")
        check(not set(deleted) & set(ready),
              f"the node certified on a validator the machine deleted ({what}): {found}, "
              f"{validator_events}")
        plugin_log = kubelet.logs("gpu-operator-validator").get("plugin-validation", "")
        found["prewarm_line"] = next((line.strip() for line in plugin_log.splitlines()
                                      if "build cache warmed" in line
                                      or "prewarm failed" in line), None)
        print(f"the recycled validator's prewarm ({what}): {found['prewarm_line']}")
        return found

    def driver_view(after):
        template = deep_get(driver_ds(), "spec", "template", "metadata", "labels", default={})
        policy = raw.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        return {"ds_hash": (template or {}).get(consts.TEMPLATE_HASH_LABEL),
                "policy_driver_env": deep_get(policy, "spec", "driver", "env"),
                "pod_events": [e for e in driver_events if e["t"] >= after]}

    op = _Operator(ctx, os.path.join(ctx.work, "operator-upgrade.log"))
    trail = watch = None
    try:
        _wait_for(lambda: op.readyz().get("status") == "ok", 120, "the phase-15 operator ready")
        t_patch = time.time()
        _patch_policy(ctx, {"health": {"enabled": False},
                            "driver": {"upgradePolicy": UPGRADE_POLICY}})
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
        for pod in raw.list("v1", "Pod", ns, label_selector={
                "app.kubernetes.io/component": "gpu-operator-validator"}):
            on_validator("LISTED", pod)

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
        _patch_policy(ctx, {"driver": {"env": U1_ENV}})
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
        u1["validators"] = certification(t_u1, "u1")
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
        _patch_policy(ctx, {"driver": {"env": [{"name": consts.DRIVER_SRC_ENV, "value": broken}]}})
        u2 = {}
        for state in ("upgrade-required", "pod-restart-required", "upgrade-failed"):
            u2[f"{state}_s"] = since(
                t_u2, lambda: trail.first(t_u2, state=state), 180, f"{state} (U2)",
                explain=lambda: f"states {trail.states(t_u2)}, the driver since U2 "
                                f"{driver_view(t_u2)}")
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
        check("upgrade-failed" in status["out"], f"gpuop-cfg status shows no upgrade-failed; "
              f"states {trail.states(t_u2)}, the driver since U2 {driver_view(t_u2)}")
        # sticky while the pod crash-loops in place, ready between its crashes
        time.sleep(3.0)
        check(trail.states(t_u2)[-1] == "upgrade-failed", f"U2 left upgrade-failed: "
              f"{trail.states(t_u2)}, the driver since U2 {driver_view(t_u2)}")
        check(not {"uncordon-required", "upgrade-done"} & set(trail.states(t_u2)),
              f"U2 certified a broken driver: {trail.states(t_u2)}, validator pods "
              f"{[e for e in validator_events if e['t'] >= t_u2]}")
        t_r = time.time()
        u2["failed_held_s"] = round(t_r - t_u2 - u2["upgrade-failed_s"], 3)
        _patch_policy(ctx, {"driver": {"env": U1_ENV}})
        # the retry leaves upgrade-failed and cordons in one sweep: its
        # upgrade-required may not reach the apiserver as a state of its own
        for state in ("pod-restart-required", "validation-required", "upgrade-done"):
            u2[f"retry_{state}_s"] = since(t_r, lambda: trail.first(t_r, state=state), 180,
                                           f"{state} (U2's retry)")
        u2["retry_cleared_s"] = since(t_r, lambda: trail.first(
            t_r + u2["retry_upgrade-done_s"], state=""), 60, "the label cleared (U2)")
        u2["retry_validators"] = certification(t_r, "u2_retry")
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


#: phase 16's ClusterPolicy settings: the pool between one node (the card's)
#: and three, a cooldown that holds the pool after each resize for the rest
#: of the phase (so one scale-down follows the scale-up), a short delay; the
#: migration controller on, and a drain window the tenant acks well inside
AUTOSCALE_SPEC = {"enabled": True, "minNodes": {"default": 1}, "maxNodes": {"default": 3},
                  "cooldownS": 15, "scaleDownDelayS": 2}
MIGRATE_SPEC = {"enabled": True}
AUTOSCALE_DRAIN_DEADLINE_S = 60
#: the chaos under phase 16's RestClient: one seed, 10% of requests refused
#: or answered 429/503 before the server, 20% of watch streams chopped
#: (dropped mid-event while the fleet grows, truncated mid-line while it
#: shrinks)
AUTOSCALE_CHAOS = {"seed": 1729, "error_rate": 0.1, "watch_chop_rate": 0.2}
CHAOS_KINDS = ("429", "503", "reset", "watch-drop", "watch-truncate")
AUTOSCALE_WATCH_IDLE_S = 1.0
#: the traffic feed's cadence
TRAFFIC_TICK_S = 0.1
#: the traffic, as multiples of one node's measured tokens/s at the SLO
DEMAND_UP, DEMAND_DOWN = 2.5, 0.5
#: where phase 16 ends, with or without chaos: the pool at two nodes (the
#: card's and one registered), two registered in all, one migration done
#: and its source deleted, the tenant resumed at its acked step, one Event
#: of each kind, no orphan actuation
AUTOSCALE_TERMINAL = {
    "pool_size": 2, "registered": 2, "registered_left": 1, "card_node_kept": True,
    "migration": {"phase": "done", "seq": 4}, "source_deleted": True,
    "steps_lost_beyond_drain_window": 0,
    "events": {"RetilePlanned": 1, "MigrationRestored": 1, "MigrationCompleted": 1,
               "AutoscaleUp": 1, "AutoscaleDown": 1},
    "audit": {"ok": True, "orphans": 0},
}
#: the migration-episode Events that must not occur on the cooperative path
MIGRATION_FAILURE_REASONS = ("MigrationFailed", "MigrationBlocked", "MigrationSnapshotRequested",
                             "MigrationSnapshotFailed", "RetileDeadlineExpired",
                             "AutoscaleSaturated")


class TrafficFeed:
    """The traffic scenario's part: a ``tpu.ai/traffic-snapshot`` on the
    ClusterPolicy every :data:`TRAFFIC_TICK_S`, its token demand ``multiple``
    times ``tokens_per_node``, written over HTTP through the same chaos as the
    operator's (a tick the chaos refuses is missed; the next one carries on,
    as the reference's feed does)."""

    def __init__(self, base: str, chaos):
        from tpu_operator_torch.client.chaos import ChaosTransport
        from tpu_operator_torch.client.rest import RestClient, Transport

        self.client = RestClient(base, transport=ChaosTransport(Transport(base), chaos)
                                 if chaos is not None else None)
        self.tokens_per_node = self.multiple = 0.0
        self.ticks = self.missed = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="traffic-feed")

    def _tick(self) -> None:
        from tpu_operator_torch import consts

        snapshot = {"ts": time.time(), "queue_depth": 0, "backlog_chips": 0.0, "attainment": 1.0,
                    "demand_tokens_per_s": round(self.multiple * self.tokens_per_node, 3)}
        self.ticks += 1
        try:
            self.client.patch("tpu.ai/v1", "ClusterPolicy", "cluster-policy", {
                "metadata": {"annotations": {consts.TRAFFIC_SNAPSHOT_ANNOTATION: json.dumps(
                    snapshot, sort_keys=True)}}})
        except Exception:  # refused by the chaos: the next tick carries on
            self.missed += 1

    def _run(self) -> None:
        while not self._stop.wait(TRAFFIC_TICK_S):
            self._tick()

    def start(self) -> None:
        self._thread.start()

    def set(self, multiple: float) -> float:
        """Change the demand: returns when the change was first published."""
        self.multiple = multiple
        return time.time()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10)
        self.client.stop()


class MigrationTrail:
    """Every autoscale and migration change on the nodes, timed, from the
    apiserver backend's own watch: registrations, each migration state
    (phase and sequence number) on a source, the drain plan and ack, the
    transfer record and the restore answer on a destination, deletions."""

    def __init__(self, backend):
        self.entries: list = []
        self._lock = threading.Lock()
        self._seen: dict = {}
        self._handle = backend.watch("v1", "Node", None, handler=self._on)

    def _note(self, key, value) -> None:
        if self._seen.get(key) == value:
            return
        self._seen[key] = value
        self.entries.append({"t": time.time(), "node": key[0], "what": key[1],
                             "value": value})

    def _on(self, event) -> None:
        from tpu_operator_torch import consts

        meta = event.object.get("metadata") or {}
        name, anns = meta.get("name"), meta.get("annotations") or {}
        labels = meta.get("labels") or {}
        with self._lock:
            if event.type == "DELETED":
                self._note((name, "deleted"), True)
                return
            if consts.AUTOSCALE_MANAGED_LABEL in labels:
                self._note((name, "registered"), labels[consts.AUTOSCALE_MANAGED_LABEL])
            raw = anns.get(consts.MIGRATION_STATE_ANNOTATION)
            if raw:
                with contextlib.suppress(ValueError):
                    state = json.loads(raw)
                    self._note((name, "migration"), (state.get("phase"), state.get("seq")))
            for key, what in ((consts.MIGRATE_REQUEST_ANNOTATION, "request"),
                              (consts.RETILE_PLAN_ANNOTATION, "plan"),
                              (consts.DRAIN_ACK_ANNOTATION, "ack"),
                              (consts.MIGRATION_INBOUND_ANNOTATION, "inbound"),
                              (consts.MIGRATION_RESTORE_ANNOTATION, "restored")):
                if anns.get(key):
                    self._note((name, what), True)

    def first(self, what: str, node: str = None):
        with self._lock:
            return next((e for e in self.entries if e["what"] == what
                         and (node is None or e["node"] == node)), None)

    def all(self, what: str) -> list:
        with self._lock:
            return [e for e in self.entries if e["what"] == what]

    def stop(self) -> None:
        self._handle.stop()


def autoscale_phase(ctx) -> dict:
    """Phase 16, on phases 12-15's cluster: the capacity loop under chaos.

    A fresh operator runs in this process on the production client chain
    (``build_client``) over a ``RestClient`` whose transport is the chaos
    transport (:data:`AUTOSCALE_CHAOS`; ``ctx.chaos`` False runs it without).
    The smoke reads and asserts through the apiserver's backend, which no
    chaos touches.

    1. The frontier: the card's node carries ``tpu.ai/serving-frontier`` as
       feature discovery published it from the serving probe (run first, on
       the card, when the node has none); the capacity collector's
       ``tokens_per_node()`` must equal the curve's best tokens/s at
       ``spec.serving.maxDecodeP99Ms``, and so must ``/debug/capacity`` and
       ``tpu_operator_serving_frontier_tokens_per_s`` of the node's pool.
    2. Scale up: ``spec.autoscale`` and ``spec.migrate`` on
       (:data:`AUTOSCALE_SPEC`), a ``tpu.ai/traffic-snapshot`` asking for
       :data:`DEMAND_UP` times that number; the autoscaler registers two
       nodes with the pool's template, and a ``KubeletSimulator`` animates
       those nodes alone (the card's stays with the process kubelet).
    3. Scale down by migration: demand at :data:`DEMAND_DOWN` times; once
       the cooldown and the delay have passed, the victim (a registered
       node, never the card's) gets a migrate request; a
       ``SimulatedTrainingJob`` on it acks the drain (its ack mirrored as
       feature discovery mirrors a node's), the migration goes draining,
       transferring, restoring, done onto another node, whose migrate agent
       restores the checkpoint, and the victim is deleted. The tenant
       resumes on the destination at the step it acked.
    4. The chaos: every kind injected (:data:`CHAOS_KINDS`), the retries and
       the breaker's transitions; the terminal state must be
       :data:`AUTOSCALE_TERMINAL`, the one a run without chaos reaches.
    5. ``gpuop-cfg status`` mid-migration (the AUTOSCALE and MIGRATION
       columns) and the operator's modules, each in a fresh process mapping
       neither torch nor libcuda.

    ``ctx``: as :func:`upgrade_phase` has it, and ``serving_args`` /
    ``serving_env`` for the serving probe's command line and environment."""
    import logging

    from tpu_operator_torch import consts
    from tpu_operator_torch.api.clusterpolicy import ClusterPolicy
    from tpu_operator_torch.client.chaos import ChaosPolicy, ChaosTransport
    from tpu_operator_torch.client.rest import RestClient, Transport
    from tpu_operator_torch.cmd.operator import build_parser
    from tpu_operator_torch.controllers.manager import OperatorApp, build_client
    from tpu_operator_torch.health import drain
    from tpu_operator_torch.provenance import ActuationObserver, causality_audit
    from tpu_operator_torch.serving import frontier as frontier_schema
    from tpu_operator_torch.state.nodepool import get_node_pools
    from tpu_operator_torch.testing.kubelet import KubeletSimulator
    from tpu_operator_torch.testing.trainjob import SimulatedTrainingJob
    from tpu_operator_torch.validator.status import StatusFiles

    raw, ns, card_node = ctx.srv.backend, ctx.namespace, ctx.node_name
    numbers = {"card": ctx.card}
    started = time.monotonic()

    def policy():
        return raw.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")

    def node(name):
        return raw.get("v1", "Node", name)

    def annotation(name, key):
        with contextlib.suppress(Exception):
            return (node(name)["metadata"].get("annotations") or {}).get(key)
        return None

    def registered():
        return sorted(n["metadata"]["name"] for n in raw.list("v1", "Node")
                      if consts.AUTOSCALE_MANAGED_LABEL in (n["metadata"].get("labels") or {}))

    # -- the operator, with chaos under its RestClient --------------------------------
    chaos = ChaosPolicy(truncate_mode="drop", **AUTOSCALE_CHAOS) \
        if getattr(ctx, "chaos", True) else None
    observer = ctx.srv.backend = ActuationObserver(raw)  # the HTTP handlers write through it
    # watch streams end after 1 s idle, as behind a load balancer with a short
    # idle timeout: the informers resume (and, for a kind written meanwhile,
    # relist) through the chaos every second
    idle_s, ctx.srv.watch_idle_timeout_s = ctx.srv.watch_idle_timeout_s, AUTOSCALE_WATCH_IDLE_S
    direct = RestClient(ctx.base, transport=ChaosTransport(Transport(ctx.base), chaos)
                        if chaos else None)
    args = build_parser().parse_args([f"--api-server={ctx.base}", f"--namespace={ns}"])
    client, _ = build_client(args, direct)
    metrics_port, health_port = free_port(), free_port()
    app = OperatorApp(client, namespace=ns, metrics_port=metrics_port, health_port=health_port)
    log_path = os.path.join(ctx.work, "operator-autoscale.log")
    handler = logging.FileHandler(log_path)
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
    port_log = logging.getLogger("tpu_operator_torch")
    port_log.addHandler(handler)
    level = port_log.level
    port_log.setLevel(logging.INFO)
    port_log.propagate = False
    sim = trail = feed = None
    tenants = {}  # node -> (job, status)
    fetch_root = os.path.join(ctx.work, "tenants")

    def tenant_status(name):
        return StatusFiles(os.path.join(fetch_root, name))

    def fetch(inbound):
        # the object store's stand-in: the source's host path
        return drain.load_checkpoint(drain.checkpoint_path(
            tenant_status(str(inbound.get("src"))).directory))

    def samples():
        return scrape_samples(_try_scrape(metrics_port) or "")

    before = {name: _node_events(raw, ns, name) for name in (card_node, "cluster-policy")}
    try:
        app.start()
        _wait_for(lambda: app.readiness()[0], 120, "the phase-16 operator ready")
        feed = TrafficFeed(ctx.base, chaos)
        feed.start()  # no demand until the frontier is known
        # -- 1. the measured frontier on the card's node (published by feature discovery,
        # which the operator's DaemonSet runs there) ----------------------------------
        status_dir = policy()["spec"]["hostPaths"]["validationStatusDir"]
        if not annotation(card_node, consts.SERVING_FRONTIER_ANNOTATION):
            t = time.time()
            probe = subprocess.run(
                [sys.executable, "-m", "tpu_operator_torch.cmd.validator", "-c", "serving",
                 f"--status-dir={status_dir}", *getattr(ctx, "serving_args", ())],
                cwd=ctx.repo, env=dict(os.environ, PYTHONPATH=ctx.repo,
                                       **getattr(ctx, "serving_env", {})),
                capture_output=True, text=True, timeout=300)
            check(probe.returncode == 0, f"the serving probe exited {probe.returncode}: "
                                         f"{probe.stdout[-2000:]}{probe.stderr[-2000:]}")
            numbers["serving_probe_s"] = round(time.time() - t, 3)
            _wait_for(lambda: annotation(card_node, consts.SERVING_FRONTIER_ANNOTATION), 60,
                      "feature discovery's serving frontier on the card's node")
            numbers["frontier_published_s"] = round(time.time() - t, 3)
        fr = frontier_schema.decode_annotation(annotation(card_node,
                                                          consts.SERVING_FRONTIER_ANNOTATION))
        max_p99 = float(ClusterPolicy.from_obj(policy()).spec.serving.max_decode_p99_ms)
        want = fr.best_tokens_per_s(max_p99)
        check(want > 0, f"no point of the card's frontier within {max_p99} ms: {fr}")
        [pool] = get_node_pools([node(card_node)])
        check(bool(pool.node_selector), f"the card's node has no pool label: {node(card_node)}")
        numbers["frontier"] = {"points": [[p.batch, p.p99_ms, p.tokens_per_s] for p in fr.points],
                               "max_p99_ms": max_p99, "best_tokens_per_s": want,
                               "pool": pool.name, "template": pool.node_selector}
        trail = MigrationTrail(raw)
        sim = KubeletSimulator(raw, ns, node_filter=lambda n: consts.AUTOSCALE_MANAGED_LABEL in (
            n["metadata"].get("labels") or {}), write_ds_status=False)
        sim.start()
        t_settings = time.time()
        _patch_policy(ctx, {"autoscale": AUTOSCALE_SPEC, "migrate": MIGRATE_SPEC,
                            "health": {"drainDeadlineS": AUTOSCALE_DRAIN_DEADLINE_S}})
        # the collector keeps tokens/s to 0.1
        _wait_for(lambda: app.capacity.tokens_per_node() == round(want, 1), 60,
                  f"the collector's tokens_per_node at {want}")
        debug = _debug_json(health_port, "/debug/capacity") or {}
        metric = samples().get(
            f'tpu_operator_serving_frontier_tokens_per_s{{p99_bucket="'
            f'{frontier_schema.p99_bucket(max_p99)}",pool="{pool.name}"}}')
        numbers["capacity"] = {"tokens_per_node": app.capacity.tokens_per_node(),
                               "debug_capacity": debug.get("tokens_per_node_at_slo"),
                               "debug_pool": (debug.get("pools") or {}).get(pool.name),
                               "metric": metric,
                               "collector_s": round(time.time() - t_settings, 3)}
        check(debug.get("tokens_per_node_at_slo") == round(want, 1) == metric,
              f"the frontier's {want} tokens/s: {numbers['capacity']}")
        print(json.dumps({"autoscale_capacity": numbers["capacity"],
                          "frontier": numbers["frontier"],
                          "serving_probe_s": numbers.get("serving_probe_s"),
                          "frontier_published_s": numbers.get("frontier_published_s"),
                          "card": ctx.card}))

        feed.tokens_per_node = want
        t_up = feed.set(DEMAND_UP)
        _wait_for(lambda: len(registered()) >= 2, 60, "two nodes registered by the autoscaler")
        names = registered()
        up = {"registered": names,
              "registered_s": [round(trail.first("registered", n)["t"] - t_up, 3)
                               for n in names]}
        for name in names:
            labels = node(name)["metadata"]["labels"]
            check(all(labels.get(k) == v for k, v in pool.node_selector.items())
                  and labels.get(consts.AUTOSCALE_MANAGED_LABEL) == pool.name,
                  f"{name} lacks the pool's template {pool.node_selector}: {labels}")
            tenants[name] = (SimulatedTrainingJob(raw, name, tenant_status(name)),
                             tenant_status(name))
        up["joined_s"] = []
        for name in names:  # the simulated kubelet's device plugin registered its GPUs
            _wait_for(lambda n=name: ((node(n).get("status") or {}).get("capacity") or {}).get(
                consts.GPU_RESOURCE_NAME), 60, f"{name} joined")
            up["joined_s"].append(round(time.time() - t_up, 3))
        numbers["scale_up"] = up
        print(json.dumps({"autoscale_up": up, "card": ctx.card}))

        # -- 3. scale down by migration ---------------------------------------------------
        if chaos is not None:
            chaos.truncate_mode = "truncate"
        t_down = feed.set(DEMAND_DOWN)
        acked, status_out, deadline = {}, None, time.monotonic() + 180
        while not trail.first("deleted"):
            check(time.monotonic() < deadline, f"no scale-down within 180 s: {trail.entries}")
            if status_out is None and any(e["value"][0] == "restoring"
                                          for e in trail.all("migration")):
                # the table mid-migration: the transfer record is on the
                # destination, the source's state says restoring (written
                # after the record), and no migrate agent runs yet to
                # restore it
                status_out = _gpuop_cfg(ctx, "status", "--base-url", ctx.base)
                # now the agents, the card's node's too (with its own tenant
                # host path: the migration may pick it as the destination)
                for name in [card_node, *names]:
                    sim.attach_migrate_agent(name, tenant_status(name), fetch=fetch)
            for name, (job, status) in tenants.items():
                if trail.first("deleted", name):
                    continue
                with contextlib.suppress(Exception):  # its node deleted meanwhile
                    job.tick()  # steps go on inside the drain window
                    if job.acked_plans:
                        acked.setdefault(name, job.step)
                    # feature discovery's part on a simulated node: mirror the
                    # barrier's ack onto the node
                    value = drain.ack_annotation_value(drain.read_drain_ack(status))
                    if value and annotation(name, consts.DRAIN_ACK_ANNOTATION) != value:
                        raw.patch("v1", "Node", name, {"metadata": {"annotations": {
                            consts.DRAIN_ACK_ANNOTATION: value}}})
            time.sleep(0.1)
        victim = trail.first("deleted")["node"]
        check(victim in names and victim != card_node, f"the victim {victim} of {names}")
        check(victim in acked, f"the victim's tenant never acked: {acked}")
        dst = next((e["node"] for e in trail.all("inbound")), None)
        check(dst is not None and dst != victim, f"no transfer record off {victim}")
        states = [e["value"] for e in trail.entries if e["what"] == "migration"
                  and e["node"] == victim]
        check(states[0] == ("draining", 1) and states[-1] == ("done", 4)
              and [p for p, _ in states] == [p for p in ("draining", "transferring",
                                                         "restoring", "done")
                                             if p in {q for q, _ in states}],
              f"the migration walked {states}")
        resumed = SimulatedTrainingJob(raw, dst, tenant_status(dst)).resume()
        t_req = trail.first("request", victim)["t"]

        def at(what, name):
            entry = trail.first(what, name)
            return None if entry is None else round(entry["t"] - t_down, 3)

        down = {"victim": victim, "destination": dst, "states": [list(s) for s in states],
                "requested_s": at("request", victim), "plan_s": at("plan", victim),
                "ack_s": at("ack", victim), "transfer_s": at("inbound", dst),
                "restored_s": at("restored", dst),
                "done_s": round(next(e["t"] for e in trail.entries if e["what"] == "migration"
                                     and e["value"][0] == "done") - t_down, 3),
                "deleted_s": at("deleted", victim), "ack_step": acked[victim],
                "resume_step": resumed}
        down["phase_s"] = {"draining": round(down["ack_s"] - down["requested_s"], 3),
                           "transferring": round(down["transfer_s"] - down["ack_s"], 3),
                           "restoring": round(down["restored_s"] - down["transfer_s"], 3),
                           "done": round(down["done_s"] - down["restored_s"], 3),
                           "node_deleted": round(down["deleted_s"] - down["done_s"], 3)}
        numbers["scale_down"] = down
        print(json.dumps({"autoscale_down": down, "card": ctx.card}))

        # -- 4. the chaos and the terminal state -------------------------------------------
        _wait_for(lambda: samples().get("tpu_operator_migrations_in_progress") == 0.0, 30,
                  "no migration in progress")

        def phase_events():
            out = {}
            for name in {victim, dst, card_node, "cluster-policy"}:
                counts = _events_since(before.get(name, {}), _node_events(raw, ns, name))
                for reason, n in counts.items():
                    out[reason] = out.get(reason, 0) + n
            return out

        # the scale-down's Event follows the node's deletion, through the chaos
        _wait_for(lambda: all(phase_events().get(k, 0) >= n
                              for k, n in AUTOSCALE_TERMINAL["events"].items()), 30,
                  "the phase's Events")
        time.sleep(2.0)  # a sweep more: the pool must hold at two
        metric_now = samples()
        events = phase_events()
        audit = causality_audit(app.journal, observer.observed)
        pool_size = len([n for n in raw.list("v1", "Node")
                         if all((n["metadata"].get("labels") or {}).get(k) == v
                                for k, v in pool.node_selector.items())])
        terminal = {
            "pool_size": pool_size, "registered": len(names),
            "registered_left": len(registered()),
            "card_node_kept": card_node in [n["metadata"]["name"]
                                            for n in raw.list("v1", "Node")],
            "migration": dict(zip(("phase", "seq"), states[-1])),
            "source_deleted": not any(n["metadata"]["name"] == victim
                                      for n in raw.list("v1", "Node")),
            "steps_lost_beyond_drain_window": acked[victim] - (resumed or 0),
            "events": {k: events.get(k, 0) for k in AUTOSCALE_TERMINAL["events"]},
            "audit": {"ok": audit["ok"], "orphans": len(audit["orphans"])},
        }
        numbers["terminal"] = terminal
        numbers["audit"] = {k: audit[k] for k in ("observed", "covered", "episodes",
                                                  "complete_episodes", "ok")}
        failures = {k: events.get(k, 0) for k in MIGRATION_FAILURE_REASONS if events.get(k)}
        resizes = {k.split("{", 1)[1].rstrip("}"): v for k, v in metric_now.items()
                   if k.startswith("tpu_operator_autoscale_resizes_total{")}
        numbers["metrics"] = {
            "migrations_total": {k.split('"')[1]: v for k, v in metric_now.items()
                                 if k.startswith("tpu_operator_migrations_total{")},
            "autoscale_resizes": resizes,
            "target_nodes": metric_now.get(f'tpu_operator_autoscale_target_nodes{{pool="'
                                           f'{pool.name}"}}'),
            "api_retries": {k.split("{", 1)[1].rstrip("}"): v for k, v in metric_now.items()
                            if k.startswith("tpu_operator_api_retries_total{")},
            "breaker_transitions": {k.split('"')[1]: v for k, v in metric_now.items()
                                    if k.startswith("tpu_operator_api_breaker_transitions_total{")},
            "breaker_state": metric_now.get("tpu_operator_api_breaker_state"),
        }
        numbers["chaos"] = None if chaos is None else dict(sorted(chaos.injected.items()))
        numbers["traffic_feed"] = {"ticks": feed.ticks, "missed": feed.missed}
        print(json.dumps({"autoscale_terminal": terminal, "audit": numbers["audit"],
                          "metrics": numbers["metrics"], "chaos_injected": numbers["chaos"],
                          "traffic_feed": numbers["traffic_feed"], "card": ctx.card}))
        check(terminal == AUTOSCALE_TERMINAL,
              f"the terminal state {terminal} is not {AUTOSCALE_TERMINAL}")
        check(not failures, f"failure Events on the cooperative path: {failures}")
        check(numbers["metrics"]["migrations_total"] == {"completed": 1.0},
              f"tpu_operator_migrations_total {numbers['metrics']['migrations_total']}")
        if chaos is not None:
            check(all(chaos.injected.get(k, 0) > 0 for k in CHAOS_KINDS),
                  f"a chaos kind never injected: {chaos.injected}")
            check(sum(numbers["metrics"]["api_retries"].values()) > 0,
                  f"no retry under chaos: {numbers['metrics']}")

        # -- 5. the table and the operator's isolation --------------------------------------
        check(status_out is not None and status_out["maps_line"] == "MAPS False False",
              f"gpuop-cfg status: {status_out and status_out['maps_line']}")
        print(status_out["out"])
        lines = status_out["out"].splitlines()
        header = next((line for line in lines if line.startswith("NODE ")), "")
        row = next((line for line in lines if line.startswith(victim + " ")), "")
        check("AUTOSCALE" in header and "MIGRATION" in header and "resizing:down" in row
              and f"restoring {victim}->{dst} seq=3" in row,
              f"gpuop-cfg status mid-migration: {header!r} {row!r}")
        isolation = subprocess.run(
            [sys.executable, "-c",
             "import sys\n"
             "from tpu_operator_torch.client.fake import FakeClient\n"
             "from tpu_operator_torch.controllers.manager import OperatorApp\n"
             "import tpu_operator_torch.autoscale, tpu_operator_torch.capacity\n"
             "import tpu_operator_torch.migrate.controller, tpu_operator_torch.client.chaos\n"
             "app = OperatorApp(FakeClient())\n"
             "maps = open('/proc/self/maps').read()\n"
             "print('MAPS', 'libtorch' in maps, 'libcuda' in maps, 'torch' in sys.modules)\n"],
            cwd=ctx.repo, env=ctx.operator_env, capture_output=True, text=True, timeout=120)
        numbers["operator_maps"] = isolation.stdout.strip()
        check(isolation.returncode == 0 and numbers["operator_maps"] == "MAPS False False False",
              f"the operator's modules: {isolation.stdout}{isolation.stderr[-2000:]}")
        numbers["phase_s"] = round(time.monotonic() - started, 3)
        print(json.dumps({"autoscale_phase": {"phase_s": numbers["phase_s"],
                                              "operator_maps": numbers["operator_maps"]},
                          "card": ctx.card}))
    except SystemExit:
        with contextlib.suppress(OSError):
            print(f"-- {log_path}:\n{open(log_path).read()[-6000:]}", file=sys.stderr)
        if trail is not None:
            print(f"-- trail: {trail.entries}", file=sys.stderr)
        raise
    finally:
        if feed is not None:
            feed.stop()
        if trail is not None:
            trail.stop()
        if sim is not None:
            sim.stop()
        app.stop()
        client.stop()
        direct.stop()
        ctx.srv.backend = raw
        ctx.srv.watch_idle_timeout_s = idle_s
        port_log.removeHandler(handler)
        port_log.setLevel(level)
        port_log.propagate = True
        handler.close()
    return numbers



#: the fuzz sweep's scenarios in phase 17: the scenario-fuzz gate's 25, cut
#: to 3 for the smoke's time
SIM_FUZZ_BUDGET = 3
#: the traffic mix's sampling interval over phase 11's handoff
SIM_TRAFFIC_SAMPLE_S = 5.0
#: runs a module as ``python -m`` would, then reports on standard error
#: whether the process mapped torch or the CUDA driver (argv: the module,
#: then its arguments; standard output stays the module's)
_MODULE_SCRIPT = ("import runpy, sys\n"
                  "module = sys.argv[1]\n"
                  "sys.argv = [module, *sys.argv[2:]]\n"
                  "try:\n"
                  "    runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
                  "finally:\n"
                  "    maps = open('/proc/self/maps').read()\n"
                  "    print('MAPS', 'libtorch' in maps, 'libcuda' in maps,\n"
                  "          'torch' in sys.modules, file=sys.stderr)\n")


def _module_process(ctx, argv: list, timeout: float = 600) -> dict:
    """``argv`` (``[python, -m, module, ...]``, as :func:`console_script`
    gives it) in a fresh process: its exit code, output, maps line, wall s."""
    t = time.monotonic()
    check(argv[1:2] == ["-m"], f"not a module's command line: {argv}")
    out = subprocess.run([argv[0], "-c", _MODULE_SCRIPT, *argv[2:]], cwd=ctx.repo,
                         env=ctx.operator_env, capture_output=True, text=True, timeout=timeout)
    maps = [line for line in out.stderr.splitlines() if line.startswith("MAPS ")]
    return {"rc": out.returncode, "out": out.stdout, "err": out.stderr,
            "maps_line": maps[-1] if maps else "", "wall_s": round(time.monotonic() - t, 3)}


def card_curve(ctx, checked: list) -> list:
    """Phase 17's step 1: the serving frontier on the card's node, as phase
    16 checked it (``checked``: its ``[batch, p99_ms, tokens_per_s]``
    points), one GPU's curve."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.serving import frontier as frontier_schema

    node = ctx.srv.backend.get("v1", "Node", ctx.node_name)
    fr = frontier_schema.decode_annotation(
        (node["metadata"].get("annotations") or {}).get(consts.SERVING_FRONTIER_ANNOTATION))
    check(fr is not None, f"no serving frontier on {ctx.node_name}")
    points = [[p.batch, p.p99_ms, p.tokens_per_s] for p in fr.points]
    check(points == checked, f"the node's frontier {points} is not phase 16's {checked}")
    return points


def simulator_phase(ctx, curve=None, handoff=None, budget: int = SIM_FUZZ_BUDGET) -> dict:
    """Phase 17: the fleet simulator (``gpu-sim``) on the card's frontier.

    1. ``curve``: one GPU's serving frontier, ``[batch, p99_ms,
       tokens_per_s]`` points (:func:`card_curve`; None takes the engine's
       ``CARD_FRONTIER``), and the per-GPU rate a healthy node of the
       simulated fleet derives from it.
    2. Each committed case (``tests/cases/scenarios/*.yaml``) through
       ``python -m tpu_operator_torch.cmd.sim run <case> --double-run
       --json`` in a fresh process: exit 0, every oracle green, the double
       run's canonical logs byte-identical, neither torch nor libcuda mapped.
    3. The same cases in this process on ``curve``: the canonical log must be
       step 2's (it holds no token figure, so a card's scale changes no
       decision).
    4. ``gpu-sim fuzz --budget <budget> --double-run`` at the pinned seed:
       every scenario green and byte-identical across the double run.
    5. The traffic mix (``serving.traffic.scenario_from_handoff``) twice
       over ``handoff`` (phase 11's, from the card's NVML), sampled every
       :data:`SIM_TRAFFIC_SAMPLE_S`: equal dicts, no unhandled error, every
       request finished or still queued.

    ``ctx``: ``repo``, ``operator_env`` (a torch-free process's
    environment), ``work`` and ``card``."""
    from tpu_operator_torch.serving import traffic
    from tpu_operator_torch.simulator import (DEFAULT_SCENARIO_SEED, FleetSimulator,
                                              engine, parse_file)

    started = time.monotonic()
    numbers = {"card": ctx.card}
    # -- 1. the card's curve ---------------------------------------------------------
    frontier = [list(p) for p in (curve or engine.CARD_FRONTIER)]
    per_gpu = engine.tokens_per_gpu(frontier)
    check(per_gpu > 0, f"no point of the curve {frontier} within {engine.MAX_P99_MS} ms")
    numbers["curve"] = {"points": frontier, "measured": curve is not None,
                        "tokens_per_gpu": per_gpu, "gpus_per_node": engine.GPUS_PER_NODE}
    print(json.dumps({"simulator_curve": numbers["curve"], "card": ctx.card}))

    # -- 2. the committed cases in fresh processes -------------------------------------
    cases = sorted(glob.glob(os.path.join(ctx.repo, "tests", "cases", "scenarios", "*.yaml")))
    check(len(cases) == 5, f"the committed cases: {cases}")
    runs = {}
    for path in cases:
        name = os.path.splitext(os.path.basename(path))[0]
        out = _module_process(ctx, [*console_script(ctx.repo, "gpu-sim"), "run", path,
                                    "--double-run", "--json"])
        check(out["rc"] == 0, f"gpu-sim run {name} exited {out['rc']}: "
                              f"{out['out'][-2000:]}{out['err'][-3000:]}")
        check(out["maps_line"] == "MAPS False False False",
              f"gpu-sim run {name}: {out['maps_line']!r}")
        report = json.loads(out["out"])
        failed = [o["name"] for o in report["oracles"] if not o["ok"]]
        check(report["ok"] and not failed and not report["injections_unfired"],
              f"{name}: oracles {failed}, unfired {report['injections_unfired']}")
        runs[name] = {"ok": report["ok"], "settled_at_tick": report["settled_at_tick"],
                      "reconcile_errors": len(report["reconcile_errors"]),
                      "feeder_faults": len(report["feeder_faults"]),
                      "wall_s": out["wall_s"], "seed": report["seed"],
                      "canonical": report["canonical"]}
        print(json.dumps({"simulator_case": name,
                          **{k: v for k, v in runs[name].items() if k != "canonical"},
                          "double_run": "byte-identical", "maps": out["maps_line"],
                          "card": ctx.card}))

    # -- 3. the same cases here, on the card's curve -------------------------------------
    for path in cases:
        name = os.path.splitext(os.path.basename(path))[0]
        t = time.monotonic()
        report = FleetSimulator(parse_file(path), seed=runs[name]["seed"],
                                frontier=frontier).run()
        check(report["canonical"] == runs[name]["canonical"],
              f"{name} on the card's curve: the canonical log differs from the "
              f"process's\n{report['canonical']}\n{runs[name]['canonical']}")
        runs[name]["card_curve_s"] = round(time.monotonic() - t, 3)
    print(json.dumps({"simulator_card_curve": {n: r["card_curve_s"] for n, r in runs.items()},
                      "canonical": "equal", "card": ctx.card}))

    # -- 4. the fuzz sweep ---------------------------------------------------------------
    bundles = os.path.join(ctx.work, "sim-bundles")
    out = _module_process(ctx, [*console_script(ctx.repo, "gpu-sim"), "fuzz", "--seed",
                                str(DEFAULT_SCENARIO_SEED), "--budget", str(budget),
                                "--double-run", "--out", bundles])
    check(out["rc"] == 0, f"gpu-sim fuzz exited {out['rc']}: {out['out'][-3000:]}"
                          f"{out['err'][-3000:]}")
    check(out["maps_line"] == "MAPS False False False", f"gpu-sim fuzz: {out['maps_line']!r}")
    check(f"fuzz done: {budget}/{budget} passed, 0 failed" in out["out"]
          and f"double run: {budget} canonical logs byte-identical" in out["out"],
          f"gpu-sim fuzz: {out['out'][-3000:]}")
    numbers["fuzz"] = {"seed": DEFAULT_SCENARIO_SEED, "budget": budget, "wall_s": out["wall_s"],
                       "verdicts": [line.strip() for line in out["out"].splitlines()
                                    if line.startswith("[")]}
    print(out["out"].rstrip())
    print(json.dumps({"simulator_fuzz": numbers["fuzz"], "note": "the gate's budget is 25, "
                      f"cut to {budget} for the smoke's time", "card": ctx.card}))

    # -- 5. the traffic mix over the card's handoff -----------------------------------------
    check(handoff is None or handoff.get("groups"), f"phase 11's handoff: {handoff}")
    mixes = [traffic.scenario_from_handoff(handoff, sample_interval_s=SIM_TRAFFIC_SAMPLE_S)
             for _ in range(2)]
    mix = mixes[0]
    check(mixes[0] == mixes[1], "the traffic mix differs between two runs")
    check(mix["unhandled_errors"] == 0, f"traffic mix errors: {mix['unhandled_errors']}")
    check(mix["rejected"] == 0 and mix["arrivals"] == mix["completed"] + mix["incomplete"],
          f"traffic mix lost requests: {mix}")
    numbers["traffic"] = {k: mix[k] for k in ("slices", "arrivals", "completed", "incomplete",
                                              "slo_attainment", "latency_p50_s",
                                              "latency_p99_s", "preemptions",
                                              "unhandled_errors")}
    numbers["traffic"]["samples"] = len(mix["timeseries"])
    print(json.dumps({"simulator_traffic": numbers["traffic"], "handoff": handoff,
                      "card": ctx.card}))

    numbers["cases"] = {n: {k: v for k, v in r.items() if k != "canonical"}
                        for n, r in runs.items()}
    numbers["phase_s"] = round(time.monotonic() - started, 3)
    print(json.dumps({"simulator_phase": {"phase_s": numbers["phase_s"]}, "card": ctx.card}))
    return numbers

def must_gather_phase(ctx) -> dict:
    """Phase 18, after phase 17 on the same cluster: the support bundle.

    1. A fresh ``gpu-operator`` from the chart's rendered Deployment
       (:func:`deployment_process`, plus ``--api-server`` and two free
       ports), ready on its ``/readyz``, and its Pod as the Deployment's
       ReplicaSet would make it, at this machine's address.
    2. ``gpu-must-gather`` (its console script) in a fresh process that maps
       neither torch nor libcuda, against the apiserver, the operator's
       metrics and health ports, phase 12's status directory and the two
       exporters' ``/metrics``. Its tarball must hold a file in every
       section of ``SECTIONS``, every route of the operator's
       ``DEBUG_ROUTES`` (not an error file), the card's node in the node
       summary with NVML's GPU count as its ``nvidia.com/gpu`` capacity,
       phase 12's barrier files, a scrape of each exporter and no error.
    3. ``gpuop-cfg validate-csv`` of ``bundle-gpu/`` and ``schema_gen
       --check``, each in a fresh process that maps neither torch nor
       libcuda, each exiting 0.

    ``ctx``: as :func:`upgrade_phase` has it, and ``deployment`` (the
    rendered Deployment), ``gpu_count`` (NVML's), ``status_dir`` (phase
    12's) and ``exporter_urls``."""
    import tarfile

    from tpu_operator_torch import consts
    from tpu_operator_torch.cmd.must_gather import SECTIONS, debug_endpoint_files

    started = time.monotonic()
    numbers = {"card": ctx.card}
    backend, ns = ctx.srv.backend, ctx.namespace
    out_dir = os.path.join(ctx.work, "must-gather")
    argv, env = deployment_process(ctx.repo, ctx.deployment)
    metrics_port, health_port = free_port(), free_port()
    log_path = os.path.join(ctx.work, "operator-must-gather.log")
    operator = subprocess.Popen(
        [*argv, f"--api-server={ctx.base}", f"--metrics-port={metrics_port}",
         f"--health-port={health_port}"],
        cwd=ctx.repo, stdout=open(log_path, "w"), stderr=subprocess.STDOUT,
        start_new_session=True, env=dict(ctx.operator_env, **env))
    template = ctx.deployment["spec"]["template"]
    pod_name = f"{ctx.deployment['metadata']['name']}-{uuid.uuid4().hex[:5]}"
    try:
        def ready():
            with contextlib.suppress(OSError, ValueError):
                with urllib.request.urlopen(f"http://127.0.0.1:{health_port}/readyz",
                                            timeout=2) as r:
                    return r.status == 200
            return False

        _wait_for(ready, 60, "the chart's operator ready on /readyz")
        numbers["operator_ready_s"] = round(time.monotonic() - started, 3)
        backend.create({"apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": pod_name, "namespace": ns,
                                     "labels": dict(template["metadata"]["labels"])},
                        "spec": copy.deepcopy(template["spec"]),
                        "status": {"phase": "Running", "podIP": "127.0.0.1"}})
        t = time.monotonic()
        gather = _module_process(ctx, [
            *console_script(ctx.repo, "gpu-must-gather"), f"--base-url={ctx.base}",
            f"--namespace={ns}", f"--out={out_dir}", f"--status-dir={ctx.status_dir}",
            *(f"--telemetry-url={url}" for url in ctx.exporter_urls),
            f"--operator-metrics-port={metrics_port}", f"--operator-health-port={health_port}"])
        numbers["must_gather_s"] = round(time.monotonic() - t, 3)
        check(gather["rc"] == 0, f"gpu-must-gather exited {gather['rc']}: "
                                 f"{gather['out'][-2000:]}{gather['err'][-2000:]}")
        check(gather["maps_line"] == "MAPS False False False",
              f"gpu-must-gather maps torch or libcuda: {gather['maps_line']}")
        check(operator.poll() is None, "the chart's operator died during the gather")
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(operator.pid, signal.SIGKILL)
        operator.wait(timeout=60)
        with contextlib.suppress(Exception):
            backend.delete("v1", "Pod", pod_name, ns)

    # -- the tarball ---------------------------------------------------------------------
    tar_path = out_dir + ".tar.gz"
    base = os.path.basename(out_dir)
    with tarfile.open(tar_path) as tar:
        members = {m.name: m for m in tar.getmembers() if m.isfile()}

        def read(rel):
            return tar.extractfile(members[f"{base}/{rel}"]).read().decode()

        manifest = json.loads(read("manifest.json"))
        per_section = {sec: sorted(n[len(base) + len(sec) + 2:] for n in members
                                   if n.startswith(f"{base}/{sec}/")) for sec in SECTIONS}
        numbers["files"] = {sec: len(names) for sec, names in per_section.items()}
        numbers["errors"] = manifest["errors"]
        numbers["tarball_bytes"] = os.path.getsize(tar_path)
        for sec, names in per_section.items():
            check(names, f"the bundle's {sec}/ section is empty")
        check(manifest["errors"] == [], f"the bundle recorded errors: {manifest['errors']}")
        routes = {route: f"{pod_name}/{fname}" for route, fname in debug_endpoint_files()}
        missing = [route for route, rel in routes.items() if rel not in per_section["operator"]]
        check(not missing, f"debug routes not collected: {missing} "
                           f"(operator/: {per_section['operator']})")
        check(f"{pod_name}/metrics.prom" in per_section["operator"],
              "the operator's /metrics not collected")
        for rel in routes.values():
            if rel.endswith(".json"):
                json.loads(read(f"operator/{rel}"))  # stays machine-readable
        summary = read("cluster/node-summary.txt").splitlines()
        header = summary[0].split()
        rows = {r.split()[0]: dict(zip(header, r.split())) for r in summary[1:] if r.strip()}
        check(ctx.node_name in rows, f"the card's node is not in the summary: {summary}")
        capacity = rows[ctx.node_name]["CAPACITY"]
        check(capacity == str(ctx.gpu_count),
              f"the summary's {consts.GPU_RESOURCE_NAME} capacity {capacity}, NVML's "
              f"GPU count {ctx.gpu_count}")
        barriers = sorted(n.split("/", 1)[1] for n in per_section["validation"]
                          if n.startswith("barriers/"))
        for name in ("driver-ready", "plugin-ready", "workload-ready"):
            check(name in barriers, f"phase 12's barrier {name} not in the bundle: {barriers}")
            with open(os.path.join(ctx.status_dir, name)) as f:
                check(read(f"validation/barriers/{name}") == f.read(),
                      f"the bundle's {name} differs from the status dir's")
        scrapes = [n for n in per_section["telemetry"] if n.endswith(".prom")]
        check(len(scrapes) == len(ctx.exporter_urls),
              f"exporter scrapes {per_section['telemetry']}")
        for rel in scrapes:
            text = read(f"telemetry/{rel}")
            check("\n# TYPE " in text or text.count("\n") > 3,
                  f"telemetry/{rel} holds no metrics: {text[:300]}")
        info = read("cluster/clusterinfo.txt")
        check(info.startswith("kubernetes: ") and "runtime: " in info, f"clusterinfo {info}")
    numbers["node_summary"] = rows[ctx.node_name]
    numbers["barriers"] = barriers
    numbers["debug_routes"] = sorted(routes)
    numbers["clusterinfo"] = info.strip()
    print(json.dumps({"must_gather": numbers}))

    # -- the OLM bundle and the CRD copies, torch-free ----------------------------------------
    csv = os.path.join(ctx.repo, "bundle-gpu", "manifests",
                       "gpu-operator.clusterserviceversion.yaml")
    checks = {"validate_csv": [*console_script(ctx.repo, "gpuop-cfg"), "validate-csv", csv],
              "schema_gen_check": [sys.executable, "-m", "tpu_operator_torch.api.schema_gen",
                                   "--check"]}
    numbers["torch_free"] = {}
    for name, cmd in checks.items():
        result = _module_process(ctx, cmd)
        numbers["torch_free"][name] = {"rc": result["rc"], "maps": result["maps_line"],
                                       "wall_s": result["wall_s"]}
        check(result["rc"] == 0, f"{name} exited {result['rc']}: "
                                 f"{result['out'][-2000:]}{result['err'][-2000:]}")
        check(result["maps_line"] == "MAPS False False False",
              f"{name} maps torch or libcuda: {result['maps_line']}")
    numbers["phase_s"] = round(time.monotonic() - started, 3)
    print(json.dumps({"must_gather_phase": {"torch_free": numbers["torch_free"],
                                            "phase_s": numbers["phase_s"]}, "card": ctx.card}))
    return numbers


#: the reference's 17 rule names (``tpu_operator/analysis/checkers/``)
LINT_RULES = ("annotation-registry", "api-bypass", "blocking-call", "breaker-swallow",
              "deadline-propagation", "exactly-once-event", "exception-hygiene",
              "lock-discipline", "lock-order-inversion", "metrics-discipline", "operand-dag",
              "provenance-discipline", "span-discipline", "state-before-actuation",
              "unbatched-sweep-write", "unfenced-write", "untracked-shared-state")
#: the reference's budget for a full-tree lint (tests/test_analysis_graph.py)
LINT_BUDGET_S = 30.0
#: the in-place suppression the seeded violation removes, and what it hides
LINT_SEED = ("tpu_operator_torch/client/rest.py", "exception-hygiene")


def lint_phase(ctx) -> dict:
    """Phase 19, after phase 18 and outside the operator's cluster: the
    port's static checker over this tree.

    1. ``gpuop-lint --format json`` (its console script, in a fresh process
       that maps neither torch nor libcuda): exit 0, no new, baselined or
       stale finding, the committed baseline empty, the wall time under
       :data:`LINT_BUDGET_S`.
    2. ``--list-rules``: the reference's 17 names (:data:`LINT_RULES`).
    3. ``--format sarif``: parses, its run's tool is ``gpuop-lint``, no
       result.
    4. A copy of the tree whose :data:`LINT_SEED` file has lost its
       suppression comment (made first: a seed that names no suppression
       fails before any lint runs): exit 1, the finding naming that rule
       and file.

    ``ctx``: ``repo``, ``work`` (a scratch directory), ``card`` and
    ``operator_env`` (the processes' environment)."""
    started = time.monotonic()
    numbers = {"card": ctx.card}
    lint = console_script(ctx.repo, "gpuop-lint")

    def run(*argv, root=ctx.repo) -> dict:
        result = _module_process(ctx, [*lint, f"--root={root}", *argv], timeout=300)
        check(result["maps_line"] == "MAPS False False False",
              f"gpuop-lint {' '.join(argv)} maps torch or libcuda: {result['maps_line']}")
        return result

    # the gate's teeth: one suppression taken out of a copy of the tree
    seeded = os.path.join(ctx.work, "lint-seeded")
    shutil.copytree(os.path.join(ctx.repo, "tpu_operator_torch"),
                    os.path.join(seeded, "tpu_operator_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(seeded, "docs", "gpu"))
    shutil.copy(os.path.join(ctx.repo, "docs", "gpu", "operations.md"),
                os.path.join(seeded, "docs", "gpu"))
    shutil.copy(os.path.join(ctx.repo, ".gpuop-lint-baseline.json"), seeded)
    path, rule = LINT_SEED
    with open(os.path.join(seeded, path)) as f:
        text = f.read()
    marker = f"  # opalint: disable={rule}"
    lines = text.splitlines(keepends=True)
    hit = [i for i, line in enumerate(lines) if marker in line]
    check(len(hit) == 1, f"{path} holds {len(hit)} suppressions of {rule}, not 1")
    lines[hit[0]] = lines[hit[0]].split(marker)[0] + "\n"
    with open(os.path.join(seeded, path), "w") as f:
        f.write("".join(lines))

    full = run("--format=json")
    check(full["rc"] == 0, f"gpuop-lint over the tree exited {full['rc']}: "
                           f"{full['out'][-3000:]}{full['err'][-2000:]}")
    report = json.loads(full["out"])
    numbers["full_tree"] = {"rc": full["rc"], "wall_s": full["wall_s"],
                            "files": report["files"], "new": len(report["findings"]),
                            "baselined": report["baselined"],
                            "suppressed": report["suppressed"],
                            "stale": len(report["stale_baseline"])}
    check(report["findings"] == [] and report["baselined"] == 0
          and report["stale_baseline"] == [], f"gpuop-lint findings: {numbers['full_tree']}")
    with open(os.path.join(ctx.repo, ".gpuop-lint-baseline.json")) as f:
        check(json.load(f)["findings"] == [], "the committed baseline holds findings")
    check(full["wall_s"] < LINT_BUDGET_S,
          f"the full-tree lint took {full['wall_s']} s, over {LINT_BUDGET_S} s")

    listed = run("--list-rules")
    check(listed["rc"] == 0, f"--list-rules exited {listed['rc']}: {listed['err'][-2000:]}")
    names = tuple(sorted(line.split(":", 1)[0] for line in listed["out"].splitlines()
                         if line.strip()))
    numbers["rules"] = len(names)
    check(names == LINT_RULES, f"--list-rules names {names}, not the reference's 17")

    sarif = run("--format=sarif")
    check(sarif["rc"] == 0, f"--format sarif exited {sarif['rc']}: {sarif['err'][-2000:]}")
    doc = json.loads(sarif["out"])
    [sarif_run] = doc["runs"]
    numbers["sarif"] = {"version": doc["version"], "tool": sarif_run["tool"]["driver"]["name"],
                        "results": len(sarif_run["results"])}
    check(numbers["sarif"]["tool"] == "gpuop-lint" and numbers["sarif"]["results"] == 0,
          f"the SARIF run: {numbers['sarif']}")

    # the gate's teeth, on the copy made above
    bad = run("--format=json", root=seeded)
    found = json.loads(bad["out"])["findings"] if bad["out"].strip() else []
    numbers["seeded"] = {"rc": bad["rc"], "wall_s": bad["wall_s"],
                         "findings": [f"{f['path']}:{f['line']} [{f['rule']}]" for f in found]}
    check(bad["rc"] == 1, f"the seeded tree exited {bad['rc']}, not 1: {bad['err'][-2000:]}")
    check([(f["rule"], f["path"], f["line"]) for f in found] == [(rule, path, hit[0] + 1)],
          f"the seeded tree's findings: {numbers['seeded']['findings']}")
    numbers["phase_s"] = round(time.monotonic() - started, 3)
    print(json.dumps({"lint": numbers}))
    return numbers


#: the sanitized run's root seed (the race-soak lane's)
OPSAN_SEED = 20260807
#: the fuzz slice under the sanitizer
OPSAN_FUZZ_BUDGET = 3
#: registered structures every sanitized join reaches (``/debug/opsan``'s
#: ``tracked_vars``, ``#<n>`` suffixes aside): the read cache, the write
#: batcher, the flight recorder and the ClusterPolicy sweep's
OPSAN_JOIN_TRACKED = ("CachedClient._informers", "ClusterPolicyController._last_slice_state",
                      "FlightRecorder._traces", "Informer[ClusterPolicy]._store",
                      "Informer[Node]._store", "WriteBatcher._pending")
#: a race planted for the gate's teeth: two threads write one registered
#: dict with no lock, under the sanitizer; the process dumps its report
OPSAN_PLANTED = ("import threading\n"
                 "from tpu_operator_torch.utils.locks import register_shared\n"
                 "shared = register_shared('smoke.planted', {})\n"
                 "def write(key):\n"
                 "    for i in range(20):\n"
                 "        shared[key] = i\n"
                 "threads = [threading.Thread(target=write, args=(k,)) for k in 'ab']\n"
                 "for t in threads:\n"
                 "    t.start()\n"
                 "for t in threads:\n"
                 "    t.join()\n")


def opsan_env(env: dict, report_dir: str) -> dict:
    """``env`` with the race sanitizer's three switches and its seed."""
    out = {k: v for k, v in env.items() if not k.startswith("GPU_OPERATOR_OPSAN")}
    out.update(GPU_OPERATOR_OPSAN="1", GPU_OPERATOR_OPSAN_PERTURB="1",
               GPU_OPERATOR_OPSAN_REPORT=report_dir, OPSAN_SEED=str(OPSAN_SEED))
    return out


def opsan_gate(ctx, reports: str) -> dict:
    """``python -m tpu_operator_torch.cmd.opsan check --json`` over
    ``reports`` with the committed fixtures, in a fresh process: its exit
    code, its result and its maps line."""
    out = _module_process(ctx, [sys.executable, "-m", "tpu_operator_torch.cmd.opsan", "check",
                                "--reports", reports, "--root", ctx.repo, "--json", "--fixtures",
                                os.path.join(ctx.repo, "tests", "cases", "torch_opsan",
                                             "dynamic_edges.json")], timeout=300)
    try:
        result = json.loads(out["out"])
    except ValueError:
        result = None
    check(result is not None, f"opsan check printed no JSON (rc {out['rc']}): "
                              f"{out['out'][-2000:]}{out['err'][-2000:]}")
    check(out["maps_line"] == "MAPS False False False",
          f"opsan check maps torch or libcuda: {out['maps_line']!r}")
    return {"rc": out["rc"], "result": result, "wall_s": out["wall_s"]}


def opsan_phase(ctx) -> dict:
    """Phase 20, after phase 19: the operator's join under the race
    sanitizer, then the gate over its reports.

    1. A fresh one-node cluster as phase 12's (:func:`join_cluster` on
       ``ctx.node``), its ``gpu-operator`` (the chart's Deployment as a
       process) with the three switches, the seed and a report directory
       (passed explicitly: the operator's environment holds no ``GPU_*``
       otherwise). The ClusterPolicy goes in; the validators run on the
       card; the join must reach ``ready``.
    2. At ``ready``: ``/debug/opsan`` answers ``enabled: true``, its
       ``tracked_vars`` hold :data:`OPSAN_JOIN_TRACKED` and its ``races``
       is empty; ``/metrics`` counts tracked accesses above 0 and races at
       0; the operator maps neither torch nor libcuda.
    3. SIGTERM: the operator exits 0 through its shutdown path, and its
       at-exit hook writes one report.
    4. ``gpu-sim fuzz --budget`` :data:`OPSAN_FUZZ_BUDGET` under the same
       switches (its own report).
    5. ``cmd.opsan check`` over the two reports exits 0: no race, no
       dynamic-only lock edge without a fixture (:func:`opsan_gate`).
    6. The gate's teeth: :data:`OPSAN_PLANTED` under the switches, then the
       gate over its report exits 1 and names ``smoke.planted``.

    ``ctx``: ``repo``, ``work``, ``card``, ``node`` (:func:`card_node`'s
    dict), ``operator_env`` (a torch-free process's environment),
    ``phase12_ready_s`` (phase 12's unsanitized ``ready``, printed beside
    this one) and ``join_timeout_s``."""
    started = time.monotonic()
    numbers = {"card": ctx.card}
    reports = os.path.join(ctx.work, "opsan-reports")
    os.makedirs(reports)
    cluster = join_cluster(ctx.repo, ctx.work, ctx.node)
    env = opsan_env(dict({k: v for k, v in ctx.operator_env.items()
                          if not k.startswith("GPU_")}, **cluster.env), reports)
    metrics_port, health_port = free_port(), free_port()
    log_path = os.path.join(ctx.work, "operator-opsan.log")
    operator = subprocess.Popen(
        [*cluster.argv, f"--api-server={cluster.base}", f"--metrics-port={metrics_port}",
         f"--health-port={health_port}"], cwd=ctx.repo, stdout=open(log_path, "w"),
        stderr=subprocess.STDOUT, start_new_session=True, env=env)
    srv, kubelet = cluster.srv, cluster.kubelet

    def policy_state():
        live = srv.backend.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        return (live.get("status") or {}).get("state")

    try:
        # -- 1. the sanitized join ---------------------------------------------------------
        kubelet.start()
        t0 = time.time()
        srv.backend.create(cluster.cp)
        _wait_for(lambda: policy_state() == "ready", ctx.join_timeout_s,
                  "the sanitized join's ClusterPolicy ready")
        ready_s = round(time.time() - t0, 3)
        numbers["join"] = {"ready_s": ready_s, "phase12_ready_s": ctx.phase12_ready_s}
        print(json.dumps({"opsan_join": numbers["join"], "card": ctx.card}))

        # -- 2. the live report and the counters at ready --------------------------------------
        page = _debug_json(health_port, "/debug/opsan") or {}
        check(page.get("enabled") is True, f"/debug/opsan under the switch: {page}")
        # a structure registered again (a relist, a flush, a second instance)
        # is tracked as ``name#<n>``
        tracked = {v.split("#", 1)[0] for v in page.get("tracked_vars") or ()}
        missing = sorted(set(OPSAN_JOIN_TRACKED) - tracked)
        check(not missing, f"/debug/opsan tracks none of {missing}: {page.get('tracked_vars')}")
        check(page.get("races") == [], f"races in the sanitized join: {page.get('races')}")
        samples = scrape_samples(_try_scrape(metrics_port) or "")
        accesses = samples.get("tpu_operator_opsan_tracked_accesses_total", 0)
        races = samples.get("tpu_operator_opsan_races_total")
        check(accesses > 0 and races == 0,
              f"/metrics: {accesses} tracked accesses, {races} races")
        maps = _maps(operator.pid)
        check(maps == (False, False), f"the sanitized operator maps torch or libcuda: {maps}")
        numbers["live"] = {"tracked_vars": len(page["tracked_vars"]),
                           "locks": len(page["locks"]), "lock_edges": len(page["lock_edges"]),
                           "accesses_total": page["accesses_total"],
                           "metric_accesses": accesses, "metric_races": races}
        print(json.dumps({"opsan_live": numbers["live"], "card": ctx.card}))

        # -- 3. SIGTERM: the shutdown path and the at-exit report ----------------------------
        operator.send_signal(signal.SIGTERM)
        rc = operator.wait(timeout=60)
        check(rc == 0, f"the sanitized operator exited {rc} on SIGTERM")
        dumped = sorted(os.listdir(reports))
        check(len(dumped) == 1 and dumped[0].startswith(f"opsan-{operator.pid}-"),
              f"the operator's report: {dumped}")
    except SystemExit:
        with open(log_path) as f:
            print(f"-- sanitized operator log:\n{f.read()[-6000:]}", file=sys.stderr)
        print(f"-- kubelet events: {kubelet.events}", file=sys.stderr)
        raise
    finally:
        kubelet.stop()
        with contextlib.suppress(ProcessLookupError):
            os.killpg(operator.pid, signal.SIGKILL)
        operator.wait(timeout=60)
        srv.stop()

    # -- 4. the fuzz slice under the same switches -------------------------------------------
    sanitized = types.SimpleNamespace(repo=ctx.repo, operator_env=env)
    fuzz = _module_process(sanitized, [*console_script(ctx.repo, "gpu-sim"), "fuzz",
                                       "--budget", str(OPSAN_FUZZ_BUDGET)])
    check(fuzz["rc"] == 0 and f"fuzz done: {OPSAN_FUZZ_BUDGET}/{OPSAN_FUZZ_BUDGET} passed"
          in fuzz["out"], f"sanitized gpu-sim fuzz exited {fuzz['rc']}: "
                          f"{fuzz['out'][-2000:]}{fuzz['err'][-2000:]}")
    check(fuzz["maps_line"] == "MAPS False False False",
          f"sanitized gpu-sim fuzz: {fuzz['maps_line']!r}")
    check(len(os.listdir(reports)) == 2, f"the reports: {sorted(os.listdir(reports))}")
    numbers["fuzz"] = {"budget": OPSAN_FUZZ_BUDGET, "wall_s": fuzz["wall_s"]}

    # -- 5. the gate ---------------------------------------------------------------------------
    plain = types.SimpleNamespace(repo=ctx.repo, operator_env={
        k: v for k, v in env.items() if not k.startswith("GPU_OPERATOR_OPSAN")})
    gate = opsan_gate(plain, reports)
    result = gate["result"]
    numbers["gate"] = {"rc": gate["rc"], "wall_s": gate["wall_s"],
                       "coverage": result["coverage"],
                       "static_edges": len(result["static_edges"]),
                       "dynamic_edges": len(result["dynamic_edges"]),
                       "dynamic_only": len(result["dynamic_only"]),
                       "unfixtured": result["unfixtured"],
                       "stale_fixtures": len(result["stale_fixtures"]),
                       "races": len(result["races"])}
    print(json.dumps({"opsan_gate": numbers["gate"], "card": ctx.card}))
    check(gate["rc"] == 0 and result["ok"],
          f"opsan check over the sanitized run: {numbers['gate']} {result['races']}")

    # -- 6. the gate's teeth: a planted race -------------------------------------------------
    planted_dir = os.path.join(ctx.work, "opsan-planted")
    out = subprocess.run([sys.executable, "-c", OPSAN_PLANTED], cwd=ctx.repo,
                         env=dict(opsan_env(plain.operator_env, planted_dir),
                                  PYTHONPATH=ctx.repo),
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"the planted race's process: {out.stderr[-2000:]}")
    teeth = opsan_gate(plain, planted_dir)
    named = [r["var"] for r in teeth["result"]["races"]]
    numbers["planted"] = {"rc": teeth["rc"], "races": named}
    check(teeth["rc"] == 1 and named == ["smoke.planted"],
          f"opsan check over the planted race: {numbers['planted']}")
    numbers["phase_s"] = round(time.monotonic() - started, 3)
    print(json.dumps({"opsan": {k: numbers[k] for k in ("join", "fuzz", "planted", "phase_s")},
                      "card": ctx.card}))
    return numbers


#: the envtest driver's five steps and its verdict, each of which must pass
LANES_ENVTEST_STEPS = ("crd-install", "schema-422", "structural-pruning",
                       "reconcile-to-ready", "ownerref-gc", "overall")
#: the shell e2e's outer bound (its cases' own waits are the detectors)
LANES_E2E_TIMEOUT_S = 600


def lanes_phase(ctx) -> dict:
    """Phase 21, after phase 20: the port's test lanes outside the package,
    run on this machine.

    1. ``bash`` and ``curl`` must be found (the shell e2e's two tools).
    2. ``tests/scripts/torch/end-to-end.sh``, every case: exit 0 and a
       ``PASS: <case> (<s> s)`` line for each ``tests/cases/torch/*.sh``.
    3. ``tests/torch_envtest_driver.py --mini-apiserver --expect-gc yes``:
       exit 0 and every step of :data:`LANES_ENVTEST_STEPS` ``pass`` in its
       ``results.jsonl``.
    4. ``tests/e2e-envtest-gpu.sh`` and ``tests/e2e-kind-gpu.sh``: exit 77
       with their skip record in ``ctx.work``, or exit 0 where their tools
       exist.

    ``ctx``: ``repo``, ``work`` (a scratch directory), ``card`` and
    ``operator_env`` (the processes' environment)."""
    started = time.monotonic()
    numbers = {"card": ctx.card}
    tools = {tool: shutil.which(tool) for tool in ("bash", "curl")}
    check(all(tools.values()), f"the lanes need bash and curl; missing: "
          f"{sorted(t for t, path in tools.items() if not path)}")
    env = dict(ctx.operator_env, TMPDIR=ctx.work)

    t = time.monotonic()
    e2e = subprocess.run(["bash", os.path.join("tests", "scripts", "torch", "end-to-end.sh")],
                         cwd=ctx.repo, env=env, capture_output=True, text=True,
                         timeout=LANES_E2E_TIMEOUT_S)
    total_s = round(time.monotonic() - t, 3)
    cases = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(ctx.repo, "tests", "cases", "torch", "*.sh")))
    passed = dict(re.findall(r"=== PASS: (\S+) \(([\d.]+) s\) ===", e2e.stdout))
    check(e2e.returncode == 0 and sorted(passed) == cases and len(cases) == 7,
          f"the shell e2e exited {e2e.returncode} with {sorted(passed)} of {cases} passed:\n"
          f"{e2e.stdout[-3000:]}\n{e2e.stderr[-3000:]}")
    numbers["shell_e2e"] = {"case_s": {c: float(passed[c]) for c in cases}, "total_s": total_s}

    evidence = os.path.join(ctx.work, "envtest-evidence")
    t = time.monotonic()
    envtest = subprocess.run(
        [sys.executable, os.path.join("tests", "torch_envtest_driver.py"), "--mini-apiserver",
         "--expect-gc", "yes", "--timeout", "120", "--evidence-dir", evidence],
        cwd=ctx.repo, env=env, capture_output=True, text=True, timeout=300)
    steps = {}
    if os.path.exists(os.path.join(evidence, "results.jsonl")):
        with open(os.path.join(evidence, "results.jsonl")) as f:
            steps = {r["step"]: r["status"] for r in map(json.loads, f)}
    check(envtest.returncode == 0 and steps == {s: "pass" for s in LANES_ENVTEST_STEPS},
          f"the envtest driver exited {envtest.returncode} with {steps}:\n"
          f"{envtest.stdout[-2000:]}\n{envtest.stderr[-2000:]}")
    numbers["envtest"] = {"steps": steps, "wall_s": round(time.monotonic() - t, 3)}

    for script, record_env in (("e2e-envtest-gpu.sh", "ENVTEST_SKIP_RECORD"),
                               ("e2e-kind-gpu.sh", "KIND_SKIP_RECORD")):
        record = os.path.join(ctx.work, f"{script}.skip.json")
        out = subprocess.run(["bash", os.path.join("tests", script)], cwd=ctx.repo,
                             env=dict(env, **{record_env: record}), capture_output=True,
                             text=True, timeout=1800)
        skipped = out.returncode == 77 and os.path.exists(record)
        if skipped:
            with open(record) as f:
                skipped = json.load(f).get("skipped") is True
        check(skipped or out.returncode == 0,
              f"{script} exited {out.returncode} (77 with a skip record, or 0, expected):\n"
              f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
        numbers[script] = "skipped (77)" if skipped else "ran (0)"
    numbers["phase_s"] = round(time.monotonic() - started, 3)
    print(json.dumps({"lanes": numbers}))
    return numbers


#: phase 22's outage: longer than the elector's 5 s renew period, shorter than
#: its 15 s lease and its 12 s hold window (controllers/leader.py, the
#: defaults ``gpu-operator --leader-elect`` runs with)
OUTAGE_S = 6.0
#: phase 22's budget, from the fresh cluster to ``ready`` after the outage
OUTAGE_BUDGET_S = 120.0
#: the DaemonSet deleted while the apiserver is down
OUTAGE_DS = "gpu-device-plugin"


def outage_phase(ctx) -> dict:
    """Phase 22, after phase 21: a join through an apiserver outage.

    1. A fresh one-node cluster as phase 12's (:func:`join_cluster` on
       ``ctx.node``) whose ``gpu-operator`` (the chart's Deployment as a
       process) keeps the chart's ``--leader-elect``: the elector's 15 s
       lease, 5 s renew period and 12 s hold window. The ClusterPolicy
       goes in once the operator holds the Lease.
    2. Once the validation chain runs on the card (the driver barrier
       written, the device plugin's pod has given the node its GPUs, the
       ClusterPolicy not yet ``ready``), the MiniApiServer stops: the
       operator and the validators' processes (``KUBE_API_URL``) meet a dead
       endpoint.
    3. It stays down :data:`OUTAGE_S`. Meanwhile the ``gpu-device-plugin``
       DaemonSet is deleted from the store: the process kubelet kills its
       pod and the node's GPUs go to 0.
    4. A new MiniApiServer over the same store starts on the same port.
    5. Checks: the operator is the same process, still running, and kept
       the Lease (holder and epoch unchanged, renewed after the restart);
       the DaemonSet is back and its pod ready; the node advertises NVML's
       GPU count again; the workload barrier passed; the ClusterPolicy is
       ``ready``; all within :data:`OUTAGE_BUDGET_S`.

    Prints the outage's length, the seconds from the restart to each
    milestone, the operator's retry, breaker and request counters from its
    ``/metrics`` across the outage, and the workload report's
    ``elapsed_s``. ``ctx``: ``repo``, ``work``, ``card``, ``node``
    (:func:`card_node`'s dict) and ``operator_env``."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.controllers.leader import LEASE_NAME
    from tpu_operator_torch.testing.apiserver import MiniApiServer
    from tpu_operator_torch.utils import deep_get
    from tpu_operator_torch.validator.status import StatusFiles

    started = time.monotonic()
    deadline = started + OUTAGE_BUDGET_S

    def left() -> float:
        return max(0.0, deadline - time.monotonic())

    numbers = {"card": ctx.card}
    ns = consts.DEFAULT_NAMESPACE
    cluster = join_cluster(ctx.repo, ctx.work, ctx.node, leader_elect=True)
    check("--leader-elect" in cluster.argv, f"the chart's operator argv: {cluster.argv}")
    env = dict({k: v for k, v in ctx.operator_env.items() if not k.startswith("GPU_")},
               **cluster.env)
    metrics_port, health_port = free_port(), free_port()
    log_path = os.path.join(ctx.work, "operator-outage.log")
    operator = subprocess.Popen(
        [*cluster.argv, f"--api-server={cluster.base}", f"--metrics-port={metrics_port}",
         f"--health-port={health_port}"], cwd=ctx.repo, stdout=open(log_path, "w"),
        stderr=subprocess.STDOUT, start_new_session=True, env=env)
    srv, kubelet, backend = cluster.srv, cluster.kubelet, cluster.srv.backend
    port = int(cluster.base.rsplit(":", 1)[1])
    node_name, gpus = ctx.node["node_name"], str(ctx.node["gpu_count"])
    status = StatusFiles(cluster.status_dir)

    def lease():
        with contextlib.suppress(Exception):
            return backend.get("coordination.k8s.io/v1", "Lease", LEASE_NAME, ns)
        return None

    def lease_view(obj) -> dict:
        spec = (obj or {}).get("spec") or {}
        return {"holder": spec.get("holderIdentity"), "renew": spec.get("renewTime"),
                "transitions": spec.get("leaseTransitions"),
                "epoch": ((obj or {}).get("metadata", {}).get("annotations") or {}).get(
                    consts.LEADER_EPOCH_ANNOTATION)}

    def policy_state():
        live = backend.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        return (live.get("status") or {}).get("state")

    def capacity():
        return deep_get(backend.get("v1", "Node", node_name), "status", "capacity",
                        consts.GPU_RESOURCE_NAME)

    def counters() -> dict:
        samples = scrape_samples(_try_scrape(metrics_port) or "")

        def total(prefix):
            return sum(v for k, v in samples.items() if k.startswith(prefix))

        requests = "tpu_operator_rest_client_requests_total{"
        return {"api_retries": total("tpu_operator_api_retries_total"),
                "breaker_transitions": total("tpu_operator_api_breaker_transitions_total"),
                # each informer's watch (re)connect is one answered WATCH
                "watch_connects": total(requests + 'code="200",method="WATCH"'),
                "requests": total(requests),
                "requests_refused": sum(v for k, v in samples.items() if k.startswith(requests)
                                        and not k.startswith(requests + 'code="2')),
                "reconcile_errors": total("tpu_operator_reconcile_errors_total{")}

    try:
        # -- 1. the operator leads; the join starts --------------------------------------
        held = _wait_for(lambda: lease_view(lease())["holder"], left(), "the operator's Lease")
        kubelet.start()
        t0 = time.time()
        backend.create(cluster.cp)

        # -- 2. the chain runs on the card; the apiserver goes ----------------------------
        _wait_for(lambda: status.read("driver") is not None and capacity() == gpus,
                  left(), "the driver barrier and the node's GPUs")
        state = policy_state()
        check(state != "ready", f"the ClusterPolicy was {state} before the outage: no chain "
                                f"left to run through it")
        before = {"lease": lease_view(lease()), "counters": counters()}
        check(before["lease"]["holder"] == held, f"the Lease changed hands: {before['lease']}")
        srv.stop()
        t_down = time.time()
        numbers["down_after_cr_s"] = round(t_down - t0, 3)

        # -- 3. down for OUTAGE_S; the device plugin's DaemonSet goes --------------------
        time.sleep(0.5)  # the watches, the elector and the validators meet the dead endpoint
        backend.delete("apps/v1", "DaemonSet", OUTAGE_DS, ns)
        _wait_for(lambda: kubelet.first("capacity-withdrawn", after=t_down, ds=OUTAGE_DS),
                  OUTAGE_S, "the kubelet taking the plugin's GPUs back")
        check(capacity() == "0", f"the node's GPUs during the outage: {capacity()}")
        time.sleep(max(0.0, t_down + OUTAGE_S - time.time()))

        # -- 4. back on the same port ------------------------------------------------------
        srv = MiniApiServer(backend=backend)
        srv.start(port)
        t_up = time.time()
        numbers["outage_s"] = round(t_up - t_down, 3)
        milestones = Milestones(t_up, {
            "ds_recreated": lambda: backend.get("apps/v1", "DaemonSet", OUTAGE_DS, ns),
            "plugin_pod_ready": lambda: kubelet.first("ready", after=t_up, ds=OUTAGE_DS),
            "capacity_back": lambda: capacity() == gpus,
            "lease_renewed": lambda: lease_view(lease())["renew"] != before["lease"]["renew"],
            "ready": lambda: policy_state() == "ready"})
        try:
            _wait_for(lambda: policy_state() == "ready" and capacity() == gpus
                      and kubelet.first("ready", after=t_up, ds=OUTAGE_DS), left(),
                      "the ClusterPolicy ready, the plugin's pod running and the GPUs back "
                      "after the outage")
            time.sleep(0.1)  # the milestone poller's last tick
        finally:
            numbers["restart_to_s"] = milestones.stop()

        # -- 5. what held through it -------------------------------------------------------
        after = lease_view(lease())
        check(operator.poll() is None, f"the operator exited {operator.returncode}")
        check(after["holder"] == held and after["epoch"] == before["lease"]["epoch"]
              and after["transitions"] == before["lease"]["transitions"]
              and after["renew"] != before["lease"]["renew"],
              f"the operator did not keep the Lease: {before['lease']} -> {after}")
        ds = backend.get("apps/v1", "DaemonSet", OUTAGE_DS, ns)
        check((ds.get("status") or {}).get("numberAvailable") == 1,
              f"the recreated {OUTAGE_DS}: {ds.get('status')}")
        barrier = status.read("workload") or {}
        check(barrier.get("passed") is True, f"the workload barrier: {barrier}")
        check(set(numbers["restart_to_s"]) >= {"ds_recreated", "capacity_back", "ready"},
              f"milestones after the restart: {numbers['restart_to_s']}")
        counted = counters()
        numbers["operator"] = {
            "pid": operator.pid, "lease_holder": held, "epoch": after["epoch"],
            "counters_before": before["counters"],
            "counters_delta": {k: round(counted[k] - before["counters"][k], 3)
                               for k in counted}}
        numbers["workload_elapsed_s"] = barrier.get("elapsed_s")
        numbers["join_ready_s"] = round(time.time() - t0, 3)
        # where the wait after the restart went: the validation chain's
        # containers that failed against the dead apiserver and reran, and
        # the workload pod's run
        failed = [e for e in kubelet.matching("init-exit", after=t_down)
                  if e.get("rc") not in (0, None)]
        pod_exit = kubelet.first("pod-exit", after=t_down)
        numbers["chain"] = {
            "failed_inits": [f"{e['ds']}/{e['container']}@{round(e['t'] - t_up, 3)}"
                             for e in failed],
            "workload_pod_exit_s": round(pod_exit["t"] - t_up, 3) if pod_exit else None}
        maps = _maps(operator.pid)
        check(maps == (False, False), f"the operator maps torch or libcuda: {maps}")
    except SystemExit:
        with open(log_path) as f:
            print(f"-- operator log:\n{f.read()[-6000:]}", file=sys.stderr)
        print(f"-- kubelet events: {kubelet.events}", file=sys.stderr)
        raise
    finally:
        kubelet.stop()
        with contextlib.suppress(ProcessLookupError):
            os.killpg(operator.pid, signal.SIGKILL)
        operator.wait(timeout=60)
        srv.stop()
    numbers["phase_s"] = round(time.monotonic() - started, 3)
    check(numbers["phase_s"] <= OUTAGE_BUDGET_S + 10.0,
          f"phase 22 took {numbers['phase_s']} s of its {OUTAGE_BUDGET_S} s")
    print(json.dumps({"outage": {k: numbers[k] for k in (
        "outage_s", "down_after_cr_s", "restart_to_s", "operator", "chain",
        "workload_elapsed_s", "join_ready_s", "phase_s")}, "card": ctx.card}))
    return numbers


#: phase 23's simulated cluster, the reference's join-bench settings
#: (bench.py:INJECTED, INJECTED_DS_ROLLOUT_TICKS): a 20 ms apiserver, a
#: 0.5 s kubelet sync period, and image pulls of 10 ticks for the
#: validator's image, 7 for the device plugin's and 5 for every other
#: image, keyed here by the DaemonSets' component labels
PIPELINED_LATENCY_S = 0.02
PIPELINED_INTERVAL_S = 0.5
PIPELINED_PULL_TICKS = {"gpu-operator-validator": 10, "gpu-device-plugin": 7, "*": 5}
#: the sweep's matrix, as the join bench's and phase 12's
PIPELINED_MATRIX_DIM = 512
PIPELINED_BUDGET_S = 120.0
#: the attribution gate (the reference's join bench: 95% of the window)
PIPELINED_MIN_COVERAGE = 0.95
#: the operator's images, from the chart's Deployment env
OPERAND_IMAGE_ENVS = ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "DEVICE_PLUGIN_IMAGE",
                      "FEATURE_DISCOVERY_IMAGE", "TELEMETRY_EXPORTER_IMAGE",
                      "SLICE_PARTITIONER_IMAGE")


class ProfilerTape:
    """Every input the operator's join profiler takes, in order, with the
    wall time it came at: each finished reconcile root (``on_trace``) and
    each ClusterPolicy sweep's view (``observe``: the policy's name and uid,
    each node's name, GPU capacity and the two annotations the profiler
    reads, and whether the policy was ready). A replay of the tape through
    any join profiler under a clock set to each sweep's time gives its
    attribution of the same join."""

    def __init__(self, profiler, tracer):
        from tpu_operator_torch import consts

        self.events: list = []
        self._lock = threading.Lock()
        self._keys = (consts.IMAGE_PREPULL_ANNOTATION, consts.TRACE_SPANS_ANNOTATION)
        self._resource = consts.GPU_RESOURCE_NAME
        on_trace, observe = profiler.on_trace, profiler.observe

        def taped_on_trace(root):
            if root.duration_s is not None:
                with self._lock:
                    self.events.append({
                        "kind": "trace", "start_unix": root.start_unix,
                        "duration_s": root.duration_s, "trace_id": root.trace_id,
                        "controller": str(root.attributes.get("controller", ""))})
            on_trace(root)

        def taped_observe(policy, nodes, results):
            meta = policy.obj.get("metadata") or {}
            with self._lock:
                self.events.append({
                    "kind": "observe", "t": time.time(),
                    "policy": {"name": meta.get("name"), "uid": meta.get("uid")},
                    "nodes": [self._node(n) for n in nodes],
                    "ready": bool(getattr(results, "ready", False))})
            observe(policy, nodes, results)

        tracer.on_finalize = taped_on_trace
        profiler.observe = taped_observe

    def _node(self, node: dict) -> dict:
        meta = node.get("metadata") or {}
        annotations = meta.get("annotations") or {}
        capacity = (node.get("status") or {}).get("capacity") or {}
        return {"metadata": {"name": meta.get("name"),
                             "annotations": {k: annotations[k] for k in self._keys
                                             if k in annotations}},
                "status": {"capacity": {k: v for k, v in capacity.items()
                                        if k == self._resource}}}


def _uncovered(intervals: list, window: tuple, at_least_s: float = 0.01) -> list:
    """The stretches of ``window`` no interval covers, each at least
    ``at_least_s`` long: ``[start, seconds]`` from the window's start."""
    gaps, reach = [], window[0]
    for _, a, b in sorted(intervals, key=lambda i: i[1]):
        if a > reach and min(a, window[1]) - reach >= at_least_s:
            gaps.append([round(reach - window[0], 3), round(min(a, window[1]) - reach, 3)])
        reach = max(reach, b)
    if window[1] - reach >= at_least_s:
        gaps.append([round(reach - window[0], 3), round(window[1] - reach, 3)])
    return gaps


@contextlib.contextmanager
def _environ(updates: dict):
    """``os.environ`` with ``updates`` for the block, restored after."""
    saved = {k: os.environ.get(k) for k in updates}
    os.environ.update(updates)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pipelined_join_phase(ctx) -> dict:
    """Phase 23, after phase 22: the pipelined join, the reference's join
    attribution (``bench.py:bench_join_attribution``) in the port's terms.

    1. A fresh MiniApiServer with a 20 ms latency, a ClusterPolicy from
       ``new_cluster_policy()`` and the operator in this process
       (``OperatorApp`` over ``CachedClient(RestClient)``, its images the
       chart's), so its join profiler is read directly; a tape records every
       input the profiler takes (:class:`ProfilerTape`).
       The Node for this machine (NVIDIA's feature-discovery PCI label) is
       there before the ClusterPolicy; the join starts with the policy.
    2. Once the first rendered DaemonSet carries the join's trace parent,
       the in-memory kubelet starts without pods: ``KubeletSimulator(
       create_pods=False, interval=0.5)``, each (DaemonSet, node) pulling
       its image on its own clock (:data:`PIPELINED_PULL_TICKS`, mapped onto
       the rendered DaemonSets' names by their component labels) from the
       labeller's pre-pull stamp, each pod available only past the barriers
       its rendered init containers gate on, read from the status directory.
    3. The node agent, once the operator's first sweep over the node is done
       (the join's window open, the pre-pull stamped): the port's validator
       CLI in subprocesses, in the manifest's order, ``-c driver`` over
       ``ctx.node``'s driver bundle,
       ``-c plugin --timeout 60 --poll 0.2 --prewarm`` into a fresh kernel
       cache, ``-c workload-local``; beside them ``-c wait --for workload
       --timeout 90``. Each runs under the rendered trace parent.
    4. Once the node has its GPUs and the ClusterPolicy is ``ready``, one
       feature-discovery pass mirrors the node's spans, and the profiler's
       join trace is read.

    Checks (the reference's join-bench gates but its CPU time budget):
    every step exits 0; the three barriers passed, stamped driver <= plugin
    <= workload; the node carries the pre-pull stamp and ``image-prepull``
    is attributed; coverage at least :data:`PIPELINED_MIN_COVERAGE`; no
    orphan span; the window complete; the phase within
    :data:`PIPELINED_BUDGET_S`. Prints ``join_s``, the tick and second
    each DaemonSet became available, the seconds per phase, coverage and
    ``unattributed_s``, the serial sum of the pulls beside ``join_s``, the
    sweep's ``elapsed_s`` and ``compile_s``, and the card. ``ctx``:
    ``repo``, ``work``, ``card``, ``node`` (:func:`card_node`'s dict),
    ``device`` (feature discovery's; ``cuda`` on the card). The returned
    numbers hold the profiler's tape (``tape``) and the kubelet's
    ``transitions``."""
    import logging

    from tpu_operator_torch import consts
    from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
    from tpu_operator_torch.client.cache import CachedClient
    from tpu_operator_torch.client.rest import RestClient
    from tpu_operator_torch.controllers.manager import OperatorApp
    from tpu_operator_torch.joinprofile.critical_path import record_intervals
    from tpu_operator_torch.testing.apiserver import MiniApiServer
    from tpu_operator_torch.testing.kubelet import KubeletSimulator
    from tpu_operator_torch.utils import deep_get
    from tpu_operator_torch.validator import feature_discovery
    from tpu_operator_torch.validator.status import StatusFiles

    started = time.monotonic()
    deadline = started + PIPELINED_BUDGET_S

    def left() -> float:
        return max(0.0, deadline - time.monotonic())

    ns = consts.DEFAULT_NAMESPACE
    node_name = ctx.node["node_name"]
    status_dir = os.path.join(ctx.work, "pipelined-status")
    cache_dir = os.path.join(ctx.work, "pipelined-kernel-cache")
    os.makedirs(status_dir)
    status = StatusFiles(status_dir)
    rendered = install_from_chart(ctx.repo, chart_values(ctx.work, status_dir), ns)
    _, deployment_env = deployment_process(
        ctx.repo, next(o for o in rendered if o["kind"] == "Deployment"))
    images = {k: deployment_env[k] for k in OPERAND_IMAGE_ENVS}

    log_path = os.path.join(ctx.work, "operator-pipelined.log")
    handler = logging.FileHandler(log_path)
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
    port_log = logging.getLogger("tpu_operator_torch")
    saved_log = (port_log.level, port_log.propagate)
    port_log.addHandler(handler)
    port_log.setLevel(logging.INFO)
    port_log.propagate = False

    srv = MiniApiServer(latency_s=PIPELINED_LATENCY_S)
    base = srv.start()
    seed = RestClient(base)
    numbers: dict = {"card": ctx.card}
    app = op_client = kubelet = None
    procs: dict = {}
    chain_rcs: dict = {}
    try:
        with _environ(images):
            seed.create({"apiVersion": "v1", "kind": "Node", "metadata": {
                "name": node_name, "labels": {consts.NFD_NVIDIA_PCI_LABEL: "true",
                                              "kubernetes.io/hostname": node_name}}})
            op_client = CachedClient(RestClient(base))
            app = OperatorApp(op_client)
            tape = ProfilerTape(app.join_profiler, app.tracer)
            app.start()
            t0 = time.time()
            seed.create(new_cluster_policy())

            # -- 1. the first render carries the join's trace parent -----------------------
            def trace_parent():
                for ds in srv.backend.list("apps/v1", "DaemonSet", ns):
                    spec = deep_get(ds, "spec", "template", "spec", default={})
                    for c in (spec.get("initContainers") or []) + (spec.get("containers") or []):
                        for e in c.get("env") or []:
                            if e.get("name") == consts.TRACE_PARENT_ENV and e.get("value"):
                                return e["value"]
                return None

            parent = _wait_for(trace_parent, min(30.0, left()),
                               "a rendered DaemonSet carrying the trace parent")

            def by_component():
                return {deep_get(ds, "spec", "template", "metadata", "labels",
                                 "app.kubernetes.io/component"): ds["metadata"]["name"]
                        for ds in srv.backend.list("apps/v1", "DaemonSet", ns)}

            components = _wait_for(
                lambda: (lambda c: c if set(PIPELINED_PULL_TICKS) - {"*"} <= set(c) else None)(
                    by_component()), min(30.0, left()), "the validator's and the plugin's "
                                                        "DaemonSets rendered")
            pulls = {components.get(k, k): v for k, v in PIPELINED_PULL_TICKS.items()}
            numbers["pull_ticks"] = pulls

            # -- 2. the pod-less kubelet ----------------------------------------------------
            kubelet = KubeletSimulator(
                seed, create_pods=False, interval=PIPELINED_INTERVAL_S, rollout_ticks=pulls,
                barrier_check=status.is_ready, gpus_per_node=ctx.node["gpu_count"])
            kubelet.start()
            numbers["kubelet_start_s"] = round(time.time() - t0, 3)

            # -- 3. the node agent, in the manifest's order, once the operator's sweep has
            # seen the node (the join's window is open; the labeller has stamped it)
            _wait_for(lambda: app.join_profiler.join_trace(node_name) is not None,
                      min(30.0, left()), "the operator's first sweep over the node")
            numbers["chain_start_s"] = round(time.time() - t0, 3)
            env = dict(os.environ, **{
                consts.TRACE_PARENT_ENV: parent, "NODE_NAME": node_name,
                "STATUS_DIR": status_dir, "KUBE_API_URL": base,
                "GPU_COMPILATION_CACHE_DIR": cache_dir, "PYTHONPATH": ctx.repo})
            validator = ctx.node["validator"]
            bundle = ctx.node["driver_env"][consts.DRIVER_SRC_ENV]
            steps = (("driver", ["-c", "driver", f"--install-dir={bundle}"]),
                     ("plugin", ["-c", "plugin", "--timeout", "60", "--poll", "0.2",
                                 "--prewarm"]),
                     ("workload", ["-c", "workload-local", "--matrix-dim",
                                   str(PIPELINED_MATRIX_DIM)]))

            def run(name, args):
                with open(os.path.join(ctx.work, f"pipelined-{name}.log"), "w") as out:
                    return subprocess.Popen(
                        [*validator, *args, f"--status-dir={status_dir}"], cwd=ctx.repo,
                        env=env, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)

            def chain():
                for name, args in steps:
                    procs[name] = run(name, args)
                    chain_rcs[name] = procs[name].wait()
                    if chain_rcs[name] != 0:
                        return  # a failed stage blocks the chain, as in a pod

            runner = threading.Thread(target=chain, daemon=True, name="pipelined-chain")
            runner.start()
            procs["wait"] = run("wait", ["-c", "wait", "--for", "workload", "--timeout", "90"])

            def converged():
                node = srv.backend.get("v1", "Node", node_name)
                policy = srv.backend.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
                return (deep_get(node, "status", "capacity", consts.GPU_RESOURCE_NAME) is not None
                        and deep_get(policy, "status", "state") == "ready")

            _wait_for(lambda: converged() or (chain_rcs and any(chain_rcs.values())), left(),
                      "the node schedulable and the ClusterPolicy ready")
            check(converged(), f"a chain step failed: {chain_rcs}")
            numbers["join_s"] = round(time.time() - t0, 3)
            runner.join(timeout=left())
            check(not runner.is_alive(), "the node agent's chain within the budget")
            _wait_for(lambda: procs["wait"].poll() is not None, left(), "the concurrent wait")
            chain_rcs["wait"] = procs["wait"].returncode
            numbers["chain_exit_codes"] = dict(chain_rcs)
            check(all(chain_rcs.get(s) == 0 for s in ("driver", "plugin", "workload", "wait")),
                  f"the node agent's exit codes: {chain_rcs}")

            # -- what ready means: real barriers, in the DAG's order ------------------------
            barriers = {b: status.read(b) or {} for b in ("driver", "plugin", "workload")}
            check(all(b and b.get("passed") is not False for b in barriers.values()),
                  f"the barriers: {barriers}")
            stamps = [barriers[b].get("timestamp") for b in ("driver", "plugin", "workload")]
            check(None not in stamps and stamps == sorted(stamps),
                  f"barriers out of order (driver, plugin, workload): {stamps}")
            node = srv.backend.get("v1", "Node", node_name)
            check(deep_get(node, "metadata", "annotations",
                           consts.IMAGE_PREPULL_ANNOTATION) is not None,
                  "the node carries no pre-pull stamp")

            # -- 4. the node's spans mirrored, the join trace read --------------------------
            feature_discovery.sync_node_labels(seed, node_name, device=ctx.device,
                                               status_dir=status_dir)
            trace = _wait_for(lambda: (lambda t: t if t and t["node_spans"] else None)(
                app.join_profiler.join_trace(node_name)), min(30.0, left()),
                "the join trace with the node's spans")
        att = trace["attribution"]
        available = {}
        for tick, t, ds, count in kubelet.transitions:
            if count and ds not in available:
                available[ds] = {"tick": tick, "s": round(t - t0, 3)}
        workload = barriers["workload"]
        interval_s = PIPELINED_INTERVAL_S
        numbers.update({
            "ds_available": available,
            "serial_pull_s": round(sum(pulls.get(ds, pulls["*"]) for ds in available)
                                   * interval_s, 3),
            "phases": att["phases"], "coverage": att["coverage"],
            "window_s": att["window_s"], "unattributed_s": att["unattributed_s"],
            "node_spans": len(trace["node_spans"]), "orphan_spans": len(trace["orphan_spans"]),
            "complete": trace["window"]["complete"],
            "operator_sweeps": trace["operator_sweeps"],
            "sweep": {"elapsed_s": workload.get("elapsed_s"),
                      "compile_s": workload.get("compile_s"),
                      "platform": workload.get("platform")},
            "barrier_stamps_s": {b: round(s - t0, 3) for b, s in
                                 zip(("driver", "plugin", "workload"), stamps)},
            "tape": tape.events,
            "transitions": [list(x) for x in kubelet.transitions],
        })
        print(json.dumps({"pipelined_join": {k: v for k, v in numbers.items()
                                             if k not in ("tape", "transitions")},
                          "card": ctx.card}))
        if att["coverage"] < PIPELINED_MIN_COVERAGE:
            window = (trace["window"]["start_unix"], trace["window"]["end_unix"])
            spans = record_intervals(trace["node_spans"])
            sweeps = [("reconcile", e["start_unix"], e["start_unix"] + e["duration_s"])
                      for e in tape.events if e["kind"] == "trace"]
            rollout = [("ds-rollout-wait", window[0],
                        trace["window"]["completed_at"] or window[1])]
            print(json.dumps({"pipelined_unattributed": _uncovered(spans + sweeps + rollout,
                                                                   window),
                              "node_spans": sorted((round(a - window[0], 3), round(b - a, 3), p)
                                                   for p, a, b in spans)}))
        check(att["coverage"] >= PIPELINED_MIN_COVERAGE,
              f"attribution covers {att['coverage']} of the window, under "
              f"{PIPELINED_MIN_COVERAGE}")
        check(not trace["orphan_spans"], f"orphan spans: {trace['orphan_spans']}")
        check(trace["window"]["complete"], f"the join window is not complete: {trace['window']}")
        check("image-prepull" in att["phases"], f"no image-prepull attributed: {att['phases']}")
    except SystemExit:
        with open(log_path) as f:
            print(f"-- operator log:\n{f.read()[-6000:]}", file=sys.stderr)
        for name in ("driver", "plugin", "workload", "wait"):
            path = os.path.join(ctx.work, f"pipelined-{name}.log")
            if os.path.exists(path):
                with open(path) as f:
                    print(f"-- {name}:\n{f.read()[-3000:]}", file=sys.stderr)
        if kubelet is not None:
            print(f"-- kubelet transitions: {kubelet.transitions}", file=sys.stderr)
        raise
    finally:
        for p in procs.values():
            if p.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
        if app is not None:
            app.stop()
        if op_client is not None:
            op_client.stop()
        if kubelet is not None:
            kubelet.stop()
        srv.stop()
        port_log.removeHandler(handler)
        handler.close()
        port_log.setLevel(saved_log[0])
        port_log.propagate = saved_log[1]
    numbers["phase_s"] = round(time.monotonic() - started, 3)
    print(json.dumps({"pipelined_phase_s": numbers["phase_s"], "join_s": numbers["join_s"],
                      "serial_pull_s": numbers["serial_pull_s"], "card": ctx.card}))
    check(numbers["phase_s"] <= PIPELINED_BUDGET_S,
          f"phase 23 took {numbers['phase_s']} s of its {PIPELINED_BUDGET_S} s")
    return numbers


#: phase 24's rendezvous budget for a world that lacks a process, and
#: each run's own bound (s)
MULTIHOST_INIT_TIMEOUT_S = 5
MULTIHOST_RUN_TIMEOUT_S = 300


def multihost_phase(ctx) -> dict:
    """Phase 24, after phase 23: the multi-node sweep (``workload-multihost``)
    and the graft entry's command line, on this machine.

    1. ``gpu-validator -c workload-multihost`` as a world of one process over
       every visible GPU (``ctx.n_gpus``), through a TCP coordinator on
       ``127.0.0.1`` at a free port: exit 0, its report and barrier with
       ``n_devices`` equal to the GPU count, ``local_chips`` ``0 .. n-1``,
       every check passed and no partial sweep.
    2. ``--num-processes=2`` with only process 0 started, at
       ``--init-timeout=5``: a non-zero exit within the budget, no barrier.
    3. ``make -f gpu.mk graft-check``: the single-GPU check, then the mesh
       dry run over every visible GPU.

    Each run's seconds print. ``ctx``: ``repo``, ``work`` (a scratch
    directory), ``card``, ``device`` (``cuda``; ``cpu`` rehearses the phase
    with one gloo rank) and ``n_gpus``."""
    from tpu_operator_torch.validator import status as vstatus

    started = time.monotonic()
    numbers = {"card": ctx.card}
    env = dict(os.environ, PYTHONPATH=ctx.repo, TMPDIR=ctx.work)
    validator = [sys.executable, "-m", "tpu_operator_torch.cmd.validator",
                 "-c", "workload-multihost", f"--device={ctx.device}", "--matrix-dim=512"]

    def sweep(name: str, *argv) -> tuple:
        status_dir = os.path.join(ctx.work, name)
        t = time.monotonic()
        out = subprocess.run([*validator, f"--status-dir={status_dir}", *argv], cwd=ctx.repo,
                             env=env, capture_output=True, text=True,
                             timeout=MULTIHOST_RUN_TIMEOUT_S)
        seconds = round(time.monotonic() - t, 3)
        lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
        report = json.loads(lines[-1]) if lines else None
        return out, report, vstatus.StatusFiles(status_dir), seconds

    out, report, status, seconds = sweep(
        "world-of-one", f"--coordinator=127.0.0.1:{free_port()}", "--num-processes=1",
        "--process-id=0")
    n = ctx.n_gpus
    check(out.returncode == 0 and report is not None,
          f"workload-multihost as a world of one exited {out.returncode}:\n"
          f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    barrier = status.read("workload")
    check(report["passed"] and report["n_devices"] == n
          and report["local_chips"] == list(range(n)) and report["failed_local_chips"] == [],
          f"the world of one's report: {report} (expected {n} GPUs, local_chips 0..{n - 1})")
    check(status.is_ready("workload") and barrier.get("local_chips") == list(range(n)),
          f"the world of one's barrier: {barrier}")
    check(vstatus.partial_sweep(barrier, n) is False, f"a partial sweep: {barrier}")
    numbers["world_of_one"] = {"s": seconds, "n_devices": report["n_devices"],
                               "local_chips": report["local_chips"],
                               "platform": report["platform"],
                               "elapsed_s": report["elapsed_s"],
                               "compile_s": report["compile_s"]}

    out, report, status, seconds = sweep(
        "missing-worker", f"--coordinator=127.0.0.1:{free_port()}", "--num-processes=2",
        "--process-id=0", f"--init-timeout={MULTIHOST_INIT_TIMEOUT_S}")
    check(out.returncode != 0 and report is not None and report["passed"] is False,
          f"a world missing its process 1 exited {out.returncode} with {report}:\n"
          f"{out.stderr[-2000:]}")
    check(status.read("workload") is None and not status.is_ready("workload"),
          "a world missing its process 1 wrote a barrier")
    check(seconds < MULTIHOST_INIT_TIMEOUT_S + 60,
          f"the missing worker's rendezvous failed after {seconds} s")
    numbers["missing_worker"] = {"s": seconds, "rc": out.returncode,
                                 "error": str(report["details"].get("error"))[:200]}

    t = time.monotonic()
    graft = subprocess.run(["make", "-f", "gpu.mk", "graft-check", f"PYTHON={sys.executable}",
                            f"DEVICE={ctx.device}"], cwd=ctx.repo, env=env,
                           capture_output=True, text=True, timeout=MULTIHOST_RUN_TIMEOUT_S)
    check(graft.returncode == 0 and "entry ok: True" in graft.stdout
          and "dryrun_multichip(" in graft.stdout,
          f"make -f gpu.mk graft-check exited {graft.returncode}:\n{graft.stdout[-2000:]}\n"
          f"{graft.stderr[-2000:]}")
    numbers["graft_check"] = {"s": round(time.monotonic() - t, 3),
                              "out": [line for line in graft.stdout.splitlines()
                                      if line.startswith(("entry", "dryrun"))]}
    numbers["phase_s"] = round(time.monotonic() - started, 3)
    print(json.dumps({"multihost": numbers}))
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
    last = last_components_phase(card, status_dir, native_s)
    last_launches = k1.launches
    check(last_launches == 0, f"the last components launched K1 {last_launches} times")

    phase("the operator's join on the card: gpu-operator, a process kubelet, the chain")
    k1.launches = 0
    counts = {}

    def phases_13_to_18(ctx):
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
        phase("the capacity loop under chaos: frontier, scale-up, scale-down by migration")
        k1.launches = 0
        autoscale = autoscale_phase(ctx)
        counts["autoscale"] = k1.launches
        phase("the fleet simulator on the card's frontier: five cases, a fuzz sweep, traffic")
        k1.launches = 0
        simulator_phase(ctx, card_curve(ctx, autoscale["frontier"]["points"]),
                        last["handoff"])
        counts["simulator"] = k1.launches
        phase("the support bundle: gpu-must-gather on the chart's operator, the OLM bundle")
        k1.launches = 0
        must_gather_phase(ctx)
        counts["must_gather"] = k1.launches

    phase12 = operator_phase(card, then=phases_13_to_18)
    operator_launches, gpudriver_launches = counts["operator"], counts["gpudriver"]
    health_launches, upgrade_launches = counts["health"], counts["upgrade"]
    autoscale_launches, simulator_launches = counts["autoscale"], counts["simulator"]
    must_gather_launches = counts["must_gather"]
    check(operator_launches == 0, f"the operator path launched K1 {operator_launches} times")
    check(gpudriver_launches == 0, f"phase 13 launched K1 {gpudriver_launches} times")
    check(health_launches == 0, f"phase 14 launched K1 {health_launches} times")
    check(upgrade_launches == 0, f"phase 15 launched K1 {upgrade_launches} times")
    check(autoscale_launches == 0, f"phase 16 launched K1 {autoscale_launches} times")
    check(simulator_launches == 0, f"phase 17 launched K1 {simulator_launches} times")
    check(must_gather_launches == 0, f"phase 18 launched K1 {must_gather_launches} times")

    phase("the port's static checker: gpuop-lint over this tree, and a seeded violation")
    k1.launches = 0
    lint_phase(types.SimpleNamespace(
        repo=os.path.dirname(os.path.abspath(__file__)), card=card,
        work=tempfile.mkdtemp(prefix="chip-smoke-lint-"), operator_env=dict(os.environ)))
    lint_launches = k1.launches
    check(lint_launches == 0, f"phase 19 launched K1 {lint_launches} times")

    phase("a sanitized join: gpu-operator under opsan, the gate and a planted race")
    k1.launches = 0
    opsan_work = tempfile.mkdtemp(prefix="chip-smoke-opsan-")
    opsan_phase(types.SimpleNamespace(
        repo=os.path.dirname(os.path.abspath(__file__)), card=card, work=opsan_work,
        node=card_node(opsan_work), operator_env=dict(os.environ), join_timeout_s=600,
        phase12_ready_s=phase12["join_s"]["ClusterPolicy ready"]))
    opsan_launches = k1.launches
    check(opsan_launches == 0, f"phase 20 launched K1 {opsan_launches} times")
    shutil.rmtree(opsan_work, ignore_errors=True)

    phase("the port's lanes: the shell e2e, the envtest driver, the kind and envtest skips")
    k1.launches = 0
    lanes_work = tempfile.mkdtemp(prefix="chip-smoke-lanes-")
    lanes_phase(types.SimpleNamespace(
        repo=os.path.dirname(os.path.abspath(__file__)), card=card, work=lanes_work,
        operator_env=dict(os.environ)))
    lanes_launches = k1.launches
    check(lanes_launches == 0, f"phase 21 launched K1 {lanes_launches} times")
    shutil.rmtree(lanes_work, ignore_errors=True)

    phase("a join through an apiserver outage: 6 s down, a DaemonSet deleted meanwhile")
    k1.launches = 0
    outage_work = tempfile.mkdtemp(prefix="chip-smoke-outage-")
    outage_phase(types.SimpleNamespace(
        repo=os.path.dirname(os.path.abspath(__file__)), card=card, work=outage_work,
        node=card_node(outage_work), operator_env=dict(os.environ)))
    outage_launches = k1.launches
    check(outage_launches == 0, f"phase 22 launched K1 {outage_launches} times")
    shutil.rmtree(outage_work, ignore_errors=True)

    phase("the pipelined join: concurrent image pulls, barrier gates, the chain on the card")
    k1.launches = 0
    pipelined_work = tempfile.mkdtemp(prefix="chip-smoke-pipelined-")
    pipelined_join_phase(types.SimpleNamespace(
        repo=os.path.dirname(os.path.abspath(__file__)), card=card, work=pipelined_work,
        node=card_node(pipelined_work), device="cuda"))
    pipelined_launches = k1.launches
    check(pipelined_launches == 0, f"phase 23 launched K1 {pipelined_launches} times")
    shutil.rmtree(pipelined_work, ignore_errors=True)

    phase("the multi-node sweep: a world of one over every GPU, a missing worker, graft-check")
    k1.launches = 0
    multihost_work = tempfile.mkdtemp(prefix="chip-smoke-multihost-")
    multihost_phase(types.SimpleNamespace(
        repo=os.path.dirname(os.path.abspath(__file__)), card=card, work=multihost_work,
        device="cuda", n_gpus=torch.cuda.device_count()))
    multihost_launches = k1.launches
    check(multihost_launches == 0, f"phase 24 launched K1 {multihost_launches} times")
    shutil.rmtree(multihost_work, ignore_errors=True)

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
        # loop (14), the rolling upgrade (15), the capacity loop (16), the
        # fleet simulator (17), the support bundle (18), the static checker
        # (19), the sanitized join (20), the lanes (21), the join through
        # an outage (22), the pipelined join (23) and the multi-node sweep
        # (24) are checked at 0 above
        "launches_by_phase": {"perf": k1_main_launches, "serving": serving_launches,
                              "steady_state": steady_state_launches,
                              "device_plumbing": plumbing_launches,
                              "last_components": last_launches,
                              "operator": operator_launches,
                              "gpudriver": gpudriver_launches,
                              "health": health_launches,
                              "upgrade": upgrade_launches,
                              "autoscale": autoscale_launches,
                              "simulator": simulator_launches,
                              "must_gather": must_gather_launches,
                              "lint": lint_launches,
                              "opsan": opsan_launches,
                              "lanes": lanes_launches,
                              "outage": outage_launches,
                              "pipelined": pipelined_launches,
                              "multihost": multihost_launches},
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        if _FAILURES:
            print(f"chip_smoke: FAIL (first): {_FAILURES[0][-4000:]}", file=sys.stderr)
