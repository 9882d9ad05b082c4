"""Kubelets for the port's tests and its smoke: a process kubelet that runs
what the operator schedules onto one node as processes on this host, and
:class:`KubeletSimulator`, an in-memory DaemonSet controller and kubelet
for many nodes (the counterpart of tpu_operator/testing/kubelet.py).

It polls an apiserver client for the DaemonSets of a namespace whose node
selector matches its Node, and for Pods bound to that Node, and runs their
containers: ``command`` + ``args`` with the env the manifest sets
(``valueFrom.fieldRef`` resolved for the node and pod names), the first
word mapped through ``command_map`` (``gpu-validator`` to the port's
validator module). The templates mount each hostPath at its own path, so
paths need no rewriting, except those ``path_map`` names: an env value or
argument that starts with such a host path is moved under its mapped
directory, as a runtime would bind a hostPath volume from elsewhere. Per
DaemonSet a mode decides what runs:

- ``run``: the init containers in order, then the main containers; the
  pod is ready once every main container passed its exec startup probe,
  or is alive :data:`READY_AFTER_S` after its start (or exited 0). A failed
  container reruns after a doubling back-off (restartPolicy Always), and
  the pod is not ready meanwhile;
- ``init``: the init containers only, the main containers simulated;
- ``simulate`` (an app ``modes`` does not name): nothing, the DaemonSet
  is marked available at once.

A DaemonSet's pod also exists as a Pod object, ``<ds>-<node>``, owned by
the DaemonSet and labelled as its template is: deleting that Pod (the
operator's health machine recycles pods so, the upgrade restarts its
driver) kills the processes and runs the pod again from its first init
container under a new Pod, on the DaemonSet's current template, as the
DaemonSet controller and a kubelet would. The Pod object's status is the
kubelet's: phase, a ``Ready`` condition, and ``initContainerStatuses`` and
``containerStatuses`` with each container's ``restartCount`` and state,
waiting in ``CrashLoopBackOff`` during a failed container's back-off. A
template change reruns the pod under ``updateStrategy`` ``RollingUpdate``;
under ``OnDelete`` the running pod stays until its Pod object is deleted. A
DaemonSet counts as available only once its pod is ready, and as updated
while its pod runs the current template; a deleted DaemonSet's pod is
killed. Its status (desired, available, updated, observedGeneration) is
written back as the DaemonSet controller would. ``capacity_app``'s pod, once
its init containers passed, gives the Node ``gpu_count`` of
``nvidia.com/gpu`` as capacity and allocatable, as a device plugin's
registration would. A Pod of any namespace bound to the Node (the
``workload`` component's spawned pod, a user's workload) runs once; its
phase is set from its containers' exit codes, and deleting or evicting it
kills its processes at once (a watch on Pods).

Every process runs in its own process group; :meth:`stop` kills them all.
What happened, and when, is in :attr:`events`.
"""

from __future__ import annotations

import copy
import logging
import os
import signal
import subprocess
import threading
import time
from typing import Dict, List, Optional

from .. import consts
from ..utils import deep_get, template_fingerprint

log = logging.getLogger(__name__)

RUN, INIT, SIMULATE = "run", "init", "simulate"
#: a main container without a startup probe is ready once alive this long
READY_AFTER_S = 2.0
#: how often a startup probe and the apiserver are polled
PROBE_PERIOD_S = 0.5
POLL_S = 0.1
#: a failed container's first rerun waits this long, doubling to 8x
BACKOFF_S = 1.0


class _Container:
    """One container as a process in its own group."""

    def __init__(self, kubelet: "ProcessKubelet", owner: str, spec: dict, pod_name: str,
                 extra_env: Optional[dict] = None, image_env: Optional[dict] = None):
        self.name = spec["name"]
        self.spec = spec
        self.log_path = os.path.join(kubelet.log_dir, f"{owner}.{self.name}.log")
        argv = kubelet.argv(spec)
        # the image's env, then the container's own over it (as a runtime
        # layers them), then a test's injected env over both
        env = dict(kubelet.base_env)
        env.update(image_env or {})
        env.update(kubelet.container_env(spec, pod_name))
        env.update(extra_env or {})
        self.env = env
        self.started = time.time()
        with open(self.log_path, "w") as log_file:
            self.proc = subprocess.Popen(argv, env=env,
                                         stdout=log_file, stderr=subprocess.STDOUT,
                                         start_new_session=True)

    def kill(self) -> None:
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()

    def output(self) -> str:
        try:
            with open(self.log_path) as f:
                return f.read()
        except OSError:
            return ""


class _PodRun:
    """A DaemonSet's pod on this node: its containers and their state."""

    def __init__(self, kubelet: "ProcessKubelet", ds: dict, mode: str, image_env: dict,
                 uid: Optional[str] = None):
        self.kubelet = kubelet
        self.ds_name = ds["metadata"]["name"]
        #: the pod template this pod runs (the DaemonSet controller's
        #: revision hash): another fingerprint is a template change
        self.fingerprint = template_fingerprint(deep_get(ds, "spec", "template", default={}))
        self.template = copy.deepcopy(deep_get(ds, "spec", "template", "spec", default={}))
        self.mode = mode
        self.image_env = image_env
        #: the uid of this run's Pod object, whose status it writes
        self.uid = uid
        self.state = "pending"
        self.containers: List[_Container] = []
        #: container name -> its status in the Pod object
        self.statuses: Dict[str, dict] = {}
        for kind in ("initContainers", "containers"):
            for spec in self.template.get(kind) or []:
                self.statuses[spec["name"]] = {
                    "name": spec["name"], "restartCount": 0, "ready": False,
                    "state": {"waiting": {"reason": "PodInitializing"}}}
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"kubelet-{self.ds_name}")
        self._thread.start()

    @property
    def ready(self) -> bool:
        return self.state == "ready"

    def _event(self, kind: str, **fields) -> None:
        self.kubelet.record(kind, ds=self.ds_name, **fields)

    def _container(self, name: str, state: dict, ready: bool = False,
                   restarted: bool = False) -> None:
        """One container's status changed: write the Pod object's status."""
        status = self.statuses[name]
        status["state"] = state
        status["ready"] = ready
        if restarted:
            status["restartCount"] += 1
        self.kubelet.write_pod_status(self)

    def pod_status(self) -> dict:
        """The Pod object's status as a kubelet writes it."""
        inits = [s["name"] for s in self.template.get("initContainers") or []]
        mains = [s["name"] for s in self.template.get("containers") or []]
        initialized = all("terminated" in self.statuses[n]["state"] for n in inits)
        return {
            "phase": "Running" if initialized else "Pending",
            "conditions": [
                {"type": "Initialized", "status": str(initialized)},
                {"type": "Ready", "status": str(self.ready)}],
            "initContainerStatuses": [copy.deepcopy(self.statuses[n]) for n in inits],
            "containerStatuses": [copy.deepcopy(self.statuses[n]) for n in mains],
        }

    def _back_off(self, c: _Container, failures: int) -> bool:
        """A failed container waits out its back-off in ``CrashLoopBackOff``,
        the pod not ready; True when the pod was stopped meanwhile."""
        self.statuses[c.name]["ready"] = False
        self._container(c.name, {"waiting": {"reason": "CrashLoopBackOff",
                                             "message": f"exit code {c.proc.returncode}"}},
                        restarted=True)
        return self._stopped.wait(self.kubelet.backoff(failures))

    def _run(self) -> None:
        pod_name = f"{self.ds_name}-{self.kubelet.node_name}"
        if self.mode == SIMULATE:
            self.state = "ready"
            for name in self.statuses:
                self.statuses[name].update(state={"running": {}}, ready=True)
            self.kubelet.write_pod_status(self)
            self._event("simulated")
            return
        for spec in self.template.get("initContainers") or []:
            failures = 0
            while True:  # restartPolicy Always: a failed init container reruns
                self.state = f"init:{spec['name']}"
                c = _Container(self.kubelet, self.ds_name, spec, pod_name,
                               image_env=self.image_env)
                self.containers.append(c)
                self._container(c.name, {"running": {}})
                self._event("init-start", container=c.name)
                while c.proc.poll() is None:
                    if self._stopped.wait(0.05):
                        return
                self._event("init-exit", container=c.name, rc=c.proc.returncode)
                if c.proc.returncode == 0:
                    self._container(c.name, {"terminated": {"exitCode": 0,
                                                            "reason": "Completed"}})
                    break
                self.state = f"failed:{c.name}:{c.proc.returncode}"
                if self._back_off(c, failures):
                    return
                failures += 1
        self._event("init-done")
        if self.mode == INIT:
            self.state = "ready"
            for s in self.template.get("containers") or []:
                self.statuses[s["name"]].update(state={"running": {}}, ready=True)
            self.kubelet.write_pod_status(self)
            self._event("ready", simulated_containers=[
                s["name"] for s in self.template.get("containers") or []])
            return
        self.state = "running"
        mains = {}
        for spec in self.template.get("containers") or []:
            mains[spec["name"]] = self._start_main(spec, pod_name)
            if mains[spec["name"]] is None:
                return
        self._set_ready()
        # restartPolicy Always: a main container that fails once ready is
        # rerun after its back-off, the pod not ready meanwhile (one that
        # exits 0 has completed and stays so)
        while not self._stopped.wait(0.05):
            for spec in self.template.get("containers") or []:
                c = mains[spec["name"]]
                if c.proc.poll() in (None, 0):
                    continue
                self.state = f"failed:{c.name}:{c.proc.returncode}"
                self._event("main-failed", container=c.name, rc=c.proc.returncode)
                if self._back_off(c, 0):
                    return
                mains[spec["name"]] = self._start_main(spec, pod_name, failures=1)
                if mains[spec["name"]] is None:
                    return
                self._set_ready()

    def _start_main(self, spec: dict, pod_name: str, failures: int = 0) -> Optional[_Container]:
        """Run a main container until it is ready, rerunning it after a
        back-off while it fails; None when the pod is stopped meanwhile."""
        while True:
            c = _Container(self.kubelet, self.ds_name, spec, pod_name, image_env=self.image_env)
            self.containers.append(c)
            self._container(c.name, {"running": {}})
            if self._main_ready(c):
                return c
            if self._stopped.is_set():
                return None
            c.kill()
            self.state = f"failed:{c.name}:{c.proc.returncode}"
            self._event("main-failed", container=c.name, rc=c.proc.returncode)
            if self._back_off(c, failures):
                return None
            failures += 1
            self.state = "running"

    def _set_ready(self) -> None:
        self.state = "ready"
        for s in self.template.get("containers") or []:
            self.statuses[s["name"]]["ready"] = True
        self.kubelet.write_pod_status(self)
        self._event("ready")

    def _main_ready(self, c: _Container) -> bool:
        probe = deep_get(c.spec, "startupProbe", "exec", "command")
        if probe:
            period = float(deep_get(c.spec, "startupProbe", "periodSeconds", default=5))
            budget = period * float(deep_get(c.spec, "startupProbe", "failureThreshold",
                                             default=3))
            deadline = time.time() + budget
            while time.time() < deadline and not self._stopped.is_set():
                if c.proc.poll() not in (None, 0):
                    return False
                if self.kubelet.probe(probe, c.env) == 0:
                    self._event("startup-probe-passed", container=c.name)
                    return True
                self._stopped.wait(min(period, PROBE_PERIOD_S))
            return False
        deadline = c.started + READY_AFTER_S
        while time.time() < deadline:
            if c.proc.poll() is not None:
                return c.proc.returncode == 0
            if self._stopped.wait(0.05):
                return False
        return c.proc.poll() in (None, 0)

    def stop(self) -> None:
        self._stopped.set()
        self._thread.join(timeout=30)
        for c in self.containers:
            c.kill()


class ProcessKubelet:
    def __init__(self, client, node_name: str, namespace: str, log_dir: str,
                 base_env: Dict[str, str], command_map: Dict[str, List[str]],
                 modes: Optional[Dict[str, str]] = None,
                 image_env: Optional[Dict[str, Dict[str, str]]] = None,
                 capacity_app: Optional[str] = None, gpu_count: int = 1,
                 path_map: Optional[Dict[str, str]] = None):
        self.client = client
        self.node_name = node_name
        self.namespace = namespace
        self.log_dir = log_dir
        self.base_env = dict(base_env)
        self.command_map = command_map
        self.modes = modes or {}
        self.image_env = image_env or {}
        self.capacity_app = capacity_app
        self.gpu_count = gpu_count
        self.path_map = path_map or {}
        #: env every spawned Pod's containers get on top of their own (a
        #: test's fault injection); None: nothing added
        self.pod_env: Optional[Dict[str, str]] = None
        self.events: List[dict] = []
        self._events_lock = threading.Lock()
        self._pods: Dict[str, _PodRun] = {}
        self._spawned: Dict[str, List[_Container]] = {}
        #: uids of spawned pods whose Pod object went: their processes are
        #: killed and nothing more of them runs
        self._killed: set = set()
        #: guards the two above; never held across a client call (the
        #: watch handler runs under the apiserver backend's own lock)
        self._spawn_lock = threading.Lock()
        self._watch = None
        self._capacity_set = False
        self._stopped = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(log_dir, exist_ok=True)

    # -- containers --------------------------------------------------------------
    def host_path(self, value: str) -> str:
        """``value`` (a path, or ``--flag=path``) with a mapped host path
        moved under its mapped directory."""
        for host, mapped in self.path_map.items():
            head, sep, tail = value.partition(host)
            if sep and head in ("", head.split("=")[0] + "=") and tail[:1] in ("", "/"):
                return head + mapped + tail
        return value

    def argv(self, spec: dict) -> List[str]:
        command = list(spec.get("command") or [])
        if command and command[0] in self.command_map:
            command = list(self.command_map[command[0]]) + command[1:]
        return [self.host_path(str(a)) for a in command + list(spec.get("args") or [])]

    def container_env(self, spec: dict, pod_name: str) -> Dict[str, str]:
        env: Dict[str, str] = {}
        for entry in spec.get("env") or []:
            if "value" in entry:
                env[entry["name"]] = self.host_path(str(entry["value"]))
                continue
            path = deep_get(entry, "valueFrom", "fieldRef", "fieldPath")
            if path == "spec.nodeName":
                env[entry["name"]] = self.node_name
            elif path == "metadata.name":
                env[entry["name"]] = pod_name
            elif path == "metadata.namespace":
                env[entry["name"]] = self.namespace
        return env

    def probe(self, command: List[str], env: Dict[str, str]) -> int:
        argv = self.argv({"command": command})
        return subprocess.run(argv, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL, timeout=60).returncode

    def backoff(self, failures: int) -> float:
        """Seconds before a failed container's rerun: doubling, capped at 8x."""
        return BACKOFF_S * min(8, 2 ** failures)

    def record(self, kind: str, **fields) -> None:
        with self._events_lock:
            self.events.append(dict(fields, kind=kind, t=time.time()))
        log.info("kubelet: %s %s", kind, fields)

    def matching(self, kind: str, after: float = 0.0, **match) -> List[dict]:
        """The events of ``kind`` later than ``after`` whose fields equal
        ``match``, in order."""
        with self._events_lock:
            return [e for e in self.events if e["kind"] == kind and e["t"] > after
                    and all(e.get(k) == v for k, v in match.items())]

    def first(self, kind: str, after: float = 0.0, **match) -> Optional[dict]:
        """The first of :meth:`matching`'s events, or None."""
        found = self.matching(kind, after, **match)
        return found[0] if found else None

    # -- the loop ---------------------------------------------------------------
    def start(self) -> "ProcessKubelet":
        # a deleted or evicted pod's processes go at once, before the
        # delete's caller goes on, as a kubelet ends a pod before the
        # apiserver lets its object go
        self._watch = self.client.watch("v1", "Pod", None, handler=self._on_pod_event)
        self._thread = threading.Thread(target=self._loop, daemon=True, name="process-kubelet")
        self._thread.start()
        return self

    def _on_pod_event(self, event) -> None:
        if event.type != "DELETED":
            return
        meta = event.object.get("metadata") or {}
        self._kill_spawned(meta.get("uid", meta.get("name")), meta.get("name"))

    def _kill_spawned(self, uid: str, name: str) -> None:
        with self._spawn_lock:
            if uid not in self._spawned or uid in self._killed:
                return
            self._killed.add(uid)
            containers = list(self._spawned[uid])
        for c in containers:
            c.kill()
        self.record("pod-killed", pod=name)

    def _loop(self) -> None:
        while not self._stopped.wait(POLL_S):
            try:
                self.sync_once()
            except Exception:
                log.exception("kubelet sync failed; retrying")

    def sync_once(self) -> None:
        node = self.client.get("v1", "Node", self.node_name)
        labels = deep_get(node, "metadata", "labels", default={}) or {}
        present = set()
        for ds in self.client.list("apps/v1", "DaemonSet", self.namespace):
            present.add(ds["metadata"]["name"])
            self._sync_daemonset(ds, labels)
        # a deleted DaemonSet's pod goes (the garbage collector's part)
        with self._lock:
            gone = [(n, self._pods.pop(n)) for n in list(self._pods) if n not in present]
        for name, run in gone:
            run.stop()
            self._delete_pod_object(name)
            self.record("pod-stop", ds=name)
        pods = self.client.list("v1", "Pod", None,
                                field_selector={"spec.nodeName": self.node_name})
        owned = {self._pod_name(ref["name"]) for p in pods
                 for ref in deep_get(p, "metadata", "ownerReferences", default=[]) or []
                 if ref.get("kind") == "DaemonSet"}
        # a DaemonSet pod whose Pod object was deleted: kill it, and let the
        # next pass run it again under a new Pod
        with self._lock:
            deleted = [(n, self._pods.pop(n)) for n in list(self._pods)
                       if self._pod_name(n) not in owned]
        for name, run in deleted:
            run.stop()
            self.record("pod-deleted", ds=name)
        for pod in pods:
            if not any(ref.get("kind") == "DaemonSet" for ref in
                       deep_get(pod, "metadata", "ownerReferences", default=[]) or []):
                self._sync_pod(pod)
        # a spawned pod whose object went while no watch event reached us
        live = {p["metadata"].get("uid", p["metadata"]["name"]) for p in pods}
        with self._spawn_lock:
            gone = [uid for uid in self._spawned if uid not in live and uid not in self._killed]
        for uid in gone:
            self._kill_spawned(uid, uid)

    def _pod_name(self, ds_name: str) -> str:
        return f"{ds_name}-{self.node_name}"

    def _create_pod_object(self, ds: dict) -> str:
        """The Pod object of a DaemonSet's pod on this node, a fresh one
        (a new uid) for every run; returns its uid."""
        name = ds["metadata"]["name"]
        self._delete_pod_object(name)
        return self.client.create({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {
                "name": self._pod_name(name), "namespace": self.namespace,
                "labels": dict(deep_get(ds, "spec", "template", "metadata", "labels",
                                        default={}) or {}),
                "ownerReferences": [{"apiVersion": "apps/v1", "kind": "DaemonSet",
                                     "name": name, "uid": ds["metadata"].get("uid", ""),
                                     "controller": True}]},
            "spec": {"nodeName": self.node_name},
            "status": {"phase": "Pending"}})["metadata"]["uid"]

    def write_pod_status(self, run: _PodRun) -> None:
        """A run's status onto its own Pod object (never a later run's)."""
        try:
            live = self.client.get("v1", "Pod", self._pod_name(run.ds_name), self.namespace)
        except Exception:  # deleted: the run is being stopped
            return
        if live["metadata"].get("uid") != run.uid:
            return
        live["status"] = run.pod_status()
        try:
            self.client.update_status(live)
        except Exception as e:  # a delete or a write racing this one
            log.info("kubelet: status of %s not written (%s)", run.ds_name, e)

    def _delete_pod_object(self, ds_name: str) -> None:
        try:
            self.client.delete("v1", "Pod", self._pod_name(ds_name), self.namespace)
        except Exception:  # gone already (or collected with its DaemonSet)
            pass

    def _sync_daemonset(self, ds: dict, labels: dict) -> None:
        name = ds["metadata"]["name"]
        selector = deep_get(ds, "spec", "template", "spec", "nodeSelector", default={}) or {}
        matches = all(labels.get(k) == v for k, v in selector.items())
        app = deep_get(ds, "metadata", "labels", "app", default=name)
        generation = deep_get(ds, "metadata", "generation", default=1)
        fingerprint = template_fingerprint(deep_get(ds, "spec", "template", default={}))
        # OnDelete: a new template waits for the pod to be deleted
        rolling = deep_get(ds, "spec", "updateStrategy", "type") != "OnDelete"
        with self._lock:
            run = self._pods.get(name)
            if matches and (run is None or (rolling and run.fingerprint != fingerprint)):
                if run is not None:
                    run.stop()
                mode = self.modes.get(app, SIMULATE)
                uid = self._create_pod_object(ds)
                self.record("pod-start", ds=name, mode=mode)
                run = self._pods[name] = _PodRun(self, ds, mode, self.image_env.get(app, {}),
                                                 uid)
            elif not matches and run is not None:
                run.stop()
                del self._pods[name]
                self._delete_pod_object(name)
                run = None
        if (run is not None and app == self.capacity_app and not self._capacity_set
                and (run.ready or run.state == "running")):
            self._set_capacity()
        want = {"desiredNumberScheduled": 1 if matches else 0,
                "currentNumberScheduled": 1 if matches else 0,
                "numberAvailable": 1 if run is not None and run.ready else 0,
                "numberReady": 1 if run is not None and run.ready else 0,
                "updatedNumberScheduled": 1 if run is not None and run.fingerprint == fingerprint
                                          else 0,
                "observedGeneration": generation}
        status = ds.get("status") or {}
        if any(status.get(k) != v for k, v in want.items()):
            ds["status"] = dict(status, **want)
            self.client.update_status(ds)
            if want["numberAvailable"]:
                self.record("ds-available", ds=name)

    def _set_capacity(self) -> None:
        node = self.client.get("v1", "Node", self.node_name)
        status = node.setdefault("status", {})
        for field in ("capacity", "allocatable"):
            status.setdefault(field, {})[consts.GPU_RESOURCE_NAME] = str(self.gpu_count)
        self.client.update_status(node)
        self._capacity_set = True
        self.record("capacity", count=self.gpu_count)

    def _sync_pod(self, pod: dict) -> None:
        name = pod["metadata"]["name"]
        uid = pod["metadata"].get("uid", name)
        phase = deep_get(pod, "status", "phase")
        with self._spawn_lock:
            if uid in self._spawned or phase in ("Succeeded", "Failed"):
                return
            self._spawned[uid] = []
        threading.Thread(target=self._run_pod, args=(pod,), daemon=True,
                         name=f"kubelet-pod-{name}").start()

    def _set_phase(self, pod: dict, phase: str) -> None:
        try:
            live = self.client.get("v1", "Pod", pod["metadata"]["name"],
                                   pod["metadata"].get("namespace"))
        except Exception as e:  # the spawner deleted it: nothing to report
            log.info("kubelet: pod %s gone (%s)", pod["metadata"]["name"], e)
            return
        live.setdefault("status", {})["phase"] = phase
        self.client.update_status(live)

    def _run_pod(self, pod: dict) -> None:
        name = pod["metadata"]["name"]
        uid = pod["metadata"].get("uid", name)
        self._set_phase(pod, "Running")
        self.record("pod-running", pod=name)
        rc = 0
        for spec in deep_get(pod, "spec", "containers", default=[]) or []:
            with self._spawn_lock:
                if uid in self._killed:
                    return
                c = _Container(self, name, spec, name, self.pod_env)
                self._spawned[uid].append(c)
            while c.proc.poll() is None:
                if self._stopped.wait(0.05):
                    return
            if uid in self._killed:
                return
            rc = rc or c.proc.returncode
        phase = "Succeeded" if rc == 0 else "Failed"
        self._set_phase(pod, phase)
        self.record("pod-exit", pod=name, rc=rc, phase=phase)

    # -- control ---------------------------------------------------------------
    def restart(self, ds_name: str) -> None:
        """Kill the DaemonSet's pod and run it again from its first init
        container (a pod recycle)."""
        with self._lock:  # no pass may start the next run in between
            run = self._pods.pop(ds_name, None)
            self._delete_pod_object(ds_name)
        if run is not None:
            run.stop()
        self.record("pod-recycle", ds=ds_name)

    def logs(self, ds_name: str) -> Dict[str, str]:
        run = self._pods.get(ds_name)
        return {} if run is None else {c.name: c.output() for c in run.containers}

    def spawned_logs(self) -> Dict[str, str]:
        return {c.name + "@" + uid: c.output()
                for uid, cs in list(self._spawned.items()) for c in cs}

    def stop(self) -> None:
        self._stopped.set()
        if self._watch is not None:
            self._watch.stop()
        if self._thread is not None:
            self._thread.join(timeout=30)
        with self._lock:
            runs = list(self._pods.values())
            self._pods.clear()
        for run in runs:
            run.stop()
        for cs in list(self._spawned.values()):
            for c in cs:
                c.kill()


# -- many nodes, in memory -------------------------------------------------------

#: label on a simulated DaemonSet pod naming its DaemonSet
SIM_DS_LABEL = "tpu.ai/kubelet-sim-ds"
#: the GPUs each simulated node's device plugin registers
GPUS_PER_NODE = 8
#: the app labels of the pods the validator spawns, run to completion here
VALIDATION_APPS = ("gpu-workload-validation", "gpu-multihost-validation",
                   "gpu-serving-validation")


class KubeletSimulator:
    """The DaemonSet controller and the kubelets of many nodes, in memory:
    nothing runs. Every (DaemonSet, node) its selector matches has a Pod,
    running and ready at once, and the DaemonSet's status counts them; the
    device plugin's DaemonSet gives its nodes :data:`GPUS_PER_NODE` of
    ``nvidia.com/gpu``; the validator's spawned pods finish ``Succeeded``. A
    pod's template governs it as the DaemonSet controller's would: under
    ``RollingUpdate`` an outdated pod is replaced, under ``OnDelete`` it
    stays until someone (the upgrade machine) deletes it. A pod is outdated
    when its ``tpu.ai/template-hash`` label is not its template's, or,
    without the label, when its images and args are not the template's.

    The reference's simulator can also mark DaemonSets ready without pods
    and models image pulls, barrier gates, the migrate agent and spot
    revocation; the port's tests need none of these yet."""

    def __init__(self, client, namespace: str = consts.DEFAULT_NAMESPACE,
                 interval: float = 0.05):
        self.client = client
        self.namespace = namespace
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "KubeletSimulator":
        self._thread = threading.Thread(target=self._run, daemon=True, name="kubelet-sim")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        from ..client.errors import ApiError

        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except (ApiError, OSError) as e:  # a kubelet rides out apiserver errors
                log.debug("kubelet sim tick error: %s", e)

    def tick(self) -> None:
        """One pass; public so that tests can drive it step by step."""
        from ..state.skel import node_matches_selector

        nodes = self.client.list("v1", "Node")
        self._complete_validation_pods()
        for ds in self.client.list("apps/v1", "DaemonSet", self.namespace):
            selector = deep_get(ds, "spec", "template", "spec", "nodeSelector", default={})
            matching = [n for n in nodes if node_matches_selector(n, selector)]
            available, updated = self._reconcile_pods(ds, matching)
            status = {"observedGeneration": deep_get(ds, "metadata", "generation", default=1),
                      "desiredNumberScheduled": len(matching),
                      "currentNumberScheduled": available, "numberReady": available,
                      "numberAvailable": available, "updatedNumberScheduled": updated}
            if ds.get("status") != status:
                ds["status"] = status
                self.client.update_status(ds)
            component = deep_get(ds, "spec", "template", "metadata", "labels",
                                 "app.kubernetes.io/component")
            if available and component == "gpu-device-plugin":
                for node in matching:
                    self._register_gpus(node)

    @staticmethod
    def _current(pod: dict, template: dict) -> bool:
        want = deep_get(template, "metadata", "labels", consts.TEMPLATE_HASH_LABEL)
        if want:
            return want == deep_get(pod, "metadata", "labels", consts.TEMPLATE_HASH_LABEL)

        def essence(containers):
            return [{"image": c.get("image"), "args": c.get("args")} for c in containers or []]

        return (essence(deep_get(pod, "spec", "containers"))
                == essence(deep_get(template, "spec", "containers")))

    def _reconcile_pods(self, ds: dict, matching: List[dict]) -> tuple:
        """The DaemonSet controller's and kubelets' part for one DaemonSet:
        (available, updated) from the pods as they are."""
        from ..client.errors import AlreadyExistsError, NotFoundError

        name = ds["metadata"]["name"]
        template = deep_get(ds, "spec", "template", default={})
        rolling = deep_get(ds, "spec", "updateStrategy", "type") != "OnDelete"
        existing = {deep_get(p, "spec", "nodeName"): p for p in self.client.list(
            "v1", "Pod", self.namespace, label_selector={SIM_DS_LABEL: name})}
        wanted = {n["metadata"]["name"] for n in matching}
        available = updated = 0
        for node_name, pod in existing.items():
            current = node_name in wanted and self._current(pod, template)
            if node_name not in wanted or (rolling and not current):
                try:
                    self.client.delete("v1", "Pod", pod["metadata"]["name"], self.namespace)
                except NotFoundError:
                    pass
                continue
            available += 1
            updated += current
        for node_name in sorted(wanted - set(existing)):
            labels = dict(deep_get(template, "metadata", "labels", default={}) or {})
            labels[SIM_DS_LABEL] = name
            try:
                self.client.create({
                    "apiVersion": "v1", "kind": "Pod",
                    "metadata": {
                        "name": f"{name}-{node_name}"[:63].rstrip("-"),
                        "namespace": self.namespace, "labels": labels,
                        "ownerReferences": [{"apiVersion": "apps/v1", "kind": "DaemonSet",
                                             "name": name, "uid": ds["metadata"].get("uid", ""),
                                             "controller": True}]},
                    "spec": {"nodeName": node_name,
                             "containers": copy.deepcopy(deep_get(template, "spec",
                                                                  "containers", default=[]))},
                    "status": {"phase": "Running",
                               "conditions": [{"type": "Ready", "status": "True"}]}})
            except AlreadyExistsError:  # a deleted pod's name not yet free
                pass
        return available, updated

    def _complete_validation_pods(self) -> None:
        for pod in self.client.list("v1", "Pod", self.namespace):
            if deep_get(pod, "metadata", "labels", "app") not in VALIDATION_APPS:
                continue
            if deep_get(pod, "status", "phase") in ("Succeeded", "Failed"):
                continue
            pod["status"] = {"phase": "Succeeded"}
            self.client.update_status(pod)

    def _register_gpus(self, node: dict) -> None:
        want = str(GPUS_PER_NODE)
        if deep_get(node, "status", "capacity", consts.GPU_RESOURCE_NAME) == want:
            return
        live = self.client.get("v1", "Node", node["metadata"]["name"])
        status = live.setdefault("status", {})
        for field in ("capacity", "allocatable"):
            status.setdefault(field, {})[consts.GPU_RESOURCE_NAME] = want
        self.client.update_status(live)
