"""Device plugin advertising ``nvidia.com/gpu`` to the kubelet (counterpart
of tpu_operator/deviceplugin/plugin.py).

- **Discovery**: one unit per GPU from NVML, in PCI bus-id order, id
  ``gpu-<i>``; or, when the partitioner published a partition, one unit per
  GPU group (``gpu-part-<i>``). Unit ``i`` is CUDA ordinal ``i`` of a sweep
  run with ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` (as every sweep the port
  starts is), so a barrier's per-GPU verdict gates the GPU it names. Where
  NVML gives no bus ids, the CUDA driver tells the order; where neither
  does, a per-GPU failure gates every unit.
  Device nodes are not GPUs: a node can show nodes of GPUs that are not
  its own, and ``/dev/nvidia<i>`` need not be GPU ``i``, so each GPU's node
  comes from its NVML minor number.
- **Allocate**: the container gets the allocated GPUs' own device nodes
  and the control nodes, the driver library files read-only, and
  ``NVIDIA_VISIBLE_DEVICES`` / ``CUDA_VISIBLE_DEVICES`` set to the GPUs'
  UUIDs (indexes renumber inside a container). The reference hands every
  container every device node and narrows with ``TPU_VISIBLE_CHIPS``; a
  GPU's isolation is its device node, so only the allocated ones go.
- **Preferred allocation**: the candidate set whose GPUs are nearest over
  NVML's link topology (``partitioner.topology.link_cost``: NVLink, then
  one PCIe switch, host bridge, NUMA node, across sockets), ties broken
  lexically. The reference ranks on its host's ICI grid, which a GPU node
  does not have; its ranking stays here as :func:`prefer_compact`.
- **Health**: the reference's gate on the node's workload barrier,
  unchanged: bootstrap-safe, per-GPU when the barrier attributes the
  failure, carried forward over a partial-coverage pass, with an absence
  grace window.

Two layers. The plan layer (inventory, health, preferred and planned
allocations) is plain Python and needs neither ``grpc`` nor ``protobuf``.
The wire layer, :class:`GPUDevicePlugin`'s RPC methods and ``start``,
``register`` and ``run_forever``, imports them inside the call and raises
an ImportError naming them where they are missing. Nothing here opens a
CUDA context or imports torch.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import os
import queue
import threading
import time
from concurrent import futures
from typing import Dict, List, Optional, Tuple

from .. import consts, nvml
from ..partitioner.partitioner import DEFAULT_HANDOFF_DIR, read_handoff
from ..partitioner.topology import Links, link_cost
from ..validator.cdi import qualified_name
from ..validator.driver import control_nodes, driver_lib_files, gpu_node
from ..validator.status import StatusFiles, failed_local_chips, partial_sweep

log = logging.getLogger(__name__)

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"


@dataclasses.dataclass
class Unit:
    """One schedulable unit: a GPU, or a partitioned GPU group. ``chips``
    are positions in the node's GPU list (PCI bus-id order)."""

    id: str
    chips: List[int]
    topology: str
    health: str = HEALTHY


_READ_HANDOFF = object()  # sentinel: "read the file yourself"


def discover_units(handoff_dir: str = DEFAULT_HANDOFF_DIR, handoff=_READ_HANDOFF,
                   gpus: Optional[List[nvml.Gpu]] = None) -> List[Unit]:
    """Units from an already-parsed handoff dict when given (an explicit
    None is "observed absent"), else from the handoff file; without a
    partition, one unit per GPU of ``gpus`` (default: NVML's, which raises
    when NVML is missing; there is no empty inventory)."""
    if handoff is _READ_HANDOFF:
        handoff = read_handoff(handoff_dir)
    if handoff and handoff.get("groups"):
        return [Unit(id=f"gpu-part-{i}", chips=list(g.get("chips", [])),
                     topology=g.get("topology", ""))
                for i, g in enumerate(handoff["groups"])]
    if gpus is None:
        gpus = nvml.gpus()
    return [Unit(id=f"gpu-{i}", chips=[i], topology="") for i in range(len(gpus))]


def _chip_coords(chip: int, total: int, grid: Optional[tuple] = None) -> tuple:
    """Host-local grid coordinates. When the partitioner published the
    host's real grid in the handoff file, use it (row-major chip ids);
    otherwise fall back to the 2-row guess (odd counts degrade to a line,
    which keeps the metric monotone anyway)."""
    if grid:
        coords = []
        for g in reversed(grid):
            coords.append(chip % g)
            chip //= g
        return tuple(reversed(coords))
    cols = max(total // 2, 1) if total % 2 == 0 else total
    return (chip // cols, chip % cols)


def _dispersion(device_ids, chips_of, total: int,
                grid: Optional[tuple] = None) -> int:
    """Sum of pairwise Manhattan distances between all chips of the chosen
    devices on the host grid — lower means more adjacent."""
    chips = [c for d in device_ids for c in chips_of.get(d, [])]
    coords = [_chip_coords(c, total, grid) for c in chips]
    return sum(sum(abs(x - y) for x, y in zip(a, b))
               for i, a in enumerate(coords) for b in coords[i + 1:])


def prefer_compact(available, must_include, size: int, chips_of,
                   grid: Optional[tuple] = None) -> list:
    """Pick `size` device IDs preferring compact chip subsets on a host
    grid: the reference's ranking, kept as its copy (the plugin ranks with
    :func:`prefer_near`, a GPU node having no grid).

    The kubelet's default allocator is topology-blind; brute-force over
    the (tiny: <=8 devices/host) candidate set; falls back to lexical fill
    when the search space is degenerate."""
    must = list(must_include)
    rest = [d for d in available if d not in must]
    need = size - len(must)
    if need <= 0:
        return must[:size]
    if need >= len(rest):
        return must + rest
    total_chips = sum(len(c) for c in chips_of.values()) or 1
    if len(rest) > 16:  # safety bound; hosts have at most 8 units
        return must + rest[:need]
    best = min(itertools.combinations(rest, need),
               key=lambda combo: (_dispersion(must + list(combo), chips_of,
                                              total_chips, grid), combo))
    return must + list(best)


def prefer_near(available, must_include, size: int, chips_of,
                links: Optional[Links]) -> list:
    """Pick ``size`` device IDs whose GPUs are nearest over the node's
    links: the lowest :func:`link_cost` of all their GPUs, ties broken
    lexically. With every pair alike (an NVSwitch board), or no link
    matrix, that is the lexical pick."""
    must = list(must_include)
    rest = [d for d in available if d not in must]
    need = size - len(must)
    if need <= 0:
        return must[:size]
    if need >= len(rest) or len(rest) > 16:  # safety bound; nodes have at most 8 units
        return must + rest[:need]

    if links is not None and any(not 0 <= c < len(links)
                                 for chips in chips_of.values() for c in chips):
        links = None  # a handoff naming GPUs NVML does not list: rank lexically

    def cost(combo) -> int:
        return link_cost([c for d in must + list(combo) for c in chips_of.get(d, [])], links)

    return must + list(min(itertools.combinations(rest, need),
                           key=lambda combo: (cost(combo), combo)))


@dataclasses.dataclass
class ContainerPlan:
    """What Allocate hands one container."""

    envs: Dict[str, str]
    #: (container path, host path, permissions)
    devices: List[Tuple[str, str, str]]
    #: (container path, host path, read only)
    mounts: List[Tuple[str, str, bool]]
    #: CDI device names (CDI mode: the runtime injects from the spec)
    cdi_devices: List[str]


def plan_container(units: List[Unit], gpus: List[nvml.Gpu], install_dir: str,
                   dev_dir: Optional[str] = None, use_cdi: bool = False,
                   injection: str = "") -> ContainerPlan:
    """The allocation of ``units`` to one container. Raises ValueError
    for a unit whose GPUs the node does not have."""
    chips = sorted(c for u in units for c in u.chips)
    if use_cdi:
        return ContainerPlan({}, [], [], [qualified_name(c) for c in chips])
    missing = [c for c in chips if not 0 <= c < len(gpus)]
    if missing:
        raise ValueError(f"GPU(s) {missing} of {[u.id for u in units]} are not on this node "
                         f"({len(gpus)} GPUs)")
    nodes = [gpu_node(gpus[c].minor, dev_dir) for c in chips] + control_nodes(dev_dir)
    if injection == "mounts":
        # device paths as read-only bind mounts: container runtimes refuse
        # regular files as devices, and control-plane e2e fakes them
        devices, mounts = [], [(d, d, True) for d in nodes]
    else:
        devices, mounts = [(d, d, "rw") for d in nodes], []
    mounts += [(f, f, True) for f in driver_lib_files(install_dir)]
    uuids = ",".join(gpus[c].uuid for c in chips)
    envs = {"NVIDIA_VISIBLE_DEVICES": uuids, "CUDA_VISIBLE_DEVICES": uuids}
    topologies = {u.topology for u in units if u.topology}
    if len(topologies) == 1:
        envs["GPU_TOPOLOGY"] = topologies.pop()
    return ContainerPlan(envs, devices, mounts, [])


def _wire():
    """The wire layer's packages: ``grpc`` and the protobuf messages."""
    try:
        import grpc

        from . import grpc_api
        from .proto import deviceplugin_pb2 as pb
    except ImportError as e:
        raise ImportError("the device plugin's wire layer needs the grpc package "
                          f"(grpcio) and google.protobuf: {e}") from e
    return grpc, grpc_api, pb


class GPUDevicePlugin:
    def __init__(self, resource_name: str = consts.GPU_RESOURCE_NAME,
                 plugin_dir: str = os.path.dirname(consts.KUBELET_SOCKET),
                 socket_name: str = consts.PLUGIN_SOCKET_NAME,
                 install_dir: str = consts.DEFAULT_DRIVER_LIB_DIR,
                 handoff_dir: str = DEFAULT_HANDOFF_DIR,
                 health_interval: float = 10.0,
                 status_dir: Optional[str] = None,
                 absence_grace_s: float = 300.0,
                 dev_dir: Optional[str] = None,
                 nvml_lib=None):
        self.resource_name = resource_name
        self.plugin_dir = plugin_dir
        self.socket_path = os.path.join(plugin_dir, socket_name)
        self.install_dir = install_dir
        self.handoff_dir = handoff_dir
        self.health_interval = health_interval
        self.status = StatusFiles(status_dir or os.environ.get(
            "STATUS_DIR", consts.VALIDATION_STATUS_DIR))
        self.absence_grace_s = absence_grace_s
        self.dev_dir = dev_dir
        self.nvml_lib = nvml_lib
        #: the workload barrier has been observed at least once — from then
        #: on its absence is a regression, not bootstrap
        self._workload_seen = False
        #: monotonic timestamp of first observing the barrier absent after
        #: having been seen; None while present/never-seen
        self._workload_gone_at: Optional[float] = None
        self._units: Dict[str, Unit] = {}
        #: the node's GPUs in PCI bus-id order, as of the last refresh
        self._gpus: List[nvml.Gpu] = []
        #: the GPUs' pairwise link classes as of the last refresh (None:
        #: NVML could not tell, and preferred allocations are lexical)
        self._links: Optional[Links] = None
        self._watchers: List["queue.Queue[List[Unit]]"] = []
        self._lock = threading.Lock()
        self._server = None
        self._stop = threading.Event()

    # -- unit inventory (plan layer) ---------------------------------------------
    def _validation_health(self):
        """Health verdict from the node's workload validation barrier:
        ``(verdict, barrier_info)``, where barrier_info is the parsed
        barrier when the verdict is Unhealthy *because the barrier recorded
        a failed sweep* (it may carry per-GPU attribution); None means
        node-level (all units). Absent before first sight is healthy (the
        sweep's pod needs this plugin to schedule); absent after it is a
        regression once the grace window passes; unreadable or non-dict
        is unhealthy."""
        try:
            with open(self.status.path("workload")) as f:
                info = json.load(f)
        except FileNotFoundError:
            info = None  # absent — grace path below, never "unreadable"
        except (OSError, ValueError):
            return UNHEALTHY, None  # present but unreadable/corrupt: fail safe
        if not isinstance(info, dict) and info is not None:
            return UNHEALTHY, None  # valid JSON that is not an object is corrupt too
        if info is not None:
            self._workload_gone_at = None
            if info.get("passed") is False:
                return UNHEALTHY, info
            self._workload_seen = True
            return HEALTHY, info
        if not self._workload_seen:
            return HEALTHY, None  # bootstrap: the sweep needs this plugin first
        # absent after being seen: give a revalidation cycle time to
        # rewrite it before declaring regression
        if self._workload_gone_at is None:
            self._workload_gone_at = time.monotonic()
        if time.monotonic() - self._workload_gone_at < self.absence_grace_s:
            return HEALTHY, None
        return UNHEALTHY, None

    def refresh_units(self) -> bool:
        """Re-enumerate; returns True (and notifies watchers) on change.
        Raises :class:`~tpu_operator_torch.nvml.NvmlError` without NVML."""
        verdict, barrier = self._validation_health()
        handoff = read_handoff(self.handoff_dir)
        with nvml.session(self.nvml_lib) as s:
            gpus = s.gpus()
            try:
                links = s.links(gpus)
            except nvml.NvmlError as e:
                log.warning("NVML gives no link topology (%s): preferred allocations "
                            "are lexical", e)
                links = None
        fresh = {u.id: u for u in discover_units(self.handoff_dir, handoff=handoff, gpus=gpus)}
        n_chips = len({c for u in fresh.values() for c in u.chips})
        failed = failed_local_chips(barrier, n_chips) \
            if verdict == UNHEALTHY and barrier is not None else None
        if failed is not None and any(g.cuda_ordinal is None for g in gpus):
            # which unit is which failing ordinal is unknown: gate the node
            log.warning("the sweep failed GPU(s) %s, but the GPUs' CUDA ordinals are "
                        "unknown: gating every unit", sorted(failed))
            failed = None
        # a pass that provably covered only a subset of the host's GPUs
        # certifies nothing about the gated ones: carry their health forward
        partial_pass = verdict == HEALTHY and partial_sweep(barrier, n_chips)
        with self._lock:
            previous = {uid: u.health for uid, u in self._units.items()}
        for uid, u in fresh.items():
            if verdict == HEALTHY:
                u.health = previous.get(uid, HEALTHY) if partial_pass else HEALTHY
            elif failed is None:
                u.health = UNHEALTHY  # node-level: no per-GPU attribution
            else:
                u.health = UNHEALTHY if failed & set(u.chips) else HEALTHY
        with self._lock:
            self._links = links
            if gpus == self._gpus and \
               {k: (v.chips, v.health) for k, v in fresh.items()} == \
               {k: (v.chips, v.health) for k, v in self._units.items()}:
                return False
            self._units = fresh
            self._gpus = gpus
            snapshot = list(fresh.values())
            for w in self._watchers:
                w.put(snapshot)
        log.info("device inventory: %d unit(s): %s", len(fresh), sorted(fresh))
        return True

    def _snapshot(self) -> List[Unit]:
        with self._lock:
            return list(self._units.values())

    def preferred(self, available, must_include, size: int) -> list:
        with self._lock:
            chips_of = {u.id: u.chips for u in self._units.values()}
            links = self._links
        return prefer_near(sorted(available), list(must_include), size, chips_of, links)

    def allocation_plan(self, device_ids) -> ContainerPlan:
        """Raises KeyError for an id the inventory does not hold."""
        with self._lock:
            units = [self._units[d] for d in device_ids]
            gpus = list(self._gpus)
        return plan_container(
            units, gpus, self.install_dir, self.dev_dir,
            use_cdi=os.environ.get(consts.USE_CDI_ENV) == "1",
            injection=os.environ.get(consts.PLUGIN_DEVICE_INJECTION_ENV, ""))

    # -- DevicePlugin service (wire layer) ---------------------------------------
    def GetDevicePluginOptions(self, request, context):
        _, _, pb = _wire()
        return pb.DevicePluginOptions(pre_start_required=False,
                                      get_preferred_allocation_available=True)

    def ListAndWatch(self, request, context):
        _, _, pb = _wire()
        watcher: "queue.Queue[List[Unit]]" = queue.Queue()
        with self._lock:
            self._watchers.append(watcher)
            units = list(self._units.values())
        try:
            yield self._response(pb, units)
            while not self._stop.is_set():
                try:
                    units = watcher.get(timeout=0.5)
                except queue.Empty:
                    continue
                yield self._response(pb, units)
        finally:
            with self._lock:
                if watcher in self._watchers:
                    self._watchers.remove(watcher)

    @staticmethod
    def _response(pb, units: List[Unit]):
        return pb.ListAndWatchResponse(devices=[
            pb.Device(ID=u.id, health=u.health) for u in units])

    def GetPreferredAllocation(self, request, context):
        _, _, pb = _wire()
        return pb.PreferredAllocationResponse(container_responses=[
            pb.ContainerPreferredAllocationResponse(deviceIDs=self.preferred(
                creq.available_deviceIDs, creq.must_include_deviceIDs, creq.allocation_size))
            for creq in request.container_requests])

    def Allocate(self, request, context):
        grpc, _, pb = _wire()
        responses = []
        for creq in request.container_requests:
            try:
                plan = self.allocation_plan(list(creq.devicesIDs))
            except KeyError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"unknown device {e.args[0]}")
            except ValueError as e:
                context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
            if plan.cdi_devices:
                responses.append(pb.ContainerAllocateResponse(cdi_devices=[
                    pb.CDIDevice(name=n) for n in plan.cdi_devices]))
                continue
            responses.append(pb.ContainerAllocateResponse(
                envs=plan.envs,
                mounts=[pb.Mount(container_path=c, host_path=h, read_only=ro)
                        for c, h, ro in plan.mounts],
                devices=[pb.DeviceSpec(container_path=c, host_path=h, permissions=p)
                         for c, h, p in plan.devices]))
        return pb.AllocateResponse(container_responses=responses)

    def PreStartContainer(self, request, context):
        _, _, pb = _wire()
        return pb.PreStartContainerResponse()

    # -- lifecycle (wire layer) -----------------------------------------------------
    def start(self) -> str:
        """Serve on the plugin socket; raises without grpc, without NVML,
        or with no GPU to advertise."""
        grpc, grpc_api, _ = _wire()
        self.refresh_units()
        if not self._snapshot():
            raise RuntimeError("NVML reports no GPU on this node: not serving an empty "
                               "inventory")
        try:
            os.unlink(self.socket_path)
        except FileNotFoundError:
            pass
        os.makedirs(self.plugin_dir, exist_ok=True)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        grpc_api.add_deviceplugin_servicer(self._server, self)
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        threading.Thread(target=self._health_loop, daemon=True).start()
        log.info("device plugin serving on %s", self.socket_path)
        return self.socket_path

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval):
            try:
                self.refresh_units()
            except Exception:
                log.exception("device inventory refresh failed")

    def register(self, kubelet_socket: str = consts.KUBELET_SOCKET) -> None:
        grpc, grpc_api, pb = _wire()
        with grpc.insecure_channel(f"unix://{kubelet_socket}") as channel:
            stub = grpc_api.RegistrationStub(channel)
            stub.Register(pb.RegisterRequest(
                version=grpc_api.API_VERSION,
                endpoint=os.path.basename(self.socket_path),
                resource_name=self.resource_name,
                options=pb.DevicePluginOptions(get_preferred_allocation_available=True),
            ), timeout=10)
        log.info("registered %s with kubelet", self.resource_name)

    def stop(self) -> None:
        self._stop.set()
        if self._server:
            self._server.stop(grace=1)

    def run_forever(self, kubelet_socket: str = consts.KUBELET_SOCKET) -> int:
        """Serve + register, re-registering whenever the kubelet restarts."""
        grpc, _, _ = _wire()
        self.start()
        kubelet_inode = None
        while not self._stop.is_set():
            try:
                inode = os.stat(kubelet_socket).st_ino
            except FileNotFoundError:
                time.sleep(2.0)
                continue
            if inode != kubelet_inode:
                try:
                    self.register(kubelet_socket)
                    kubelet_inode = inode
                except grpc.RpcError as e:
                    log.warning("kubelet registration failed: %s", e)
                    time.sleep(2.0)
                    continue
            self._stop.wait(5.0)
        return 0
