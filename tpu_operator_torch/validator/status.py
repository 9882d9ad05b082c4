"""Node-local status-file barriers (copy of tpu_operator/validator/status.py).

Files like ``driver-ready`` under ``/run/tpu/validations`` survive pod
restarts (hostPath) and act as resumable barriers: operand init containers
block on them, so operand start order is enforced per node without any
central coordination. The file format is byte-compatible with the TPU
operator's, so either package's readers parse either package's barriers.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

from .. import consts

#: wait budgets (reference waits 60x5s for workload pods, 30x5s for resources)
DEFAULT_WAIT_TIMEOUT = 300.0
DEFAULT_POLL_INTERVAL = 5.0


class StatusFiles:
    def __init__(self, directory: str = consts.VALIDATION_STATUS_DIR):
        self.directory = directory

    def path(self, component: str) -> str:
        return os.path.join(self.directory, f"{component}-ready")

    def write(self, component: str, details: Optional[dict] = None) -> str:
        os.makedirs(self.directory, exist_ok=True)
        payload = {"component": component, "timestamp": time.time(),
                   "host": os.environ.get("NODE_NAME", os.uname().nodename)}
        if details:
            payload.update(details)
        path = self.path(component)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # atomic: a reader never sees a partial barrier
        return path

    def clear(self, component: str) -> None:
        try:
            os.remove(self.path(component))
        except FileNotFoundError:
            pass

    def clear_all(self) -> None:
        if not os.path.isdir(self.directory):
            return
        for name in os.listdir(self.directory):
            if name.endswith("-ready"):
                os.remove(os.path.join(self.directory, name))

    def is_ready(self, component: str) -> bool:
        """Present AND not recording a failure. Validators write the
        barrier with ``passed: false`` when a sweep fails (so consumers —
        wait gates, exporters, the device plugin's health gate — see the
        regression rather than a stale pass); absence and corruption both
        read as not-ready."""
        info = self.read(component)
        return info is not None and info.get("passed") is not False

    def read(self, component: str) -> Optional[dict]:
        try:
            with open(self.path(component)) as f:
                info = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        # valid-but-non-dict JSON (a bare list/number written by a broken
        # producer) is as corrupt as unparsable bytes: every consumer
        # treats None-with-file-present as the fail-safe corrupt branch,
        # and handing them a list would be an AttributeError instead
        return info if isinstance(info, dict) else None

    def ready_components(self) -> List[str]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(n[: -len("-ready")] for n in os.listdir(self.directory)
                      if n.endswith("-ready"))

    def wait_for(self, component: str, timeout: float = DEFAULT_WAIT_TIMEOUT,
                 poll: float = DEFAULT_POLL_INTERVAL) -> bool:
        deadline = time.monotonic() + timeout
        while True:
            if self.is_ready(component):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(min(poll, max(0.01, deadline - time.monotonic())))


def failed_local_chips(info, local_count: int):
    """Local chip ids implicated by a failed workload barrier, or None when
    the failure cannot be attributed to specific chips (consumers then must
    treat EVERY chip as implicated — fail safe).

    ``details.*.failed_chips`` carries *global sweep ordinals*; the
    report's ``local_chips`` (global ordinal per local chip, in local
    device order — written by ``ici_health_check``) translates them, and
    only counts when the sweep covered this host's FULL chip set
    (``local_count``): a subset sweep's renumbered ordinals cannot be tied
    to host chip ids. Barriers from older validators lack the map: the
    identity mapping applies only when ``n_devices`` matches exactly.

    Shared by the device plugin's per-chip health gate and the node-status
    exporters so the two can never disagree about attribution."""
    if not isinstance(info, dict):
        return None
    pre_paired = info.get("failed_local_chips")
    if isinstance(pre_paired, list):
        # modern barrier: attribution was computed at the source
        # (ici_health_check pairs failing checks with their chips); only
        # the coverage guard remains — a subset sweep's local indices are
        # renumbered and cannot be tied to host chip ids
        local_map = info.get("local_chips")
        if not isinstance(local_map, list) or len(local_map) != local_count:
            return None
        try:
            return frozenset(int(c) for c in pre_paired)
        except (TypeError, ValueError):
            return None
    details = info.get("details")
    if not isinstance(details, dict):
        return None
    failed_global = set()
    try:
        for check in details.values():
            if not isinstance(check, dict):
                return None  # e.g. {"error": "..."} — unattributable
            if check.get("passed") is not False:
                continue
            chips = check.get("failed_chips")
            if not isinstance(chips, list) or not chips:
                return None  # a check failed with no chip attribution
            failed_global.update(int(c) for c in chips)
        if not failed_global:
            return None  # passed:false but no failing check recorded
        local_map = info.get("local_chips")
        if local_map:
            if len(local_map) != local_count:
                return None
        else:
            if info.get("n_devices") != local_count:
                return None
            local_map = list(range(local_count))
        return frozenset(local for local, global_ord in enumerate(local_map)
                         if global_ord in failed_global)
    except (TypeError, ValueError):
        return None  # malformed barrier content: attribute nothing


def partial_sweep(info, local_count: int) -> bool:
    """True when a PASSING barrier provably covered less than this host's
    full chip set (see the device plugin's gate for why a subset pass must
    not clear per-chip gates)."""
    if not isinstance(info, dict):
        return False  # hand-written/minimal barriers: no coverage claim
    local_map = info.get("local_chips")
    if isinstance(local_map, list) and local_map:
        return len(local_map) != local_count
    n = info.get("n_devices")
    return isinstance(n, int) and n < local_count
