"""Cluster-level chaos for convergence tests (counterpart of
tpu_operator/testing/chaos.py).

:mod:`~tpu_operator_torch.client.chaos` injects faults into the client
stack; this module injects them into the cluster itself: :class:`PodChaos`
deletes random pods, :class:`NodeChaos` revokes whole preemptible nodes.
"""

from __future__ import annotations

import random
import threading
from typing import Optional

from .. import consts
from ..client.errors import ApiError, NotFoundError
from ..utils import deep_get


class PodChaos:
    """A thread deleting a random pod of a namespace at a fixed cadence.
    Deterministic through ``seed``; ``victim_count`` counts the deletions.
    A context manager, or start()/stop()."""

    def __init__(self, client, namespace: str, interval_s: float = 0.05, seed: int = 1729,
                 label_selector: Optional[dict] = None):
        self.client = client
        self.namespace = namespace
        self.interval_s = interval_s
        self.label_selector = label_selector
        self.victim_count = 0
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def kill_one(self) -> Optional[str]:
        """Delete one pod drawn from the sorted pod list (so the choice is a
        function of the seed and the cluster); None when nothing matches."""
        try:
            pods = self.client.list("v1", "Pod", self.namespace,
                                    label_selector=self.label_selector)
        except ApiError:
            return None  # chaos tolerates the chaos it causes
        if not pods:
            return None
        victim = self._rng.choice(sorted(p["metadata"]["name"] for p in pods))
        try:
            self.client.delete("v1", "Pod", victim, self.namespace)
        except (NotFoundError, ApiError):
            return None
        self.victim_count += 1
        return victim

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.kill_one()

    def start(self) -> "PodChaos":
        self._thread = threading.Thread(target=self._run, daemon=True, name="pod-chaos")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "PodChaos":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class NodeChaos:
    """Revokes whole preemptible nodes mid-episode, as a cloud reclaims spot
    capacity: pods and Node vanish together, with no drain plan
    (:meth:`KubeletSimulator.revoke_node`). Only nodes labelled ``label``
    ("true") are eligible. Deterministic through ``seed``; ``revoked`` lists
    the victims in order. ``revoke_one()`` for exact control, or
    start()/stop() for background revocations bounded by
    ``max_revocations``."""

    def __init__(self, kubelet, interval_s: float = 0.1, seed: int = 1729,
                 max_revocations: int = 1, label: str = consts.PREEMPTIBLE_POOL_LABEL):
        self.kubelet = kubelet
        self.interval_s = interval_s
        self.max_revocations = max_revocations
        self.label = label
        self.revoked: list = []
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def revoke_one(self) -> Optional[str]:
        """Revoke one eligible node drawn at random; None when there is no
        preemptible capacity left."""
        try:
            nodes = self.kubelet.client.list("v1", "Node")
        except ApiError:
            return None
        eligible = sorted(n["metadata"]["name"] for n in nodes
                          if deep_get(n, "metadata", "labels", self.label) == "true")
        if not eligible:
            return None
        victim = self._rng.choice(eligible)
        if not self.kubelet.revoke_node(victim):
            return None
        self.revoked.append(victim)
        return victim

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            if len(self.revoked) >= self.max_revocations:
                return
            try:
                self.revoke_one()
            except (NotFoundError, ApiError):
                continue

    def start(self) -> "NodeChaos":
        self._thread = threading.Thread(target=self._run, daemon=True, name="node-chaos")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "NodeChaos":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
