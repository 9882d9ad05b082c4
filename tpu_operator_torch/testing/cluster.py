"""The cluster harness as a process (counterpart of
tpu_operator/testing/cluster.py).

Runs the port's :class:`~.apiserver.MiniApiServer` and the in-memory
:class:`~.kubelet.KubeletSimulator` as a real OS process, so a shell script
(or ``gpu-must-gather``) can drive the operator over genuine HTTP, as
NVIDIA's shell e2e drives a holodeck cluster.

Usage::

    python -m tpu_operator_torch.testing.cluster --url-file /tmp/cluster.url \\
        --nodes 2 --gpus-per-node 8 --gpu-product nvidia-h100-80gb

Seeds ``--nodes`` GPU nodes (``gpu-node-<i>``) carrying NFD's NVIDIA PCI
label, the GPU model as GKE's accelerator label, ``--gpus-per-node`` of
``nvidia.com/gpu`` and a ``nodeInfo`` with kubelet and runtime versions,
writes the API base URL to ``--url-file`` once the server is listening and
the nodes exist, then serves until SIGTERM or SIGINT, and exits 0.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from .. import consts
from .apiserver import MiniApiServer
from .kubelet import GPUS_PER_NODE, KubeletSimulator

#: what the seeded nodes report in ``status.nodeInfo``
KUBELET_VERSION = "v1.31.0"
CONTAINER_RUNTIME_VERSION = "containerd://1.7.13"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpu-cluster-harness")
    p.add_argument("--url-file", required=True,
                   help="file to write the API server base URL to once ready")
    p.add_argument("--port", type=int, default=0, help="listen port (0 = ephemeral)")
    p.add_argument("--nodes", type=int, default=4, help="GPU nodes to seed")
    p.add_argument("--gpus-per-node", type=int, default=GPUS_PER_NODE)
    p.add_argument("--gpu-product", default="nvidia-h100-80gb",
                   help="GKE accelerator label value (the GPU model) of the seeded nodes")
    p.add_argument("--interval", type=float, default=0.05,
                   help="kubelet simulator tick interval (s)")
    return p


def seed_nodes(client, n: int, gpus_per_node: int, gpu_product: str) -> None:
    for i in range(n):
        gpus = str(gpus_per_node)
        client.create({
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": f"gpu-node-{i}", "labels": {
                consts.NFD_NVIDIA_PCI_LABEL: "true",
                consts.GKE_ACCELERATOR_LABEL: gpu_product,
                "kubernetes.io/hostname": f"gpu-node-{i}",
            }},
            "status": {"capacity": {consts.GPU_RESOURCE_NAME: gpus},
                       "allocatable": {consts.GPU_RESOURCE_NAME: gpus},
                       "nodeInfo": {"kubeletVersion": KUBELET_VERSION,
                                    "containerRuntimeVersion": CONTAINER_RUNTIME_VERSION}},
        })


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    srv = MiniApiServer()
    base = srv.start(port=args.port)
    seed_nodes(srv.backend, args.nodes, args.gpus_per_node, args.gpu_product)
    kubelet = KubeletSimulator(srv.backend, interval=args.interval,
                               gpus_per_node=args.gpus_per_node).start()

    tmp = args.url_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(base)
    os.replace(tmp, args.url_file)

    stop.wait()
    kubelet.stop()
    srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
