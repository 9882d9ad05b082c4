"""Device-plugin validation (counterpart of tpu_operator/validator/plugin.py):
wait until this node's capacity advertises the GPU extended resource, then
write the plugin barrier. ``client`` is any object with
``.get("v1", "Node", name)`` returning the node as a dict."""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

from .. import consts
from ..utils import deep_get, parse_quantity
from .status import StatusFiles

log = logging.getLogger(__name__)

#: wait 30 x 5 s for the resource to appear
RESOURCE_WAIT_TIMEOUT = 150.0
RESOURCE_POLL = 5.0

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class ApiNodeReader:
    """The one apiserver read this component makes, GET /api/v1/nodes/<name>,
    over HTTP(S) with the pod's service-account token. Reads
    ``$KUBE_API_URL`` when set, else the in-cluster service address."""

    def __init__(self, base_url: str, token: Optional[str] = None, verify=True,
                 timeout: float = 10.0):
        import requests

        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._session = requests.Session()
        self._session.verify = verify
        if token:
            self._session.headers["Authorization"] = f"Bearer {token}"

    @classmethod
    def from_env(cls) -> "ApiNodeReader":
        url = os.environ.get("KUBE_API_URL")
        if url:
            return cls(url)
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        if not host:
            raise RuntimeError("no apiserver: set KUBE_API_URL or run in-cluster")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(os.path.join(SA_DIR, "token")) as f:
            token = f.read().strip()
        ca = os.path.join(SA_DIR, "ca.crt")
        return cls(f"https://{host}:{port}", token, ca if os.path.exists(ca) else True)

    def get(self, api_version: str, kind: str, name: str, namespace=None) -> dict:
        if (api_version, kind) != ("v1", "Node"):
            raise ValueError(f"ApiNodeReader reads v1 Nodes only, not {api_version} {kind}")
        resp = self._session.get(f"{self.base_url}/api/v1/nodes/{name}",
                                 timeout=self.timeout)
        resp.raise_for_status()
        return resp.json()


def node_gpu_allocatable(client, node_name: str,
                         resource: str = consts.GPU_RESOURCE_NAME) -> int:
    node = client.get("v1", "Node", node_name)
    raw = deep_get(node, "status", "allocatable", resource,
                   default=deep_get(node, "status", "capacity", resource, default=0))
    try:
        return int(parse_quantity(raw))
    except ValueError:
        return 0


def validate(client, node_name: Optional[str] = None,
             resource: str = consts.GPU_RESOURCE_NAME,
             status: Optional[StatusFiles] = None,
             timeout: float = RESOURCE_WAIT_TIMEOUT, poll: float = RESOURCE_POLL) -> bool:
    status = status or StatusFiles()
    node_name = node_name or os.environ.get("NODE_NAME", "")
    if not node_name:
        log.error("plugin validation: NODE_NAME unset")
        return False
    deadline = time.monotonic() + timeout
    while True:
        count = node_gpu_allocatable(client, node_name, resource)
        if count > 0:
            status.write("plugin", {"resource": resource, "count": count})
            log.info("plugin validation ok: %s=%d on %s", resource, count, node_name)
            return True
        if time.monotonic() >= deadline:
            log.error("plugin validation timed out: %s absent on %s", resource, node_name)
            return False
        time.sleep(min(poll, max(0.01, deadline - time.monotonic())))
