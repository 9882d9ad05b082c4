"""Device-plugin validation (counterpart of tpu_operator/validator/plugin.py):
wait until this node's capacity advertises the GPU extended resource, then
write the plugin barrier. ``client`` is any object with
``.get("v1", "Node", name)`` returning the node as a dict; the CLI passes
the port's :class:`~tpu_operator_torch.client.ApiClient`."""

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
