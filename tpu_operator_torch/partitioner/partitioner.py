"""The partition handoff file (copy of the reader in
tpu_operator/partitioner/partitioner.py).

The partitioner publishes an applied partition as a host-path JSON file,
``{"partition": <name>, "groups": [{"topology": "...", "chips": [0, 1]}],
"grid": [...]}``, written atomically; the device plugin and the telemetry
exporter read it. On a GPU node a chip is a GPU, numbered in PCI bus-id
order. Applying partitions (MIG) comes in a later slice.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .. import consts

DEFAULT_HANDOFF_DIR = consts.DEFAULT_HANDOFF_DIR
HANDOFF_FILE = "partition.json"


def read_handoff(handoff_dir: str = DEFAULT_HANDOFF_DIR) -> Optional[dict]:
    try:
        with open(os.path.join(handoff_dir, HANDOFF_FILE)) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None
