"""Root-seed resolution and content-addressed seed derivation (copy of
tpu_operator/utils/seeds.py).

The mechanics behind the simulator's unified scenario seeding
(:mod:`tpu_operator_torch.simulator.seeds`, which re-exports these and
documents the derived-name contract), in :mod:`utils` so that a
dependency-light consumer can derive seeds without importing the simulator
package and everything it pulls in.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

SCENARIO_SEED_ENV = "SCENARIO_SEED"
#: the pinned default of the scenario-fuzz gate
DEFAULT_SCENARIO_SEED = 20260806


def resolve_seed(explicit: Optional[int] = None) -> int:
    """Root-seed precedence: explicit flag > $SCENARIO_SEED > pinned
    default."""
    if explicit is not None:
        return int(explicit)
    raw = os.environ.get(SCENARIO_SEED_ENV)
    if raw:
        return int(raw)
    return DEFAULT_SCENARIO_SEED


def seed_for(root: int, name: str) -> int:
    """Derive the per-consumer seed for ``name`` from the root seed.

    sha256-based (not ``hash()``: that is salted per-process) and truncated
    to 32 bits so it fits every consumer's ``random.Random(seed)``."""
    digest = hashlib.sha256(f"{int(root)}:{name}".encode()).digest()
    return int.from_bytes(digest[:4], "big")
