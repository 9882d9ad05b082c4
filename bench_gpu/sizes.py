"""The sizes a certification runs at, read from the configuration's
``validator_flags``: the flags are the one place they are stated, and the
warm-up, the reference and the roofline counts all read them here."""

from __future__ import annotations

import argparse
from typing import Dict, Iterable

#: size -> the ``gpu-validator`` flag that sets it
PERF_FLAGS = {"matrix_dim": "--perf-matrix-dim", "hbm_mib": "--perf-hbm-mib",
              "ici_mib": "--perf-ici-mib"}


def perf_sizes(flags: Iterable[str]) -> Dict[str, int]:
    """``{"matrix_dim", "hbm_mib", "ici_mib"}`` as ``flags`` set them; a
    flag left out is an error, not the CLI's default."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    for key, flag in PERF_FLAGS.items():
        parser.add_argument(flag, dest=key, type=int)
    known, _ = parser.parse_known_args(list(flags))
    sizes = vars(known)
    missing = [PERF_FLAGS[k] for k, v in sizes.items() if v is None]
    if missing:
        raise ValueError(f"the validator flags do not set {', '.join(missing)}")
    return sizes
