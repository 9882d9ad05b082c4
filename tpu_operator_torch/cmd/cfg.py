"""``gpuop-cfg`` config-validation CLI (counterpart of tpu_operator/cmd/cfg.py;
NVIDIA's cmd/gpuop-cfg)."""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ..cfgtool.main import run

    return run(argv)


if __name__ == "__main__":
    sys.exit(main())
