"""GPU validator binary entrypoint (counterpart of tpu_operator/cmd/validator.py)."""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ..validator.main import run

    return run(argv)


if __name__ == "__main__":
    sys.exit(main())
