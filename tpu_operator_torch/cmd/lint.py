"""``gpuop-lint`` / ``python -m tpu_operator_torch.cmd.lint`` — the port's
operator-invariant checker.

File-local rules (lock discipline, API-bypass, blocking calls, exception &
metrics hygiene) plus graph-backed interprocedural rules
(state-before-actuation, deadline-propagation, exactly-once-event,
annotation-registry, lock-order-inversion), run over
``tpu_operator_torch/``. ``--changed[=REF]`` lints only changed files while
the graph still covers the full tree; ``--format sarif`` emits
code-scanning annotations. Exit 0 clean, 1 on findings or stale baseline
entries, 2 on a usage error. See ``tpu_operator_torch/analysis/``.
"""

from __future__ import annotations

import sys

from ..analysis.runner import main

if __name__ == "__main__":
    sys.exit(main())
