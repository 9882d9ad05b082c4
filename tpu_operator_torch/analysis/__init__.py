"""gpuop-lint: AST-based operator invariant checking for the port.

The port's own copy of the reference's checker (``opalint``), run over
``tpu_operator_torch/`` with its rules mapped to the port's names. It
holds the port's control plane to the invariants that are
*operator-specific* and therefore invisible to any generic linter:

* every apiserver call routes through :class:`~..client.resilience.RetryingClient`
  (``api-bypass``)
* fields guarded by a lock somewhere are guarded everywhere (``lock-discipline``)
* reconcile paths never sleep, join unboundedly, or issue timeout-less
  network calls (``blocking-call``)
* broad exception handlers never silently swallow — and reconcile paths
  never swallow ``BreakerOpenError`` (``exception-hygiene``,
  ``breaker-swallow``)
* every metric is kept by its owner, documented in
  ``docs/gpu/operations.md``, and bounded-cardinality (``metrics-discipline``)

Entry points: ``gpuop-lint`` / ``python -m tpu_operator_torch.cmd.lint``.
Inline suppression: ``# opalint: disable=<rule>[,<rule>...] — <why>`` on
the flagged line (or alone on the line above): the reference's grammar, so
its rationales carry over word for word. Grandfathered findings live in
the committed ``.gpuop-lint-baseline.json`` (empty); regenerate it
deliberately with ``gpuop-lint --write-baseline``. Nothing here imports
torch.
"""

from .core import Checker, FileContext, Finding, LintConfig, all_checkers, register

__all__ = [
    "Checker",
    "FileContext",
    "Finding",
    "LintConfig",
    "all_checkers",
    "register",
]
