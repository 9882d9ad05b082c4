"""Join profiler: cross-process span records and the critical-path
attribution of a node's join (counterpart of tpu_operator/joinprofile/).

* :mod:`.records` — the compact span records the node agents write to the
  node's span log (``trace-spans.json``), which feature discovery mirrors
  to the ``tpu.ai/trace-spans`` node annotation.
* :mod:`.critical_path` — the name-to-phase rules and the sweep line that
  charges every instant of the join to one phase.
* :mod:`.collector` — the operator's :class:`JoinProfiler`, which stitches
  the operator's reconcile spans (through ``Tracer.on_finalize``) and the
  node's records into one join trace per node, behind
  ``/debug/join-traces`` and ``tpu_operator_join_phase_seconds``.

Importing the package loads neither torch nor anything of the validator.
"""

from .collector import JoinProfiler  # noqa: F401
from .critical_path import PHASES, attribute, phase_of  # noqa: F401
from .records import (  # noqa: F401
    MAX_ANNOTATION_BYTES,
    MAX_ANNOTATION_RECORDS,
    MAX_LOG_RECORDS,
    SpanLog,
    decode_annotation,
    encode_annotation,
    span_to_records,
)
