"""Decision-provenance journal: the operator's black box (counterpart of
tpu_operator/provenance/).

Every actuating reconciler (the health machine and its drain gate, the
partitioner's re-tile) records a structured
:class:`~.journal.DecisionRecord` — trigger, inputs, decision and rejected
alternatives, actuations with trace ids and leader epoch, outcome —
chained into **episodes**.

Surfaces: ``/debug/timeline`` on the health server, ``gpuop-cfg explain
node <X>``, the ``tpu_operator_decision_records_total``,
``tpu_operator_episode_duration_seconds``,
``tpu_operator_episode_open_age_seconds`` and
``tpu_operator_provenance_orphans_total`` families, and the causality
audit (:func:`~.audit.causality_audit`).
"""

from .journal import DecisionJournal, DecisionRecord, episode_id  # noqa: F401
from .audit import ActuationObserver, ObservedActuation, causality_audit  # noqa: F401
from .explain import render_explain  # noqa: F401
