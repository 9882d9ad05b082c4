"""resourceVersion-preconditioned read-modify-write for label state machines
(copy of tpu_operator/client/preconditions.py).

The health machine, drain protocol, and partitioner all persist protocol
state in node labels/annotations via JSON merge patches. A blind merge
patch only writes the keys it names, but the *values* are computed from an
earlier read — so two writers interleaving (a deposed leader racing the
new one, or a health sweep racing feature discovery) can resurrect retired
state: stale flap history, a re-announced drain plan, a double-counted
remediation attempt.

:func:`preconditioned_patch` closes the read→write window: the merge
patch carries the ``metadata.resourceVersion`` of the object the mutation
was computed from, the apiserver rejects it with 409 if anything wrote in
between, and the helper re-reads and re-applies the mutation against the
fresh object. The mutation callback therefore must be a pure function of
the object it is handed — it may run several times.

The node agents hand it any client, the reference's included (in the
parity tests), so a conflict is recognised by its HTTP code.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from .batch import find_batcher
from .errors import ConflictError, is_conflict
from .interface import Client

log = logging.getLogger(__name__)

#: bounded re-read-and-reapply budget: conflicts mean a live competing
#: writer, and an unbounded loop against one would spin forever
DEFAULT_ATTEMPTS = 6


def preconditioned_patch(client: Client, api_version: str, kind: str,
                         name: str,
                         build: Callable[[dict], Optional[dict]],
                         namespace: Optional[str] = None,
                         attempts: int = DEFAULT_ATTEMPTS,
                         sleep: Callable[[float], None] = time.sleep) -> dict:
    """Read ``name``, let ``build(fresh_obj)`` compute a JSON merge patch
    from it (return None for "nothing to do"), and apply it preconditioned
    on the resourceVersion that was read. On 409, re-read and re-apply —
    ``build`` sees the competing writer's state and recomputes, so the lost
    write is re-derived, never replayed verbatim.

    Returns the server's post-patch object (the fresh read when ``build``
    declined). NotFoundError propagates to the caller — object lifecycle
    is its policy, not this helper's.

    When the client chain carries a :class:`~.batch.WriteBatcher` with an
    open flush window, the write is deferred instead: ``build`` is queued
    and re-run at flush against the read the merged patch is preconditioned
    on, and the returned object is an optimistic local projection of the
    patch (callers mirror it into sweep snapshots; the flush's own
    recompute-reapply loop preserves the 409 contract).
    """
    batcher = find_batcher(client)
    if batcher is not None and batcher.window_active:
        return batcher.defer_patch(api_version, kind, name, build, namespace)
    last_exc: Optional[BaseException] = None
    for attempt in range(attempts):
        if attempt:
            # brief pause so an informer-backed read can observe the
            # competing write before the re-read (write-through caches lag
            # by one event delivery)
            sleep(min(0.25, 0.02 * (2 ** attempt)))
        obj = client.get(api_version, kind, name, namespace)
        patch = build(obj)
        if patch is None:
            return obj
        rv = obj.get("metadata", {}).get("resourceVersion")
        if rv is not None:
            patch.setdefault("metadata", {})["resourceVersion"] = rv
        try:
            return client.patch(api_version, kind, name, patch, namespace)
        except Exception as e:
            if not is_conflict(e):
                raise
            last_exc = e
            log.debug("preconditioned patch of %s/%s conflicted at rv %s "
                      "(attempt %d/%d); re-reading", kind, name, rv,
                      attempt + 1, attempts)
    raise last_exc if last_exc is not None else ConflictError(
        f"preconditioned patch of {kind}/{name} never applied")
