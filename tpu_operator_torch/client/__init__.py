"""The port's apiserver clients (counterpart of tpu_operator/client/): one
error hierarchy for the validator's components and the operator.

- :class:`RestClient`, the operator's client over ``http.client``, and
  :class:`ApiClient`, the validator's (v1 Nodes, Pods and Events only);
- :class:`FakeClient`, the in-memory apiserver of the tests and of
  :class:`~tpu_operator_torch.testing.apiserver.MiniApiServer`;
- :class:`WriteBatcher` and :func:`preconditioned_patch`, the operator's
  write coalescing and the agents' resourceVersion-preconditioned writes;
- the operator's other layers, in their modules: ``cache.CachedClient``
  (informer reads), ``resilience.RetryingClient`` (retries, token bucket,
  circuit breaker) and ``fenced.FencedClient`` (the leader write fence);
- the fault injectors of ``chaos``: ``ChaosClient`` (call level),
  ``ChaosTransport`` (wire level, under a ``RestClient``) and
  ``CrashPointClient`` (kill points).
"""

from .errors import (
    AlreadyExistsError,
    ApiError,
    BreakerOpenError,
    ConflictError,
    DeadlineExceededError,
    FencedError,
    InvalidError,
    KindNotServedError,
    NotFoundError,
    TooManyRequestsError,
    is_conflict,
    is_not_found,
    is_transient,
)
from .interface import Client, WatchEvent, WatchHandle
from .fake import FakeClient
from .batch import WriteBatcher, batch_window, coalesced_patch, find_batcher
from .preconditions import preconditioned_patch
from .rest import ApiClient, RestClient
from .scheme import Scheme, default_scheme

__all__ = [
    "AlreadyExistsError", "ApiError", "BreakerOpenError", "ConflictError",
    "DeadlineExceededError", "FencedError", "InvalidError",
    "KindNotServedError", "NotFoundError", "TooManyRequestsError",
    "is_conflict", "is_not_found", "is_transient",
    "Client", "WatchEvent", "WatchHandle", "FakeClient",
    "WriteBatcher", "batch_window", "coalesced_patch", "find_batcher",
    "preconditioned_patch", "ApiClient", "RestClient", "Scheme", "default_scheme",
]
