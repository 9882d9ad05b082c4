"""The apiserver error hierarchy of every client of the port (counterpart
of tpu_operator/client/errors.py): the validator's components and the
operator raise and catch the same classes.

Callers that may be handed another client (the reference's, in the parity
tests) test the HTTP ``code`` (:func:`is_not_found`, :func:`is_conflict`)
rather than the class.
"""

from __future__ import annotations


class ApiError(Exception):
    """Apiserver error with its HTTP status code."""

    code = 500

    def __init__(self, message: str, code: int | None = None):
        super().__init__(message)
        if code is not None:
            self.code = code


class NotFoundError(ApiError):
    code = 404


class KindNotServedError(ApiError):
    """An (apiVersion, kind) pair the scheme does not register. Not a
    NotFoundError: an ``except NotFoundError`` means "this object is
    absent", and a typo'd kind must stay loud there. Only the optional API
    groups of ``state/skel.py`` tolerate it."""

    code = 404


class InvalidError(ApiError):
    """Object rejected by the apiserver's validation (422 Invalid)."""

    code = 422


class TooManyRequestsError(ApiError):
    """Apiserver overload, or an eviction blocked by a disruption budget
    (429); ``retry_after`` is the server's ``Retry-After`` in seconds."""

    code = 429

    def __init__(self, message: str, code: int | None = None,
                 retry_after: float | None = None):
        super().__init__(message, code)
        self.retry_after = retry_after


class DeadlineExceededError(ApiError):
    """A client-side deadline expired before the request could go out (the
    rate limiter's wait would overrun the call's deadline). Not transient,
    and not the apiserver's failure: 504 by analogy only."""

    code = 504


class ConflictError(ApiError):
    code = 409


class AlreadyExistsError(ConflictError):
    code = 409


class BreakerOpenError(ApiError):
    """The client-side circuit breaker is open: calls short-circuit locally
    instead of piling onto a failing apiserver. Not transient (retrying at
    once is what the breaker prevents); ``retry_in`` is the seconds until it
    half-opens, which reconcilers requeue for without counting an error."""

    code = 503

    def __init__(self, message: str, retry_in: float | None = None):
        super().__init__(message, 503)
        self.retry_in = retry_in


class FencedError(ApiError):
    """This replica is not the leader: the write fence
    (``client/fenced.py``) refused the write before it reached the wire.
    Not transient; reconcilers requeue without counting an error. ``epoch``
    is the last leader epoch this replica held (None if it never led)."""

    code = 403

    def __init__(self, message: str, epoch: int | None = None,
                 current_epoch: int | None = None):
        super().__init__(message, 403)
        self.epoch = epoch
        self.current_epoch = current_epoch


def is_transient(exc: BaseException) -> bool:
    """Would a retry plausibly succeed? True for overload (429), a 5xx and a
    transport failure (``OSError``, ``http.client.HTTPException``, what the
    port's ``http.client`` transport raises); False for 4xx answers and for
    the client's own refusals (breaker, deadline, fence)."""
    import http.client

    if isinstance(exc, (BreakerOpenError, DeadlineExceededError, FencedError)):
        return False
    if isinstance(exc, TooManyRequestsError):
        return True
    if isinstance(exc, ApiError):
        return exc.code >= 500
    return isinstance(exc, (OSError, http.client.HTTPException))


def is_not_found(error: BaseException) -> bool:
    return getattr(error, "code", None) == 404


def is_conflict(error: BaseException) -> bool:
    return getattr(error, "code", None) == 409

