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


class ConflictError(ApiError):
    code = 409


class AlreadyExistsError(ConflictError):
    code = 409


def is_not_found(error: BaseException) -> bool:
    return getattr(error, "code", None) == 404


def is_conflict(error: BaseException) -> bool:
    return getattr(error, "code", None) == 409

