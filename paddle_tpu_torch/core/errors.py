"""The error taxonomy and the enforce helpers.

Counterpart: ``paddle_tpu/core/errors.py``. The twelve codes of Paddle's
``errors.h``, each a subclass of ``EnforceNotMet`` that also inherits the
natural builtin (``InvalidArgumentError`` is a ``ValueError``,
``NotFoundError`` a ``LookupError``, ...), so ``except ValueError`` keeps
working; ``enforce``, ``enforce_eq`` and ``enforce_not_none`` raise them
with the reference's messages.
"""
from __future__ import annotations

__all__ = ["AlreadyExistsError", "BY_CODE", "EnforceNotMet",
           "ExecutionTimeoutError", "ExternalError", "FatalError",
           "InvalidArgumentError", "NotFoundError", "OutOfRangeError",
           "PermissionDeniedError", "PreconditionNotMetError",
           "ResourceExhaustedError", "UnavailableError",
           "UnimplementedError", "enforce", "enforce_eq",
           "enforce_not_none"]


class EnforceNotMet(RuntimeError):
    """Base of all enforce failures (enforce.h EnforceNotMet)."""
    code = "UNKNOWN"


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet, LookupError):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet, IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceNotMet, PermissionError):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceNotMet, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    code = "UNAVAILABLE"


class FatalError(EnforceNotMet):
    code = "FATAL"


class ExternalError(EnforceNotMet):
    code = "EXTERNAL"


_ALL = [InvalidArgumentError, NotFoundError, OutOfRangeError,
        AlreadyExistsError, ResourceExhaustedError, PreconditionNotMetError,
        PermissionDeniedError, ExecutionTimeoutError, UnimplementedError,
        UnavailableError, FatalError, ExternalError]
BY_CODE = {c.code: c for c in _ALL}


def enforce(condition, message: str, etype=InvalidArgumentError):
    """PADDLE_ENFORCE: raise ``etype(message)`` when ``condition`` is
    falsy."""
    if not condition:
        raise etype(message)


def enforce_eq(a, b, message: str = "", etype=InvalidArgumentError):
    if a != b:
        raise etype(f"expected {a!r} == {b!r}" +
                    (f": {message}" if message else ""))


def enforce_not_none(value, name: str = "value",
                     etype=PreconditionNotMetError):
    if value is None:
        raise etype(f"{name} must not be None")
    return value
