"""Typed, rich error machinery: a copy of ``paddle_tpu/core/errors.py``.

The analogue of the reference's enforce/error system
(``paddle/phi/core/enforce.h``, ``paddle/phi/core/errors.h``): a family of
typed exceptions plus ``enforce``-style check helpers that build readable
messages with context.
"""

from __future__ import annotations


class PaddleTpuError(Exception):
    """Base class for framework errors."""

    code = "Error"

    def __init__(self, message: str = ""):
        super().__init__(f"[{self.code}] {message}" if message else self.code)
        self.message = message


class InvalidArgumentError(PaddleTpuError, ValueError):
    code = "InvalidArgument"


class NotFoundError(PaddleTpuError, KeyError):
    code = "NotFound"


class OutOfRangeError(PaddleTpuError, IndexError):
    code = "OutOfRange"


class AlreadyExistsError(PaddleTpuError):
    code = "AlreadyExists"


class PermissionDeniedError(PaddleTpuError):
    code = "PermissionDenied"


class UnimplementedError(PaddleTpuError, NotImplementedError):
    code = "Unimplemented"


class UnavailableError(PaddleTpuError, RuntimeError):
    code = "Unavailable"


class PreconditionNotMetError(PaddleTpuError, RuntimeError):
    code = "PreconditionNotMet"


class ExecutionTimeoutError(PaddleTpuError, TimeoutError):
    code = "ExecutionTimeout"


class FatalError(PaddleTpuError, RuntimeError):
    code = "Fatal"


def enforce(cond, message: str = "", exc=InvalidArgumentError):
    """``PADDLE_ENFORCE`` analogue: raise ``exc`` with ``message`` if not cond."""
    if not cond:
        raise exc(message)


def enforce_eq(a, b, message: str = ""):
    if a != b:
        raise InvalidArgumentError(f"expected {a!r} == {b!r}. {message}")


def enforce_not_none(value, name: str = "value"):
    if value is None:
        raise InvalidArgumentError(f"{name} must not be None")
    return value


def enforce_shape_rank(shape, rank: int, name: str = "input"):
    if len(shape) != rank:
        raise InvalidArgumentError(
            f"{name} expected rank {rank}, got rank {len(shape)} (shape={list(shape)})"
        )
