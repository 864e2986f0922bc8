"""Comparison / logical / bitwise ops: port of
``paddle_tpu/tensor/logic.py``."""

from __future__ import annotations

import torch

from ..core.dispatch import dispatch, wrap
from ._helpers import asarray, binop, dims, normalize_axis, unop

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "is_empty", "isclose",
    "allclose", "equal_all", "all", "any", "is_tensor",
]


def equal(x, y, name=None):
    return binop("equal", torch.eq, x, y)


def not_equal(x, y, name=None):
    return binop("not_equal", torch.ne, x, y)


def greater_than(x, y, name=None):
    return binop("greater_than", torch.gt, x, y)


def greater_equal(x, y, name=None):
    return binop("greater_equal", torch.ge, x, y)


def less_than(x, y, name=None):
    return binop("less_than", torch.lt, x, y)


def less_equal(x, y, name=None):
    return binop("less_equal", torch.le, x, y)


def logical_and(x, y, out=None, name=None):
    return binop("logical_and", torch.logical_and, x, y, scalars=False)


def logical_or(x, y, out=None, name=None):
    return binop("logical_or", torch.logical_or, x, y, scalars=False)


def logical_xor(x, y, out=None, name=None):
    return binop("logical_xor", torch.logical_xor, x, y, scalars=False)


def logical_not(x, out=None, name=None):
    return unop("logical_not", torch.logical_not, x)


def bitwise_and(x, y, out=None, name=None):
    return binop("bitwise_and", torch.bitwise_and, x, y)


def bitwise_or(x, y, out=None, name=None):
    return binop("bitwise_or", torch.bitwise_or, x, y)


def bitwise_xor(x, y, out=None, name=None):
    return binop("bitwise_xor", torch.bitwise_xor, x, y)


def bitwise_not(x, out=None, name=None):
    return unop("bitwise_not", torch.bitwise_not, x)


def bitwise_left_shift(x, y, is_arithmetic=True, out=None, name=None):
    return binop("bitwise_left_shift", torch.bitwise_left_shift, x, y,
                 scalars=False)


def bitwise_right_shift(x, y, is_arithmetic=True, out=None, name=None):
    return binop("bitwise_right_shift", torch.bitwise_right_shift, x, y,
                 scalars=False)


def is_empty(x, name=None):
    a = asarray(x)
    return wrap(torch.tensor(a.numel() == 0, device=a.device))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return dispatch("isclose", lambda a, b: torch.isclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan),
        asarray(x), asarray(y), promote=0)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return dispatch("allclose", lambda a, b: torch.all(torch.isclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)),
        asarray(x), asarray(y), promote=0)


def equal_all(x, y, name=None):
    a, b = asarray(x), asarray(y)
    if tuple(a.shape) != tuple(b.shape):
        return wrap(torch.tensor(False, device=a.device))
    return dispatch("equal_all", lambda p, q: torch.all(torch.eq(p, q)),
                    a, b, promote=0)


def all(x, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return dispatch("all", lambda a: torch.all(
        a.to(torch.bool), dims(ax, a.ndim), keepdim=keepdim), asarray(x))


def any(x, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return dispatch("any", lambda a: torch.any(
        a.to(torch.bool), dims(ax, a.ndim), keepdim=keepdim), asarray(x))


def is_tensor(x):
    return isinstance(x, torch.Tensor)
