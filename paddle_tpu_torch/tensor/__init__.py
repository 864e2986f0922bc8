"""paddle_tpu_torch.tensor: the op surface, port of
``paddle_tpu/tensor/__init__.py``.

Importing this package also attaches the reference's surface to the
facade ``Tensor`` (its ``tensor_patch_methods``), limited so that no
``torch.Tensor`` method changes for a call torch accepts:

- the operators (``+ - * / // % ** @``, the comparisons, the r-forms,
  ``& | ^ << >>``, unary ``- abs ~``) and ``__getitem__``/
  ``__setitem__`` go through the facade's functions (the operator table
  of the reference's :106), for the reference's result dtype and the op
  names AMP and the spans see;
- ``astype`` and the registry's methods whose names ``torch.Tensor``
  lacks (41 of the 231 ``tensor_method`` ops, and the in-place
  ``scale_``) are attached as the reference attaches them (:173); the
  other 190 names keep torch's meaning (README, "Known differences of
  the tensor facade").
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dispatch import dispatch
from ..core.tensor import Tensor, inplace_update

from .math import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .einsum import *  # noqa: F401,F403
from .attribute import *  # noqa: F401,F403

from ._helpers import as_operand as _as_operand


def _index_to_static(idx):
    """Lists and numpy arrays inside an index expression as tensors
    (int64 for integers, as torch's indexing takes them)."""
    def conv(i):
        if isinstance(i, (list, np.ndarray)) and not (
                isinstance(i, list) and builtins.any(
                    isinstance(e, (builtins.slice, type(None), type(...)))
                    for e in i)):
            arr = np.asarray(i)
            return torch.from_numpy(arr.astype(np.int64)
                                    if arr.dtype.kind in "iu" else arr)
        return i

    if isinstance(idx, tuple):
        return tuple(conv(i) for i in idx)
    return conv(idx)


def _getitem(self, idx):
    sidx = _index_to_static(idx)
    return dispatch("getitem", lambda a: a[sidx], self)


def _setitem(self, idx, value):
    sidx = _index_to_static(idx)
    if isinstance(value, (int, float, bool, builtins.complex)):
        def impl(a):
            torch.Tensor.__setitem__(a, sidx, value)
            return a
        dispatch("setitem", impl, self, amp=False)
        return
    value = _as_operand(value, self)

    def impl(a, v):
        torch.Tensor.__setitem__(a, sidx, v.to(a.dtype))
        return a

    dispatch("setitem", impl, self, value, amp=False)


def _rsub(self, other):
    return subtract(other, self)  # noqa: F405


def _rdiv(self, other):
    return divide(other, self)  # noqa: F405


def _rpow(self, other):
    return pow(other, self)  # noqa: F405


def _rfloordiv(self, other):
    return floor_divide(other, self)  # noqa: F405


def _rmod(self, other):
    return mod(other, self)  # noqa: F405


def _matmul_method(self, other):
    return matmul(self, other)  # noqa: F405


def _rmatmul(self, other):
    return matmul(other, self)  # noqa: F405


def _inplace(fn):
    def method(self, *args, **kwargs):
        return inplace_update(self, fn(self, *args, **kwargs))

    return method


def _operand(fn):
    """A binary operator: ``NotImplemented`` for an operand that is not
    array-like (so Python tries the other side); ``== None`` is False."""
    def op(self, other):
        if other is None or isinstance(other, str):
            return NotImplemented
        return fn(self, other)

    return op


_BINARY = {
    "__add__": add, "__radd__": add, "__sub__": subtract, "__rsub__": _rsub,  # noqa: F405
    "__mul__": multiply, "__rmul__": multiply, "__truediv__": divide,  # noqa: F405
    "__rtruediv__": _rdiv, "__div__": divide, "__floordiv__": floor_divide,  # noqa: F405
    "__rfloordiv__": _rfloordiv, "__mod__": mod, "__rmod__": _rmod,  # noqa: F405
    "__pow__": pow, "__rpow__": _rpow, "__matmul__": _matmul_method,  # noqa: F405
    "__rmatmul__": _rmatmul, "__eq__": equal, "__ne__": not_equal,  # noqa: F405
    "__lt__": less_than, "__le__": less_equal, "__gt__": greater_than,  # noqa: F405
    "__ge__": greater_equal, "__and__": bitwise_and, "__or__": bitwise_or,  # noqa: F405
    "__xor__": bitwise_xor, "__lshift__": bitwise_left_shift,  # noqa: F405
    "__rshift__": bitwise_right_shift,  # noqa: F405
}


def _registry_methods():
    """The registry's ``tensor_method`` ops whose names ``torch.Tensor``
    lacks, with their functions."""
    from ..ops.registry import registry, resolve
    return [(s.op, resolve(s)) for s in registry()
            if s.tensor_method and not hasattr(torch.Tensor, s.op)]


def _patch_tensor_methods():
    for name, fn in _BINARY.items():
        setattr(Tensor, name, _operand(fn))
    Tensor.__neg__ = lambda self: neg(self)  # noqa: F405
    Tensor.__abs__ = lambda self: abs(self)  # noqa: F405
    Tensor.__invert__ = lambda self: bitwise_not(self)  # noqa: F405
    Tensor.__getitem__ = _getitem
    Tensor.__setitem__ = _setitem
    Tensor.__hash__ = torch.Tensor.__hash__
    Tensor.astype = lambda self, dtype: cast(self, dtype)  # noqa: F405
    for name, fn in _registry_methods():
        setattr(Tensor, name,
                (lambda f: lambda self, *a, **k: f(self, *a, **k))(fn))
    # the in-place forms torch lacks
    Tensor.scale_ = _inplace(scale)  # noqa: F405


_patch_tensor_methods()
