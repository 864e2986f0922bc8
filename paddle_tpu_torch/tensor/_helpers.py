"""Shared helpers for the tensor ops: port of
``paddle_tpu/tensor/_helpers.py``.

The reference's promotion rule (JAX's lattice with weak Python scalars)
is ``core.dtypes.result_type``; the dispatcher applies it to the inputs
an op names (``dispatch(..., promote=k, weak=...)``).  ``binop`` keeps a
Python scalar operand weak: it is closed over, not a dispatcher input,
and takes part in the rule through ``weak``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as _dtypes
from ..core.dispatch import dispatch
from ..core.dtypes import result_type  # noqa: F401  (the rule's home)

def is_scalar(x):
    return isinstance(x, (int, float, bool, complex)) and not isinstance(
        x, torch.Tensor)


def as_operand(x, like=None):
    """A non-tensor array operand (numpy, list) as a host-read tensor in
    the reference's dtype, on ``like``'s device."""
    if isinstance(x, torch.Tensor) or is_scalar(x) or x is None:
        return x
    t = _dtypes.from_numpy(np.asarray(x))
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def _weak(s, t, scalars):
    """Python scalar ``s`` beside tensor ``t`` (already promoted) as
    ``fn`` takes it: as is, or with ``scalars=False`` a 0-d tensor of the
    dtype torch gives the pair."""
    if scalars:
        return s
    return torch.tensor(s, dtype=torch.result_type(t, s), device=t.device)


def binop(name, fn, x, y, scalars=True):
    """A binary op under the reference's promotion, Python scalars kept
    weak (closed over, not dispatcher inputs).  ``scalars=False`` for a
    torch function that takes tensors only."""
    x = as_operand(x, y)
    y = as_operand(y, x)
    if is_scalar(y) and not is_scalar(x):
        return dispatch(name, lambda a: fn(a, _weak(y, a, scalars)), x,
                        promote=0, weak=(y,))
    if is_scalar(x) and not is_scalar(y):
        return dispatch(name, lambda b: fn(_weak(x, b, scalars), b), y,
                        promote=0, weak=(x,))
    return dispatch(name, fn, x, y, promote=0)


def unop(name, fn, x):
    return dispatch(name, fn, as_operand(x))


def normalize_axis(axis):
    if isinstance(axis, torch.Tensor):
        return tuple(int(v) for v in axis.reshape(-1).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    if axis is None:
        return None
    return int(axis)


def normalize_shape(shape):
    """Shapes may be int lists or tensors (read on the host)."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in shape.reshape(-1).tolist())
    if isinstance(shape, (list, tuple)):
        return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                     for s in shape)
    return (int(shape),)


def dims(ax, ndim):
    """A reduction's axes as the tuple torch takes: every axis for
    ``None``."""
    if ax is None:
        return tuple(range(ndim))
    return (ax,) if isinstance(ax, int) else tuple(ax)


def index(t):
    """An index tensor as torch's gather/scatter take it (int64); the
    facade's dtypes never are."""
    return t.long() if t.dtype != torch.int64 else t


def asarray(x):
    return x if isinstance(x, torch.Tensor) else as_operand(x)
