"""Creation ops: port of ``paddle_tpu/tensor/creation.py``.

A new tensor lies on ``set_device``'s device (the card unless
``set_device("cpu")``; raising without CUDA), in the reference's default
dtype (``_dt``: the default float dtype, int32 for integers); ops that
take a tensor stay on its device.
"""

from __future__ import annotations

import torch

from ..core.dispatch import dispatch, wrap
from ..core.dtypes import convert_dtype, default_float_dtype
from ..core.tensor import to_tensor
from ._helpers import asarray, normalize_shape

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "arange", "linspace", "logspace", "eye", "empty",
    "empty_like", "diag", "diagflat", "tril_indices", "triu_indices",
    "assign", "clone", "complex", "polar", "tril", "triu", "meshgrid",
    "diag_embed", "diagonal",
]


def _dt(dtype, default=None):
    d = convert_dtype(dtype)
    if d is None:
        d = default or default_float_dtype()
    return d


def _dev():
    from .. import device as _device
    return _device.layer_device()


def zeros(shape, dtype=None, name=None):
    return wrap(torch.zeros(normalize_shape(shape), dtype=_dt(dtype),
                            device=_dev()))


def ones(shape, dtype=None, name=None):
    return wrap(torch.ones(normalize_shape(shape), dtype=_dt(dtype),
                           device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = torch.bool
        elif isinstance(fill_value, int):
            dtype = torch.int32
        else:
            dtype = default_float_dtype()
    return wrap(torch.full(normalize_shape(shape), fill_value,
                           dtype=_dt(dtype), device=_dev()))


def _like(fn, x, dtype, *args):
    a = asarray(x)
    d = convert_dtype(dtype) or convert_dtype(a.dtype)
    with torch.no_grad():
        return wrap(fn(a.detach(), *args, dtype=d))


def zeros_like(x, dtype=None, name=None):
    return _like(torch.zeros_like, x, dtype)


def ones_like(x, dtype=None, name=None):
    return _like(torch.ones_like, x, dtype)


def full_like(x, fill_value, dtype=None, name=None):
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    return _like(torch.full_like, x, dtype, fill_value)


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start = start.item() if isinstance(start, torch.Tensor) else start
    end = end.item() if isinstance(end, torch.Tensor) else end
    step = step.item() if isinstance(step, torch.Tensor) else step
    if end is None:
        start, end = 0, start
    d = convert_dtype(dtype)
    if d is None:
        if any(isinstance(v, float) for v in (start, end, step)):
            d = default_float_dtype()
        else:
            d = torch.int32
    return wrap(torch.arange(start, end, step, dtype=d, device=_dev()))


def linspace(start, stop, num, dtype=None, name=None):
    start = start.item() if isinstance(start, torch.Tensor) else start
    stop = stop.item() if isinstance(stop, torch.Tensor) else stop
    num = int(num.item() if isinstance(num, torch.Tensor) else num)
    return wrap(torch.linspace(start, stop, num, dtype=_dt(dtype),
                               device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    start = start.item() if isinstance(start, torch.Tensor) else start
    stop = stop.item() if isinstance(stop, torch.Tensor) else stop
    num = int(num.item() if isinstance(num, torch.Tensor) else num)
    return wrap(torch.logspace(start, stop, num, base=base, dtype=_dt(dtype),
                               device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n, m = num_rows, num_rows if num_columns is None else num_columns
    return wrap(torch.eye(n, m, dtype=_dt(dtype), device=_dev()))


def diag(x, offset=0, padding_value=0, name=None):
    def impl(a):
        if a.ndim == 1:
            out = torch.diag(a, offset)
            if padding_value != 0:
                mask = torch.diag(torch.ones_like(a, dtype=torch.bool),
                                  offset)
                out = torch.where(mask, out, torch.full_like(
                    out, padding_value))
            return out
        return torch.diagonal(a, offset).clone()

    return dispatch("diag", impl, asarray(x))


def diagflat(x, offset=0, name=None):
    return dispatch("diagflat",
                    lambda a: torch.diagflat(a.reshape(-1), offset),
                    asarray(x))


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return dispatch("diag_embed", lambda a: torch.diag_embed(
        a, offset, dim1, dim2), asarray(x))


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return dispatch("diagonal", lambda a: torch.diagonal(
        a, offset, axis1, axis2), asarray(x))


def tril(x, diagonal=0, name=None):
    return dispatch("tril", lambda a: torch.tril(a, diagonal), asarray(x))


def triu(x, diagonal=0, name=None):
    return dispatch("triu", lambda a: torch.triu(a, diagonal), asarray(x))


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return wrap(torch.tril_indices(row, col, offset, device=_dev()).to(
        convert_dtype(dtype)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return wrap(torch.triu_indices(row, col, offset, device=_dev()).to(
        convert_dtype(dtype)))


def meshgrid(*args, name=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    if not args:
        return ()
    return dispatch("meshgrid", lambda *arrays: tuple(
        torch.meshgrid(*arrays, indexing="ij")), *[asarray(a) for a in args])


def assign(x, output=None):
    # the reference reads x's value: no gradient flows through assign
    out = dispatch("assign", lambda a: a.clone(), asarray(x).detach())
    if output is not None:
        from ..core.tensor import inplace_update
        return inplace_update(output, out)
    return out


def clone(x, name=None):
    return dispatch("clone", lambda a: a.clone(), asarray(x))


def complex(real, imag, name=None):
    return dispatch("complex", torch.complex, asarray(real), asarray(imag),
                    promote=0)


def polar(abs, angle, name=None):
    return dispatch("polar", torch.polar, asarray(abs), asarray(angle),
                    promote=0)
