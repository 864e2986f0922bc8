"""Search/sort ops: port of ``paddle_tpu/tensor/search.py``.

Indices are int32, as the reference's (``argmax``, ``argsort``,
``topk``, ``kthvalue``, ``mode``, ``searchsorted``); ``nonzero`` reads
its input on the host (a data-dependent shape).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import dispatch, wrap
from ..core.dtypes import convert_dtype, from_numpy
from ._helpers import asarray

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "where", "nonzero",
    "searchsorted", "masked_select", "kthvalue", "mode", "index_sample",
    "bucketize",
]


def _arg(name, fn, x, axis, keepdim, dtype):
    d = convert_dtype(dtype)

    def impl(a):
        if axis is None:
            out = fn(a.reshape(-1), 0)
            if keepdim:
                out = out.reshape((1,) * a.ndim)
        else:
            out = fn(a, axis, keepdim=keepdim)
        return out.to(d)

    return dispatch(name, impl, asarray(x), nondiff=[True])


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg("argmax", torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg("argmin", torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    def impl(a):
        out = torch.argsort(a, dim=axis, stable=True)
        if descending:
            out = torch.flip(out, (axis,))
        return out.to(torch.int32)

    return dispatch("argsort", impl, asarray(x), nondiff=[True])


def sort(x, axis=-1, descending=False, stable=False, name=None):
    def impl(a):
        out = torch.sort(a, dim=axis, stable=True).values
        if descending:
            out = torch.flip(out, (axis,))
        return out

    return dispatch("sort", impl, asarray(x))


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    kk = int(k.item()) if isinstance(k, torch.Tensor) else int(k)

    def impl(a):
        ax = a.ndim - 1 if axis is None else axis % a.ndim
        vals, idx = torch.topk(a, kk, dim=ax, largest=largest, sorted=True)
        return vals, idx.to(torch.int32)

    return dispatch("topk", impl, asarray(x), n_diff=1)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)

    def impl(c, a, b):
        return torch.where(c.to(torch.bool), a, b)

    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x = asarray(x)
    return dispatch("where", impl, asarray(condition), asarray(x),
                    asarray(y), nondiff=[True, False, False], promote=1)


def nonzero(x, as_tuple=False):
    # dynamic output shape: read on the host
    a = asarray(x)
    host = a.detach().cpu()
    if host.dtype == torch.bfloat16:
        host = host.float()
    idx = np.nonzero(host.numpy())
    if as_tuple:
        return tuple(wrap(from_numpy(i.reshape(-1, 1)).to(a.device))
                     for i in idx)
    return wrap(from_numpy(np.stack(idx, axis=1)).to(a.device))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    def impl(seq, v):
        return torch.searchsorted(seq.contiguous(), v.contiguous(),
                                  right=right).to(torch.int32)

    return dispatch("searchsorted", impl, asarray(sorted_sequence),
                    asarray(values), nondiff=[True, True], promote=0)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def masked_select(x, mask, name=None):
    from .manipulation import masked_select as _ms
    return _ms(x, mask)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def impl(a):
        ax = axis % a.ndim
        svals, sidx = torch.sort(a, dim=ax, stable=True)
        vals = torch.select(svals, ax, k - 1)
        idx = torch.select(sidx, ax, k - 1)
        if keepdim:
            vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
        return vals, idx.to(torch.int32)

    return dispatch("kthvalue", impl, asarray(x), n_diff=1)


def mode(x, axis=-1, keepdim=False, name=None):
    def impl(a):
        ax = axis % a.ndim
        moved = torch.movedim(a, ax, -1)
        n = moved.shape[-1]
        flat = moved.reshape(-1, n)
        svals = torch.sort(flat, dim=-1, stable=True).values
        counts = (svals[:, :, None] == svals[:, None, :]).sum(-1)
        # the largest count, ties to the smallest value (first in order)
        best = torch.argmax(counts, dim=-1)
        val = torch.gather(svals, 1, best[:, None])
        pos = torch.arange(n, device=a.device).expand_as(flat)
        idx = torch.where(flat == val, pos, torch.full_like(pos, -1)).amax(
            -1)
        vals = val[:, 0].reshape(moved.shape[:-1])
        idx = idx.reshape(moved.shape[:-1])
        if keepdim:
            vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
        return vals, idx.to(torch.int32)

    return dispatch("mode", impl, asarray(x), n_diff=1)


def index_sample(x, index):
    from .manipulation import index_sample as _is
    return _is(x, index)
