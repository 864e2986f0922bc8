"""Statistics ops: port of ``paddle_tpu/tensor/stat.py``."""

from __future__ import annotations

import math as _math

import torch

from ..core.dispatch import dispatch
from ._helpers import asarray, dims, normalize_axis

__all__ = ["mean", "std", "var", "median", "nanmedian", "quantile",
           "nanquantile", "histogram", "histogramdd", "numel"]

from .math import mean, _float  # noqa: E402
from .manipulation import numel  # noqa: E402


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return dispatch("std", lambda a: torch.std(
        _float(a), dims(ax, a.ndim), correction=1 if unbiased else 0,
        keepdim=keepdim), asarray(x))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return dispatch("var", lambda a: torch.var(
        _float(a), dims(ax, a.ndim), correction=1 if unbiased else 0,
        keepdim=keepdim), asarray(x))


def _quantile(fn, a, q, ax, keepdim, interpolation):
    """``jnp.quantile`` over the axes ``ax`` (None: all), the q axis
    leading when q is not a scalar."""
    a = _float(a)
    axes = dims(ax, a.ndim)
    axes = tuple(sorted(d % a.ndim for d in axes)) if a.ndim else ()
    rest = [d for d in range(a.ndim) if d not in axes]
    moved = a.permute(*rest, *axes).reshape(
        [a.shape[d] for d in rest] + [-1])
    qq = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    out = fn(moved, qq, dim=-1, interpolation=interpolation)
    if keepdim:
        shape = [1 if d in axes else a.shape[d] for d in range(a.ndim)]
        out = out.reshape(tuple(out.shape[:qq.ndim]) + tuple(shape))
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    ax = normalize_axis(axis)

    def impl(a):
        if mode == "avg":
            return _quantile(torch.quantile, a, 0.5, ax, keepdim, "linear")
        # 'min' mode: lower of the two middle values
        arr = a.reshape(-1) if ax is None else a
        axis_ = 0 if ax is None else ax
        n = arr.shape[axis_]
        s = torch.sort(arr, dim=axis_, stable=True).values
        out = torch.select(s, axis_, (n - 1) // 2)
        if keepdim and ax is not None:
            out = out.unsqueeze(axis_)
        return out

    return dispatch("median", impl, asarray(x))


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    ax = normalize_axis(axis)
    return dispatch("nanmedian", lambda a: _quantile(
        torch.nanquantile, a, 0.5, ax, keepdim, "linear"), asarray(x))


def quantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    ax = normalize_axis(axis)
    return dispatch("quantile", lambda a: _quantile(
        torch.quantile, a, q, ax, keepdim, interpolation), asarray(x))


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    ax = normalize_axis(axis)
    return dispatch("nanquantile", lambda a: _quantile(
        torch.nanquantile, a, q, ax, keepdim, interpolation), asarray(x))


def _bin_index(v, edges):
    """``searchsorted(edges, v, 'right')``, the last edge in the last
    bin (``jnp.histogram``)."""
    idx = torch.searchsorted(edges, v.contiguous(), right=True)
    return torch.where(v == edges[-1], torch.full_like(idx, len(edges) - 1),
                       idx)


def histogram(input, bins=100, min=0, max=0, weight=None, density=False, name=None):
    def impl(a, *rest):
        a = _float(a).reshape(-1)
        if min != 0 or max != 0:
            lo, hi = float(min), float(max)
        else:
            lo, hi = a.min().item(), a.max().item()
        edges = torch.linspace(lo, hi, bins + 1, dtype=a.dtype,
                               device=a.device)
        w = rest[0].reshape(-1).to(a.dtype) if rest else torch.ones_like(a)
        idx = _bin_index(a, edges)
        counts = torch.zeros(len(edges) + 1, dtype=w.dtype,
                             device=a.device).index_add(0, idx, w)[1:-1]
        if density:
            counts = counts / torch.diff(edges) / counts.sum()
        return counts if density or rest else counts.to(torch.int32)

    args = (asarray(input), asarray(weight)) if weight is not None \
        else (asarray(input),)
    return dispatch("histogram", impl, *args, nondiff=[True] * len(args))


def histogramdd(x, bins=10, ranges=None, density=False, weights=None, name=None):
    def impl(a, *rest):
        a = _float(a)
        n, d = a.shape
        per_dim = [bins] * d if isinstance(bins, int) else list(bins)
        idxs, edges_all = [], []
        for i in range(d):
            col = a[:, i].contiguous()
            if ranges is None:
                lo, hi = col.min().item(), col.max().item()
            else:
                lo, hi = ranges[i]
            edges = torch.linspace(lo, hi, per_dim[i] + 1, dtype=a.dtype,
                                   device=a.device)
            idx = torch.searchsorted(edges, col, right=True)
            idx = torch.where(col == edges[-1], idx - 1, idx)
            idxs.append(idx)
            edges_all.append(edges)
        nbins = [len(e) + 1 for e in edges_all]
        flat = torch.zeros_like(idxs[0])
        for idx, nb in zip(idxs, nbins):
            flat = flat * nb + idx.clamp(0, nb - 1)
        w = rest[0].reshape(-1) if rest else torch.ones(
            n, dtype=torch.int32, device=a.device)
        hist = torch.zeros(_math.prod(nbins), dtype=w.dtype,
                           device=a.device).index_add(0, flat, w)
        hist = hist.reshape(nbins)[(slice(1, -1),) * d]
        if density:
            hist = hist.to(a.dtype)
            hist = hist / hist.sum()
            for i, e in enumerate(edges_all):
                shape = [1] * d
                shape[i] = -1
                hist = hist / torch.diff(e).reshape(shape)
        return (hist,) + tuple(edges_all)

    args = (asarray(x), asarray(weights)) if weights is not None \
        else (asarray(x),)
    out = dispatch("histogramdd", impl, *args, nondiff=[True] * len(args))
    return out[0], list(out[1:])
