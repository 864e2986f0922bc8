"""Shape/layout manipulation ops: port of
``paddle_tpu/tensor/manipulation.py``.

Ops whose output shape depends on the data (``masked_select``,
``unique``, ``unique_consecutive``, ``bincount``) read their input on
the host, as the reference does eagerly, and record no gradient.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dispatch import dispatch, wrap
from ..core.dtypes import convert_dtype, from_numpy
from ._helpers import asarray, index, normalize_axis, normalize_shape

__all__ = [
    "reshape", "reshape_", "transpose", "concat", "stack", "split", "chunk",
    "squeeze", "squeeze_", "unsqueeze", "unsqueeze_", "flatten", "tile",
    "expand", "expand_as", "broadcast_to", "broadcast_tensors", "flip",
    "roll", "gather", "gather_nd", "scatter", "scatter_", "scatter_nd",
    "scatter_nd_add", "index_select", "index_sample", "index_add",
    "index_put", "masked_select", "masked_fill", "slice", "strided_slice",
    "crop", "pad", "unbind", "unstack", "repeat_interleave",
    "take_along_axis", "put_along_axis", "moveaxis", "rot90",
    "as_complex", "as_real", "view", "view_as", "tensor_split", "hsplit",
    "vsplit", "dsplit", "hstack", "vstack", "dstack", "row_stack",
    "column_stack", "atleast_1d", "atleast_2d", "atleast_3d", "unflatten",
    "unique", "unique_consecutive", "bincount", "one_hot", "numel", "rank",
    "shard_index", "flatten_", "cast", "cast_", "tolist", "chunk",
]


def _inplace(x, out):
    from ..core.tensor import inplace_update
    return inplace_update(x, out)


def cast(x, dtype):
    d = convert_dtype(dtype)
    return dispatch("cast", lambda a: a.to(d), asarray(x))


def cast_(x, dtype):
    return _inplace(x, cast(x, dtype))


def tolist(x):
    return asarray(x).tolist()


def reshape(x, shape, name=None):
    sh = normalize_shape(shape)
    return dispatch("reshape", lambda a: torch.reshape(a, sh), asarray(x))


def reshape_(x, shape, name=None):
    return _inplace(x, reshape(x, shape))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    if isinstance(shape_or_dtype, torch.Tensor):
        # the reference's jax ``view`` of a non-dtype returns the array
        return dispatch("view_dtype", lambda a: a, asarray(x))
    d = convert_dtype(shape_or_dtype)
    return dispatch("view_dtype", lambda a: a.view(d), asarray(x))


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def transpose(x, perm, name=None):
    perm = [int(p) for p in perm]
    return dispatch("transpose", lambda a: torch.permute(a, perm), asarray(x))


def moveaxis(x, source, destination, name=None):
    return dispatch("moveaxis",
                    lambda a: torch.movedim(a, source, destination),
                    asarray(x))


def concat(x, axis=0, name=None):
    tensors = [asarray(t) for t in x]
    ax = int(axis.item()) if isinstance(axis, torch.Tensor) else int(axis)
    return dispatch("concat",
                    lambda *arrays: torch.cat(arrays, dim=ax), *tensors,
                    promote=0)


def stack(x, axis=0, name=None):
    tensors = [asarray(t) for t in x]
    return dispatch("stack",
                    lambda *arrays: torch.stack(arrays, dim=axis), *tensors,
                    promote=0)


def hstack(x, name=None):
    return dispatch("hstack", lambda *arrays: torch.hstack(arrays),
                    *[asarray(t) for t in x], promote=0)


def vstack(x, name=None):
    return dispatch("vstack", lambda *arrays: torch.vstack(arrays),
                    *[asarray(t) for t in x], promote=0)


def dstack(x, name=None):
    return dispatch("dstack", lambda *arrays: torch.dstack(arrays),
                    *[asarray(t) for t in x], promote=0)


row_stack = vstack


def column_stack(x, name=None):
    return dispatch("column_stack",
                    lambda *arrays: torch.column_stack(arrays),
                    *[asarray(t) for t in x], promote=0)


def split(x, num_or_sections, axis=0, name=None):
    ax = int(axis.item()) if isinstance(axis, torch.Tensor) else int(axis)

    def impl(a):
        total = a.shape[ax]
        if isinstance(num_or_sections, int):
            if total % num_or_sections:
                raise ValueError(
                    f"array split does not result in an equal division: "
                    f"{total} into {num_or_sections} sections")
            return tuple(torch.split(a, total // num_or_sections, dim=ax))
        sections = [int(s) for s in num_or_sections]
        # paddle allows one -1 section
        neg = [i for i, s in enumerate(sections) if s == -1]
        if neg:
            sections[neg[0]] = total - builtins.sum(
                s for s in sections if s != -1)
        return tuple(torch.split(a, sections, dim=ax))

    return list(dispatch("split", impl, asarray(x)))


def tensor_split(x, num_or_indices, axis=0, name=None):
    return list(dispatch(
        "tensor_split",
        lambda a: tuple(torch.tensor_split(a, num_or_indices, dim=axis)),
        asarray(x)))


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1 if x.ndim > 1 else 0)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def squeeze(x, axis=None, name=None):
    ax = normalize_axis(axis)

    def impl(a):
        if ax is None:
            return torch.squeeze(a)
        axes = (ax,) if isinstance(ax, int) else ax
        axes = tuple(a_ % a.ndim for a_ in axes if a.shape[a_ % a.ndim] == 1)
        return torch.squeeze(a, axes) if axes else a

    return dispatch("squeeze", impl, asarray(x))


def squeeze_(x, axis=None, name=None):
    return _inplace(x, squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    ax = normalize_axis(axis)
    axes = (ax,) if isinstance(ax, int) else ax

    def impl(a):
        out = a
        for a_ in sorted(axes):
            out = torch.unsqueeze(out, a_)
        return out

    return dispatch("unsqueeze", impl, asarray(x))


def unsqueeze_(x, axis, name=None):
    return _inplace(x, unsqueeze(x, axis))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def impl(a):
        nd = a.ndim
        s = start_axis % nd if nd else 0
        e = stop_axis % nd if nd else 0
        return torch.reshape(a, tuple(a.shape[:s]) + (-1,) +
                             tuple(a.shape[e + 1:]))

    return dispatch("flatten", impl, asarray(x))


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _inplace(x, flatten(x, start_axis, stop_axis))


def unflatten(x, axis, shape, name=None):
    sh = normalize_shape(shape)

    def impl(a):
        ax = axis % a.ndim
        return torch.reshape(a, tuple(a.shape[:ax]) + tuple(sh) +
                             tuple(a.shape[ax + 1:]))

    return dispatch("unflatten", impl, asarray(x))


def tile(x, repeat_times, name=None):
    reps = normalize_shape(repeat_times)
    return dispatch("tile", lambda a: torch.tile(a, reps), asarray(x))


def expand(x, shape, name=None):
    sh = normalize_shape(shape)

    def impl(a):
        target = list(sh)
        # -1 means keep original dim
        offset = len(target) - a.ndim
        for i in range(len(target)):
            if target[i] == -1:
                target[i] = a.shape[i - offset]
        return torch.broadcast_to(a, tuple(target))

    return dispatch("expand", impl, asarray(x))


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    return list(dispatch("broadcast_tensors",
                         lambda *arrays: tuple(torch.broadcast_tensors(
                             *arrays)),
                         *[asarray(t) for t in inputs]))


def flip(x, axis, name=None):
    ax = normalize_axis(axis)
    return dispatch("flip", lambda a: torch.flip(
        a, tuple(range(a.ndim)) if ax is None else
        ((ax,) if isinstance(ax, int) else ax)), asarray(x))


def rot90(x, k=1, axes=(0, 1), name=None):
    return dispatch("rot90", lambda a: torch.rot90(a, k, tuple(axes)),
                    asarray(x))


def roll(x, shifts, axis=None, name=None):
    ax = normalize_axis(axis)
    sh = shifts if isinstance(shifts, int) else tuple(
        int(s) for s in np.atleast_1d(np.asarray(shifts)))
    return dispatch("roll", lambda a: torch.roll(a, sh, ax), asarray(x))


def gather(x, index, axis=0, name=None):
    ax = int(axis.item()) if isinstance(axis, torch.Tensor) else int(axis)
    return dispatch("gather", lambda a, idx: torch.index_select(
        a, ax, _index(idx).reshape(-1)), asarray(x), asarray(index),
        nondiff=[False, True])


def _index(t):
    return index(t) if isinstance(t, torch.Tensor) else t


def gather_nd(x, index, name=None):
    def impl(a, idx):
        idx = _index(idx)
        return a[tuple(idx[..., i] for i in range(idx.shape[-1]))]

    return dispatch("gather_nd", impl, asarray(x), asarray(index),
                    nondiff=[False, True])


def _set_rows(a, idx, upd):
    """``a.at[idx].set(upd)`` along axis 0 with JAX's rule for repeated
    indices: the last update of a row wins and only it gets a gradient
    (deterministic on every device, no host read)."""
    pos = torch.arange(idx.numel(), device=a.device)
    last = torch.full((a.shape[0],), -1, dtype=pos.dtype, device=a.device)
    last = last.scatter_reduce(0, idx, pos, "amax")
    src = upd.expand((idx.numel(),) + tuple(a.shape[1:]))[last.clamp(min=0)]
    hit = (last >= 0).reshape((-1,) + (1,) * (a.ndim - 1))
    return torch.where(hit, src, a)


def scatter(x, index, updates, overwrite=True, name=None):
    def impl(a, idx, upd):
        idx = _index(idx).reshape(-1)
        upd = upd.to(a.dtype)
        if overwrite:
            return _set_rows(a, idx, upd)
        # paddle semantics: zero the rows then accumulate
        return a.index_fill(0, idx, 0).index_add(0, idx, upd)

    return dispatch("scatter", impl, asarray(x), asarray(index),
                    asarray(updates), nondiff=[False, True, False])


def scatter_(x, index, updates, overwrite=True, name=None):
    return _inplace(x, scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    def impl(a, idx, upd):
        idx = _index(idx)
        return a.index_put(tuple(idx[..., i] for i in range(idx.shape[-1])),
                           upd.to(a.dtype), accumulate=True)

    return dispatch("scatter_nd_add", impl, asarray(x), asarray(index),
                    asarray(updates), nondiff=[False, True, False])


def scatter_nd(index, updates, shape, name=None):
    from .creation import zeros
    base = zeros(shape, dtype=updates.dtype if isinstance(
        updates, torch.Tensor) else None)
    if isinstance(updates, torch.Tensor):
        base = base.to(updates.device)
    return scatter_nd_add(base, index, updates)


def index_select(x, index, axis=0, name=None):
    return dispatch("index_select", lambda a, idx: torch.index_select(
        a, axis, _index(idx).reshape(-1)), asarray(x), asarray(index),
        nondiff=[False, True])


def index_sample(x, index):
    def impl(a, idx):
        rows = torch.arange(a.shape[0], device=a.device)[:, None]
        return a[rows, _index(idx)]

    return dispatch("index_sample", impl, asarray(x), asarray(index),
                    nondiff=[False, True])


def index_add(x, index, axis, value, name=None):
    return dispatch("index_add", lambda a, idx, v: torch.index_add(
        a, axis, _index(idx).reshape(-1), v.to(a.dtype)), asarray(x),
        asarray(index), asarray(value), nondiff=[False, True, False])


def index_put(x, indices, value, accumulate=False, name=None):
    def impl(a, v, *idx):
        v = v.to(a.dtype)
        if accumulate or any(i.dtype == torch.bool for i in idx):
            return a.index_put(tuple(_index(i) if i.dtype != torch.bool
                                     else i for i in idx), v,
                               accumulate=accumulate)
        # the indexed leading axes as one row index (_set_rows' rule)
        idx = torch.broadcast_tensors(*[_index(i) for i in idx])
        lead = a.shape[:len(idx)]
        lin = torch.zeros_like(idx[0])
        for i, n in zip(idx, lead):
            lin = lin * n + torch.remainder(i, n)
        rest = tuple(a.shape[len(idx):])
        flat = a.reshape((-1,) + rest)
        upd = torch.broadcast_to(v, tuple(lin.shape) + rest).reshape(
            (-1,) + rest)
        return _set_rows(flat, lin.reshape(-1), upd).reshape(a.shape)

    return dispatch("index_put", impl, asarray(x), asarray(value),
                    *[asarray(i) for i in indices],
                    nondiff=[False, False] + [True] * len(indices))


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return dispatch("take_along_axis", lambda a, idx: torch.take_along_dim(
        a, _index(idx), dim=axis), asarray(arr), asarray(indices),
        nondiff=[False, True])


_SCATTER_REDUCE = {"multiply": "prod", "mul": "prod", "amax": "amax",
                   "amin": "amin"}


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    scalar_v = not isinstance(values, torch.Tensor) and np.ndim(values) == 0

    def impl(a, idx, *rest):
        idx = _index(idx)
        if scalar_v:
            v = torch.full(idx.shape, values, dtype=a.dtype, device=a.device)
        else:
            v = torch.broadcast_to(rest[0].to(a.dtype), idx.shape)
        if reduce == "assign":
            return a.scatter(axis, idx, v)
        if reduce == "add":
            return a.scatter_add(axis, idx, v)
        if reduce in _SCATTER_REDUCE:
            return a.scatter_reduce(axis, idx, v, _SCATTER_REDUCE[reduce],
                                    include_self=True)
        raise ValueError(f"unsupported reduce {reduce!r}")

    if scalar_v:
        return dispatch("put_along_axis", impl, asarray(arr),
                        asarray(indices), nondiff=[False, True])
    return dispatch("put_along_axis", impl, asarray(arr), asarray(indices),
                    asarray(values), nondiff=[False, True, False])


def masked_select(x, mask, name=None):
    # dynamic output shape: read on the host, no gradient (the reference's)
    a, m = asarray(x), asarray(mask)
    with torch.no_grad():
        return wrap(torch.masked_select(a.detach(), m.to(torch.bool)))


def masked_fill(x, mask, value, name=None):
    v = value.item() if isinstance(value, torch.Tensor) and \
        value.numel() == 1 else value
    if isinstance(v, torch.Tensor):
        v = v.detach().as_subclass(torch.Tensor)    # closed over, as there

    def impl(a, m):
        fill = v.to(a.dtype) if isinstance(v, torch.Tensor) else \
            torch.tensor(v, dtype=a.dtype, device=a.device)
        return torch.where(m.to(torch.bool), fill, a)

    return dispatch("masked_fill", impl, asarray(x), asarray(mask),
                    nondiff=[False, True])


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _take_range(a, ax, s, e, st):
    """``a[..., s:e:st, ...]`` on axis ``ax`` (a negative step too)."""
    r = range(a.shape[ax])[s:e:st]
    if st > 0:
        idx = [builtins.slice(None)] * a.ndim
        idx[ax] = builtins.slice(r.start, r.stop if len(r) else r.start,
                                 st)
        return a[tuple(idx)]
    sel = torch.tensor(list(r), dtype=torch.int64, device=a.device)
    return torch.index_select(a, ax, sel)


def slice(input, axes, starts, ends, name=None):
    def impl(a):
        for ax, s, e in zip(axes, starts, ends):
            a = _take_range(a, ax, _int(s), _int(e), 1)
        return a

    return dispatch("slice", impl, asarray(input))


def strided_slice(x, axes, starts, ends, strides, name=None):
    def impl(a):
        for ax, s, e, st in zip(axes, starts, ends, strides):
            a = _take_range(a, ax, _int(s), _int(e), _int(st))
        return a

    return dispatch("strided_slice", impl, asarray(x))


def crop(x, shape=None, offsets=None, name=None):
    sh = normalize_shape(shape)
    offs = [0] * len(sh) if offsets is None else [int(o) for o in offsets]

    def impl(a):
        idx = tuple(builtins.slice(o, o + (s if s != -1 else a.shape[i] - o))
                    for i, (o, s) in enumerate(zip(offs, sh)))
        return a[idx]

    return dispatch("crop", impl, asarray(x))


def _pad_index(n, lo, hi, mode, device):
    """Source positions of a padded axis of length ``n`` (numpy's
    ``reflect``, ``edge`` and ``wrap`` pads)."""
    pos = np.arange(-lo, n + hi)
    if mode == "edge":
        src = np.clip(pos, 0, n - 1)
    elif mode == "wrap":
        src = np.mod(pos, n)
    else:  # reflect, about the edge elements
        period = 2 * (n - 1) if n > 1 else 1
        src = np.mod(pos, period)
        src = np.where(src >= n, period - src, src)
    return torch.as_tensor(src, dtype=torch.int64, device=device)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    pad = [int(p) for p in (pad.tolist() if isinstance(pad, torch.Tensor)
                            else pad)]

    def impl(a):
        nd = a.ndim
        if len(pad) == 2 * nd:
            width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
        else:
            # paddle NCHW/NCDHW convention: pad applies to trailing spatial
            # dims, given in reverse (last dim first)
            n_spatial = len(pad) // 2
            width = [(0, 0)] * (nd - n_spatial)
            spatial = [(pad[2 * i], pad[2 * i + 1]) for i in range(n_spatial)]
            if data_format in ("NHWC", "NDHWC", "NLC"):
                width = [(0, 0)] + spatial[::-1] + [(0, 0)]
            else:
                width += spatial[::-1]
        if mode == "constant":
            flat = []
            for lo, hi in reversed(width):
                flat += [lo, hi]
            return F.pad(a, flat, mode="constant", value=value)
        jmode = {"reflect": "reflect", "replicate": "edge",
                 "circular": "wrap"}[mode]
        for ax, (lo, hi) in enumerate(width):
            if lo or hi:
                a = torch.index_select(a, ax, _pad_index(
                    a.shape[ax], lo, hi, jmode, a.device))
        return a

    return dispatch("pad", impl, asarray(x))


def unbind(input, axis=0, name=None):
    return list(dispatch("unbind", lambda a: tuple(torch.unbind(a, axis)),
                         asarray(input)))


unstack = unbind


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, torch.Tensor):
        reps = repeats.detach().long()
        return dispatch("repeat_interleave", lambda a: torch.repeat_interleave(
            a, reps.to(a.device), dim=axis), asarray(x))
    return dispatch("repeat_interleave", lambda a: torch.repeat_interleave(
        a, repeats, dim=axis), asarray(x))


def as_complex(x, name=None):
    return dispatch("as_complex", lambda a: torch.complex(a[..., 0],
                                                          a[..., 1]),
                    asarray(x))


def as_real(x, name=None):
    return dispatch("as_real", lambda a: torch.stack(
        [torch.real(a), torch.imag(a) if a.is_complex()
         else torch.zeros_like(a)], dim=-1), asarray(x))


def _atleast(name, fn, inputs):
    outs = [dispatch(name, fn, asarray(t)) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast("atleast_1d", torch.atleast_1d, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast("atleast_2d", torch.atleast_2d, inputs)


def atleast_3d(*inputs, name=None):
    return _atleast("atleast_3d", torch.atleast_3d, inputs)


def _host(x) -> np.ndarray:
    a = asarray(x).detach()
    if a.dtype == torch.bfloat16:
        a = a.float()
    return a.cpu().numpy()


def _back(arr, like):
    return wrap(from_numpy(np.asarray(arr)).to(asarray(like).device))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    # dynamic output shape: read on the host
    res = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse, return_counts=return_counts,
                    axis=axis)
    if not isinstance(res, tuple):
        return _back(res, x)
    return tuple(_back(r, x) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None,
                       dtype="int64", name=None):
    a = _host(x)
    if axis is None:
        a = a.reshape(-1)
        keep = np.ones(len(a), dtype=bool)
        keep[1:] = a[1:] != a[:-1]
        outs = [_back(a[keep], x)]
        if return_inverse:
            outs.append(_back(np.cumsum(keep) - 1, x))
        if return_counts:
            idx = np.flatnonzero(keep)
            outs.append(_back(np.diff(np.append(idx, len(a))), x))
        return outs[0] if len(outs) == 1 else tuple(outs)
    raise NotImplementedError("unique_consecutive with axis is not supported yet")


def bincount(x, weights=None, minlength=0, name=None):
    w = _host(weights) if weights is not None else None
    return _back(np.bincount(_host(x), weights=w, minlength=minlength), x)


def one_hot(x, num_classes, name=None):
    return dispatch("one_hot", lambda idx: F.one_hot(
        _index(idx), num_classes).to(torch.float32), asarray(x),
        nondiff=[True])


def numel(x, name=None):
    a = asarray(x)
    return wrap(torch.tensor(a.numel(), dtype=torch.int32, device=a.device))


def rank(input):
    a = asarray(input)
    return wrap(torch.tensor(a.ndim, dtype=torch.int32, device=a.device))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards

    def impl(idx):
        shard = torch.div(idx, shard_size, rounding_mode="floor")
        local = torch.remainder(idx, shard_size)
        return torch.where(shard == shard_id, local,
                           torch.full_like(local, ignore_value))

    return dispatch("shard_index", impl, asarray(input), nondiff=[True])
