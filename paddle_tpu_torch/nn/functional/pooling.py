"""Pooling: port of ``paddle_tpu/nn/functional/pooling.py``.

The reference pools with ``lax.reduce_window``; the port with torch's
pools on the same windows:
- max pools pad with ``-inf`` and average pools sum zeros; with
  ``exclusive=True`` (the default) an average divides by the count of
  unpadded elements in its window (torch's ``count_include_pad=False``),
  otherwise by the window size; a string padding (``"SAME"``/``"VALID"``,
  XLA's rule) always divides by the window size, as the reference does;
- ``ceil_mode``, ``return_mask`` and ``divisor_override`` are accepted
  and not applied, exactly as the reference (its ``_pool`` reads none of
  them): outputs have the floor shape and no mask is returned
  (ROADMAP.md, "Known differences of the vision layers");
- channels-last inputs (``N*C``) move their channel axis by a view, as
  the convolutions do;
- the adaptive pools use the reference's bins (``floor(i in / out)`` to
  ``ceil((i + 1) in / out)``), which are torch's; ``adaptive_max_pool*``
  reads channels-first only, as the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp.auto_cast import cast as _amp_cast
from .conv import _pad_arg, _string_pads

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
    "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
]

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_ADA_AVG = {1: F.adaptive_avg_pool1d, 2: F.adaptive_avg_pool2d,
            3: F.adaptive_avg_pool3d}
_ADA_MAX = {1: F.adaptive_max_pool1d, 2: F.adaptive_max_pool2d,
            3: F.adaptive_max_pool3d}


def _tup(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in (list(v) * n if len(v) == 1 else v))
    return (int(v),) * n


def _pool(x, kernel, stride, padding, n, kind, data_format,
          exclusive=True, name="pool"):
    (x,) = _amp_cast(name, x)
    ks = _tup(kernel, n)
    st = _tup(stride if stride is not None else kernel, n)
    last = not data_format.startswith("NC")
    if last:
        x = x.movedim(-1, 1)
    if isinstance(padding, str):
        pairs = _string_pads(padding.upper(), x.shape[2:], ks, st)
        fill = float("-inf") if kind == "max" else 0.0
        x = F.pad(x, _pad_arg(pairs), value=fill)
        pads, exclusive = (0,) * n, False
    else:
        pads = _tup(padding, n)
    if any(2 * p > k for p, k in zip(pads, ks)):
        # torch pools take pads up to half the window; pad by hand
        fill = float("-inf") if kind == "max" else 0.0
        if kind == "avg" and exclusive:
            ones = torch.ones_like(x[:1, :1])
            cnt = _AVG[n](F.pad(ones, _pad_arg([(p, p) for p in pads])),
                          ks, st, 0, divisor_override=1)
        x = F.pad(x, _pad_arg([(p, p) for p in pads]), value=fill)
        if kind == "max":
            out = _MAX[n](x, ks, st, 0)
        elif exclusive:
            out = _AVG[n](x, ks, st, 0, divisor_override=1) / cnt
        else:
            out = _AVG[n](x, ks, st, 0)
    elif kind == "max":
        out = _MAX[n](x, ks, st, pads)
    else:
        out = _AVG[n](x, ks, st, pads, count_include_pad=not exclusive)
    return out.movedim(1, -1) if last else out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg", "NCL",
                 exclusive, "avg_pool1d")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, "avg", data_format,
                 exclusive, "avg_pool2d")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg", data_format,
                 exclusive, "avg_pool3d")


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, "max", "NCL",
                 name="max_pool1d")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _pool(x, kernel_size, stride, padding, 2, "max", data_format,
                 name="max_pool2d")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool(x, kernel_size, stride, padding, 3, "max", data_format,
                 name="max_pool3d")


def _adaptive(x, output_size, n, kind, name, last=False):
    (x,) = _amp_cast(name, x)
    if last:
        x = x.movedim(-1, 1)
    sizes = list(output_size) if isinstance(output_size, (list, tuple)) \
        else [output_size]
    os = tuple(s if o is None else int(o)
               for o, s in zip(sizes * n if len(sizes) == 1 else sizes,
                               x.shape[2:2 + n]))
    if kind == "max":
        out = _ADA_MAX[n](x, os)
    else:
        out = _ADA_AVG[n](x, os)
    return out.movedim(1, -1) if last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg", "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, "avg", "adaptive_avg_pool2d",
                     not data_format.startswith("NC"))


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg", "adaptive_avg_pool3d",
                     not data_format.startswith("NC"))


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "max", "adaptive_max_pool1d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "max", "adaptive_max_pool2d")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "max", "adaptive_max_pool3d")
