"""Convolutions: port of ``paddle_tpu/nn/functional/conv.py``.

The JAX package lowers every convolution to ``lax.conv_general_dilated``
(an XLA op, not a Pallas kernel); the port runs torch's convolutions,
cuDNN on the card.

- Padding keeps every form of ``_conv_padding``: an int, one value per
  spatial dimension, a (lo, hi) pair per dimension (or ``2 n`` flat
  values), and ``"SAME"``/``"VALID"`` with XLA's rule (``SAME``: output
  ``ceil(in / stride)``, the odd pad at the high end).  torch takes only
  symmetric pads, so an asymmetric one is applied by ``F.pad`` first.
- ``data_format`` ``N*C`` (channels-last) is a ``[N, *spatial, C]``
  tensor; ``movedim(-1, 1)`` of it is already ``torch.channels_last``
  memory, which cuDNN takes without a copy, and the output moves back
  the same way (a view).
- A transposed convolution is the reference's conv of the lhs-dilated
  input with the flipped kernel and pads ``k_eff - 1 - p`` (plus
  ``output_padding`` at the high end), which is torch's
  ``conv_transpose``; other pads (asymmetric, negative, or an
  ``output_padding`` torch refuses) run ``conv_transpose`` unpadded and
  crop or zero-extend the result.  The reference refuses ``groups > 1``
  (its ``IO`` kernel does not group) and a string padding (XLA has none
  for a transposed convolution); so does the port (ROADMAP.md, "Known
  differences of the vision layers").
- The input and the kernel must share a dtype: a float32 batch into a
  bf16 network raises ``TypeError``, as the reference's
  ``lax.conv_general_dilated`` does (nothing is cast outside the AMP
  rule).
- float32 on the card runs without TF32 (``exact_fp32``): cuDNN would
  otherwise round the operands to TF32 by default.  The switch is
  scoped to the port's own forward and backward calls; the caller's
  setting is restored.  bf16 convolutions use the tensor cores.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

from ...amp.auto_cast import cast as _amp_cast
from ...device import dtype_name

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_KNOWN = "(ROADMAP.md, \"Known differences of the vision layers\")"


@contextmanager
def _cudnn_full_fp32():
    c = torch.backends.cudnn
    prev = c.allow_tf32
    c.allow_tf32 = False
    try:
        yield
    finally:
        c.allow_tf32 = prev


class _FullFP32(torch.autograd.Function):
    """Run ``fn`` (forward) and its backward with cuDNN's TF32 off: the
    forward records ``fn``'s own graph on detached leaves, the backward
    differentiates it under the same switch."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  if isinstance(t, torch.Tensor) else t for t in inputs]
        with torch.enable_grad(), _cudnn_full_fp32():
            out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        ctx.leaves, ctx.outs = leaves, outs
        ctx.single = not isinstance(out, tuple)
        res = tuple(o.detach() for o in outs)
        return res[0] if ctx.single else res

    @staticmethod
    def backward(ctx, *grads):
        leaves, outs = ctx.leaves, ctx.outs
        need = [i for i, t in enumerate(leaves)
                if isinstance(t, torch.Tensor) and t.requires_grad]
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        result = [None] * len(leaves)
        if need and pairs:
            with _cudnn_full_fp32():
                got = torch.autograd.grad(
                    [o for o, _ in pairs], [leaves[i] for i in need],
                    [g for _, g in pairs], allow_unused=True)
            for i, g in zip(need, got):
                result[i] = g
        ctx.leaves = ctx.outs = None
        return (None, *result)


def exact_fp32(fn, *tensors):
    """``fn(*tensors)``; on a CUDA float32 input, with cuDNN's TF32 off
    for the call and for its backward."""
    first = next(t for t in tensors if isinstance(t, torch.Tensor))
    if first.device.type != "cuda" or first.dtype != torch.float32 \
            or not torch.backends.cudnn.allow_tf32:
        return fn(*tensors)
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        return _FullFP32.apply(fn, *tensors)
    with _cudnn_full_fp32():
        return fn(*tensors)


def _norm_tuple(v, n):
    if isinstance(v, (list, tuple)):
        out = [tuple(int(i) for i in item) if isinstance(item, (list, tuple))
               else int(item) for item in v]
        return out * n if len(out) == 1 else out
    return [int(v)] * n


def _conv_padding(padding, n):
    """``"SAME"``/``"VALID"``, or a list of n (lo, hi) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    p = _norm_tuple(padding, n)
    if all(isinstance(i, int) for i in p):
        if len(p) == n:
            return [(i, i) for i in p]
        if len(p) == 2 * n:
            return [(p[2 * i], p[2 * i + 1]) for i in range(n)]
    return [tuple(i) if isinstance(i, (list, tuple)) else (i, i) for i in p]


def _string_pads(mode, spatial, windows, strides):
    """XLA's ``padtype_to_pads``: (lo, hi) per dimension."""
    if mode == "VALID":
        return [(0, 0)] * len(spatial)
    if mode != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {mode!r}")
    pads = []
    for size, w, s in zip(spatial, windows, strides):
        out = -(-size // s)
        total = max((out - 1) * s + w - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_arg(pairs):
    """``F.pad``'s flat list (last dimension first) of (lo, hi) pairs."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return flat


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _same_dtype(name, x, weight):
    if x.dtype != weight.dtype:
        raise TypeError(
            f"{name} requires arguments to have the same dtypes, got "
            f"{dtype_name(x.dtype)}, {dtype_name(weight.dtype)} (as the "
            f"reference's lax.conv_general_dilated)")


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format,
          n, name):
    x, weight, bias = _amp_cast(name, x, weight, bias)
    _same_dtype(name, x, weight)
    last = not data_format.startswith("NC")
    if last:
        x = x.movedim(-1, 1)
    strides = _norm_tuple(stride, n)
    dilations = _norm_tuple(dilation, n)
    pad = _conv_padding(padding, n)
    if isinstance(pad, str):
        k_eff = [d * (k - 1) + 1 for d, k in zip(dilations, weight.shape[2:])]
        pad = _string_pads(pad, x.shape[2:], k_eff, strides)
    if all(lo == hi and lo >= 0 for lo, hi in pad):
        sym = [lo for lo, _ in pad]
    else:
        x = F.pad(x, _pad_arg(pad))
        sym = [0] * n

    def run(a, w, b):
        return _CONV[n](a, w, b, strides, sym, dilations, groups)

    out = exact_fp32(run, x, weight, bias)
    return out.movedim(1, -1) if last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    df = "NCH" if data_format == "NCL" else "NHC"
    return _conv(x, weight, bias, stride, padding, dilation, groups, df, 1,
                 "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3, "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding, groups,
                    dilation, data_format, n, name):
    if groups != 1:
        raise ValueError(
            f"{name} with groups={groups}: the reference's transposed "
            f"convolution takes groups=1 only (its IO kernel layout does not "
            f"group) {_KNOWN}")
    x, weight, bias = _amp_cast(name, x, weight, bias)
    _same_dtype(name, x, weight)
    last = not data_format.startswith("NC")
    if last:
        x = x.movedim(-1, 1)
    strides = _norm_tuple(stride, n)
    dilations = _norm_tuple(dilation, n)
    k_eff = [d * (k - 1) + 1 for d, k in zip(dilations, weight.shape[2:])]
    pad = _conv_padding(padding, n)
    if isinstance(pad, str):
        raise ValueError(
            f"{name} with padding={padding!r}: the reference's transposed "
            f"convolution takes explicit pads only (XLA refuses a string "
            f"there)")
    opad = _norm_tuple(output_padding, n)
    lohi = [(k - 1 - lo, k - 1 - hi + op)
            for k, (lo, hi), op in zip(k_eff, pad, opad)]
    # in torch's terms: pads p_lo, p_hi cropped off the full output
    crop = [(k - 1 - lo, k - 1 - hi) for k, (lo, hi) in zip(k_eff, lohi)]
    native = all(lo >= 0 and 0 <= lo - hi < max(s, d)
                 for (lo, hi), s, d in zip(crop, strides, dilations))

    def run(a, w, b):
        if native:
            return _CONV_T[n](a, w, b, strides, [lo for lo, _ in crop],
                              [lo - hi for lo, hi in crop], 1, dilations)
        full = _CONV_T[n](a, w, None, strides, 0, 0, 1, dilations)
        out = F.pad(full, _pad_arg([(-lo, -hi) for lo, hi in crop]))
        # the bias reaches the zero-extended border too, as the
        # reference adds it after the convolution
        return out if b is None else out + b.reshape((1, -1) + (1,) * n)

    out = exact_fp32(run, x, weight, bias)
    return out.movedim(1, -1) if last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    df = "NCH" if data_format == "NCL" else "NHC"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, df, 1, "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, data_format, 2,
                           "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, data_format, 3,
                           "conv3d_transpose")
