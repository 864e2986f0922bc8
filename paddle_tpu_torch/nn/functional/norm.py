"""Normalization functionals: port of the rest of
``paddle_tpu/nn/functional/norm.py`` (``layer_norm`` is in the
package's ``__init__``).

``rms_norm(x, weight=None, epsilon=1e-6)`` (``norm.py:50-68``): with a
weight it is ``ops.rms_norm`` (the ``csrc/rms_norm.cu`` kernel on the
card, ``rms_norm_plain`` on the CPU), its inputs cast by the AMP rule
under the name of the reference's kernel route, ``rms_norm_pallas``;
without one it is the reference's float32 formula in torch ops, cast
under ``rms_norm``.

``batch_norm`` keeps the reference's rules, which are not torch's:
- the batch variance is the biased one;
- the running update is ``running = momentum * running + (1 - momentum)
  * batch`` (Paddle's ``momentum``, 0.9 by default, weighs the OLD
  value), in float32, written back in the buffer's dtype (a bf16 buffer
  stays bf16; its ``momentum * running`` rounds in bf16 first, as the
  reference's weak-typed product does);
- the normalization is float32 math and the output is in x's dtype;
- ``use_global_stats=True`` normalizes by the running buffers in
  training too, and updates nothing.
``torch.nn.functional.batch_norm`` with the buffers passed in would be
neither (its momentum weighs the new value and it stores the unbiased
variance).  So the port gives torch's normalization fresh float32
statistics (momentum 1: they receive the batch mean and the unbiased
variance of the same pass that normalizes, cuDNN's on the card), turns
the variance biased, and updates the module's buffers in place under
``no_grad`` by the reference's rule.  The batch statistics are
differentiated (the full batch-norm gradient), as the reference's
compiled ``TrainStep`` differentiates its statistics; its eager tape
does not (``nondiff_mask``), which ROADMAP.md's "Known differences of
the vision layers" records.  A channels-last input is normalized as the
channels-first view of its memory, without a copy.

``instance_norm`` (channels-first, as the reference), ``group_norm``,
``local_response_norm`` and ``normalize`` are the reference's float32
formulas in torch ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp.auto_cast import cast as _amp_cast
from ...ops.rms_norm import rms_norm as _rms_norm_op

__all__ = ["normalize", "batch_norm", "instance_norm", "group_norm",
           "local_response_norm", "rms_norm"]


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    (x,) = _amp_cast("normalize", x)
    n = torch.sum(x.abs() ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(n, epsilon)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    if weight is not None:
        x, weight = _amp_cast("rms_norm_pallas", x, weight)
        return _rms_norm_op(x, weight, epsilon)
    (x,) = _amp_cast("rms_norm", x)
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
    return out.to(x.dtype)


def _stat_dtype(x):
    """float32 statistics (float64 for a float64 input)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    channels_first = data_format.startswith("NC") and x.ndim > 2
    c_axis = 1 if channels_first or x.ndim == 2 else x.ndim - 1
    use_batch = training and use_global_stats is not True
    if use_batch:
        _amp_cast("batch_norm_stats", x)
    buffers = (running_mean, running_var)    # updated in place, uncast
    x, running_mean, running_var, weight, bias = _amp_cast(
        "batch_norm", x, running_mean, running_var, weight, bias)
    xc = x.movedim(c_axis, 1) if c_axis != 1 else x
    sdt = _stat_dtype(x)
    w, b = (None if t is None else t.to(sdt) for t in (weight, bias))
    if not use_batch:
        out = F.batch_norm(xc, running_mean.to(sdt), running_var.to(sdt), w,
                           b, False, 0.0, epsilon)
    else:
        c = xc.shape[1]
        n = xc.numel() // c
        bmean = torch.zeros(c, dtype=sdt, device=x.device)
        bvar = torch.zeros(c, dtype=sdt, device=x.device)
        out = F.batch_norm(xc, bmean, bvar, w, b, True, 1.0, epsilon)
        if buffers[0] is not None:
            with torch.no_grad():
                bvar = bvar * ((n - 1) / n) if n > 1 else bvar
                for buf, stat in zip(buffers, (bmean, bvar)):
                    buf.copy_((momentum * buf).to(sdt)
                              + (1.0 - momentum) * stat)
    out = out.to(x.dtype)
    return out.movedim(1, c_axis) if c_axis != 1 else out


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out


def _moments(xf, axes):
    m = xf.mean(dim=axes, keepdim=True)
    c = xf - m
    return m, (c * c).mean(dim=axes, keepdim=True)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    x, weight, bias = _amp_cast("instance_norm", x, weight, bias)
    axes = tuple(range(2, x.ndim))
    xf = x.float()
    m, v = _moments(xf, axes)
    out = (xf - m) * torch.rsqrt(v + eps)
    out = _affine(out, weight, bias, [1, -1] + [1] * (x.ndim - 2))
    return out.to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    x, weight, bias = _amp_cast("group_norm", x, weight, bias)
    if data_format.startswith("NC"):
        n, c = x.shape[0], x.shape[1]
        g = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
        axes = tuple(range(2, g.ndim))
        shape = [1, -1] + [1] * (x.ndim - 2)
    else:
        n, c = x.shape[0], x.shape[-1]
        g = x.reshape((n,) + tuple(x.shape[1:-1])
                      + (num_groups, c // num_groups))
        axes = tuple(range(1, g.ndim - 2)) + (g.ndim - 1,)
        shape = [1] * (x.ndim - 1) + [-1]
    gf = g.float()
    m, v = _moments(gf, axes)
    out = ((gf - m) * torch.rsqrt(v + epsilon)).reshape(x.shape)
    return _affine(out, weight, bias, shape).to(x.dtype)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    (x,) = _amp_cast("local_response_norm", x)
    c_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    sq = (x * x).movedim(c_axis, -1)
    padded = F.pad(sq, (size // 2, (size - 1) // 2))
    c = sq.shape[-1]
    window = torch.stack([padded[..., i:i + c] for i in range(size)],
                         dim=0).sum(dim=0)
    div = (k + alpha * window) ** beta
    return x / div.movedim(-1, c_axis)
