"""Dynamic-shape bucketing: port of ``paddle_tpu/jit/bucketing.py``.

Pad a dynamic axis up to one of a few bucket sizes, so a program made per
input shape (an exported or captured one: a ``Predictor`` captures one
CUDA graph per input signature) is made once per bucket and every input
reuses it.  ``pad_to_bucket`` is the primitive; ``BucketedFunction``
wraps a callable with the padding and crops its outputs back to the true
size; the mask lets a loss ignore the padded positions.  Padding and
cropping are torch ops, so gradients flow through both.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["default_buckets", "pad_to_bucket", "BucketedFunction",
           "bucketed"]


def default_buckets(max_size: int, min_size: int = 8):
    """Power-of-two buckets up to max_size (at most log2(max/min)
    programs per axis)."""
    buckets = []
    b = min_size
    while b < max_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_size)
    return buckets


def _pick(size: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if size <= b:
            return int(b)
    raise ValueError(
        f"size {size} exceeds the largest bucket {max(buckets)}; widen the "
        "bucket ladder or truncate the input")


def pad_to_bucket(x, axis: int, buckets: Sequence[int], pad_value=0):
    """Pad ``x`` along ``axis`` up to the smallest bucket >= its size.
    Returns (padded tensor, original size, mask) where mask is 1.0 for
    real positions along that axis (shape: [bucket], on x's device)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    axis = axis % t.ndim
    size = t.shape[axis]
    target = _pick(size, buckets)
    mask = (torch.arange(target, device=t.device) < size).to(torch.float32)
    if target == size:
        return t, size, mask
    pad = [0, 0] * (t.ndim - 1 - axis) + [0, target - size]
    return F.pad(t, pad, value=pad_value), size, mask


class BucketedFunction:
    """Wraps fn so every call pads the chosen axes to bucket sizes before
    invoking it (bounding the number of distinct shapes) and crops the
    outputs back to the true size.

    axes: {arg_index: (axis, buckets, pad_value)}.
    crop: None (no cropping) or (out_axis,): crops every output tensor of
    sufficient rank along that axis to the original (pre-pad) size of the
    lowest-indexed bucketed argument; lower-rank outputs (a scalar loss)
    pass through uncropped.
    """

    def __init__(self, fn: Callable, axes, crop=None):
        self.fn = fn
        self.axes = axes
        self.crop = crop
        self.compiled_shapes = set()

    def __call__(self, *args):
        args = list(args)
        true_size = None
        for idx in sorted(self.axes):
            axis, buckets, pad_value = self.axes[idx]
            args[idx], size, _ = pad_to_bucket(args[idx], axis, buckets,
                                               pad_value)
            if true_size is None:
                true_size = size
        self.compiled_shapes.add(tuple(
            tuple(a.shape) if isinstance(a, torch.Tensor) else None
            for a in args))
        out = self.fn(*args)
        if self.crop is None or true_size is None:
            return out
        (out_axis,) = self.crop

        def crop_one(t):
            if not isinstance(t, torch.Tensor) or t.ndim <= out_axis:
                return t       # scalars/low-rank outputs pass through
            return t.narrow(out_axis, 0, true_size)

        if isinstance(out, (tuple, list)):
            return type(out)(crop_one(o) for o in out)
        return crop_one(out)


def bucketed(axes, crop=None):
    """Decorator form: @bucketed({0: (1, default_buckets(2048), 0)})."""
    def wrap(fn):
        return BucketedFunction(fn, axes, crop)
    return wrap
