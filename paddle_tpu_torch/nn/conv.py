"""Convolution layers: port of ``paddle_tpu/nn/layer/conv.py``.

The weight is ``[out, in / groups, *k]``, a transposed convolution's
``[in, out / groups, *k]`` (the reference's layouts, also torch's), the
bias ``[out]``; ``reference_init`` draws the weight from
``KaimingUniform(fan_in)`` with ``fan_in = in / groups * prod(k)`` and
zeroes the bias.  The forwards are ``nn.functional``'s convolutions.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import functional as F
from .common import materialize, meta_factory

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _tup(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, n_spatial,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", transpose=False, output_padding=0, *,
                 device=None, dtype="float32"):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _tup(kernel_size, n_spatial)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        self.output_padding = output_padding
        self._n_spatial = n_spatial
        if transpose:
            wshape = (in_channels, out_channels // groups) + self.kernel_size
        else:
            wshape = (out_channels, in_channels // groups) + self.kernel_size
        self._fan_in = (in_channels // groups) * int(np.prod(self.kernel_size))
        fac = meta_factory(dtype)
        self.weight = nn.Parameter(torch.empty(wshape, **fac))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.empty((out_channels,), **fac))
        materialize(self, device)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={list(self.kernel_size)}, stride={self.stride}")


def _conv_cls(name, n, fn, data_format):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=data_format,
                 *, device=None, dtype="float32"):
        _ConvNd.__init__(self, in_channels, out_channels, kernel_size, n,
                         stride, padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype)

    def forward(self, x):
        return getattr(F, fn)(x, self.weight, self.bias, self.stride,
                              self.padding, self.dilation, self.groups,
                              self.data_format)

    return type(name, (_ConvNd,), {"__init__": __init__, "forward": forward,
                                   "__module__": __name__})


def _conv_t_cls(name, n, fn, data_format):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format=data_format,
                 *, device=None, dtype="float32"):
        _ConvNd.__init__(self, in_channels, out_channels, kernel_size, n,
                         stride, padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format, transpose=True,
                         output_padding=output_padding, device=device,
                         dtype=dtype)

    def forward(self, x, output_size=None):
        return getattr(F, fn)(x, self.weight, self.bias, self.stride,
                              self.padding, self.output_padding, self.groups,
                              self.dilation, output_size, self.data_format)

    return type(name, (_ConvNd,), {"__init__": __init__, "forward": forward,
                                   "__module__": __name__})


Conv1D = _conv_cls("Conv1D", 1, "conv1d", "NCL")
Conv2D = _conv_cls("Conv2D", 2, "conv2d", "NCHW")
Conv3D = _conv_cls("Conv3D", 3, "conv3d", "NCDHW")
# the reference's Conv1DTranspose takes (groups, dilation) in that order
Conv2DTranspose = _conv_t_cls("Conv2DTranspose", 2, "conv2d_transpose",
                              "NCHW")
Conv3DTranspose = _conv_t_cls("Conv3DTranspose", 3, "conv3d_transpose",
                              "NCDHW")


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype="float32"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, device=device,
                         dtype=dtype)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)
