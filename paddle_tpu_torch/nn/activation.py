"""Activation layers: port of ``paddle_tpu/nn/layer/activation.py``, each
the layer form of its functional (``nn.functional``).  ``PReLU`` holds a
``[num_parameters]`` weight, initialised to ``init`` (0.25)."""

from __future__ import annotations

import torch
from torch import nn

from . import functional as F
from .common import materialize, meta_factory

__all__ = ["ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Silu", "Sigmoid",
           "Hardsigmoid", "Hardswish", "Hardtanh", "Hardshrink", "Softshrink",
           "Tanhshrink", "LeakyReLU", "PReLU", "RReLU", "LogSigmoid",
           "Maxout", "Softplus", "Softsign", "Tanh", "Mish", "Softmax",
           "LogSoftmax", "GLU", "ThresholdedReLU", "Swish"]


def _simple(name, fn_name, **defaults):
    def __init__(self, **kwargs):
        nn.Module.__init__(self)
        merged = dict(defaults)
        merged.update({k: v for k, v in kwargs.items() if k != "name"})
        self._kwargs = merged

    def forward(self, x):
        return getattr(F, fn_name)(x, **self._kwargs)

    return type(name, (nn.Module,), {"__init__": __init__,
                                     "forward": forward,
                                     "__module__": __name__})


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
Tanh = _simple("Tanh", "tanh")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
Softsign = _simple("Softsign", "softsign")
Mish = _simple("Mish", "mish")
Hardswish = _simple("Hardswish", "hardswish")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")


class _Args(nn.Module):
    """A layer that calls ``F.<_fn>(x, *args)``."""

    _fn = None

    def __init__(self, *args):
        super().__init__()
        self._args = args

    def forward(self, x):
        return getattr(F, self._fn)(x, *self._args)


class ELU(_Args):
    _fn = "elu"

    def __init__(self, alpha=1.0, name=None):
        super().__init__(alpha)


class SELU(_Args):
    _fn = "selu"

    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__(scale, alpha)


class CELU(_Args):
    _fn = "celu"

    def __init__(self, alpha=1.0, name=None):
        super().__init__(alpha)


class GELU(_Args):
    _fn = "gelu"

    def __init__(self, approximate=False, name=None):
        super().__init__(approximate)


class Hardtanh(_Args):
    _fn = "hardtanh"

    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__(min, max)


class Hardshrink(_Args):
    _fn = "hardshrink"

    def __init__(self, threshold=0.5, name=None):
        super().__init__(threshold)


class Softshrink(_Args):
    _fn = "softshrink"

    def __init__(self, threshold=0.5, name=None):
        super().__init__(threshold)


class LeakyReLU(_Args):
    _fn = "leaky_relu"

    def __init__(self, negative_slope=0.01, name=None):
        super().__init__(negative_slope)


class Maxout(_Args):
    _fn = "maxout"

    def __init__(self, groups, axis=1, name=None):
        super().__init__(groups, axis)


class Softplus(_Args):
    _fn = "softplus"

    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__(beta, threshold)


class Softmax(_Args):
    _fn = "softmax"

    def __init__(self, axis=-1, name=None):
        super().__init__(axis)


class LogSoftmax(_Args):
    _fn = "log_softmax"

    def __init__(self, axis=-1, name=None):
        super().__init__(axis)


class GLU(_Args):
    _fn = "glu"

    def __init__(self, axis=-1, name=None):
        super().__init__(axis)


class ThresholdedReLU(_Args):
    _fn = "thresholded_relu"

    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__(threshold, value)


class RReLU(nn.Module):
    def __init__(self, lower=0.125, upper=0.3333333, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, self.training)


class PReLU(nn.Module):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 dtype="float32"):
        super().__init__()
        self.data_format = data_format
        self._init = float(init)
        self.weight = nn.Parameter(torch.empty((num_parameters,),
                                               **meta_factory(dtype)))
        materialize(self, device)

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)
