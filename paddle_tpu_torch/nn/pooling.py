"""Pooling layers: port of ``paddle_tpu/nn/layer/pooling.py``, each the
layer form of its functional (keywords such as ``ceil_mode``,
``exclusive`` and ``data_format`` passed through)."""

from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _Pool(nn.Module):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return getattr(F, self._fn)(x, self.kernel_size, self.stride,
                                    self.padding, **self.kwargs)


class _AdaptivePool(nn.Module):
    _fn = None

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return getattr(F, self._fn)(x, self.output_size, **self.kwargs)


def _named(base, name, fn):
    return type(name, (base,), {"_fn": fn, "__module__": __name__})


AvgPool1D = _named(_Pool, "AvgPool1D", "avg_pool1d")
AvgPool2D = _named(_Pool, "AvgPool2D", "avg_pool2d")
AvgPool3D = _named(_Pool, "AvgPool3D", "avg_pool3d")
MaxPool1D = _named(_Pool, "MaxPool1D", "max_pool1d")
MaxPool2D = _named(_Pool, "MaxPool2D", "max_pool2d")
MaxPool3D = _named(_Pool, "MaxPool3D", "max_pool3d")
AdaptiveAvgPool1D = _named(_AdaptivePool, "AdaptiveAvgPool1D",
                           "adaptive_avg_pool1d")
AdaptiveAvgPool2D = _named(_AdaptivePool, "AdaptiveAvgPool2D",
                           "adaptive_avg_pool2d")
AdaptiveAvgPool3D = _named(_AdaptivePool, "AdaptiveAvgPool3D",
                           "adaptive_avg_pool3d")
AdaptiveMaxPool1D = _named(_AdaptivePool, "AdaptiveMaxPool1D",
                           "adaptive_max_pool1d")
AdaptiveMaxPool2D = _named(_AdaptivePool, "AdaptiveMaxPool2D",
                           "adaptive_max_pool2d")
AdaptiveMaxPool3D = _named(_AdaptivePool, "AdaptiveMaxPool3D",
                           "adaptive_max_pool3d")
