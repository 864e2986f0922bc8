"""MobileNetV3 (port of paddle_tpu/vision/models/mobilenetv3.py)."""

from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ...nn.common import built_on_meta
from ...nn.functional import multiply
from .mobilenetv2 import _make_divisible

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]

_ACTS = {"relu": nn.ReLU, "hardswish": nn.Hardswish}


class ConvNormActivation(nn.Sequential):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 groups=1, activation="relu"):
        padding = (kernel_size - 1) // 2
        layers = [
            nn.Conv2D(in_channels, out_channels, kernel_size, stride=stride,
                      padding=padding, groups=groups, bias_attr=False),
            nn.BatchNorm2D(out_channels),
        ]
        if activation is not None:
            layers.append(_ACTS[activation]())
        super().__init__(*layers)


class SqueezeExcitation(nn.Layer):
    def __init__(self, input_channels, squeeze_channels):
        super().__init__()
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(input_channels, squeeze_channels, 1)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(squeeze_channels, input_channels, 1)
        self.hardsigmoid = nn.Hardsigmoid()

    def forward(self, x):
        scale = self.avgpool(x)
        scale = self.relu(self.fc1(scale))
        scale = self.hardsigmoid(self.fc2(scale))
        return multiply(x, scale)


class InvertedResidual(nn.Layer):
    def __init__(self, in_channels, expanded_channels, out_channels,
                 kernel_size, stride, use_se, activation):
        super().__init__()
        self.use_res_connect = stride == 1 and in_channels == out_channels
        layers = []
        if expanded_channels != in_channels:
            layers.append(ConvNormActivation(in_channels, expanded_channels,
                                             kernel_size=1,
                                             activation=activation))
        layers.append(ConvNormActivation(expanded_channels, expanded_channels,
                                         kernel_size=kernel_size,
                                         stride=stride,
                                         groups=expanded_channels,
                                         activation=activation))
        if use_se:
            layers.append(SqueezeExcitation(
                expanded_channels, _make_divisible(expanded_channels // 4)))
        layers.append(ConvNormActivation(expanded_channels, out_channels,
                                         kernel_size=1, activation=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        if self.use_res_connect:
            out = F.add(out, x)
        return out


class MobileNetV3(nn.Layer):
    @built_on_meta
    def __init__(self, config, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        firstconv_out = _make_divisible(16 * scale)
        layers = [ConvNormActivation(3, firstconv_out, kernel_size=3, stride=2,
                                     activation="hardswish")]
        in_c = firstconv_out
        for k, exp, c, use_se, act, s in config:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(c * scale)
            layers.append(InvertedResidual(in_c, exp_c, out_c, k, s, use_se,
                                           act))
            in_c = out_c
        lastconv_out = 6 * in_c
        layers.append(ConvNormActivation(in_c, lastconv_out, kernel_size=1,
                                         activation="hardswish"))
        self.features = nn.Sequential(*layers)
        self.lastconv_out = lastconv_out
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(lastconv_out, last_channel),
                nn.Hardswish(),
                nn.Dropout(0.2),
                nn.Linear(last_channel, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = F.flatten(x, 1)
            x = self.classifier(x)
        return x


# (kernel, expanded, out, use_se, activation, stride)
_SMALL = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]

_LARGE = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]


class MobileNetV3Small(MobileNetV3):
    @built_on_meta
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_SMALL, last_channel=1024, scale=scale,
                         num_classes=num_classes, with_pool=with_pool)


class MobileNetV3Large(MobileNetV3):
    @built_on_meta
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_LARGE, last_channel=1280, scale=scale,
                         num_classes=num_classes, with_pool=with_pool)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Large(scale=scale, **kwargs)
