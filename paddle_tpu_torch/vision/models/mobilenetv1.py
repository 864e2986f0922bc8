"""MobileNetV1 (port of paddle_tpu/vision/models/mobilenetv1.py)."""

from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ...nn.common import built_on_meta

__all__ = ["MobileNetV1", "mobilenet_v1"]


class ConvBNLayer(nn.Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, num_groups=1):
        super().__init__()
        self.conv = nn.Conv2D(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding,
                              groups=num_groups, bias_attr=False)
        self.norm = nn.BatchNorm2D(out_channels)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.norm(self.conv(x)))


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale):
        super().__init__()
        self.depthwise = ConvBNLayer(in_channels, int(out_channels1 * scale),
                                     3, stride=stride, padding=1,
                                     num_groups=int(num_groups * scale))
        self.pointwise = ConvBNLayer(int(out_channels1 * scale),
                                     int(out_channels2 * scale), 1)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class MobileNetV1(nn.Layer):
    """scale: width multiplier; num_classes<=0 drops the classifier head."""

    @built_on_meta
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2, padding=1)
        # (in, out1, out2, groups, stride)
        cfg = [(32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
               (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
               (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
               (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
               (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
               (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
               (1024, 1024, 1024, 1024, 1)]
        blocks = []
        for in_c, o1, o2, g, s in cfg:
            blocks.append(DepthwiseSeparable(int(in_c * scale), o1, o2, g, s,
                                             scale))
        self.blocks = nn.Sequential(*blocks)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes)

    def forward(self, x):
        x = self.conv1(x)
        x = self.blocks(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = F.flatten(x, 1)
            x = self.fc(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)
