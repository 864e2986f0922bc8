"""SqueezeNet (port of paddle_tpu/vision/models/squeezenet.py)."""

from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ...nn.common import built_on_meta
from ...nn.functional import concat

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(nn.Layer):
    def __init__(self, inplanes, squeeze_planes, expand1x1_planes,
                 expand3x3_planes):
        super().__init__()
        self.squeeze = nn.Conv2D(inplanes, squeeze_planes, 1)
        self.squeeze_activation = nn.ReLU()
        self.expand1x1 = nn.Conv2D(squeeze_planes, expand1x1_planes, 1)
        self.expand1x1_activation = nn.ReLU()
        self.expand3x3 = nn.Conv2D(squeeze_planes, expand3x3_planes, 3,
                                   padding=1)
        self.expand3x3_activation = nn.ReLU()

    def forward(self, x):
        x = self.squeeze_activation(self.squeeze(x))
        return concat([
            self.expand1x1_activation(self.expand1x1(x)),
            self.expand3x3_activation(self.expand3x3(x)),
        ], axis=1)


class SqueezeNet(nn.Layer):
    @built_on_meta
    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                Fire(96, 16, 64, 64), Fire(128, 16, 64, 64),
                Fire(128, 32, 128, 128), nn.MaxPool2D(3, stride=2),
                Fire(256, 32, 128, 128), Fire(256, 48, 192, 192),
                Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2), Fire(512, 64, 256, 256))
        elif version == "1.1":
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                Fire(64, 16, 64, 64), Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2),
                Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2),
                Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
                Fire(384, 64, 256, 256), Fire(512, 64, 256, 256))
        else:
            raise ValueError(f"unsupported SqueezeNet version {version}")

        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU())
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = F.flatten(x, 1)
        return x


def squeezenet1_0(pretrained=False, **kwargs):
    return SqueezeNet(version="1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return SqueezeNet(version="1.1", **kwargs)
