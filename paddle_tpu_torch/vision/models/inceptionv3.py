"""Inception-v3 (port of paddle_tpu/vision/models/inceptionv3.py)."""

from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ...nn.common import built_on_meta
from ...nn.functional import concat

__all__ = ["InceptionV3", "inception_v3"]


class ConvBNLayer(nn.Sequential):
    def __init__(self, in_c, out_c, kernel_size, stride=1, padding=0):
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel_size, stride=stride,
                      padding=padding, bias_attr=False),
            nn.BatchNorm2D(out_c),
            nn.ReLU())


class InceptionA(nn.Layer):
    def __init__(self, in_c, pool_features):
        super().__init__()
        self.branch1x1 = ConvBNLayer(in_c, 64, 1)
        self.branch5x5 = nn.Sequential(ConvBNLayer(in_c, 48, 1),
                                       ConvBNLayer(48, 64, 5, padding=2))
        self.branch3x3dbl = nn.Sequential(
            ConvBNLayer(in_c, 64, 1), ConvBNLayer(64, 96, 3, padding=1),
            ConvBNLayer(96, 96, 3, padding=1))
        self.branch_pool = nn.Sequential(
            nn.AvgPool2D(3, stride=1, padding=1),
            ConvBNLayer(in_c, pool_features, 1))

    def forward(self, x):
        return concat([self.branch1x1(x), self.branch5x5(x),
                       self.branch3x3dbl(x), self.branch_pool(x)], axis=1)


class InceptionB(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.branch3x3 = ConvBNLayer(in_c, 384, 3, stride=2)
        self.branch3x3dbl = nn.Sequential(
            ConvBNLayer(in_c, 64, 1), ConvBNLayer(64, 96, 3, padding=1),
            ConvBNLayer(96, 96, 3, stride=2))
        self.branch_pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.branch3x3(x), self.branch3x3dbl(x),
                       self.branch_pool(x)], axis=1)


class InceptionC(nn.Layer):
    def __init__(self, in_c, channels_7x7):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = ConvBNLayer(in_c, 192, 1)
        self.branch7x7 = nn.Sequential(
            ConvBNLayer(in_c, c7, 1),
            ConvBNLayer(c7, c7, (1, 7), padding=(0, 3)),
            ConvBNLayer(c7, 192, (7, 1), padding=(3, 0)))
        self.branch7x7dbl = nn.Sequential(
            ConvBNLayer(in_c, c7, 1),
            ConvBNLayer(c7, c7, (7, 1), padding=(3, 0)),
            ConvBNLayer(c7, c7, (1, 7), padding=(0, 3)),
            ConvBNLayer(c7, c7, (7, 1), padding=(3, 0)),
            ConvBNLayer(c7, 192, (1, 7), padding=(0, 3)))
        self.branch_pool = nn.Sequential(
            nn.AvgPool2D(3, stride=1, padding=1), ConvBNLayer(in_c, 192, 1))

    def forward(self, x):
        return concat([self.branch1x1(x), self.branch7x7(x),
                       self.branch7x7dbl(x), self.branch_pool(x)], axis=1)


class InceptionD(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.branch3x3 = nn.Sequential(ConvBNLayer(in_c, 192, 1),
                                       ConvBNLayer(192, 320, 3, stride=2))
        self.branch7x7x3 = nn.Sequential(
            ConvBNLayer(in_c, 192, 1),
            ConvBNLayer(192, 192, (1, 7), padding=(0, 3)),
            ConvBNLayer(192, 192, (7, 1), padding=(3, 0)),
            ConvBNLayer(192, 192, 3, stride=2))
        self.branch_pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.branch3x3(x), self.branch7x7x3(x),
                       self.branch_pool(x)], axis=1)


class InceptionE(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.branch1x1 = ConvBNLayer(in_c, 320, 1)
        self.branch3x3_1 = ConvBNLayer(in_c, 384, 1)
        self.branch3x3_2a = ConvBNLayer(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBNLayer(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = nn.Sequential(
            ConvBNLayer(in_c, 448, 1), ConvBNLayer(448, 384, 3, padding=1))
        self.branch3x3dbl_2a = ConvBNLayer(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_2b = ConvBNLayer(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = nn.Sequential(
            nn.AvgPool2D(3, stride=1, padding=1), ConvBNLayer(in_c, 192, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = concat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], axis=1)
        bd = self.branch3x3dbl_1(x)
        bd = concat([self.branch3x3dbl_2a(bd), self.branch3x3dbl_2b(bd)], axis=1)
        return concat([self.branch1x1(x), b3, bd, self.branch_pool(x)], axis=1)


class InceptionV3(nn.Layer):
    @built_on_meta
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.inception_stem = nn.Sequential(
            ConvBNLayer(3, 32, 3, stride=2),
            ConvBNLayer(32, 32, 3),
            ConvBNLayer(32, 64, 3, padding=1),
            nn.MaxPool2D(3, stride=2),
            ConvBNLayer(64, 80, 1),
            ConvBNLayer(80, 192, 3),
            nn.MaxPool2D(3, stride=2))
        self.inception_block_list = nn.Sequential(
            InceptionA(192, 32), InceptionA(256, 64), InceptionA(288, 64),
            InceptionB(288),
            InceptionC(768, 128), InceptionC(768, 160), InceptionC(768, 160),
            InceptionC(768, 192),
            InceptionD(768),
            InceptionE(1280), InceptionE(2048))
        if with_pool:
            self.avg_pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.2)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.inception_stem(x)
        x = self.inception_block_list(x)
        if self.with_pool:
            x = self.avg_pool(x)
        if self.num_classes > 0:
            x = F.flatten(x, 1)
            x = self.fc(self.dropout(x))
        return x


def inception_v3(pretrained=False, **kwargs):
    return InceptionV3(**kwargs)
