"""GoogLeNet / Inception-v1 (analogue of
python/paddle/vision/models/googlenet.py)."""

from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ...nn.common import built_on_meta
from ...nn.functional import concat

__all__ = ["GoogLeNet", "googlenet"]


class ConvBlock(nn.Sequential):
    def __init__(self, in_channels, out_channels, **kwargs):
        super().__init__(
            nn.Conv2D(in_channels, out_channels, bias_attr=False, **kwargs),
            nn.BatchNorm2D(out_channels),
            nn.ReLU())


class Inception(nn.Layer):
    def __init__(self, in_channels, ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5,
                 pool_proj):
        super().__init__()
        self.branch1 = ConvBlock(in_channels, ch1x1, kernel_size=1)
        self.branch2 = nn.Sequential(
            ConvBlock(in_channels, ch3x3red, kernel_size=1),
            ConvBlock(ch3x3red, ch3x3, kernel_size=3, padding=1))
        self.branch3 = nn.Sequential(
            ConvBlock(in_channels, ch5x5red, kernel_size=1),
            ConvBlock(ch5x5red, ch5x5, kernel_size=3, padding=1))
        self.branch4 = nn.Sequential(
            nn.MaxPool2D(3, stride=1, padding=1),
            ConvBlock(in_channels, pool_proj, kernel_size=1))

    def forward(self, x):
        return concat([self.branch1(x), self.branch2(x), self.branch3(x),
                       self.branch4(x)], axis=1)


class GoogLeNet(nn.Layer):
    @built_on_meta
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.conv1 = ConvBlock(3, 64, kernel_size=7, stride=2, padding=3)
        self.maxpool1 = nn.MaxPool2D(3, stride=2, padding=1)
        self.conv2 = ConvBlock(64, 64, kernel_size=1)
        self.conv3 = ConvBlock(64, 192, kernel_size=3, padding=1)
        self.maxpool2 = nn.MaxPool2D(3, stride=2, padding=1)

        self.inception3a = Inception(192, 64, 96, 128, 16, 32, 32)
        self.inception3b = Inception(256, 128, 128, 192, 32, 96, 64)
        self.maxpool3 = nn.MaxPool2D(3, stride=2, padding=1)
        self.inception4a = Inception(480, 192, 96, 208, 16, 48, 64)
        self.inception4b = Inception(512, 160, 112, 224, 24, 64, 64)
        self.inception4c = Inception(512, 128, 128, 256, 24, 64, 64)
        self.inception4d = Inception(512, 112, 144, 288, 32, 64, 64)
        self.inception4e = Inception(528, 256, 160, 320, 32, 128, 128)
        self.maxpool4 = nn.MaxPool2D(3, stride=2, padding=1)
        self.inception5a = Inception(832, 256, 160, 320, 32, 128, 128)
        self.inception5b = Inception(832, 384, 192, 384, 48, 128, 128)

        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.2)
            self.fc = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.maxpool1(self.conv1(x))
        x = self.maxpool2(self.conv3(self.conv2(x)))
        x = self.inception3b(self.inception3a(x))
        x = self.maxpool3(x)
        x = self.inception4e(self.inception4d(self.inception4c(
            self.inception4b(self.inception4a(x)))))
        x = self.maxpool4(x)
        x = self.inception5b(self.inception5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = F.flatten(x, 1)
            x = self.fc(self.dropout(x))
        return x


def googlenet(pretrained=False, **kwargs):
    return GoogLeNet(**kwargs)
