"""DenseNet (port of paddle_tpu/vision/models/densenet.py)."""

from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ...nn.common import built_on_meta
from ...nn.functional import concat

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]


class DenseLayer(nn.Layer):
    def __init__(self, num_input_features, growth_rate, bn_size, drop_rate):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(num_input_features)
        self.relu1 = nn.ReLU()
        self.conv1 = nn.Conv2D(num_input_features, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.relu2 = nn.ReLU()
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.drop_rate = drop_rate
        if drop_rate > 0:
            self.dropout = nn.Dropout(drop_rate)

    def forward(self, x):
        out = self.conv1(self.relu1(self.norm1(x)))
        out = self.conv2(self.relu2(self.norm2(out)))
        if self.drop_rate > 0:
            out = self.dropout(out)
        return concat([x, out], axis=1)


class DenseBlock(nn.Layer):
    def __init__(self, num_layers, num_input_features, bn_size, growth_rate,
                 drop_rate):
        super().__init__()
        self.layers = nn.LayerList([
            DenseLayer(num_input_features + i * growth_rate, growth_rate,
                       bn_size, drop_rate)
            for i in range(num_layers)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class Transition(nn.Sequential):
    def __init__(self, num_input_features, num_output_features):
        super().__init__(
            nn.BatchNorm2D(num_input_features), nn.ReLU(),
            nn.Conv2D(num_input_features, num_output_features, 1,
                      bias_attr=False),
            nn.AvgPool2D(2, stride=2))


_LAYER_CFG = {
    121: (32, [6, 12, 24, 16], 64),
    161: (48, [6, 12, 36, 24], 96),
    169: (32, [6, 12, 32, 32], 64),
    201: (32, [6, 12, 48, 32], 64),
    264: (32, [6, 12, 64, 48], 64),
}


class DenseNet(nn.Layer):
    @built_on_meta
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        growth_rate, block_config, num_init_features = _LAYER_CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.conv1 = nn.Sequential(
            nn.Conv2D(3, num_init_features, 7, stride=2, padding=3,
                      bias_attr=False),
            nn.BatchNorm2D(num_init_features), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1))

        blocks = []
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            blocks.append(DenseBlock(num_layers, num_features, bn_size,
                                     growth_rate, dropout))
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                blocks.append(Transition(num_features, num_features // 2))
                num_features //= 2
        self.blocks = nn.Sequential(*blocks)
        self.norm_final = nn.BatchNorm2D(num_features)
        self.relu_final = nn.ReLU()
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(num_features, num_classes)

    def forward(self, x):
        x = self.conv1(x)
        x = self.blocks(x)
        x = self.relu_final(self.norm_final(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = F.flatten(x, 1)
            x = self.classifier(x)
        return x


def _densenet(layers, **kwargs):
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, **kwargs)
