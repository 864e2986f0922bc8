"""ShuffleNetV2 (port of paddle_tpu/vision/models/shufflenetv2.py)."""

from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ...nn.common import built_on_meta
from ...nn.functional import concat, split

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]


def _act(name):
    return nn.Swish() if name == "swish" else nn.ReLU()


class ConvBNAct(nn.Sequential):
    def __init__(self, in_c, out_c, kernel_size, stride=1, groups=1,
                 act="relu"):
        padding = (kernel_size - 1) // 2
        layers = [
            nn.Conv2D(in_c, out_c, kernel_size, stride=stride,
                      padding=padding, groups=groups, bias_attr=False),
            nn.BatchNorm2D(out_c),
        ]
        if act is not None:
            layers.append(_act(act))
        super().__init__(*layers)


class InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, act="relu"):
        super().__init__()
        self.stride = stride
        branch_c = out_c // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                ConvBNAct(branch_c, branch_c, 1, act=act),
                ConvBNAct(branch_c, branch_c, 3, stride=stride,
                          groups=branch_c, act=None),
                ConvBNAct(branch_c, branch_c, 1, act=act))
        else:
            self.branch1 = nn.Sequential(
                ConvBNAct(in_c, in_c, 3, stride=stride, groups=in_c,
                          act=None),
                ConvBNAct(in_c, branch_c, 1, act=act))
            self.branch2 = nn.Sequential(
                ConvBNAct(in_c, branch_c, 1, act=act),
                ConvBNAct(branch_c, branch_c, 3, stride=stride,
                          groups=branch_c, act=None),
                ConvBNAct(branch_c, branch_c, 1, act=act))
        self.shuffle = nn.ChannelShuffle(2)

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = split(x, 2, axis=1)
            out = concat([x1, self.branch2(x2)], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return self.shuffle(out)


_STAGE_CFG = {
    0.25: [24, 24, 48, 96, 512],
    0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024],
    1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024],
    2.0: [24, 244, 488, 976, 2048],
}
_REPEATS = [4, 8, 4]


class ShuffleNetV2(nn.Layer):
    @built_on_meta
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        channels = _STAGE_CFG[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.conv1 = ConvBNAct(3, channels[0], 3, stride=2, act=act)
        self.max_pool = nn.MaxPool2D(3, stride=2, padding=1)

        blocks = []
        in_c = channels[0]
        for stage_i, rep in enumerate(_REPEATS):
            out_c = channels[stage_i + 1]
            for i in range(rep):
                blocks.append(InvertedResidual(in_c, out_c,
                                               stride=2 if i == 0 else 1,
                                               act=act))
                in_c = out_c
        self.blocks = nn.Sequential(*blocks)
        self.conv_last = ConvBNAct(in_c, channels[-1], 1, act=act)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(channels[-1], num_classes)

    def forward(self, x):
        x = self.max_pool(self.conv1(x))
        x = self.blocks(x)
        x = self.conv_last(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = F.flatten(x, 1)
            x = self.fc(x)
        return x


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.25, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.33, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.5, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.5, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=2.0, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, act="swish", **kwargs)
