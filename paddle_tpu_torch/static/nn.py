"""``paddle_tpu_torch.static.nn``: static-graph layer builders (≙
``paddle.static.nn``), port of ``paddle_tpu/static/nn.py``.

Each builder makes the ``nn`` layer eagerly, with its parameters on the
host (the startup program's role: an ``Executor`` moves every captured
parameter to its place at its first run), and applies it to the program
variable, so the layer's calls are recorded into the current Program.
"""

from __future__ import annotations

from ..nn import functional as F
from ..nn.common import Embedding, Linear
from ..nn.conv import Conv2D
from ..nn.norm import BatchNorm2D
from .control_flow import case, cond, switch_case, while_loop  # noqa: F401

__all__ = ["fc", "embedding", "conv2d", "batch_norm",
           "cond", "while_loop", "case", "switch_case"]

_HOST = "cpu"


def fc(x, size, num_flatten_dims=1, activation=None, name=None):
    out = Linear(x.shape[-1], size, device=_HOST)(x)
    if activation is not None:
        out = getattr(F, activation)(out)
    return out


def embedding(input, size, is_sparse=False, padding_idx=None, name=None):
    layer = Embedding(size[0], size[1], padding_idx=padding_idx,
                      device=_HOST)
    return layer(input)


def conv2d(input, num_filters, filter_size, stride=1, padding=0,
           activation=None, name=None):
    layer = Conv2D(input.shape[1], num_filters, filter_size, stride=stride,
                   padding=padding, device=_HOST)
    out = layer(input)
    if activation is not None:
        out = getattr(F, activation)(out)
    return out


def batch_norm(input, name=None):
    return BatchNorm2D(input.shape[1], device=_HOST)(input)
