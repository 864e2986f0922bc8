"""Containers: port of ``paddle_tpu/nn/layer/container.py`` over torch's.

``Sequential`` takes layers (children ``"0"``, ``"1"``, ...), ``(name,
layer)`` pairs or an ``OrderedDict``, and a slice of it is a
``Sequential``; ``LayerList``, ``ParameterList`` and ``LayerDict`` are
torch's ``ModuleList``, ``ParameterList`` and ``ModuleDict``, which
name their children as the reference does.  The child names are the
reference's, so the weight bridge pairs parameters by name.
"""

from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(nn.Sequential):
    def __init__(self, *layers):
        if layers and isinstance(layers[0], (list, tuple)) \
                and len(layers[0]) == 2 and isinstance(layers[0][0], str):
            layers = (OrderedDict(layers),)
        super().__init__(*layers)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)


LayerList = nn.ModuleList
ParameterList = nn.ParameterList
LayerDict = nn.ModuleDict
