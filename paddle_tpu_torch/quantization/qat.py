"""QAT, the quantization-aware training driver: a copy of
``paddle_tpu/quantization/qat.py``.  ``quantize(model)`` swaps each
``Linear``/``Conv2D`` that the config quantizes for its fake-quantized
wrapper; ``convert(model)`` freezes the trained weights into the int8
inference layers (``_freeze``).

Layouts: a torch ``Linear`` weight is ``[out, in]``, so its channel-wise
weight quanter works along axis 0 where the reference's works along -1
of its ``[in, out]``; ``_freeze`` quantizes per output channel and
writes the codes transposed, ``[in, out]``, the reference's at-rest
plane byte for byte.  Layers match by type: ``torch.nn.Linear`` (the
port's ``nn.Linear`` and the models' projections) and the port's
``nn.Conv2D``.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..nn.conv import Conv2D
from ..nn.quant.quant_layers import (QuantedConv2D, QuantedLinear,
                                     QuantizedConv2DInfer,
                                     QuantizedLinearInfer)
from .config import QuantConfig
from .observers import absmax_to_scales, quantize_channelwise
from .quanters import FakeQuanterChannelWiseAbsMaxObserver


class QAT:
    def __init__(self, config: QuantConfig):
        self._config = config

    def _wrap(self, layer):
        act = self._config.activation_quanter_for(layer)
        weight = self._config.weight_quanter_for(layer)
        if act is None and weight is None:
            return None
        if isinstance(weight, FakeQuanterChannelWiseAbsMaxObserver) and \
                isinstance(layer, (nn.Linear, Conv2D)):
            # out-features of [out, in]; out-channels of [out, in, kh, kw]
            weight._axis = 0
        if isinstance(layer, nn.Linear):
            return QuantedLinear(layer, act, weight)
        if isinstance(layer, Conv2D):
            return QuantedConv2D(layer, act, weight)
        return None

    def quantize(self, model: nn.Module, inplace: bool = True) -> nn.Module:
        """Replace every quantizable sublayer with its QAT wrapper."""
        if not inplace:
            model = copy.deepcopy(model)
        self._quantize_rec(model)
        return model

    def _quantize_rec(self, layer: nn.Module):
        for name, sub in list(layer._modules.items()):
            wrapped = self._wrap(sub)
            if wrapped is not None:
                layer._modules[name] = wrapped
            else:
                self._quantize_rec(sub)

    def convert(self, model: nn.Module, inplace: bool = True) -> nn.Module:
        """Freeze a trained QAT model into the int8 inference form."""
        if not inplace:
            model = copy.deepcopy(model)
        self._convert_rec(model)
        return model

    def _convert_rec(self, layer: nn.Module):
        for name, sub in list(layer._modules.items()):
            if isinstance(sub, (QuantedLinear, QuantedConv2D)):
                layer._modules[name] = _freeze(sub)
            else:
                self._convert_rec(sub)


@torch.no_grad()
def _freeze(qlayer):
    """Per-output-channel scales from the weight's absmax
    (``absmax_to_scales``), the weight quantized to int8 codes
    (``quantize_channelwise``), and the inference layer built around
    them, on the weight's device."""
    w = qlayer.weight.detach().float()
    bits = (qlayer.weight_quanter.bit_length()
            if qlayer.weight_quanter is not None else 8)
    act_scale = None
    if qlayer.activation_quanter is not None:
        act_scale = qlayer.activation_quanter.scales()

    if isinstance(qlayer, QuantedLinear):
        w_kn = w.t()                                      # [in, out]
        scales = absmax_to_scales(torch.amax(w_kn.abs(), dim=0), bits)
        qw = quantize_channelwise(w_kn, scales, bits, quant_axis=1)
        return QuantizedLinearInfer(
            qw.contiguous(), scales, qlayer.bias,
            qlayer._float_layer.in_features,
            qlayer._float_layer.out_features, act_scale, bits)

    reduce_axes = tuple(range(1, w.ndim))             # [out, in, kh, kw]
    scales = absmax_to_scales(torch.amax(w.abs(), dim=reduce_axes), bits)
    qw = quantize_channelwise(w, scales, bits, quant_axis=0)
    conv_args = (qlayer._stride, qlayer._padding, qlayer._dilation,
                 qlayer._groups, qlayer._data_format)
    return QuantizedConv2DInfer(qw, scales, qlayer.bias, conv_args,
                                act_scale, bits)
