"""Quantization, QAT and PTQ: the port of ``paddle_tpu/quantization``.

Fake quantization is quantize-dequantize (QDQ) with a straight-through
gradient, ``x + stop_gradient(dq(q(x)) - x)``; the converted inference
model carries int8 weights with per-channel scales
(``nn.quant.QuantizedLinearInfer``), served by a dequantize and a plain
product or, under ``FLAGS_use_int8_matmul_kernel``, by the
quantized-matmul kernel.  ``absmax_to_scales`` and
``quantize_channelwise`` are the one weight-quant rule, shared with the
serving engine's ``weight_dtype`` plans.
"""

from .config import QuantConfig
from .observers import (AbsmaxObserver, BaseObserver,
                        MovingAverageAbsmaxObserver,
                        PerChannelAbsmaxObserver, absmax_to_scales,
                        quantize_channelwise)
from .ptq import PTQ, fuse_act_into_quant_linear, weight_only_quantize
from .qat import QAT
from .quanters import (BaseQuanter, FakeQuanterChannelWiseAbsMaxObserver,
                       FakeQuanterWithAbsMaxObserver, dequantize_tensor,
                       fake_quant, quantize_tensor)

__all__ = [
    "QuantConfig", "QAT", "PTQ", "weight_only_quantize",
    "fuse_act_into_quant_linear",
    "BaseObserver", "AbsmaxObserver", "MovingAverageAbsmaxObserver",
    "PerChannelAbsmaxObserver", "absmax_to_scales", "quantize_channelwise",
    "BaseQuanter", "FakeQuanterWithAbsMaxObserver",
    "FakeQuanterChannelWiseAbsMaxObserver",
    "quantize_tensor", "dequantize_tensor", "fake_quant",
]
