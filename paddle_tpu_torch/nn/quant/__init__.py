"""Quantization-aware layers (``paddle_tpu/nn/quant/``): the QAT
wrappers ``QuantedLinear``/``QuantedConv2D`` and the converted int8
inference layers ``QuantizedLinearInfer``/``QuantizedConv2DInfer``."""

from .quant_layers import (QuantedConv2D, QuantedLinear,  # noqa: F401
                           QuantizedConv2DInfer, QuantizedLinearInfer,
                           QuantStub)

__all__ = ["QuantedLinear", "QuantedConv2D", "QuantizedLinearInfer",
           "QuantizedConv2DInfer", "QuantStub"]
