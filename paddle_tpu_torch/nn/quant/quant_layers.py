"""QAT wrapper layers and converted int8 inference layers: a copy of
``paddle_tpu/nn/quant/quant_layers.py`` on torch tensors.

``QuantedLinear``/``QuantedConv2D`` wrap a float layer with weight and
activation fake-quanters during QAT; ``QuantizedLinearInfer``/
``QuantizedConv2DInfer`` are the converted inference forms, holding int8
codes and float32 per-output-channel scales as buffers.

At-rest layout: ``QuantizedLinearInfer.qweight`` is the reference's
``[in, out]`` int8 plane, the quantized-matmul kernel's ``[K, N]``
codes, and ``weight_scale`` is ``[out]`` float32, so a converted
layer's buffers equal the JAX package's byte for byte although a torch
``Linear.weight`` is ``[out, in]``.

``QuantizedLinearInfer.forward`` reads ``FLAGS_use_int8_matmul_kernel``
at every call (``quant_layers.py:98-157``):
- off (the default): the codes dequantized into x's dtype and a plain
  ``linear``, the reference's XLA route;
- on: the quantized-matmul kernel (``ops.quantized_matmul``; its plain
  version for CPU tensors), the bias added after it, differentiable in
  x; with an activation folded in by ``fuse_act_into_quant_linear``,
  the kernel's bias+act epilogue, inference only.  A fused layer fed an
  x that requires grad under grad mode takes the differentiable dequant
  route instead, as the reference decides before any launch.
The reference's route gate (its ``max_m`` cap, ``rows_below_min``, the
``% 128`` geometry and the ``pallas.quantized_matmul.route`` counter) is
not ported: on the card the kernel takes every shape it accepts and
raises on any other (ROADMAP.md, Known differences of quantization).
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.flags import flag
from ...ops.quantized_matmul import quantized_matmul
from .. import functional as F


class QuantStub(nn.Module):
    """Marks an activation quantization point; holds the act quanter."""

    def __init__(self, quanter):
        super().__init__()
        self.quanter = quanter

    def forward(self, x):
        return self.quanter(x) if self.quanter is not None else x


class QuantedLinear(nn.Module):
    """Linear with fake-quantized weight and (optionally) activation.  The
    float layer is kept unregistered: its weight and bias are registered
    on this wrapper and must not appear twice in ``parameters()``."""

    def __init__(self, layer, act_quanter=None, weight_quanter=None):
        super().__init__()
        object.__setattr__(self, "_float_layer", layer)
        self.weight = layer.weight
        self.bias = layer.bias
        self.activation_quanter = act_quanter
        self.weight_quanter = weight_quanter

    def forward(self, x):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        w = self.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        return F.linear(x, w, self.bias)


class QuantedConv2D(nn.Module):
    def __init__(self, layer, act_quanter=None, weight_quanter=None):
        super().__init__()
        object.__setattr__(self, "_float_layer", layer)
        self.weight = layer.weight
        self.bias = layer.bias
        self._stride = layer.stride
        self._padding = layer.padding
        self._dilation = layer.dilation
        self._groups = layer.groups
        self._data_format = layer.data_format
        self.activation_quanter = act_quanter
        self.weight_quanter = weight_quanter

    def forward(self, x):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        w = self.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        return F.conv2d(x, w, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


def _dequant(qw, scale, axis, dtype=torch.float32):
    """The dequantized weight in ``dtype``: each code times its channel's
    scale as one float32 product, rounded once to ``dtype`` (the
    reference's ``(q.astype(f32) * s).astype(dtype)``), written in one
    pass with no float32 copy of the weight."""
    shape = [1] * qw.ndim
    shape[axis % qw.ndim] = -1
    w = torch.empty(qw.shape, dtype=dtype, device=qw.device)
    return torch.mul(qw, scale.float().reshape(shape), out=w)


# the reference's dequant-route epilogues: GELU in its tanh form, so an
# output does not depend on the route its layer took
_ACTS = {"gelu": lambda t: F.gelu(t, True), "relu": F.relu,
         "silu": F.silu}


class QuantizedLinearInfer(nn.Module):
    """Converted inference Linear: int8 codes ``qweight [in, out]`` and
    per-output-channel scales ``weight_scale [out]`` (buffers), the float
    layer's bias (a parameter)."""

    def __init__(self, qweight, scales, bias, in_features, out_features,
                 act_scale=None, bits=8):
        super().__init__()
        self.register_buffer("qweight", qweight)
        self.register_buffer("weight_scale", scales)
        self.bias = bias
        self.in_features = in_features
        self.out_features = out_features
        self._act_scale = act_scale
        self._bits = bits
        # a following activation folded into the kernel epilogue by
        # quantization.fuse_act_into_quant_linear ("gelu"/"relu"/"silu");
        # the fused form is inference-only
        self._fused_act = None

    @classmethod
    def empty_like(cls, lin, bits=8, fused_act=None):
        """A converted layer of ``torch.nn.Linear`` ``lin``'s shape and
        device with empty ``[in, out]`` int8 codes and ``[out]`` float32
        scales, to be filled from a state dict; it keeps ``lin``'s bias
        parameter."""
        dev = lin.weight.device
        q = cls(torch.empty((lin.in_features, lin.out_features),
                            dtype=torch.int8, device=dev),
                torch.empty((lin.out_features,), dtype=torch.float32,
                            device=dev),
                lin.bias, lin.in_features, lin.out_features, bits=bits)
        q._fused_act = fused_act
        return q

    def extra_repr(self):
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bits={self._bits}, fused_act="
                f"{self._fused_act}")

    def forward(self, x):
        fused_act = self._fused_act
        use_kernel = flag("use_int8_matmul_kernel")
        if fused_act and x.requires_grad and torch.is_grad_enabled():
            # the fused epilogue has no backward: the differentiable
            # dequant route keeps the graph (the same math)
            use_kernel = False
        if use_kernel:
            if fused_act:
                bias = None if self.bias is None else self.bias.detach()
                return quantized_matmul(x, self.qweight, self.weight_scale,
                                        bias=bias, act=fused_act)
            out = quantized_matmul(x, self.qweight, self.weight_scale)
            if self.bias is not None:
                out = out + self.bias.to(out.dtype)
            return out
        # dequantize INTO the activation dtype, then the plain product
        w = _dequant(self.qweight, self.weight_scale, -1, x.dtype)
        out = F.linear(x, w.t(), self.bias)
        return _ACTS[fused_act](out) if fused_act else out


def holds_int8_layers(model) -> bool:
    """Whether ``model`` holds a ``QuantizedLinearInfer``, whose route
    ``FLAGS_use_int8_matmul_kernel`` picks at every call (a captured
    graph records one of them)."""
    return any(isinstance(m, QuantizedLinearInfer) for m in model.modules())


class QuantizedConv2DInfer(nn.Module):
    """Converted inference Conv2D: int8 codes ``[out, in, kh, kw]`` and
    per-output-channel scales, dequantized to float32 for the port's
    ``conv2d``."""

    def __init__(self, qweight, scales, bias, conv_args, act_scale=None,
                 bits=8):
        super().__init__()
        self.register_buffer("qweight", qweight)
        self.register_buffer("weight_scale", scales)
        self.bias = bias
        (self._stride, self._padding, self._dilation, self._groups,
         self._data_format) = conv_args
        self._act_scale = act_scale
        self._bits = bits

    def forward(self, x):
        w = _dequant(self.qweight, self.weight_scale, 0)
        return F.conv2d(x, w, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)
