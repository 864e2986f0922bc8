"""Fake quanters (QDQ with straight-through gradients): a copy of
``paddle_tpu/quantization/quanters.py`` on torch tensors —
``quantize_tensor`` (:22), ``dequantize_tensor`` (:39), ``fake_quant``
(:51), ``BaseQuanter`` (:69), ``FakeQuanterWithAbsMaxObserver`` (:84)
and ``FakeQuanterChannelWiseAbsMaxObserver`` (:125).

Each rule is the reference's, in its order and in float32, so a
quanter's scales and outputs equal the JAX package's bit for bit on the
same input: ``fake_quant`` floors the scale at ``1e-9`` BEFORE the
divide and returns ``a + (qdq - a)`` with the difference detached (the
straight-through estimator); the channel-wise weight quanter floors
AFTER the divide, ``max(absmax / qmax, 1e-9)``, which is not
``absmax_to_scales``' order.  Divisions are by tensors (CUDA divides by
a Python scalar as a product with its reciprocal) and ``torch.round``
rounds half to even like ``jnp.round``.  Quanters follow their input's
device.
"""

from __future__ import annotations

import torch
from torch import nn


def _qrange(bits: int):
    qmax = float(2 ** (bits - 1) - 1)
    return -qmax, qmax


def _along(s: torch.Tensor, ndim: int, axis):
    if axis is None:
        return s
    shape = [1] * ndim
    shape[axis] = -1
    return s.reshape(shape)


def quantize_tensor(x, scale, bits: int = 8, axis=None) -> torch.Tensor:
    """real -> int: ``round(x / scale)`` clipped to the signed range, int8
    (int32 past 8 bits); no gradient."""
    qmin, qmax = _qrange(bits)
    a = x.detach()
    s = _along(torch.as_tensor(scale, device=a.device).detach(), a.ndim,
               axis)
    q = torch.clamp(torch.round(a / s), qmin, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int32)


def dequantize_tensor(q, scale, axis=None) -> torch.Tensor:
    """int -> real: ``q * scale`` in float32; no gradient."""
    s = _along(torch.as_tensor(scale, device=q.device).detach(), q.ndim,
               axis)
    return q.detach().float() * s


def fake_quant(x, scale, bits: int = 8, axis=None) -> torch.Tensor:
    """QDQ with the straight-through estimator: the gradient of
    round/clip is the identity (``x + stop_gradient(qdq(x) - x)``); the
    scale takes none."""
    qmin, qmax = _qrange(bits)
    sf = torch.as_tensor(scale, device=x.device).detach().float()
    sf = _along(torch.clamp_min(sf, 1e-9), x.ndim, axis)
    qdq = torch.clamp(torch.round(x.detach() / sf), qmin, qmax) * sf
    return x + (qdq - x.detach().to(qdq.dtype)).to(x.dtype)


class BaseQuanter(nn.Module):
    """A quanter is a layer inserted into the model; calling it
    fake-quants its input and (in training) updates its statistics."""

    def scales(self):
        raise NotImplementedError

    def quant_axis(self):
        return None

    def bit_length(self):
        return self._bits


class FakeQuanterWithAbsMaxObserver(BaseQuanter):
    """Per-tensor moving-average absmax fake quanter (activation
    quanter).  In training mode the ``scale`` buffer takes the EMA of
    each batch's absmax (the first batch's absmax itself), updated in
    place without gradient; in eval mode the stored scale is used.  The
    stored scale is the absmax; the QDQ step is ``scale / qmax``."""

    def __init__(self, moving_rate: float = 0.9, bit_length: int = 8,
                 **kwargs):
        super().__init__()
        self._moving_rate = moving_rate
        self._bits = bit_length
        self.register_buffer("scale", torch.ones((), dtype=torch.float32))
        self.register_buffer("_initialized",
                             torch.zeros((), dtype=torch.bool))

    def scales(self):
        return self.scale

    def forward(self, x):
        if self.scale.device != x.device:
            self.to(x.device)
        if self.training:
            with torch.no_grad():
                f32 = dict(dtype=torch.float32, device=x.device)
                cur = torch.clamp_min(torch.amax(x.detach().float().abs()),
                                      1e-9)
                ema = (torch.tensor(self._moving_rate, **f32) * self.scale
                       + torch.tensor(1 - self._moving_rate, **f32) * cur)
                self.scale.copy_(torch.where(self._initialized, ema, cur))
                self._initialized.fill_(True)
        step = self.scale / torch.full_like(self.scale,
                                            _qrange(self._bits)[1])
        return fake_quant(x, step, bits=self._bits)


class FakeQuanterChannelWiseAbsMaxObserver(BaseQuanter):
    """Per-channel absmax fake quanter (weight quanter): the scale is the
    current weight's, every call (``max(absmax / qmax, 1e-9)`` along
    ``quant_axis``); the convert step snapshots the final scales."""

    def __init__(self, quant_axis: int = -1, bit_length: int = 8, **kwargs):
        super().__init__()
        self._axis = quant_axis
        self._bits = bit_length
        self._last_scale = None

    def quant_axis(self):
        return self._axis

    def scales(self):
        return self._last_scale

    def forward(self, w):
        axis = self._axis % w.ndim
        reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
        absmax = torch.amax(w.detach().float().abs(), dim=reduce_axes)
        scale = torch.clamp_min(
            absmax / torch.full_like(absmax, _qrange(self._bits)[1]), 1e-9)
        self._last_scale = scale
        return fake_quant(w, scale, bits=self._bits, axis=axis)
