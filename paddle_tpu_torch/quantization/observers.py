"""The weight-quantization rule of the port: a copy of
``absmax_to_scales`` (:16), ``quantize_channelwise`` (:29) and
``PerChannelAbsmaxObserver`` (:103) of
``paddle_tpu/quantization/observers.py``, on torch tensors.

Every step is the JAX package's in the same order and in float32: the
epsilon floor lands on the absmax BEFORE the divide, and ``torch.round``
rounds half to even like ``jnp.round``, so the port's codes and scales
equal the JAX package's bit for bit, on the CPU and on the card alike.
"""

from __future__ import annotations

import torch


def _qmax(bit_length: int) -> float:
    return float(2 ** (bit_length - 1) - 1)


def absmax_to_scales(absmax, bit_length: int = 8) -> torch.Tensor:
    """THE quant rule: ``scale = max(absmax, 1e-9) / qmax`` with
    ``qmax = 2**(bits-1) - 1`` (127 for int8, 7 for int4), in float32.
    Composing it with an observer's already-floored ``scales()`` is
    idempotent."""
    a = torch.clamp_min(torch.as_tensor(absmax, dtype=torch.float32), 1e-9)
    # a true division by a tensor: CUDA divides by a Python scalar as a
    # product with its reciprocal, which is not the same float
    return a / torch.full_like(a, _qmax(bit_length))


def quantize_channelwise(w, scales, bit_length: int = 8,
                         quant_axis: int = -1) -> torch.Tensor:
    """Codes for ``w`` against per-channel ``scales`` along
    ``quant_axis``: ``clip(round(w / scale), -qmax, qmax)`` as int8 (int4
    codes also ride in an int8 container, range [-7, 7])."""
    qmax = _qmax(bit_length)
    w = torch.as_tensor(w).float()
    axis = quant_axis % w.ndim
    shape = [1] * w.ndim
    shape[axis] = -1
    s = torch.as_tensor(scales, dtype=torch.float32,
                        device=w.device).reshape(shape)
    return torch.clamp(torch.round(w / s), -qmax, qmax).to(torch.int8)


class PerChannelAbsmaxObserver:
    """Running per-channel absmax along ``quant_axis``; ``scales()``
    returns the floored absmax (``max(absmax, 1e-9)``), which
    ``absmax_to_scales`` turns into quantization scales."""

    def __init__(self, quant_axis: int = -1, bit_length: int = 8):
        self._axis = quant_axis
        self._bits = bit_length
        self._absmax = None

    def bit_length(self) -> int:
        return self._bits

    def quant_axis(self) -> int:
        return self._axis

    def observe(self, x: torch.Tensor):
        axis = self._axis % x.ndim
        reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
        cur = torch.amax(x.detach().float().abs(), dim=reduce_axes)
        self._absmax = cur if self._absmax is None \
            else torch.maximum(self._absmax, cur)

    def forward(self, x):
        self.observe(x)
        return x

    __call__ = forward

    def scales(self) -> torch.Tensor:
        return torch.clamp_min(self._absmax, 1e-9)
