"""Normalization layers.

- ``RMSNorm`` (port of ``paddle_tpu/nn/layer/norm.py:113`` over
  ``nn/functional/norm.py:50``): the weight is a ``[hidden]`` parameter
  initialised to ones, and the forward is ``ops.rms_norm.rms_norm`` (the
  CUDA kernel on the card, the plain version on the CPU), its inputs
  cast by the AMP rule under the op name ``rms_norm``.
- ``LayerNorm`` (``nn/layer/norm.py:91`` over ``nn/functional/norm.py:27``):
  ``weight`` ones and ``bias`` zeros over ``normalized_shape`` (either
  left out with ``weight_attr=False``/``bias_attr=False``), the forward
  ``nn.functional.layer_norm`` (plain torch math in float32: no kernel
  in the JAX package either).
"""

from __future__ import annotations

import torch
from torch import nn

from ..amp.auto_cast import cast as _amp_cast
from ..ops.rms_norm import rms_norm
from .functional import layer_norm


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = _amp_cast("rms_norm", x, self.weight)
        return rms_norm(x, w, self.epsilon)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = float(epsilon)
        fac = dict(device=device, dtype=dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(self._normalized_shape, **fac))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(self._normalized_shape, **fac))

    def reset_parameters(self):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={list(self._normalized_shape)}"
