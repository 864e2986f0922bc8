"""``RMSNorm`` layer (port of ``paddle_tpu/nn/layer/norm.py:113`` over
``nn/functional/norm.py:50``): the weight is a ``[hidden]`` parameter
initialised to ones, and the forward is ``ops.rms_norm.rms_norm`` (the
CUDA kernel on the card, the plain version on the CPU)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.rms_norm import rms_norm


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.epsilon)
