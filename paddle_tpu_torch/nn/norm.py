"""``RMSNorm`` layer (port of ``paddle_tpu/nn/layer/norm.py:113`` over
``nn/functional/norm.py:50``): the weight is a ``[hidden]`` parameter
initialised to ones, and the forward is ``ops.rms_norm.rms_norm`` (the
CUDA kernel on the card, the plain version on the CPU), its inputs
cast by the AMP rule under the op name ``rms_norm``."""

from __future__ import annotations

import torch
from torch import nn

from ..amp.auto_cast import cast as _amp_cast
from ..ops.rms_norm import rms_norm


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
