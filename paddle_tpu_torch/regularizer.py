"""Weight-decay regularizers: port of ``paddle_tpu/regularizer.py``.

``L1Decay`` and ``L2Decay`` carry ``coeff`` (and ``_coeff``, which the
optimizers read) and are accepted as an optimizer's or a parameter
group's ``weight_decay``.  The eager ``Optimizer.step`` applies them to
the gradient before the update: L1 through ``__call__`` (``grad + coeff
* sign(param)``), L2 as the coupled ``grad + coeff * param`` (decoupled
for ``AdamW``), as the JAX package does.
"""

from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    """Base class.  ``__call__(grad, param) -> regularized grad``."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)
        self._coeff = float(coeff)  # alias the optimizer reads

    def __call__(self, grad, param):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L1Decay(WeightDecayRegularizer):
    """L1 weight decay: ``grad + coeff * sign(param)``."""

    _is_l1 = True

    def __call__(self, grad, param):
        if not self.coeff:
            return grad
        c = torch.tensor(self.coeff, dtype=grad.dtype, device=grad.device)
        return grad + c * torch.sign(param).to(grad.dtype)


class L2Decay(WeightDecayRegularizer):
    """L2 weight decay: ``grad + coeff * param``."""

    _is_l1 = False

    def __call__(self, grad, param):
        if not self.coeff:
            return grad
        c = torch.tensor(self.coeff, dtype=grad.dtype, device=grad.device)
        return grad + c * param.to(grad.dtype)
