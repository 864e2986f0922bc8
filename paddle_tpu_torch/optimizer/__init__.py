"""Optimizers of the port: the ``Optimizer`` base, ``SGD``, ``Momentum``,
``Adam`` and ``AdamW``, and the LR schedulers of ``lr``.

Port of ``paddle_tpu/optimizer/optimizer.py:24-80`` (hyperparameters,
``get_lr``/``set_lr`` over a float or an ``LRScheduler``) and
``paddle_tpu/optimizer/__init__.py:28-180`` (each optimizer's
hyperparameters; ``AdamW`` is an ``Adam``, as there).  The updates
themselves run in ``jit.TrainStep``, as the JAX package's compiled step
runs them; the eager ``step()``, ``lr_ratio``, regularizer objects and
the other optimizers are not ported yet.
"""

from __future__ import annotations

from . import lr  # noqa: F401
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr",
           "LRScheduler"]

_TRAINING = "(ROADMAP.md, Queue 1: training)"


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise NotImplementedError(
                f"learning_rate must be a float or an optimizer.lr "
                f"LRScheduler, got {type(learning_rate).__name__}: other "
                f"schedule objects are not ported {_TRAINING}")
        if weight_decay is not None and \
                not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                f"weight_decay must be a float: regularizer objects are not "
                f"ported {_TRAINING}")
        self._learning_rate = learning_rate
        self._parameters = None if parameters is None else list(parameters)
        self._weight_decay = float(weight_decay or 0.0)
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def step(self):
        raise NotImplementedError(
            f"the eager optimizer step is not ported: train with "
            f"paddle_tpu_torch.jit.TrainStep {_TRAINING}")


class SGD(Optimizer):
    """Plain SGD.  The train step ignores weight decay for it, as the JAX
    package's compiled step does."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)


class Momentum(Optimizer):
    """Heavy-ball (or Nesterov) momentum, velocity in the parameter's
    dtype.  The train step ignores weight decay, as the JAX package's
    compiled step does."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)


class Adam(Optimizer):
    """Adam; weight decay is coupled (added to the gradient as
    ``wd * p``).  ``lazy_mode`` and ``use_multi_tensor`` are accepted and
    ignored, as in the JAX package's compiled step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)


class AdamW(Adam):
    """Adam with decoupled weight decay.  As in the JAX package's compiled
    step, the decay applies to EVERY parameter (``apply_decay_param_fun``
    is kept but not read there) and ``lazy_mode`` is ignored."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError(f"AdamW(lr_ratio=...) is not ported "
                                      f"{_TRAINING}")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name=name)
        self._apply_decay_param_fun = apply_decay_param_fun
