"""Optimizers of the port: the ``Optimizer`` base and ``AdamW``.

Port of ``paddle_tpu/optimizer/optimizer.py:24-79`` and
``paddle_tpu/optimizer/__init__.py:106-180``: the hyperparameters and
``get_lr``.  The update itself runs in ``jit.TrainStep`` (as the JAX
package's compiled step does); the eager ``step()``, LR schedulers,
``lr_ratio`` and the other optimizers are not ported yet.
"""

from __future__ import annotations

_TRAINING = "(ROADMAP.md, Queue 1: training)"


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                f"learning_rate must be a float: LR schedulers are not "
                f"ported {_TRAINING}")
        if weight_decay is not None and \
                not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                f"weight_decay must be a float: regularizer objects are not "
                f"ported {_TRAINING}")
        self._learning_rate = float(learning_rate)
        self._parameters = None if parameters is None else list(parameters)
        self._weight_decay = float(weight_decay or 0.0)
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)

    def get_lr(self) -> float:
        return self._learning_rate

    def step(self):
        raise NotImplementedError(
            f"the eager optimizer step is not ported: train with "
            f"paddle_tpu_torch.jit.TrainStep {_TRAINING}")


class AdamW(Optimizer):
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
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._apply_decay_param_fun = apply_decay_param_fun
