"""``TrainStep``: one training step (forward, backward, gradient clip and
AdamW update) per call.

Port of ``paddle_tpu/jit/train_step.py``: ``_functional_adam`` with
``decoupled=True`` (:151-180), ``TrainStep.__init__`` and
``_select_update`` for AdamW (:237-292), ``_init_state`` (:357-379), the
step body with ``accumulate_steps == 1`` (:433-507) and ``__call__``
(:637-669).  The JAX package traces the step into one XLA program with
donated buffers; here it runs eagerly, and the update writes the
parameters and moments in place under ``torch.no_grad()`` (the
counterpart of donation).

The update is the JAX package's, trap for trap:
- weight decay applies to EVERY parameter (norms and embeddings too;
  ``apply_decay_param_fun`` is not read), to the fp32 copy of p BEFORE
  the moment update: ``p <- p * (1 - lr * wd)``;
- no master weights: ``p_new`` is computed in fp32 and cast back to the
  parameter's dtype;
- moments are fp32 (``multi_precision=True``, or float32 parameters);
  bf16 moments by stochastic rounding (``multi_precision=False`` on
  bf16 parameters) are not ported;
- the step count ``t`` is an fp32 scalar; bias correction ``1 - beta**t``;
- global-norm clipping sums fp32 squares, ``scale = cn / max(|g|, cn)``,
  applied as ``g * scale.to(g.dtype)``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..optimizer import AdamW, Optimizer

_TRAINING = "(ROADMAP.md, Queue 1: training)"


def _functional_adam(p, g, state, lr, hp):
    """One AdamW update of parameter ``p`` with gradient ``g``, in place:
    p, ``state["m"]`` and ``state["v"]`` are overwritten and
    ``state["t"]`` advances.  ``lr`` is an fp32 scalar tensor."""
    gf = g.float()
    pf = p.float()
    b1, b2, eps, wd = hp["beta1"], hp["beta2"], hp["epsilon"], hp["wd"]
    pf = pf * (1.0 - lr * wd)                 # decoupled decay, first
    t = state["t"] + 1
    m = state["m"].mul_(b1).add_((1 - b1) * gf)
    v = state["v"].mul_(b2).add_((1 - b2) * gf * gf)
    m_hat = m / (1 - torch.pow(b1, t))
    v_hat = v / (1 - torch.pow(b2, t))
    p.copy_((pf - lr * m_hat / (torch.sqrt(v_hat) + eps)).to(p.dtype))
    state["t"] = t


def _as_input(x, device):
    """A batch input on the model's device: numpy arrays become tensors
    (as ``jnp.asarray`` in the JAX package); tensors are moved."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


class TrainStep:
    def __init__(self, model, loss_fn: Callable, optimizer: Optimizer,
                 mesh=None, in_shardings=None, donate: bool = True,
                 accumulate_steps: int = 1, accumulate_avg: bool = True):
        """``loss_fn(net, *inputs)`` returns the scalar loss, or a tuple
        whose first entry is the loss (the rest come back as aux).  The
        step runs on the device of the model's parameters."""
        if accumulate_steps < 1:
            raise ValueError(
                f"accumulate_steps must be >= 1, got {accumulate_steps}")
        if accumulate_steps != 1:
            raise NotImplementedError(
                f"TrainStep(accumulate_steps={accumulate_steps}) (gradient "
                f"merge) is not ported {_TRAINING}")
        if mesh is not None or in_shardings is not None:
            raise NotImplementedError(
                "TrainStep over a mesh (sharding, ZeRO) is not ported "
                "(ROADMAP.md, Queue 1: distributed)")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._params = [p for p in model.parameters() if p.requires_grad]
        if not self._params:
            raise ValueError("TrainStep: the model has no trainable "
                             "parameters")
        self._device = self._params[0].device
        self._update_fn, self._hypers = self._select_update(optimizer)
        clip = optimizer._grad_clip
        if clip is not None and not hasattr(clip, "clip_norm"):
            raise NotImplementedError(
                f"TrainStep: only global-norm clipping is ported, got "
                f"{type(clip).__name__} {_TRAINING}")
        if not self._hypers["multi_precision"] and any(
                p.dtype == torch.bfloat16 for p in self._params):
            raise NotImplementedError(
                "AdamW(multi_precision=False) on bfloat16 parameters keeps "
                "bf16 moments by stochastic rounding, which is not ported "
                "(it comes with the fused AdamW kernel; ROADMAP.md, Queue "
                "1: training)")
        self._state = None

    def _select_update(self, opt):
        if isinstance(opt, AdamW):
            return _functional_adam, {
                "beta1": opt._beta1, "beta2": opt._beta2,
                "epsilon": opt._epsilon, "wd": opt._weight_decay,
                "multi_precision": opt._multi_precision}
        raise NotImplementedError(
            f"TrainStep with {type(opt).__name__}: only AdamW is ported "
            f"(SGD, Momentum and Adam are not) {_TRAINING}")

    def _init_state(self):
        """fp32 moments and an fp32 step count per parameter."""
        return [{"m": torch.zeros_like(p, dtype=torch.float32),
                 "v": torch.zeros_like(p, dtype=torch.float32),
                 "t": torch.zeros((), dtype=torch.float32,
                                  device=p.device)}
                for p in self._params]

    def _apply_update(self, grads, lr):
        clip = self.optimizer._grad_clip
        if clip is not None:
            gsq = sum(g.float().square().sum() for g in grads)
            gnorm = torch.sqrt(gsq)
            cn = clip.clip_norm
            scale = cn / torch.clamp(gnorm, min=cn)
            grads = [g * scale.to(g.dtype) for g in grads]
        for p, g, s in zip(self._params, grads, self._state):
            self._update_fn(p, g, s, lr, self._hypers)

    def run_steps(self, *inputs, steps: int):
        raise NotImplementedError(
            f"TrainStep.run_steps (several steps in one compiled call) is "
            f"not ported: call the step {steps} times {_TRAINING}")

    def __call__(self, *inputs):
        if self._state is None:
            self._state = self._init_state()
        out = self.loss_fn(self.model,
                           *[_as_input(x, self._device) for x in inputs])
        loss = out[0] if isinstance(out, tuple) else out
        aux = out[1:] if isinstance(out, tuple) else ()
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self._params, grads)]
            lr = torch.tensor(self.optimizer.get_lr(), dtype=torch.float32,
                              device=self._device)
            self._apply_update(grads, lr)
        loss = loss.detach()
        if aux:
            return (loss,) + tuple(a.detach() if isinstance(a, torch.Tensor)
                                   else a for a in aux)
        return loss
