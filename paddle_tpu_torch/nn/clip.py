"""Gradient clipping: port of ``paddle_tpu/nn/clip.py:13-120``.

The clip objects take ``[(param, grad), ...]`` and return the clipped
pairs; the eager ``Optimizer.step`` calls them.  A parameter with
``need_clip = False`` keeps its gradient.
- ``ClipGradByValue``: each element into ``[min, max]``;
- ``ClipGradByNorm``: each gradient scaled by ``min(clip_norm /
  max(|g|, 1e-12), 1)``;
- ``ClipGradByGlobalNorm``: every gradient scaled by ``clip_norm /
  max(norm, clip_norm)``, the norm over the fp32 squares of all of them.
Scales are fp32 and a low-precision gradient is scaled in fp32 and
rounded back, as JAX promotes it; ``clip_grad_norm_(norm_type=inf)``
takes its max and scale in the gradients' result dtype (bf16 over bf16
gradients), as JAX does.

``jit.TrainStep`` keeps the JAX package's compiled rule
(``paddle_tpu/jit/train_step.py:474-481``): a clip with a ``clip_norm``
(either norm clip) is applied as one global norm, ``g *
scale.to(g.dtype)``; a value clip is not applied there.
``group_name`` and ``auto_skip_clip`` are accepted and ignored.
``clip_grad_norm_`` and ``clip_grad_value_`` clip ``p.grad`` in place.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _scaled(g, scale):
    return (g.to(torch.float32) * scale).to(g.dtype)


def _over(num, den):
    """``num / den`` for a Python ``num``: a tensor divided by a tensor
    (``num / den`` would multiply by ``den``'s reciprocal)."""
    return torch.tensor(num, dtype=den.dtype, device=den.device) / den


def _clips(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _clip(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if _clips(p, g)
                 else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clips(p, g):
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g.to(torch.float32))))
            scale = torch.clamp_max(
                _over(self.clip_norm, torch.clamp_min(norm, 1e-12)), 1.0)
            out.append((p, _scaled(g, scale)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _global_norm_sq(self, params_grads):
        sq = None
        for p, g in params_grads:
            if not _clips(p, g):
                continue
            s = torch.sum(torch.square(g.to(torch.float32)))
            sq = s if sq is None else sq + s
        return sq

    def _clip(self, params_grads):
        sq = self._global_norm_sq(params_grads)
        if sq is None:
            return params_grads
        scale = _over(self.clip_norm,
                      torch.clamp_min(torch.sqrt(sq), self.clip_norm))
        return [(p, _scaled(g, scale) if _clips(p, g) else g)
                for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` by ``min(max_norm / max(total, 1e-6), 1)``,
    ``total`` the ``norm_type`` norm over all of them; returns it.  The
    p-norms sum fp32 powers; the inf-norm and its scale keep the
    gradients' result dtype."""
    params = [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        # the max and the scale in the gradients' result dtype (bf16 for
        # bf16 gradients), as JAX promotes them
        dt = functools.reduce(torch.promote_types, [g.dtype for g in grads])
        total = torch.max(torch.stack([g.abs().max().to(dt)
                                       for g in grads]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(g.to(torch.float32).abs() ** norm_type)
             for g in grads])) ** (1.0 / norm_type)
    scale = torch.clamp_max(_over(max_norm, torch.clamp_min(total, 1e-6)),
                            1.0)
    for g in grads:
        g.copy_(_scaled(g, scale))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    params = [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)
    for p in params:
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
