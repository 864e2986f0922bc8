"""Optimizers of the port: port of ``paddle_tpu/optimizer/__init__.py:24-440``.

``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adamax``, ``Lamb``,
``RMSProp``, ``Adagrad``, ``Adadelta`` and ``LBFGS`` (``step(closure)``)
over the ``Optimizer`` base (``optimizer.py``), with the LR schedulers
of ``lr``.  Each ``_append_optimize_op`` is the JAX package's jitted
update in torch ops with its dtypes and its order of operations: SGD and
Momentum compute in the parameter's dtype (the learning rate and the
momentum cast to it) unless master weights hold an fp32 copy; the Adam
family keeps fp32 moments and fp32 ``beta*_pow`` scalars and computes
the new parameter in fp32; ``AdamW`` decays decoupled and skips the
decay for a parameter whose name ``apply_decay_param_fun(name)``
rejects (the names come with ``parameters=model.named_parameters()``);
``lr_ratio`` is accepted and ignored, as the reference
ignores it.

``jit.TrainStep`` runs its own functional updates of SGD, Momentum,
Adam and AdamW (the JAX package's compiled step) and raises for the
others, as the reference's ``_select_update`` takes only those four.
"""

from __future__ import annotations

import torch

from . import lr  # noqa: F401
from .lr import LRScheduler
from .optimizer import Optimizer, as_dtype, f32

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax", "Lamb",
           "RMSProp", "Adagrad", "Adadelta", "LBFGS", "lr", "LRScheduler"]


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._wd_is_l2 = weight_decay is not None

    def _append_optimize_op(self, p, grad, lr_, wd):
        if self._use_master(p):
            mw = self._master_weight(p)
            self._write(p, mw - f32(lr_, p) * grad.float())
        else:
            p.copy_(p - as_dtype(lr_, p) * grad.to(p.dtype))

    def _functional_update(self):
        return lambda p, g, lr: p - as_dtype(lr, p) * g.to(p.dtype)


def _momentum_update(p, g, vel, lr_, mu, use_nesterov):
    g = g.to(p.dtype)
    v_new = mu * vel + g
    if use_nesterov:
        return p - lr_ * (g + mu * v_new), v_new
    return p - lr_ * v_new, v_new


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)
        self._wd_is_l2 = weight_decay is not None

    def _create_accumulators(self, p):
        self._add_accumulator("velocity", p)

    def _append_optimize_op(self, p, grad, lr_, wd):
        vel = self._get_accumulator("velocity", p)
        if self._use_master(p):
            new_p, new_vel = _momentum_update(
                self._master_weight(p), grad.float(), vel, f32(lr_, p),
                f32(self._momentum, p), self._use_nesterov)
        else:
            new_p, new_vel = _momentum_update(
                p, grad, vel, as_dtype(lr_, p), as_dtype(self._momentum, p),
                self._use_nesterov)
        self._write(p, new_p)
        self._set_accumulator("velocity", p, new_vel)


class Adam(Optimizer):
    """Adam; weight decay is coupled (added to the gradient as ``wd *
    p`` by the base step).  ``lazy_mode`` and ``use_multi_tensor`` are
    accepted and ignored, as in the JAX package."""

    _wd_mode = "l2"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._wd_is_l2 = weight_decay is not None and self._wd_mode == "l2"

    def _create_accumulators(self, p):
        self._add_accumulator("moment1", p, dtype=torch.float32)
        self._add_accumulator("moment2", p, dtype=torch.float32)
        self._add_pow("beta1_pow", p)
        self._add_pow("beta2_pow", p)

    def _append_optimize_op(self, p, grad, lr_, wd):
        m = self._get_accumulator("moment1", p)
        v = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p) * self._beta1
        b2p = self._get_accumulator("beta2_pow", p) * self._beta2
        self._set_accumulator("beta1_pow", p, b1p)
        self._set_accumulator("beta2_pow", p, b2p)
        decoupled = self._wd_mode == "decoupled" and wd
        target = self._master_weight(p) if self._use_master(p) else p
        lr_t, b1, b2 = f32(lr_, p), f32(self._beta1, p), f32(self._beta2, p)
        gf = grad.float()
        # a bf16 target meets the fp32 scalars and promotes, as in JAX
        pf = target.float()
        if decoupled:
            pf = pf * (1.0 - lr_t * f32(wd, p))
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        m_hat = m_new / (1 - b1p)
        v_hat = v_new / (1 - b2p)
        self._write(p, pf - lr_t * m_hat / (torch.sqrt(v_hat)
                                            + f32(self._epsilon, p)))
        self._set_accumulator("moment1", p, m_new)
        self._set_accumulator("moment2", p, v_new)


class AdamW(Adam):
    """Adam with decoupled weight decay."""

    _wd_mode = "decoupled"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name=name)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._wd_is_l2 = False

    def _append_optimize_op(self, p, grad, lr_, wd):
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self._param_name(p)):
            wd = 0.0
        super()._append_optimize_op(p, grad, lr_, wd)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._wd_is_l2 = weight_decay is not None

    def _create_accumulators(self, p):
        self._add_accumulator("moment", p, dtype=torch.float32)
        self._add_accumulator("inf_norm", p, dtype=torch.float32)
        self._add_pow("beta1_pow", p)

    def _append_optimize_op(self, p, grad, lr_, wd):
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        b1p = self._get_accumulator("beta1_pow", p) * self._beta1
        self._set_accumulator("beta1_pow", p, b1p)
        b1, b2 = f32(self._beta1, p), f32(self._beta2, p)
        gf = grad.to(m.dtype)
        m_new = b1 * m + (1 - b1) * gf
        inf_new = torch.maximum(b2 * inf, torch.abs(gf))
        p.copy_(p.float() - (f32(lr_, p) / (1 - b1p)) * m_new
                / (inf_new + f32(self._epsilon, p)))
        self._set_accumulator("moment", p, m_new)
        self._set_accumulator("inf_norm", p, inf_new)


def _norm(x):
    return torch.sqrt(torch.sum(x * x))


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._lamb_wd = float(lamb_weight_decay)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _create_accumulators(self, p):
        self._add_accumulator("moment1", p, dtype=torch.float32)
        self._add_accumulator("moment2", p, dtype=torch.float32)
        self._add_pow("beta1_pow", p)
        self._add_pow("beta2_pow", p)

    def _append_optimize_op(self, p, grad, lr_, wd):
        m = self._get_accumulator("moment1", p)
        v = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p) * self._beta1
        b2p = self._get_accumulator("beta2_pow", p) * self._beta2
        self._set_accumulator("beta1_pow", p, b1p)
        self._set_accumulator("beta2_pow", p, b2p)
        lamb_wd = 0.0 if (self._exclude_fn is not None
                          and self._exclude_fn(p)) else self._lamb_wd
        b1, b2 = f32(self._beta1, p), f32(self._beta2, p)
        gf, pf = grad.float(), p.float()
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        m_hat = m_new / (1 - b1p)
        v_hat = v_new / (1 - b2p)
        r = m_hat / (torch.sqrt(v_hat) + f32(self._epsilon, p)) \
            + f32(lamb_wd, p) * pf
        w_norm, r_norm = _norm(pf), _norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            f32(1.0, p))
        p.copy_(pf - f32(lr_, p) * ratio * r)
        self._set_accumulator("moment1", p, m_new)
        self._set_accumulator("moment2", p, v_new)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = float(rho), float(epsilon)
        self._momentum, self._centered = float(momentum), bool(centered)
        self._wd_is_l2 = weight_decay is not None

    def _create_accumulators(self, p):
        self._add_accumulator("mean_square", p, dtype=torch.float32)
        self._add_accumulator("mean_grad", p, dtype=torch.float32)
        self._add_accumulator("momentum_acc", p, dtype=torch.float32)

    def _append_optimize_op(self, p, grad, lr_, wd):
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        mom = self._get_accumulator("momentum_acc", p)
        rho, eps = f32(self._rho, p), f32(self._epsilon, p)
        gf, pf = grad.float(), p.float()
        ms_new = rho * ms + (1 - rho) * gf * gf
        if self._centered:
            mg_new = rho * mg + (1 - rho) * gf
            denom = torch.sqrt(ms_new - mg_new * mg_new + eps)
        else:
            mg_new = mg
            denom = torch.sqrt(ms_new + eps)
        mom_new = f32(self._momentum, p) * mom + f32(lr_, p) * gf / denom
        p.copy_(pf - mom_new)
        self._set_accumulator("mean_square", p, ms_new)
        self._set_accumulator("mean_grad", p, mg_new)
        self._set_accumulator("momentum_acc", p, mom_new)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = float(epsilon)
        self._init_acc = initial_accumulator_value
        self._wd_is_l2 = weight_decay is not None

    def _create_accumulators(self, p):
        self._add_accumulator("moment_acc", p, fill_value=self._init_acc,
                              dtype=torch.float32)

    def _append_optimize_op(self, p, grad, lr_, wd):
        mom = self._get_accumulator("moment_acc", p)
        gf, pf = grad.float(), p.float()
        mom_new = mom + gf * gf
        p.copy_(pf - f32(lr_, p) * gf / (torch.sqrt(mom_new)
                                         + f32(self._epsilon, p)))
        self._set_accumulator("moment_acc", p, mom_new)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = float(epsilon), float(rho)
        self._wd_is_l2 = weight_decay is not None

    def _create_accumulators(self, p):
        self._add_accumulator("avg_squared_grad", p, dtype=torch.float32)
        self._add_accumulator("avg_squared_update", p, dtype=torch.float32)

    def _append_optimize_op(self, p, grad, lr_, wd):
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        rho, eps = f32(self._rho, p), f32(self._epsilon, p)
        gf, pf = grad.float(), p.float()
        asg2 = rho * asg + (1 - rho) * gf * gf
        update = torch.sqrt(asu + eps) / torch.sqrt(asg2 + eps) * gf
        asu2 = rho * asu + (1 - rho) * update * update
        p.copy_(pf - f32(lr_, p) * update)
        self._set_accumulator("avg_squared_grad", p, asg2)
        self._set_accumulator("avg_squared_update", p, asu2)


class LBFGS(Optimizer):
    """Limited-memory BFGS: ``step(closure)``, the closure computing the
    loss and its gradients.  One quasi-Newton step a call along the
    two-loop direction, scaled by the learning rate (no line search),
    over the flattened fp32 parameters, as the JAX package's."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.max_iter = max_iter
        self.history_size = history_size
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self._s_hist = []
        self._y_hist = []
        self._prev_flat_grad = None
        self._prev_flat_w = None

    @staticmethod
    def _flatten(tensors):
        return torch.cat([t.reshape(-1).float() for t in tensors])

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        params = [p for p in self._parameter_list if p.requires_grad]
        with torch.enable_grad():
            loss = closure()
        with torch.no_grad():
            self._lbfgs_update(params)
        return loss

    def _lbfgs_update(self, params):
        flat_g = self._flatten([p.grad for p in params])
        flat_w = self._flatten(params)
        if self._prev_flat_grad is not None:
            s = flat_w - self._prev_flat_w
            y = flat_g - self._prev_flat_grad
            if float(torch.dot(s, y)) > 1e-10:
                self._s_hist.append(s)
                self._y_hist.append(y)
                if len(self._s_hist) > self.history_size:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
        # two-loop recursion
        one = f32(1.0, flat_g)
        q = flat_g
        alphas = []
        for s, y in zip(reversed(self._s_hist), reversed(self._y_hist)):
            rho = one / torch.dot(y, s)
            alpha = rho * torch.dot(s, q)
            q = q - alpha * y
            alphas.append((rho, alpha))
        if self._y_hist:
            y_last, s_last = self._y_hist[-1], self._s_hist[-1]
            q = q * (torch.dot(s_last, y_last) / torch.dot(y_last, y_last))
        for (s, y), (rho, alpha) in zip(zip(self._s_hist, self._y_hist),
                                        reversed(alphas)):
            beta = rho * torch.dot(y, q)
            q = q + (alpha - beta) * s
        new_flat = flat_w + f32(self.get_lr(), flat_w) * -q
        offset = 0
        for p in params:
            n = p.numel()
            p.copy_(new_flat[offset:offset + n].reshape(p.shape))
            offset += n
        self._prev_flat_grad = flat_g
        self._prev_flat_w = flat_w
