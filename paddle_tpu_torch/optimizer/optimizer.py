"""The optimizer base: port of ``paddle_tpu/optimizer/optimizer.py:23-238``.

Parameter groups (each with its own ``learning_rate`` factor and
``weight_decay``; a group's ``params``, or ``parameters``, may hold
``(name, param)`` pairs as ``named_parameters()`` yields them, which name
the parameters for ``AdamW``'s ``apply_decay_param_fun``: a torch tensor
has no settable name), a per-parameter lr factor from ``p.optimize_attr
["learning_rate"]``, per-parameter accumulators, master weights for
low-precision parameters under ``multi_precision``, the gradient clip
objects of ``nn.clip``, regularizer objects (``regularizer``) and the
reference's ``state_dict`` keys (``{accumulator}_{index}``,
``master_{index}``, ``LR_Scheduler``; the index is the parameter's
position in ``_parameter_list``).

``step()`` reads ``p.grad`` of every parameter that requires grad and
has one, clips, then per parameter (the reference's :113-161): an
``L1Decay`` regularizer (of the group, else the optimizer's) adds
``coeff * sign(p)`` to the gradient; otherwise a weight decay is
coupled (added to the gradient as ``wd * p``) unless the optimizer
decays it decoupled (``AdamW``).  A group's explicit number wins over
the optimizer's regularizer.  Each subclass's ``_append_optimize_op``
then writes the parameter in place under ``torch.no_grad()``.  The JAX
package runs each update as one jitted function; here it is torch ops
with the JAX package's dtypes: hyperparameters and the learning rate
are float32 0-d tensors (strongly typed, as ``jnp.float32`` there), or
tensors of the parameter's dtype where the reference casts them so.

``jit.TrainStep`` runs its own functional updates and reads only the
hyperparameters from here.  Without ``parameters`` the optimizer has
none (the JAX package's "every live parameter" has no counterpart in
torch).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from .lr import LRScheduler

_TRAINING = "(ROADMAP.md, known differences of the port's trainer)"


def f32(value, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device (``jnp.float32(x)``)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def as_dtype(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``like``'s dtype (``jnp.asarray(x, like.dtype)``)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise NotImplementedError(
                f"learning_rate must be a float or an optimizer.lr "
                f"LRScheduler, got {type(learning_rate).__name__}: other "
                f"schedule objects are not ported {_TRAINING}")
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = \
            defaultdict(dict)
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._param_groups: List[dict] = []
        self._param_names: Dict[int, str] = {}
        parameters = [] if parameters is None else list(parameters)
        if parameters and isinstance(parameters[0], dict):
            for g in parameters:
                self._add_param_group(dict(g))
        else:
            self._add_param_group({"params": parameters})
        if isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)
            self._wd_is_l2 = type(self).__name__ not in ("AdamW",)
        elif weight_decay is None:
            self._weight_decay = 0.0
            self._wd_is_l2 = False
        else:       # an L1Decay/L2Decay-like object with a coeff
            self._weight_decay = float(getattr(
                weight_decay, "_coeff", getattr(weight_decay, "coeff", 0.0)))
            self._wd_is_l2 = True
            self._wd_regularizer = weight_decay if callable(weight_decay) \
                else None

    def _add_param_group(self, group):
        params = []
        for item in group["params"]:
            if isinstance(item, tuple):     # (name, param), as from
                name, item = item           # named_parameters()
                self._param_names[id(item)] = name
            params.append(item)
        group["params"] = params
        group.setdefault("learning_rate", 1.0)
        group.setdefault("weight_decay", None)
        self._param_groups.append(group)

    @property
    def _parameter_list(self):
        return [p for g in self._param_groups for p in g["params"]]

    # ---- lr ----
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # ---- accumulators ----
    def _add_accumulator(self, name, param, fill_value=0.0, dtype=None):
        store = self._accumulators[name]
        if id(param) not in store:
            d = dtype or (torch.float32 if self._use_master(param)
                          else param.dtype)
            store[id(param)] = torch.full(param.shape, fill_value, dtype=d,
                                          device=param.device)
        return store[id(param)]

    def _add_pow(self, name, param):
        """A float32 scalar accumulator starting at 1 (``beta*_pow``)."""
        store = self._accumulators[name]
        if id(param) not in store:
            store[id(param)] = torch.ones((), dtype=torch.float32,
                                          device=param.device)

    def _get_accumulator(self, name, param):
        return self._accumulators[name][id(param)]

    def _set_accumulator(self, name, param, value):
        self._accumulators[name][id(param)] = value

    def _param_name(self, param):
        return self._param_names.get(id(param))

    def _use_master(self, param) -> bool:
        return self._multi_precision and param.dtype in (torch.float16,
                                                         torch.bfloat16)

    def _master_weight(self, param):
        if id(param) not in self._master_weights:
            self._master_weights[id(param)] = param.detach().float()
        return self._master_weights[id(param)]

    def _write(self, p, new):
        """The updated parameter (in the master when there is one)."""
        if self._use_master(p):
            self._master_weights[id(p)] = new
        p.copy_(new)

    # ---- the step ----
    def _create_accumulators(self, param):
        pass

    def _append_optimize_op(self, param, grad, lr, wd):
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        params_grads = []
        for g in self._param_groups:
            for p in g["params"]:
                if not p.requires_grad or p.grad is None:
                    continue
                params_grads.append((p, p.grad, g))
        if self._grad_clip is not None:
            clipped = self._grad_clip([(p, gr) for p, gr, _ in params_grads])
            params_grads = [(p, gr, g) for (p, gr), (_, _, g) in
                            zip(clipped, params_grads)]
        lr = self.get_lr()
        for p, grad, group in params_grads:
            self._create_accumulators(p)
            attr = getattr(p, "optimize_attr", None) or {}
            group_lr = lr * float(group.get("learning_rate", 1.0)) \
                * float(attr.get("learning_rate", 1.0))
            group_wd = group.get("weight_decay")
            # a regularizer object wins over coefficients; an explicit
            # per-group number (0.0 exempts a group) wins over the
            # optimizer's regularizer
            reg = group_wd if callable(group_wd) and not isinstance(
                group_wd, (int, float)) else (
                getattr(self, "_wd_regularizer", None)
                if group_wd is None else None)
            if reg is not None and getattr(reg, "_is_l1", False):
                grad = reg(grad, p)
                wd = 0.0
            else:
                if group_wd is None:
                    wd, as_l2 = self._weight_decay, self._wd_is_l2
                else:
                    wd = float(getattr(group_wd, "_coeff", group_wd))
                    # per-group decay is coupled for all but AdamW, which
                    # decays decoupled inside _append_optimize_op
                    as_l2 = type(self).__name__ != "AdamW"
                if wd and as_l2:
                    grad = grad + as_dtype(wd, grad) * p.to(grad.dtype)
                    wd = 0.0
            self._append_optimize_op(p, grad, group_lr, wd)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        if hasattr(loss, "_static_var_id"):   # a static program variable
            return self._minimize_static(loss, parameters)
        loss.backward()
        self.step()
        return None, None

    def _minimize_static(self, loss, parameters=None):
        """The static path (reference ``optimizer.py:165-200``):
        ``append_backward`` and a functional update per parameter recorded
        into the Program being built; its Executor runs the update after
        each run and writes the new values into the parameters."""
        from ..static.program import current_build_program
        prog = current_build_program()
        if prog is None:
            raise RuntimeError("minimize(loss) on a static Variable must run "
                               "under program_guard")
        params_grads = prog.append_backward(
            loss, parameters or self._parameter_list)
        update = self._functional_update()
        lr = self.get_lr()
        for p, _g in params_grads:
            prog.updates.append(
                (p, lambda pv, gv, _lr=lr: update(pv, gv, _lr)))
        return params_grads, None

    def _functional_update(self):
        """Pure (param, grad, lr) -> new param for the static path; the
        optimizers with per-parameter state take the ``jit.TrainStep``
        path, as in the reference."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support static-mode minimize; "
            "use SGD or the jit.TrainStep path (as the reference; ROADMAP.md, "
            "\"Known differences of jit and static\")")

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # ---- state dict ----
    def state_dict(self):
        out = {}
        index = {id(p): i for i, p in enumerate(self._parameter_list)}
        for acc_name, store in self._accumulators.items():
            for pid, arr in store.items():
                if pid in index:
                    out[f"{acc_name}_{index[pid]}"] = arr
        for pid, arr in self._master_weights.items():
            if pid in index:
                out[f"master_{index[pid]}"] = arr
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        """Load ``state_dict()``'s keys; values are tensors or numpy
        arrays (a JAX package state dict handed over as numpy, through
        ``models.convert.optimizer_state_from_jax``), copied onto each
        parameter's device."""
        params = self._parameter_list
        for key, value in state.items():
            if key == "LR_Scheduler":
                if isinstance(self._learning_rate, LRScheduler):
                    self._learning_rate.set_state_dict(value)
                continue
            name, _, idx = key.rpartition("_")
            try:
                p = params[int(idx)]
            except (ValueError, IndexError):
                continue
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value, copy=True))
            arr = value.detach().to(p.device, copy=True)
            if name == "master":
                self._master_weights[id(p)] = arr
            else:
                self._accumulators[name][id(p)] = arr
