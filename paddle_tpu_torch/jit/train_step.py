"""``TrainStep``: one training step (forward, backward, gradient clip and
optimizer update) per call, with gradient merge and ``run_steps``.

Port of ``paddle_tpu/jit/train_step.py``: the functional updates
``_functional_sgd`` (:83), ``_functional_momentum`` (:88) and
``_functional_adam`` (:151-180, Adam and AdamW, with the
``adamw_rsqrt_update`` form), the bf16 moment store
``_stochastic_round_bf16``/``_store_moment`` (:99-148), the fused AdamW
route ``_fused_adam_ok``/``_fused_adam_eligible``/``_fused_adam_update``
(:183-234), ``TrainStep.__init__``, ``_select_update`` and
``_init_state`` (:237-379), the step body with gradient merge
(:433-533), ``run_steps`` (:583-635) and ``__call__`` (:637-669), with
the ``_TrainStepInstruments`` of the metrics registry (:35-81) and the
spans ``train_step.build``, ``train_step.call`` and
``train_step.run_steps``.  The
JAX package traces the step into one XLA program with donated buffers;
here it runs eagerly, and the update writes the parameters and the
optimizer state in place under ``torch.no_grad()`` (the counterpart of
donation).

The update is the JAX package's, trap for trap:
- SGD and Momentum ignore weight decay; Momentum keeps its velocity in
  the parameter's dtype; an fp32 ``lr`` promotes a bf16 delta to fp32
  before the cast back (JAX promotes a strongly typed fp32 scalar, where
  torch would keep a 0-d tensor's partner dtype);
- Adam adds ``wd * p`` to the gradient; AdamW decays EVERY parameter
  (norms and embeddings too; ``apply_decay_param_fun`` is not read) on
  the fp32 copy of p BEFORE the moment update: ``p <- p * (1 - lr*wd)``;
- no master weights: ``p_new`` is computed in fp32 and cast back to the
  parameter's dtype;
- moments are fp32, except under ``multi_precision=False`` (the default)
  where bf16 parameters keep bf16 moments, stored by stochastic
  rounding; fp16 parameters keep fp32 moments;
- the step count ``t`` is an fp32 scalar; bias correction ``1 - beta**t``
  (the fused kernel's ``1 - exp(t log beta)`` differs in the last bits,
  as in the reference);
- a clip with a ``clip_norm`` (``ClipGradByGlobalNorm`` or
  ``ClipGradByNorm``) is applied as one global norm: fp32 squares
  summed, ``scale = cn / max(|g|, cn)``, applied as ``g *
  scale.to(g.dtype)``; a clip without one (``ClipGradByValue``) is not
  applied, as in the reference.

Keys (``core.generator``): one draw per call from the default generator
(``run_steps`` folds the iteration into it, cumulatively, as the
reference's scan carries it).  The draw's threefry part is pushed around
the loss (``push_trace_key``), so dropout inside the step derives from
it exactly as in the JAX package.  Its splitmix part drives the bf16
moments' stochastic rounding: folded per parameter with ``1 << 20 |
i`` and split into the m and v streams.  The unfused bf16
store draws one trailing-row noise tile per moment from the counter hash
of ``ops.fused_optimizer`` and broadcasts it across the leading dims, so
same-step rounding errors are column-correlated as in the reference; the
fused kernel draws noise per element.  The port reads the flags at every
call (the reference reads them when it traces the step).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..core import generator as _generator
from ..core.flags import flag
from ..observability import metrics as _obs
from ..observability.spans import span as _span
from ..ops.fused_optimizer import (adamw_scalars, fused_adamw_update,
                                   noise_bits, seed_of, stochastic_round_bf16)
from ..optimizer import SGD, Adam, AdamW, Momentum, Optimizer

_TRAINING = "(ROADMAP.md, known differences of the port's trainer)"


class _TrainStepInstruments:
    """Registry handles for the train step (shared by every TrainStep;
    created on first use).  A "compile" is the first dispatch of a
    (TrainStep, block size) pair, as the reference counts it: there jax
    traces and XLA compiles inside that call; here the kernels build and
    the optimizer state is made inside it."""

    _inst = None

    def __init__(self):
        r = _obs.get_registry()
        self.compiles = r.counter(
            "train_step.compiles", "XLA (re)compilations of the fused "
            "train step (first dispatch per executable)")
        self.compile_seconds = r.histogram(
            "train_step.compile_seconds",
            "trace + compile + first-step wall time",
            buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                     120.0, 300.0))
        self.cache_hits = r.counter(
            "train_step.cache_hits", "dispatches served by an existing "
            "compiled executable")
        self.cache_misses = r.counter(
            "train_step.cache_misses", "dispatches that had to build an "
            "executable")
        self.step_seconds = r.histogram(
            "train_step.step_seconds", "per-call wall time of the "
            "compiled step (async dispatch; excludes compile calls)")

    @classmethod
    def get(cls):
        if cls._inst is None:
            cls._inst = cls()
        return cls._inst

    def record_dispatch(self, was_compile: bool, dt: float):
        """Compile calls land in the compile histogram, steady-state
        calls in the step histogram."""
        if was_compile:
            self.compiles.inc()
            self.cache_misses.inc()
            self.compile_seconds.observe(dt)
        else:
            self.cache_hits.inc()
            self.step_seconds.observe(dt)


def _lr_times(lr, x):
    """``lr * x`` with JAX's promotion: the fp32 ``lr`` promotes a bf16
    ``x`` to fp32."""
    return lr * x.to(torch.promote_types(x.dtype, lr.dtype))


def _weak(value, like):
    """A Python scalar as JAX's weak type meets ``like``: rounded to
    like's dtype first."""
    return torch.tensor(value, dtype=like.dtype)


def _functional_sgd(p, g, state, lr, hp, key=None):
    p.copy_(p - _lr_times(lr, g).to(p.dtype))


def _functional_momentum(p, g, state, lr, hp, key=None):
    v = state["velocity"]
    g = g.to(v.dtype)
    mu = _weak(hp["momentum"], v)
    v_new = mu * v + g
    if hp["nesterov"]:
        p.copy_(p - _lr_times(lr, g + mu * v_new).to(p.dtype))
    else:
        p.copy_(p - _lr_times(lr, v_new).to(p.dtype))
    v.copy_(v_new)


def _stochastic_round_bf16(x, key):
    """Unbiased fp32 -> bf16 with ONE trailing-row noise tile drawn from
    ``key`` and broadcast across the leading dims (the reference's
    column-correlated form, :99-140)."""
    x1 = x.reshape(1) if x.ndim == 0 else x
    tile = noise_bits(seed_of(key), torch.arange(
        x1.shape[-1], dtype=torch.int64, device=x.device))
    return stochastic_round_bf16(x1, tile).reshape(x.shape)


def _store_moment(dst, val_f32, key):
    """Write an fp32 moment into its state tensor, in place."""
    if dst.dtype == torch.bfloat16 and key is not None:
        dst.copy_(_stochastic_round_bf16(val_f32, key))
    else:
        dst.copy_(val_f32)


def _functional_adam(p, g, state, lr, hp, key=None):
    """One Adam/AdamW update of ``p`` with gradient ``g``, in place: p,
    ``state["m"]`` and ``state["v"]`` are overwritten and ``state["t"]``
    advances.  ``lr`` is an fp32 scalar tensor."""
    gf = g.float()
    pf = p.float()
    b1, b2, eps, wd = hp["beta1"], hp["beta2"], hp["epsilon"], hp["wd"]
    if hp["decoupled"]:
        pf = pf * (1.0 - lr * wd)
    elif wd:
        gf = gf + wd * pf
    t = state["t"] + 1
    m = b1 * state["m"].float() + (1 - b1) * gf
    v = b2 * state["v"].float() + (1 - b2) * gf * gf
    m_hat = m / (1 - torch.pow(b1, t))
    v_hat = v / (1 - torch.pow(b2, t))
    if flag("adamw_rsqrt_update"):
        # the epsilon-hat form: eps inside the sqrt
        p.copy_(pf - lr * m_hat * torch.rsqrt(v_hat + eps * eps))
    else:
        p.copy_(pf - lr * m_hat / (torch.sqrt(v_hat) + eps))
    km, kv = _generator.split(key) if key is not None else (None, None)
    _store_moment(state["m"], m, km)
    _store_moment(state["v"], v, kv)
    state["t"] = t


def _fused_adam_ok(update_fn, hypers, mesh=None):
    """The fused AdamW route: the flag, AdamW (decoupled decay), no
    rsqrt form (the kernel implements only the sqrt form) and no mesh.
    The reference also requires a TPU; here the route is taken on any
    device, and on the CPU it runs the kernel's plain version."""
    return (update_fn is _functional_adam and bool(hypers.get("decoupled"))
            and mesh is None and not flag("adamw_rsqrt_update")
            and bool(flag("use_fused_adamw_kernel")))


def _fused_adam_eligible(p, s):
    """Per-parameter gate: a float32 or bfloat16 parameter (the kernel's
    dtypes) with fp32 or bf16 moments.  The reference's TPU tiling gate
    (``native_tileable``) has no counterpart: the kernel takes any
    shape."""
    if p.dtype not in (torch.float32, torch.bfloat16):
        return False
    if not isinstance(s, dict) or s.get("m") is None:
        return False
    return s["m"].dtype in (torch.float32, torch.bfloat16)


def _fused_step(state, lr, hp, device):
    """(t, scalars) of a fused update: the next step count and the
    kernel's (lr, bc1, bc2), made once per step and shared by every
    fused parameter (they all hold the same count)."""
    t = state["t"] + 1
    return t, adamw_scalars(lr, t, hp["beta1"], hp["beta2"], device)


def _fused_adam_update(p, g, state, lr, hp, key=None, *, step):
    """One fused AdamW update, in place; ``step`` is ``_fused_step``'s
    (t, scalars) of this update."""
    t, sc = step
    seed = None
    if key is not None and state["m"].dtype == torch.bfloat16:
        seed = seed_of(key)
    fused_adamw_update(p, g, state["m"], state["v"], lr, t,
                       beta1=hp["beta1"], beta2=hp["beta2"],
                       epsilon=hp["epsilon"], weight_decay=hp["wd"],
                       seed=seed, scalars=sc)
    state["t"] = t


def _as_input(x, device):
    """A batch input on the model's device: numpy arrays become tensors
    (as ``jnp.asarray`` in the JAX package); tensors are moved."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def select_update(opt):
    """``(update_fn, hypers)`` of the compiled step for ``opt``, or
    ``None`` for an optimizer it does not take (the reference's
    ``_select_update``: SGD, Momentum, Adam and AdamW)."""
    if isinstance(opt, Adam):     # AdamW is an Adam
        return _functional_adam, {
            "beta1": opt._beta1, "beta2": opt._beta2,
            "epsilon": opt._epsilon, "wd": opt._weight_decay,
            "decoupled": isinstance(opt, AdamW),
            "multi_precision": opt._multi_precision}
    if isinstance(opt, Momentum):
        return _functional_momentum, {
            "momentum": opt._momentum, "nesterov": opt._use_nesterov}
    if isinstance(opt, SGD):
        return _functional_sgd, {}
    return None


class TrainStep:
    def __init__(self, model, loss_fn: Callable, optimizer: Optimizer,
                 mesh=None, in_shardings=None, donate: bool = True,
                 accumulate_steps: int = 1, accumulate_avg: bool = True):
        """``loss_fn(net, *inputs)`` returns the scalar loss, or a tuple
        whose first entry is the loss (the rest come back as aux).  The
        step runs on the device of the model's parameters.
        ``accumulate_steps=k`` merges gradients: every call adds its
        gradients into fp32 buffers, and every k-th call applies them
        (averaged when ``accumulate_avg``)."""
        if accumulate_steps < 1:
            raise ValueError(
                f"accumulate_steps must be >= 1, got {accumulate_steps}")
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
        self._dispatched = set()    # (entry, block size) dispatched once
        self._accum_steps = accumulate_steps
        self._accum_avg = accumulate_avg
        self._state = None
        self._gm_state = None

    def _select_update(self, opt):
        chosen = select_update(opt)
        if chosen is None:
            raise NotImplementedError(
                f"TrainStep with {type(opt).__name__}: the compiled step "
                f"takes SGD, Momentum, Adam and AdamW, as the reference's "
                f"_select_update does; train it with the eager opt.step() "
                f"{_TRAINING}")
        return chosen

    def _init_state(self):
        def zeros(p, dtype=None):
            return torch.zeros_like(p, dtype=dtype or p.dtype)

        if self._update_fn is _functional_adam:
            # fp32 moments under multi_precision; otherwise bf16 params
            # get bf16 moments (stored by stochastic rounding) and fp16
            # params stay fp32 (fp16's exponent overflows v)
            def mdt(p):
                if self._hypers["multi_precision"]:
                    return torch.float32
                return (torch.bfloat16 if p.dtype == torch.bfloat16
                        else torch.float32)
            return [{"m": zeros(p, mdt(p)), "v": zeros(p, mdt(p)),
                     "t": torch.zeros((), dtype=torch.float32,
                                      device=p.device)}
                    for p in self._params]
        if self._update_fn is _functional_momentum:
            return [{"velocity": zeros(p)} for p in self._params]
        return [{} for _ in self._params]

    def _init_gm_state(self):
        if self._accum_steps == 1:
            return None
        return {"acc": [torch.zeros_like(p, dtype=torch.float32)
                        for p in self._params], "count": 0}

    def _apply_update(self, grads, lr, key):
        clip = self.optimizer._grad_clip
        if clip is not None and hasattr(clip, "clip_norm"):
            gsq = sum(g.float().square().sum() for g in grads)
            gnorm = torch.sqrt(gsq)
            cn = clip.clip_norm
            scale = cn / torch.clamp(gnorm, min=cn)
            grads = [g * scale.to(g.dtype) for g in grads]
        fused = _fused_adam_ok(self._update_fn, self._hypers)
        fused_step = None
        for i, (p, g, s) in enumerate(zip(self._params, grads,
                                          self._state)):
            fn = (_fused_adam_update if fused and _fused_adam_eligible(p, s)
                  else self._update_fn)
            kw = {}
            if fn is _fused_adam_update:
                if fused_step is None:
                    fused_step = _fused_step(s, lr, self._hypers, p.device)
                kw["step"] = fused_step
            if fn in (_functional_adam, _fused_adam_update) \
                    and s["m"].dtype == torch.bfloat16:
                # bf16 moments store by stochastic rounding: a
                # per-parameter key
                kw["key"] = _generator.fold_in(key, 1 << 20 | i)
            fn(p, g, s, lr, self._hypers, **kw)

    def _step(self, inputs, key, lr):
        """One forward, backward and (on a firing call) update; returns
        (loss, aux).  ``key`` is pushed around the loss."""
        _generator.push_trace_key(key)
        try:
            out = self.loss_fn(self.model, *[_as_input(x, self._device)
                                             for x in inputs])
        finally:
            _generator.pop_trace_key()
        loss = out[0] if isinstance(out, tuple) else out
        aux = out[1:] if isinstance(out, tuple) else ()
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self._params, grads)]
            gm = self._gm_state
            if gm is None:
                self._apply_update(grads, lr, key.mix)
            else:
                # gradient merge: the host decides fire or hold, where
                # the reference branches with lax.cond
                for a, g in zip(gm["acc"], grads):
                    a.add_(g.float())
                gm["count"] += 1
                if gm["count"] % self._accum_steps == 0:
                    gscale = (1.0 / self._accum_steps) if self._accum_avg \
                        else 1.0
                    self._apply_update(
                        [(a * gscale).to(p.dtype)
                         for a, p in zip(gm["acc"], self._params)], lr,
                        key.mix)
                    for a in gm["acc"]:
                        a.zero_()
        return loss.detach(), aux

    def _prepare(self):
        if self._state is None:
            with _span("train_step.build"):
                self._state = self._init_state()
                self._gm_state = self._init_gm_state()
        return torch.tensor(self.optimizer.get_lr(), dtype=torch.float32,
                            device=self._device)

    def _first_dispatch(self, block) -> bool:
        first = block not in self._dispatched
        self._dispatched.add(block)
        return first

    def run_steps(self, *inputs, steps: int):
        """``steps`` consecutive train steps on the SAME batch, the lr
        read once and a key folded per iteration (the reference's
        ``lax.scan`` body, run eagerly).  Returns the last step's
        loss."""
        m = _TrainStepInstruments.get()
        lr = self._prepare()
        key = _generator.default_generator().draw()
        loss = None
        t0 = time.perf_counter()
        with _span("train_step.run_steps", steps=steps):
            for i in range(steps):
                key = key.fold_in(i)
                loss, _ = self._step(inputs, key, lr)
        m.record_dispatch(self._first_dispatch(("run_steps", steps)),
                          time.perf_counter() - t0)
        return loss

    def __call__(self, *inputs):
        m = _TrainStepInstruments.get()
        lr = self._prepare()
        key = _generator.default_generator().draw()
        t0 = time.perf_counter()
        with _span("train_step.call"):
            loss, aux = self._step(inputs, key, lr)
        m.record_dispatch(self._first_dispatch(("call", 1)),
                          time.perf_counter() - t0)
        if aux:
            return (loss,) + tuple(a.detach() if isinstance(a, torch.Tensor)
                                   else a for a in aux)
        return loss
