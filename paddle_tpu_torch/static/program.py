"""Static-graph mode: Program capture and the Executor.

Port of ``paddle_tpu/static/program.py``.  The reference records every op
that flows through its eager dispatcher while a ``program_guard`` is
open, infers output shapes with ``jax.eval_shape`` and compiles the
replay with ``jax.jit``.  Here:

- ``static.data(name, shape, dtype)`` makes a feed variable: a tensor on
  the ``meta`` device (shape and dtype, no storage), so reading its data
  raises, like an uninitialised static Variable.
- Under ``program_guard`` a ``TorchFunctionMode`` records every torch
  call that reaches a program variable (an argument that is one, or the
  ``meta`` device a variable reports, as in ``torch.arange(n,
  device=x.device)``).  The output shapes come from running the call on
  ``meta`` tensors (the counterpart of ``jax.eval_shape``); a call whose
  result holds no tensor (``x.shape``, ``x.dim()``) is answered, not
  recorded.  Concrete tensors a recorded call crosses become captured
  constants, and ``nn.Parameter``s among them the program's parameters
  (the reference's persistable vars in the Scope).
- ``Executor(place)`` replays the recorded calls in order on the card
  unless ``"cpu"`` is asked for, and caches what it prepares per
  (program, its version, the fetch list, the feed signature).  A
  captured parameter that lives elsewhere gets a copy at its place (the
  Scope lives there), refreshed from the user's parameter when that one
  changed since (its version counter), and the updates of a run are
  written back to the user's parameter after it; the user's module stays
  where it is.  Other constants get a copy there.
  There is nothing to compile: the calls run eagerly, through the
  kernels where a call reaches one.  Float32 convolutions run with
  cuDNN's TF32 off, as the eager layers run them.
- ``append_backward(loss)`` names gradient variables that the Executor
  computes with ``torch.autograd.grad`` over the replay.
- ``Optimizer.minimize(loss)`` on a program variable records functional
  parameter updates, which the Executor applies after each run and
  writes into the parameters in place.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.overrides import TorchFunctionMode

from ..device import resolve_device, to_dtype

_var_ids = itertools.count()
_META = torch.device("meta")


def _is_var(v) -> bool:
    return isinstance(v, torch.Tensor) and hasattr(v, "_static_var_id")


def _is_marker(v) -> bool:
    """A program variable, or the ``meta`` device one reports."""
    return _is_var(v) or (isinstance(v, torch.device) and v.type == "meta")


def _meta_empty(shape, dtype) -> torch.Tensor:
    # the device as a string: a torch.device("meta") argument would be
    # recorded by an open program_guard
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _new_var(meta: torch.Tensor, name=None) -> torch.Tensor:
    vid = next(_var_ids)
    meta._static_var_id = vid
    meta._static_name = name or f"var_{vid}"
    return meta


class _OpRecord:
    __slots__ = ("op_name", "func", "spec", "refs", "out_ids")

    def __init__(self, op_name, func, spec, refs, out_ids):
        self.op_name = op_name
        self.func = func          # the torch callable that was called
        self.spec = spec          # pytree spec of (args, kwargs)
        self.refs = refs          # per leaf: ("var", id) | ("const", key)
        #                           | ("device",) | ("value", v)
        self.out_ids = out_ids    # per result leaf: var id or None


def _op_name(func) -> str:
    name = getattr(func, "__name__", None) or str(func)
    return name.split(".")[0] if "." in name else name


class Program:
    """Recorded call DAG (≙ ProgramDesc, framework.proto:267)."""

    def __init__(self):
        self.ops: List[_OpRecord] = []
        self.feeds: Dict[str, int] = {}       # feed name -> var id
        self.var_meta: Dict[int, torch.Tensor] = {}
        self.var_names: Dict[int, str] = {}
        # concrete tensors crossed by the graph (params + constants)
        self.captured: Dict[int, torch.Tensor] = {}   # key = id(tensor)
        self.grad_of: Dict[int, torch.Tensor] = {}    # grad var id -> param
        self._loss_var: Optional[int] = None
        self.updates: List = []   # (param, update_fn(p, g))
        self.version = 0

    # -- building --
    def add_feed(self, name, shape, dtype) -> torch.Tensor:
        t = _new_var(_meta_empty(shape, to_dtype(dtype)), name)
        self.feeds[name] = t._static_var_id
        self.var_meta[t._static_var_id] = t
        self.var_names[t._static_var_id] = t._static_name
        self.version += 1
        return t

    def record(self, func, args, kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        refs, metas = [], []
        for v in leaves:
            if _is_var(v):
                refs.append(("var", v._static_var_id))
                metas.append(v)
            elif isinstance(v, torch.device) and v.type == "meta":
                refs.append(("device",))
                metas.append(v)
            elif isinstance(v, torch.Tensor):
                if v.device.type == "meta":
                    raise ValueError(
                        f"static: {_op_name(func)} got a meta tensor that "
                        f"is not a variable of this program")
                self.captured[id(v)] = v
                refs.append(("const", id(v)))
                metas.append(v.detach().to(_META))
            else:
                refs.append(("value", v))
                metas.append(v)
        margs, mkwargs = pytree.tree_unflatten(metas, spec)
        out = func(*margs, **mkwargs)       # ≙ InferMeta
        out_leaves = pytree.tree_leaves(out)
        if not any(isinstance(o, torch.Tensor) for o in out_leaves):
            return out
        out_ids = []
        for o in out_leaves:
            if isinstance(o, torch.Tensor):
                _new_var(o)
                self.var_meta[o._static_var_id] = o
                self.var_names[o._static_var_id] = o._static_name
                out_ids.append(o._static_var_id)
            else:
                out_ids.append(None)
        self.ops.append(_OpRecord(_op_name(func), func, spec, refs,
                                  out_ids))
        self.version += 1
        return out

    # -- backward / optimize --
    def append_backward(self, loss: torch.Tensor, parameter_list=None):
        if not _is_var(loss):
            raise ValueError("append_backward: loss is not a Variable of "
                             "this program")
        self._loss_var = loss._static_var_id
        params = [p for p in (parameter_list if parameter_list is not None
                              else self.all_parameters())
                  if p.requires_grad]
        grads = []
        for p in params:
            pname = getattr(p, "name", None) or f"param_{id(p)}"
            g = _new_var(_meta_empty(p.shape, p.dtype), f"{pname}@GRAD")
            self.var_meta[g._static_var_id] = g
            self.var_names[g._static_var_id] = g._static_name
            self.grad_of[g._static_var_id] = p
            grads.append((p, g))
        self.version += 1
        return grads

    def global_block(self):
        return self

    def all_parameters(self):
        return [t for t in self.captured.values()
                if isinstance(t, torch.nn.Parameter)]

    def __str__(self):
        lines = [f"Program(ops={len(self.ops)}, feeds={list(self.feeds)})"]
        for op in self.ops:
            ins = ", ".join(self.var_names.get(r[1], "?") if r[0] == "var"
                            else r[0] for r in op.refs
                            if r[0] in ("var", "const"))
            outs = ", ".join(self.var_names[i] for i in op.out_ids
                             if i is not None)
            lines.append(f"  {outs} = {op.op_name}({ins})")
        return "\n".join(lines)


class _Recorder(TorchFunctionMode):
    """Routes every torch call that reaches a program variable into the
    program being built; any other call runs as it would."""

    def __init__(self, program: Program):
        super().__init__()
        self.program = program

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_marker(v) for v in pytree.tree_leaves((args, kwargs))):
            return self.program.record(func, args, kwargs)
        return func(*args, **kwargs)


_default_main_program = Program()
_default_startup_program = Program()  # params init eagerly; kept for parity
_building: List[Program] = []
_modes: List[_Recorder] = []


def default_main_program() -> Program:
    return _default_main_program


def default_startup_program() -> Program:
    return _default_startup_program


def current_build_program() -> Optional[Program]:
    return _building[-1] if _building else None


class program_guard:
    """Record torch calls into ``main_program`` (≙ base/framework.py
    program_guard)."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self.main_program = main_program
        self.startup_program = startup_program

    def __enter__(self):
        mode = _Recorder(self.main_program)
        mode.__enter__()
        _building.append(self.main_program)
        _modes.append(mode)
        return self

    def __exit__(self, *exc):
        _building.pop()
        _modes.pop().__exit__(*exc)
        return False


def data(name: str, shape: Sequence[int], dtype="float32", lod_level=0):
    """Feed placeholder (≙ paddle.static.data); a ``None`` or negative
    dimension becomes 1, as in the reference."""
    prog = current_build_program()
    if prog is None:
        raise RuntimeError("static.data() must be called under program_guard")
    shape = [1 if (s is None or s < 0) else s for s in shape]
    return prog.add_feed(name, shape, dtype)


def append_backward(loss, parameter_list=None):
    prog = current_build_program() or default_main_program()
    return prog.append_backward(loss, parameter_list)


def _feed_tensor(v, dtype, device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device=device, dtype=dtype, copy=True)


class Executor:
    """Runs Programs (≙ base/executor.py:1036).  ``place``: the CUDA card
    (default) or ``"cpu"``.  The cache is keyed by (program identity,
    program version, fetch ids, feed signature), the analogue of
    ``_ExecutorCache``."""

    def __init__(self, place=None):
        self.place = resolve_device(None if place in (None, "gpu")
                                    else place)
        self._cache = {}

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, return_numpy: bool = True):
        from ..nn.functional.conv import _cudnn_full_fp32
        program = program or default_main_program()
        feed = feed or {}
        fetch_ids = []
        for f in fetch_list or []:
            if not _is_var(f):
                raise ValueError(f"fetch target {f!r} is not a Variable of "
                                 "the program")
            fetch_ids.append(f._static_var_id)
        feed_vals = []
        for name in sorted(program.feeds):
            if name not in feed:
                raise ValueError(f"missing feed {name!r}")
            meta = program.var_meta[program.feeds[name]]
            feed_vals.append(_feed_tensor(feed[name], meta.dtype,
                                          self.place))
        sig = tuple((tuple(v.shape), v.dtype) for v in feed_vals)
        key = (id(program), program.version, tuple(fetch_ids), sig)
        entry = self._cache.get(key)
        if entry is None:
            entry = self._cache[key] = _Compiled(program, fetch_ids,
                                                 self.place)
        with _cudnn_full_fp32():
            outs = entry(feed_vals)
        if return_numpy:
            return [o.detach().cpu().numpy() for o in outs]
        return [o.detach() for o in outs]


class _Compiled:
    """A program prepared for one Executor: captured parameters and other
    constants at its place, and the replay.  ``placed`` pairs each
    parameter that lives elsewhere with its copy here and the version of
    the user's parameter that the copy holds."""

    def __init__(self, program: Program, fetch_ids, device):
        self.program = program
        self.fetch_ids = list(fetch_ids)
        self.consts = {}
        self.here = {}            # id(user parameter) -> the one used here
        self.placed = []          # [user parameter, copy here, version]
        for k, t in program.captured.items():
            if isinstance(t, torch.nn.Parameter) and t.device != device:
                copy = t.detach().to(device, copy=True).requires_grad_(
                    t.requires_grad)
                self.placed.append([t, copy, t._version])
                self.here[id(t)] = self.consts[k] = copy
            elif isinstance(t, torch.nn.Parameter):
                self.here[id(t)] = self.consts[k] = t
            else:
                self.consts[k] = t.to(device)
        self.device = device
        grad_fetch = [f for f in fetch_ids if f in program.grad_of]
        self.diff = list({id(p): self.here[id(p)] for p in
                          [program.grad_of[f] for f in grad_fetch]
                          + [p for p, _ in program.updates]}.values())

    def _replay(self, feed_vals):
        prog = self.program
        env = {prog.feeds[name]: v
               for name, v in zip(sorted(prog.feeds), feed_vals)}
        for op in prog.ops:
            leaves = [env[r[1]] if r[0] == "var" else
                      self.consts[r[1]] if r[0] == "const" else
                      self.device if r[0] == "device" else r[1]
                      for r in op.refs]
            args, kwargs = pytree.tree_unflatten(leaves, op.spec)
            out = op.func(*args, **kwargs)
            for vid, o in zip(op.out_ids, pytree.tree_leaves(out)):
                if vid is not None:
                    env[vid] = o
        return env

    def __call__(self, feed_vals):
        prog = self.program
        with torch.no_grad():
            for entry in self.placed:
                user, copy, seen = entry
                if user._version != seen:
                    copy.copy_(user)
                    entry[2] = user._version
        if not self.diff:
            with torch.no_grad():
                env = self._replay(feed_vals)
            return [env[f] for f in self.fetch_ids]
        with torch.enable_grad():
            env = self._replay(feed_vals)
            grads = torch.autograd.grad(env[prog._loss_var], self.diff,
                                        allow_unused=True)
        grads = {id(p): torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.diff, grads)}
        here = self.here
        outs = [grads[id(here[id(prog.grad_of[f])])] if f in prog.grad_of
                else env[f] for f in self.fetch_ids]
        outs = [o.detach() for o in outs]
        with torch.no_grad():
            for p, update in prog.updates:
                q = here[id(p)]
                q.copy_(update(q, grads[id(q)]))
            updated = {id(p) for p, _ in prog.updates}
            for entry in self.placed:
                user, copy, _ = entry
                if id(user) in updated:
                    user.copy_(copy)
                    entry[2] = user._version
        return outs


_global_scope = {}


def global_scope():
    return _global_scope
