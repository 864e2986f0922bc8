"""The eager Tensor facade: port of ``paddle_tpu/core/tensor.py``.

``Tensor`` is a ``torch.Tensor`` subclass that *adds* the reference's
surface and changes no ``torch.Tensor`` method for a call torch accepts:

- ``stop_gradient`` (the inverse of ``requires_grad``; ``True`` on a
  non-leaf detaches it in place, the reference's cut), ``astype``/
  ``cast``, ``place``, ``persistable``, ``clear_grad``/
  ``clear_gradient``, ``set_value``, ``gradient()``, ``value``, a
  settable ``name`` and the reference's ``__repr__``; the registry's
  methods whose names torch lacks are attached by ``tensor/__init__.py``,
  with the operators and ``__getitem__``/``__setitem__`` (which go
  through the facade's functions for the reference's result dtype and
  op names).
- ``numpy()`` detaches and copies to the host; a bf16 tensor comes back
  as float32 (numpy has no bf16).
- ``register_hook`` keeps the reference's rule: a hook fires once per
  consuming op, on that edge's gradient.  Each use of a hooked tensor
  by a facade op, an operator, or a torch function or method called on
  it (``__torch_function__``) goes through a per-use identity
  ``torch.autograd.Function`` whose backward runs the hooks.

Results stay facade tensors: ``__torch_function__`` runs each torch call
with torch-function dispatch off and re-classes the plain tensors it
returns (``as_facade``: the same object, so no alias is made and a
result can be detached in place).  The 190 registry method names that
``torch.Tensor`` already has keep torch's meaning (README, "Known
differences of the tensor facade"); the functions carry the reference's.
"""

from __future__ import annotations

import copy
import itertools
import weakref
from typing import Optional

import numpy as np
import torch
from torch._C import DisableTorchFunctionSubclass as _NoTF

from . import dtypes as _dtypes

_names = itertools.count()
# hooks held by live facade tensors (registered, not removed, their
# tensor not freed): the per-use wrapping is skipped while there is none
_hooked = [0]

_NOWRAP = torch.overrides.get_default_nowrap_functions()
_GRAD_GET = torch.Tensor.grad.__get__
# torch calls whose tensor arguments are never wrapped for hooks (nor
# attribute accessors, by name)
_NO_HOOK = {torch.Tensor.backward, torch.Tensor.register_hook,
            torch.Tensor.detach, torch.Tensor.detach_,
            torch.Tensor.requires_grad_, torch.Tensor.retain_grad,
            torch.Tensor.__setitem__, torch.Tensor.__repr__,
            torch.Tensor.numpy, torch.Tensor.tolist, torch.Tensor.item,
            torch.autograd.backward, torch.autograd.grad}
_ACCESSORS = ("__get__", "__set__", "__delete__")

SECTION = "README, 'Known differences of the tensor facade'"


def as_facade(t):
    """``t`` as a facade ``Tensor``: a plain ``torch.Tensor`` is
    re-classed in place (no alias); anything else is returned as is."""
    if type(t) is torch.Tensor:
        t.__class__ = Tensor
    return t


def _adopt(ret, args):
    """Re-class the plain tensors of a torch call's result, leaving any
    that is one of the call's own (plain) arguments as it is."""
    if type(ret) is torch.Tensor:
        for a in args:
            if a is ret:
                return ret
        ret.__class__ = Tensor
    elif isinstance(ret, (tuple, list)):
        for r in ret:
            _adopt(r, args)
    return ret


class _HookEdge(torch.autograd.Function):
    """One use of a hooked tensor: identity forward; the backward runs the
    tensor's hooks (the live list) on this edge's gradient."""

    @staticmethod
    def forward(ctx, x, hooks):
        ctx.hooks = hooks
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for hook in list(ctx.hooks):
            new = hook(g.as_subclass(Tensor))
            if new is not None:
                g = new
        return g, None


def edge(t):
    """A per-use stand-in for ``t`` when it carries hooks and needs a
    gradient (call with torch-function dispatch off)."""
    hooks = t.__dict__.get("_grad_hooks") if isinstance(t, Tensor) \
        else None
    if hooks and t.requires_grad and torch.is_grad_enabled():
        return _HookEdge.apply(t, hooks)
    return t


def _edges(args, kwargs):
    def one(a):
        if isinstance(a, Tensor):
            return edge(a)
        if isinstance(a, (list, tuple)) and any(
                isinstance(x, Tensor) for x in a):
            return type(a)(edge(x) if isinstance(x, Tensor) else x
                           for x in a)
        return a
    return (tuple(one(a) for a in args),
            {k: one(v) for k, v in kwargs.items()})


class _Hooks(list):
    """A facade tensor's gradient hooks.  While the tensor lives each
    counts in ``_hooked``; when it is freed they stop counting (a graph
    that still holds its edges runs them all the same)."""
    alive = True


def _release(hooks):
    hooks.alive = False
    _hooked[0] -= len(hooks)


def _hooks_of(t):
    """``t``'s hook list, made (and tied to ``t``'s life) on first use."""
    hooks = t.__dict__.get("_grad_hooks")
    if hooks is None:
        hooks = t.__dict__["_grad_hooks"] = _Hooks()
        weakref.finalize(t, _release, hooks)
    return hooks


class _Handle:
    def __init__(self, hooks, hook):
        self._hooks, self._hook = hooks, hook

    def remove(self):
        try:
            self._hooks.remove(self._hook)
        except ValueError:
            return
        if self._hooks.alive:
            _hooked[0] -= 1


class Tensor(torch.Tensor):
    """The reference's ``Tensor`` over ``torch.Tensor`` (module
    docstring)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if kwargs is None:
            kwargs = {}
        with _NoTF():
            if _hooked[0] and func not in _NO_HOOK and getattr(
                    func, "__name__", "") not in _ACCESSORS:
                args, kwargs = _edges(args, kwargs)
            ret = func(*args, **kwargs)
        if func in _NOWRAP:
            return as_facade(ret) if func == _GRAD_GET else ret
        return _adopt(ret, args)

    __hash__ = torch.Tensor.__hash__

    # ---- the reference's attributes ----
    @property
    def stop_gradient(self) -> bool:
        sg = self.__dict__.get("_stop_gradient")
        if sg is not None:
            return sg
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        with _NoTF():
            if not (self.is_floating_point() or self.is_complex()):
                # no gradient flows through an integer tensor: keep the flag
                self.__dict__["_stop_gradient"] = value
                return
            if value:
                if self.grad_fn is None:
                    self.requires_grad_(False)
                elif self._base is not None:
                    raise RuntimeError(
                        "stop_gradient=True cannot cut a view of another "
                        "tensor in place (torch keeps a view's history "
                        "with its base); use .detach() on it instead "
                        f"({SECTION})")
                else:
                    self.detach_()
            elif not self.requires_grad:
                self.requires_grad_(True)

    @property
    def place(self):
        from .device import place_of
        return place_of(self.device)

    @property
    def persistable(self) -> bool:
        return self.__dict__.get("_persistable", False)

    @persistable.setter
    def persistable(self, value):
        self.__dict__["_persistable"] = bool(value)

    @property
    def name(self) -> str:
        n = self.__dict__.get("_pname")
        if n is None:
            n = self.__dict__["_pname"] = f"tensor_{next(_names)}"
        return n

    @name.setter
    def name(self, value):
        self.__dict__["_pname"] = value

    @property
    def value(self) -> torch.Tensor:
        """The underlying plain ``torch.Tensor`` (an alias)."""
        return self.as_subclass(torch.Tensor)

    # ---- conversions ----
    def numpy(self) -> np.ndarray:
        """A host copy; bf16 (which numpy lacks) as float32."""
        with _NoTF():
            t = self.detach().cpu().resolve_conj().resolve_neg()
            if t._is_zerotensor():     # autograd's zero gradient
                t = torch.zeros(t.shape, dtype=t.dtype)
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.numpy().copy()

    def gradient(self) -> Optional[np.ndarray]:
        g = self.grad
        return None if g is None else g.numpy()

    # ---- autograd ----
    def backward(self, grad_tensor=None, retain_graph=False,
                 create_graph=False, inputs=None, gradient=None):
        from .tape import backward
        g = grad_tensor if grad_tensor is not None else gradient
        backward([self], [g], retain_graph=retain_graph,
                 create_graph=create_graph, inputs=inputs)

    def clear_grad(self, set_to_zero=False):
        if set_to_zero and self.grad is not None:
            with torch.no_grad():
                self.grad.zero_()
        else:
            self.grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """``hook(grad)`` runs once per consuming op on that use's
        gradient; a result other than None replaces it.  Returns a handle
        whose ``remove()`` drops the hook."""
        hooks = _hooks_of(self)
        hooks.append(hook)
        _hooked[0] += 1
        return _Handle(hooks, hook)

    def set_value(self, value):
        """Replace the values (cast to this tensor's dtype; a new shape is
        taken as is); the tensor leaves the graph it was recorded in."""
        with _NoTF():
            if isinstance(value, torch.Tensor):
                new = value.detach()
            else:
                new = _dtypes.from_numpy(np.asarray(value))
            new = new.to(device=self.device, dtype=self.dtype)
            if self.grad_fn is not None and self._base is None:
                self.detach_()
            if tuple(new.shape) == tuple(self.shape):
                with torch.no_grad():
                    self.copy_(new)
            else:
                self.data = new.clone()
        return self

    def __deepcopy__(self, memo):
        # torch's copy makes the copy with new_empty, which returns a
        # plain tensor under this class's __torch_function__
        if id(self) in memo:
            return memo[id(self)]
        with _NoTF():
            if self.grad_fn is not None:
                raise RuntimeError(
                    "Only Tensors created explicitly by the user (graph "
                    "leaves) support the deepcopy protocol at the moment")
            new = self.detach().clone().requires_grad_(self.requires_grad)
        new.__class__ = type(self)
        new.__dict__.update(copy.deepcopy(self.__dict__, memo))
        for hook in new.__dict__.pop("_grad_hooks", ()):
            new.register_hook(hook)     # counted, and tied to the copy
        memo[id(self)] = new
        return new

    def __repr__(self):
        if self.is_meta:        # a static program's variable: no values
            return torch.Tensor.__repr__(self)
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={list(self.shape)}, dtype="
                f"{_dtypes.dtype_name(self.dtype)}{grad_info},\n"
                f"       {self.numpy()})")


def inplace_update(x, out):
    """The reference's in-place op: ``x`` takes ``out``'s values.  A copy
    into ``x`` where shape and dtype agree (torch records it, and refuses
    it on a leaf that needs a gradient); else ``x``'s data is replaced,
    which is refused for a tensor that needs a gradient."""
    with _NoTF():
        if out.dtype == x.dtype and tuple(out.shape) == tuple(x.shape):
            x.copy_(out)
        elif x.requires_grad:
            raise RuntimeError(
                "an in-place op that changes the shape or dtype of a tensor "
                f"that needs a gradient is refused ({SECTION})")
        else:
            x.data = out.detach()
    return x


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True):
    """``paddle.to_tensor``: python scalars and lists default to the
    default float dtype or int32; numpy arrays keep their dtype with
    64-bit types narrowed to 32 bits (a ``bfloat16`` array becomes a
    bf16 tensor); a tensor is copied.  The result lies on ``place`` or
    else ``set_device``'s device (a tensor: on its own device)."""
    from .device import to_torch_device
    d = _dtypes.convert_dtype(dtype)
    with _NoTF():
        if isinstance(data, torch.Tensor):
            dev = to_torch_device(place) if place is not None \
                else data.device
            src = data.detach()
            out = src.to(device=dev, dtype=d or _dtypes.canonical(
                src.dtype), copy=True)
        else:
            dev = to_torch_device(place)
            if d is None and not hasattr(data, "dtype"):
                probe = np.asarray(data)
                if probe.dtype == np.float64:
                    d = _dtypes.default_float_dtype()
                host = _dtypes.from_numpy(probe)
            else:
                host = _dtypes.from_numpy(np.asarray(data))
            if d is not None and host.dtype != d:
                host = host.to(d)
            out = host.to(dev)
    out.__class__ = Tensor
    if not stop_gradient:
        out.stop_gradient = False
    return out


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)
