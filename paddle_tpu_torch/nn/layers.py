"""The ``Layer`` facade: port of ``paddle_tpu/nn/layer/layers.py``.

- ``Parameter`` (:28) is a ``torch.nn.Parameter`` (and a facade
  ``Tensor``) that carries the reference's attributes: ``trainable`` (``requires_grad``; its inverse
  is ``stop_gradient``), ``optimize_attr`` (the per-parameter learning
  rate the port's optimizers read), ``regularizer``, ``need_clip`` (read
  by ``nn.clip``), ``persistable``, ``is_distributed`` and ``name``.
- ``ParamAttr`` (:50) with ``_to_attr`` (:63).
- ``Layer`` (:76) subclasses ``torch.nn.Module`` and adds the
  reference's methods that torch lacks: ``create_parameter`` (XavierUniform
  for a weight, ``Constant(0)`` for a bias unless an initializer is
  given), ``add_parameter``, ``add_sublayer``, ``named_sublayers``/
  ``sublayers(include_self=)``, ``register_forward_post_hook``,
  ``register_buffer(..., persistable=)``, ``set_state_dict`` (numpy
  arrays too), ``astype``, ``full_name``, ``clear_gradients`` and
  ``to(device, dtype, blocking)``.  Torch's own methods stay where both
  packages mean the same (README, "Known differences of the ``nn``
  API").

``create_parameter`` makes a parameter on ``device.layer_device()``
(the card unless ``set_device("cpu")``), or in host RAM under
``LazyGuard``, which moves it at the layer's first forward.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..core.tensor import Tensor
from ..device import layer_device, to_dtype
from . import lazy as _lazy

__all__ = ["Layer", "ParamAttr", "Parameter"]


class Parameter(torch.nn.Parameter, Tensor):
    """A trainable tensor with the reference's attributes; a facade
    ``Tensor`` too (``isinstance(p, paddle_tpu_torch.Tensor)``, as the
    reference's parameters are its tensors), whose torch calls stay
    plain (``torch.nn.Parameter``'s ``__torch_function__`` comes first)."""

    def __new__(cls, data=None, trainable: bool = True, name=None):
        p = super().__new__(cls, data, requires_grad=trainable)
        p._pname = name
        p.persistable = True
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.need_clip = True
        p.is_distributed = False
        return p

    def __deepcopy__(self, memo):
        # torch's copy makes a fresh parameter: carry the attributes over
        out = super().__deepcopy__(memo)
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    @property
    def name(self):
        return self.__dict__.get("_pname")

    @name.setter
    def name(self, value):
        self._pname = value

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool):
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        self.requires_grad_(not value)


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        # an Initializer instance
        return ParamAttr(initializer=attr)


def _to_args(args, kwargs):
    """The reference's ``to(device, dtype, blocking)`` as torch's
    ``to``'s arguments: ``blocking`` is the inverse of ``non_blocking``,
    dtype names become torch dtypes and ``"gpu"`` is ``"cuda"``."""
    args = list(args)
    if len(args) > 2:
        kwargs.setdefault("blocking", args.pop(2))
    blocking = kwargs.pop("blocking", None)
    if blocking is not None:
        kwargs["non_blocking"] = not blocking
    for k in ("device", "dtype"):
        if k in kwargs and kwargs[k] is None:
            del kwargs[k]
    if kwargs.get("dtype") is not None:
        kwargs["dtype"] = to_dtype(kwargs["dtype"])
    for i, a in enumerate(args):
        if isinstance(a, str):
            if isinstance(getattr(torch, a, None), torch.dtype):
                args[i] = getattr(torch, a)
            else:
                args[i] = a.replace("gpu", "cuda")
    if isinstance(kwargs.get("device"), str):
        kwargs["device"] = kwargs["device"].replace("gpu", "cuda")
    moves = "device" in kwargs or any(
        not isinstance(a, torch.dtype) for a in args)
    return args, kwargs, moves


class Layer(torch.nn.Module):
    """The reference's ``Layer`` over ``torch.nn.Module``."""

    def __init__(self, name_scope=None, dtype=None):
        super().__init__()
        self._dtype = to_dtype(dtype) if dtype else torch.float32
        self._full_name = name_scope or type(self).__name__.lower()
        if _lazy.in_lazy_mode():
            # its first forward places every lazily born layer under it
            _lazy.defer(self, None)

    # ---- construction ----
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from .initializer import Constant, XavierUniform
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = to_dtype(dtype) if dtype else self._dtype
        init = attr.initializer or default_initializer or (
            Constant(0.0) if is_bias else XavierUniform())
        target = layer_device()
        with _lazy.lazy_init_scope(target):
            value = init(tuple(int(s) for s in shape), dtype)
        if _lazy.in_lazy_mode():
            value = value.to("cpu")
            _lazy.defer(self, target)
        else:
            value = value.to(target)
        p = Parameter(value.detach(), trainable=attr.trainable,
                      name=attr.name)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        super().register_buffer(
            name, tensor,
            persistent=persistable if persistent is None else persistent)
        return tensor

    # ---- iteration ----
    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is not self or include_self:
                yield name, m

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    # ---- hooks ----
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a result other than None
        replaces the outputs.  The handle's ``remove()`` drops it."""
        return self.register_forward_hook(hook)

    # ---- state ----
    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (tensors or numpy arrays) into
        this layer's parameters and buffers, by name, in place; returns
        ``(missing, unexpected)`` names.  A shape mismatch raises."""
        own = self.state_dict(keep_vars=True)
        missing = []
        for name, tensor in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            if not isinstance(src, torch.Tensor):
                src = torch.as_tensor(np.asarray(src))
            if tuple(src.shape) != tuple(tensor.shape):
                raise ValueError(
                    f"shape mismatch for {name}: checkpoint "
                    f"{tuple(src.shape)} vs model {tuple(tensor.shape)}")
            tensor.copy_(src)
        unexpected = [n for n in state_dict if n not in own]
        return missing, unexpected

    load_dict = set_state_dict

    # ---- dtype and device ----
    def to(self, *args, **kwargs):
        args, kwargs, moves = _to_args(args, kwargs)
        out = super().to(*args, **kwargs)
        if moves:
            _lazy.settle(self)
        dtype = kwargs.get("dtype") or next(
            (a for a in args if isinstance(a, torch.dtype)), None)
        if dtype is not None:
            self._dtype = dtype
        return out

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def full_name(self):
        return self._full_name

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None
