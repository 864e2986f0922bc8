"""PyLayer: user-defined forward/backward, port of
``paddle_tpu/autograd/py_layer.py`` over ``torch.autograd.Function``.

``forward(ctx, *args)`` runs with recording off; the user's
``backward(ctx, *grads)`` is the node's backward and returns one
gradient per tensor input (None for one that needs none).  Under
``create_graph=True`` torch runs the backward with recording on, so its
gradients are differentiable again.  Tensors saved by
``ctx.save_for_backward`` are kept on the context as given, as the
reference keeps them.
"""

from __future__ import annotations

import torch

from ..core.dispatch import is_facade_call, wrap_like
from ..core.tensor import Tensor


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    def saved_tensor(self):
        return self._saved


def _facade(x):
    if isinstance(x, torch.Tensor) and not isinstance(x, Tensor):
        return x.as_subclass(Tensor)
    return x


class _Function(torch.autograd.Function):
    @staticmethod
    def forward(tctx, layer, kwargs, *args):
        ctx = PyLayerContext()
        tctx.pyctx, tctx.layer = ctx, layer
        tctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        tctx.facade = is_facade_call(args)
        return layer.forward(ctx, *args, **kwargs)

    @staticmethod
    def backward(tctx, *grads):
        if tctx.facade:
            grads = tuple(_facade(g) for g in grads)
        got = tctx.layer.backward(tctx.pyctx, *grads)
        got = got if isinstance(got, tuple) else (got,)
        it = iter(got)
        out = [None, None]
        for is_t in tctx.is_tensor:
            out.append(next(it, None) if is_t else None)
        return tuple(out)


class PyLayer:
    """Subclass and define ``forward(ctx, *args)`` and
    ``backward(ctx, *grads)``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return wrap_like(_Function.apply(cls, kwargs, *args), args)
