"""Functional autodiff: port of ``paddle_tpu/autograd/functional.py``
(``vjp``, ``jvp``, ``jacobian``, ``hessian``) over torch autograd, with
the reference's return structures: one input gives one result, a list
of inputs a list (``vjp``) or a tuple per input (``jacobian``, and
``hessian``'s nested tuples); the results need no gradient."""

from __future__ import annotations

import torch

from ..core.dispatch import wrap


def _list(xs):
    return list(xs) if isinstance(xs, (list, tuple)) else [xs]


def _detached(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_detached(v) for v in x)
    return wrap(x.detach()) if isinstance(x, torch.Tensor) else x


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def vjp(func, xs, v=None):
    ins = [x.detach().requires_grad_(True) for x in _list(xs)]
    with torch.enable_grad():
        out = func(*ins)
    outs = _flat(out)
    vs = [torch.ones_like(o) for o in outs] if v is None else _flat(v)
    grads = torch.autograd.grad(outs, ins, vs, allow_unused=True)
    grads = [torch.zeros_like(i) if g is None else g
             for i, g in zip(ins, grads)]
    res = _detached(grads)
    return _detached(out), (res if len(res) > 1 else res[0])


def jvp(func, xs, v=None):
    ins = tuple(x.detach() for x in _list(xs))
    tangents = tuple(torch.ones_like(i) for i in ins) if v is None \
        else tuple(_list(v))
    out, tan = torch.autograd.functional.jvp(
        lambda *a: func(*a), ins, tangents)
    return _detached(out), _detached(tan)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    ins = tuple(x.detach() for x in _list(xs))
    jac = torch.autograd.functional.jacobian(lambda *a: func(*a), ins)
    if not isinstance(xs, (list, tuple)) and isinstance(jac, tuple):
        jac = jac[0]
    return _detached(jac)


def hessian(func, xs, create_graph=False, allow_unused=False):
    ins = tuple(x.detach() for x in _list(xs))
    hess = torch.autograd.functional.hessian(lambda *a: func(*a), ins)
    if not isinstance(xs, (list, tuple)):
        hess = hess[0][0]
    return _detached(hess)
