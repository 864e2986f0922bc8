"""The eager autograd surface: port of ``paddle_tpu/core/tape.py`` on
torch autograd.

The reference records a tape node per op and walks it in reverse; the
port records nothing of its own: every facade op is torch ops, so
torch's graph is the tape.  What the reference adds on top is kept:

- ``no_grad`` (a context manager and a decorator), ``enable_grad``,
  ``set_grad_enabled`` and ``is_grad_enabled`` are torch's grad mode
  (per thread, as the reference's);
- ``backward(roots, grad_tensors, retain_graph)`` accumulates into the
  leaves' ``.grad`` across calls;
- ``grad(...)`` returns the gradients without touching ``.grad`` and
  raises the reference's ``ValueError`` for an unused input (unless
  ``allow_unused``) and for a non-scalar root given no gradient; an
  input that needs no gradient counts as unused.

Per-edge gradient hooks are ``core.tensor``'s.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Sequence

import torch

from .tensor import as_facade


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


class set_grad_enabled:
    """``set_grad_enabled(mode)``: switches grad mode at once; used as a
    context manager, restores the previous mode on exit."""

    def __init__(self, mode: bool):
        self._prev = torch.is_grad_enabled()
        torch._C._set_grad_enabled(bool(mode))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        torch._C._set_grad_enabled(self._prev)
        return False


class _GradMode:
    _mode = False

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch._C._set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch._C._set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        mode = self._mode

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            prev = torch.is_grad_enabled()
            torch._C._set_grad_enabled(mode)
            try:
                return fn(*args, **kwargs)
            finally:
                torch._C._set_grad_enabled(prev)

        return wrapper


class no_grad(_GradMode):
    """Context manager and decorator (``@no_grad()`` or ``@no_grad``)
    that turns recording off."""

    _mode = False

    def __new__(cls, fn=None):
        self = super().__new__(cls)
        if callable(fn):           # bare ``@no_grad``
            return self(fn)
        return self

    def __init__(self, fn=None):
        pass


class enable_grad(_GradMode):
    _mode = True


def _roots(tensors):
    if isinstance(tensors, torch.Tensor):
        return [tensors]
    return list(tensors)


def _seed(roots, grad_tensors):
    """The gradients to start from: a scalar root may go without one."""
    if grad_tensors is None:
        grad_tensors = []
    elif isinstance(grad_tensors, torch.Tensor):
        grad_tensors = [grad_tensors]
    seeds = []
    for t, g in zip(roots, list(grad_tensors) + [None] * len(roots)):
        if g is None:
            if t.numel() != 1:
                raise ValueError(
                    "grad must be provided for non-scalar backward root "
                    f"(shape={list(t.shape)})")
            g = torch.ones_like(t.as_subclass(torch.Tensor))
        elif not isinstance(g, torch.Tensor):
            g = torch.as_tensor(g, dtype=t.dtype, device=t.device)
        seeds.append(g)
    return seeds


def backward(root_tensors: Sequence[Any],
             grad_tensors: Optional[Sequence[Any]] = None,
             retain_graph: bool = False, create_graph: bool = False,
             inputs=None) -> None:
    """Reverse accumulation from ``root_tensors`` into the leaves'
    ``.grad``; roots that need no gradient are skipped."""
    roots = _roots(root_tensors)
    seeds = _seed(roots, grad_tensors)
    pairs = [(r, g) for r, g in zip(roots, seeds) if r.requires_grad]
    if not pairs:
        return
    torch.autograd.backward([r for r, _ in pairs], [g for _, g in pairs],
                            retain_graph=retain_graph or create_graph,
                            create_graph=create_graph, inputs=inputs)


def grad(outputs, inputs, grad_outputs=None, retain_graph=False,
         create_graph=False, allow_unused=False):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``; with ``create_graph`` they are differentiable again."""
    roots = _roots(outputs)
    seeds = _seed(roots, grad_outputs)
    single = isinstance(inputs, torch.Tensor)
    ins = [inputs] if single else list(inputs)
    live = [i for i, t in enumerate(ins) if t.requires_grad]
    pairs = [(r, g) for r, g in zip(roots, seeds) if r.requires_grad]
    found = [None] * len(ins)
    if live and pairs:
        got = torch.autograd.grad(
            [r for r, _ in pairs], [ins[i] for i in live],
            [g for _, g in pairs],
            retain_graph=retain_graph or create_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(live, got):
            found[i] = None if g is None else as_facade(g)
    for t, g in zip(ins, found):
        if g is None and not allow_unused:
            name = getattr(t, "name", None) or "tensor"
            raise ValueError(
                f"one of the differentiated tensors ({name}) appears "
                "unused; pass allow_unused=True to return None for it")
    return found
