"""Lazy parameter initialization: port of ``paddle_tpu/nn/lazy.py``.

Under ``LazyGuard`` parameters are born in host RAM: ``create_parameter``
runs its initializer on CPU tensors (``lazy_init_scope``) and every port
layer built under the guard is materialized on the CPU
(``nn.common.materialize``), so the card's memory does not grow while a
model is built.  Each such module remembers the device it would have had
without the guard (the card unless ``"cpu"`` was asked for; without CUDA
the build raises, as every entry point does) and moves there at its
first forward, or at an explicit ``Layer.to``.  The move sets each
parameter's ``.data`` in place, so an optimizer made before it keeps the
same parameters: the reference's "values move on use".
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["LazyGuard", "in_lazy_mode", "lazy_init_scope"]

_LAZY = False


def in_lazy_mode() -> bool:
    return _LAZY


class LazyGuard:
    """``with LazyGuard(): model = BigModel()``: parameters live on the
    host until first use."""

    def __enter__(self):
        global _LAZY
        self._prev = _LAZY
        _LAZY = True
        return self

    def __exit__(self, *exc):
        global _LAZY
        _LAZY = self._prev
        return False


def lazy_init_scope(device=None):
    """The default device under which an initializer runs: the CPU in
    lazy mode, else ``device`` (none when ``device`` is None)."""
    if _LAZY:
        return torch.device("cpu")
    if device is None:
        return contextlib.nullcontext()
    return torch.device(device)


def defer(module: torch.nn.Module, target, recurse: bool = False) -> None:
    """Mark ``module`` (with ``recurse`` each of its submodules) as born on
    the host for ``target`` (None: it owns nothing to move), and make its
    first forward place every such module under it."""
    for m in (module.modules() if recurse else (module,)):
        if target is not None:
            m._lazy_target = torch.device(target)
        if getattr(m, "_lazy_hook", None) is None:
            m._lazy_hook = m.register_forward_pre_hook(_place_hook)


def _place_hook(module, args):
    place(module)


def _forget(m: torch.nn.Module):
    """Remove ``m``'s first-forward hook; returns its target (or None)."""
    hook = m.__dict__.pop("_lazy_hook", None)
    if hook is not None:
        hook.remove()
    return m.__dict__.pop("_lazy_target", None)


@torch.no_grad()
def place(module: torch.nn.Module) -> None:
    """Move every deferred module under ``module`` to its target, in
    place, and forget the deferral."""
    for m in module.modules():
        target = _forget(m)
        if target is None:
            continue
        for p in m._parameters.values():
            if p is not None and p.device != target:
                p.data = p.data.to(target)
                if p.grad is not None:
                    p.grad = p.grad.to(target)
        for name, b in m._buffers.items():
            if b is not None and b.device != target:
                m._buffers[name] = b.to(target)


def settle(module: torch.nn.Module) -> None:
    """Forget every deferral under ``module``: an explicit ``.to`` placed
    it."""
    for m in module.modules():
        _forget(m)
