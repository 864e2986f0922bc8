"""paddle_tpu_torch._C_ops: the low-level op namespace, port of
``paddle_tpu/_C_ops.py``.

Every op in the port's registry (``ops/ops.yaml``) is reachable here by
name, resolved lazily on first access.  The ``tensor`` ops return facade
tensors already; an ``nn.functional`` op called on facade tensors is
wrapped so that its tensor results are facade tensors too (a torch op
mixing a facade tensor and a ``torch.nn.Parameter`` may return a plain
tensor); on plain tensors it returns what torch gives.
"""

from __future__ import annotations

import functools

from .ops import registry as _registry


def _facade(fn):
    from .core.dispatch import wrap_like

    @functools.wraps(fn)
    def op(*args, **kwargs):
        return wrap_like(fn(*args, **kwargs),
                         list(args) + list(kwargs.values()))

    return op


def __getattr__(name: str):
    specs = _registry.registry_by_name()
    if name in specs:
        spec = specs[name]
        fn = _registry.resolve(spec)
        if not spec.module.startswith("paddle_tpu_torch.tensor"):
            fn = _facade(fn)
        globals()[name] = fn  # cache for next access
        return fn
    raise AttributeError(f"_C_ops has no op {name!r} "
                         "(not in paddle_tpu_torch/ops/ops.yaml)")


def __dir__():
    return sorted(_registry.registry_by_name())
