"""``InputSpec``: port of ``paddle_tpu/jit/api.py:19``, a shape, a dtype
and a name.  The rest of ``jit`` (``to_static``, ``save``/``load``) is
ROADMAP.md, Queue 1, item 13 (framework surface: jit and static)."""

from __future__ import annotations

from ..device import to_dtype


class InputSpec:
    """Analogue of ``paddle.static.InputSpec``; ``dtype`` is a torch
    dtype (a name such as ``"float32"`` is converted)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = to_dtype(dtype)
        self.name = name
