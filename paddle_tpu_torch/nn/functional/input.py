"""Input functionals: port of ``paddle_tpu/nn/functional/input.py``.

- ``embedding``: the reference looks ids up with ``jnp.take`` in its
  default fill mode, so an id in ``[-V, -1]`` wraps and any other id
  outside ``[0, V)`` gives a row of NaN (a mis-tokenized batch fails
  loudly).  Here the same lookup is a clamp, a gather and a ``where`` on
  the device: no host read and no device assert, so a CUDA graph can
  capture it, and an in-range id gives torch's gather unchanged.
  ``padding_idx`` zeroes the rows where ``x == padding_idx`` (a literal
  comparison, as the reference's), so their gradient is zero too.
- ``one_hot`` (``paddle_tpu/tensor/manipulation.py:574``):
  ``jax.nn.one_hot`` in float32, an id outside ``[0, num_classes)`` a
  zero row.  ``torch.nn.functional.one_hot`` returns int64 and raises
  there, so it is not this function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp.auto_cast import cast as _amp_cast

__all__ = ["embedding", "one_hot"]


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` [V, E] at the integer ids ``x``.  ``sparse`` is
    accepted and not read, as in the reference."""
    (weight,) = _amp_cast("embedding", weight)
    v = weight.shape[0]
    if not (x.dtype in (torch.int32, torch.int64) or x.dtype == torch.int16
            or x.dtype == torch.uint8 or x.dtype == torch.int8):
        x = x.to(torch.int64)     # the reference's astype(int32)
    wrapped = torch.where(x < 0, x + v, x)
    inside = (wrapped >= 0) & (wrapped < v)
    out = F.embedding(torch.where(inside, wrapped, 0), weight)
    out = torch.where(inside[..., None], out, float("nan"))
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def one_hot(x, num_classes, name=None):
    """``[..., num_classes]`` float32, 1 at each id's class; an id
    outside ``[0, num_classes)`` gives a zero row."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.long()[..., None] == classes).to(torch.float32)
