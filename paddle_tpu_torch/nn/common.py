"""Common layers and the model zoo's construction helpers.

- ``Dropout`` (port of ``paddle_tpu/nn/layer/common.py:52``): the layer
  form of ``nn.functional.dropout``, active in ``.train()`` only, its
  mask drawn from the key generator as the JAX package draws it.
- ``Linear`` (``common.py:16``) in torch's ``[out, in]`` layout, its
  forward ``nn.functional.linear`` (the AMP rule under ``linear``).
- ``reference_init``, ``meta_factory`` and ``materialize``: layers are
  built on ``meta`` and made in place on their device with the JAX
  package's initializers.
"""

from __future__ import annotations

import torch
from torch import nn

from . import functional as F


class Dropout(nn.Module):
    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train"):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Linear(nn.Linear):
    """``x @ weight.T + bias`` through ``nn.functional.linear``;
    ``bias_attr=False`` drops the bias, as the reference's."""

    def __init__(self, in_features: int, out_features: int, bias_attr=None,
                 **factory):
        super().__init__(in_features, out_features,
                         bias=bias_attr is not False, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


@torch.no_grad()
def reference_init(module: nn.Module, seed: int = 0) -> nn.Module:
    """The JAX package's default initializers, drawn by one
    ``torch.Generator`` of ``seed`` on the parameters' device in module
    order: Xavier-normal ``Linear`` weights and zero biases, N(0, 1)
    embeddings, unit ``LayerNorm`` weights and zero biases, zeros for a
    bare parameter (a bias such as the tied decoder's)."""
    from .norm import LayerNorm
    first = next(module.parameters(), None)
    if first is None:
        return module
    gen = torch.Generator(device=first.device)
    gen.manual_seed(int(seed))
    for m in module.modules():
        if isinstance(m, nn.Linear):
            fan_out, fan_in = m.weight.shape
            m.weight.normal_(0.0, (2.0 / (fan_in + fan_out)) ** 0.5,
                             generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=gen)
        elif isinstance(m, LayerNorm):
            m.reset_parameters()
        else:
            for p in m.parameters(recurse=False):
                p.zero_()
    return module


def meta_factory(dtype) -> dict:
    """Factory keywords of a layer built on ``meta`` in ``dtype`` (a name
    or a torch dtype), for ``materialize`` to move and initialise."""
    from ..device import to_dtype
    return {"device": "meta", "dtype": to_dtype(dtype)}


def materialize(module: nn.Module, device, seed: int = 0,
                init: bool = True) -> nn.Module:
    """Move a module built on ``meta`` to ``device`` (the CUDA card
    unless ``"cpu"`` is asked for; ``"meta"`` leaves it where it is, for
    a parent that materializes it), then ``reference_init`` it from
    ``seed`` unless ``init=False``.  Parameters are made in place on the
    device, never staged through the host."""
    if str(device) == "meta":
        return module
    from ..device import resolve_device
    module.to_empty(device=resolve_device(device))
    if init:
        reference_init(module, seed)
    return module
