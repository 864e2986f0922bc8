"""``paddle.flops``: port of ``paddle_tpu/hapi/dynamic_flops.py``.

Forward hooks count each layer's multiply-adds on a zero batch of
``input_size``, by the reference's handlers: convolutions ``out elements
x in_channels / groups x kernel elements``, ``Linear`` ``out elements x
in_features``, batch and layer norm ``2 x input elements``, pools
``input elements``.  The reference's ``_linear_flops`` (:32) reads
``weight.shape[0]``, its ``in_features`` in its ``[in, out]`` layout;
the port's weight is ``[out, in]``, so it reads ``in_features``.
"""

from __future__ import annotations

import torch

from ..nn.conv import Conv1D, Conv2D, Conv3D
from ..nn.norm import LayerNorm, _BatchNormBase
from ..nn.pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = ["flops"]


def _conv_flops(layer, inp, out):
    # MACs = out_elems * (in_channels/groups * prod(kernel))
    kernel = layer.weight[0, 0].numel()
    cin_g = layer.weight.shape[1]
    return out.numel() * cin_g * kernel


def _linear_flops(layer, inp, out):
    return out.numel() * layer.in_features


def _norm_flops(layer, inp, out):
    return 2 * inp.numel()


def _pool_flops(layer, inp, out):
    return inp.numel()


_HANDLERS = [
    ((Conv1D, Conv2D, Conv3D), _conv_flops),
    ((torch.nn.Linear,), _linear_flops),
    ((_BatchNormBase, LayerNorm), _norm_flops),
    ((AvgPool2D, MaxPool2D, AdaptiveAvgPool2D), _pool_flops),
]


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Count forward MAC-FLOPs of ``net`` on a zero batch of
    ``input_size``.  custom_ops: {LayerType: fn(layer, input, output) ->
    flops} extends or overrides the built-in handlers."""
    custom_ops = custom_ops or {}
    records = []
    hooks = []

    def make_hook(handler):
        def hook(layer, inputs, output):
            inp = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
            records.append((type(layer).__name__,
                            int(handler(layer, inp, output))))
        return hook

    for sub in net.modules():
        handler = custom_ops.get(type(sub))
        if handler is None:
            for types, h in _HANDLERS:
                if isinstance(sub, types):
                    handler = h
                    break
        if handler is not None:
            hooks.append(sub.register_forward_hook(make_hook(handler)))

    was_training = net.training
    net.eval()
    device = next((p.device for p in net.parameters()),
                  torch.device("cpu"))
    try:
        with torch.no_grad():
            net(torch.zeros(tuple(input_size), dtype=torch.float32,
                            device=device))
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()

    total = sum(f for _, f in records)
    if print_detail:
        for name, f in records:
            print(f"  {name}: {f:,}")
    print(f"Total Flops: {total}     Total Params: "
          f"{sum(p.numel() for p in net.parameters())}")
    return total
