"""PTQ, the post-training quantization driver, ``weight_only_quantize``
and ``fuse_act_into_quant_linear``: a copy of
``paddle_tpu/quantization/ptq.py``.

``PTQ.quantize(model)`` puts an observer in front of each quantizable
layer; the caller runs calibration batches; ``convert(model)`` freezes
the observed scales into the int8 inference layers.
``weight_only_quantize`` converts every ``torch.nn.Linear`` (the
models' projections among them) into a ``QuantizedLinearInfer`` with no
calibration.  It drops the captured ``generate()`` graphs of the model
(``_generate_graphs``): a CUDA graph is not deep-copied, and none
survives the swap of the weights it read.
"""

from __future__ import annotations

import copy

from torch import nn

from ..nn.common import Identity
from ..nn.conv import Conv2D
from ..nn.quant.quant_layers import (QuantedConv2D, QuantedLinear,
                                     QuantizedLinearInfer)
from .config import QuantConfig
from .observers import BaseObserver
from .qat import _freeze
from .quanters import FakeQuanterChannelWiseAbsMaxObserver


class _ObservedLayer(nn.Module):
    """Float layer with an input observer attached (calibration phase)."""

    def __init__(self, layer, observer):
        super().__init__()
        self.inner = layer
        self.observer = observer

    def forward(self, *args, **kwargs):
        if self.observer is not None and args:
            self.observer.observe(args[0])
        return self.inner(*args, **kwargs)


def weight_only_quantize(model: nn.Module, inplace: bool = True,
                         skip=None) -> nn.Module:
    """Weight-only int8 conversion for serving: every ``nn.Linear``
    becomes a ``QuantizedLinearInfer`` (int8 codes + per-out-channel
    scales, activations stay float), with no calibration pass.
    ``skip(qualified_name, layer) -> bool`` excludes layers (e.g. the
    ``lm_head``, commonly kept float for accuracy).  ``inplace=False``
    converts a deep copy and leaves ``model`` and its graphs as they
    are."""
    if not inplace:
        # a captured generate() graph is never deep-copied: it stays with
        # the source model, whose weights it reads
        saved = model.__dict__.pop("_generate_graphs", None)
        original = model
        try:
            model = copy.deepcopy(model)
        finally:
            if saved is not None:
                original.__dict__["_generate_graphs"] = saved
    converted = 0

    def rec(layer: nn.Module, prefix: str):
        nonlocal converted
        for name, sub in list(layer._modules.items()):
            qual = f"{prefix}.{name}" if prefix else name
            if isinstance(sub, nn.Linear):
                if skip is not None and skip(qual, sub):
                    continue
                layer._modules[name] = _freeze(QuantedLinear(sub, None,
                                                             None))
                converted += 1
            elif sub is not None:
                rec(sub, qual)

    rec(model, "")
    if converted == 0:
        raise ValueError(
            "weight_only_quantize converted no layers — the model has no "
            "nn.Linear sublayers (tensor-parallel Column/RowParallelLinear "
            "are not yet supported for int8 serving; quantize the "
            "unsharded model)")
    # the structural mutation invalidates every captured generate()
    # program: their graphs read the float weights just dropped
    if getattr(model, "_generate_graphs", None):
        model._generate_graphs.clear()
    return model


_FUSABLE_ACTS = {"GELU": "gelu", "ReLU": "relu", "Silu": "silu",
                 "SiLU": "silu"}


def fuse_act_into_quant_linear(model: nn.Module) -> int:
    """Fold ``nn.Sequential``-adjacent activation layers (GELU/ReLU/Silu)
    into the preceding ``QuantizedLinearInfer``'s kernel epilogue and
    replace them with ``Identity``; returns the number of pairs fused.
    The fused GELU is the tanh approximation, on either route of the
    layer: ``approximate=True`` GELU layers fuse to the same formula."""
    fused = 0

    def rec(layer: nn.Module):
        nonlocal fused
        if isinstance(layer, nn.Sequential):
            items = list(layer._modules.items())
            for (n1, a), (n2, b) in zip(items, items[1:]):
                act = _FUSABLE_ACTS.get(type(b).__name__)
                if act is None or not isinstance(a, QuantizedLinearInfer):
                    continue
                if a._fused_act is not None:
                    continue
                a._fused_act = act
                layer._modules[n2] = Identity()
                fused += 1
        for sub in layer._modules.values():
            if sub is not None:
                rec(sub)

    rec(model)
    return fused


class PTQ:
    def __init__(self, config: QuantConfig):
        self._config = config

    def quantize(self, model: nn.Module, inplace: bool = True) -> nn.Module:
        if not inplace:
            model = copy.deepcopy(model)
        self._insert_rec(model)
        return model

    def _insert_rec(self, layer: nn.Module):
        for name, sub in list(layer._modules.items()):
            if isinstance(sub, (nn.Linear, Conv2D)):
                obs = self._config.activation_quanter_for(sub)
                if obs is not None and not isinstance(obs, BaseObserver):
                    raise TypeError(
                        "PTQ activation config must be an observer class, "
                        f"got {type(obs).__name__}")
                if obs is not None:
                    layer._modules[name] = _ObservedLayer(sub, obs)
            elif sub is not None:
                self._insert_rec(sub)

    def convert(self, model: nn.Module, inplace: bool = True) -> nn.Module:
        if not inplace:
            model = copy.deepcopy(model)
        self._convert_rec(model)
        return model

    def _convert_rec(self, layer: nn.Module):
        for name, sub in list(layer._modules.items()):
            if isinstance(sub, _ObservedLayer):
                inner = sub.inner
                act_scale = (sub.observer.scales()
                             if sub.observer is not None else None)
                # the configured weight observer's bit width (the weight
                # scales themselves are recomputed per channel from the
                # frozen weights)
                wspec = self._config.weight_quanter_for(inner)
                bits = wspec.bit_length() if wspec is not None else 8
                wq = FakeQuanterChannelWiseAbsMaxObserver(bit_length=bits)
                wrapper_cls = QuantedLinear if isinstance(inner, nn.Linear) \
                    else QuantedConv2D
                frozen = _freeze(wrapper_cls(inner, None, wq))
                frozen._act_scale = act_scale
                layer._modules[name] = frozen
            elif sub is not None:
                self._convert_rec(sub)
