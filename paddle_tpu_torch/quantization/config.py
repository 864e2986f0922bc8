"""``QuantConfig``: which layers get which quanters or observers.  A copy
of ``paddle_tpu/quantization/config.py``: global activation and weight
factories plus per-layer and per-type overrides, where an explicit
``None`` exempts a layer from the global quanter (the ``_Unset``
sentinel tells it from "not overridden")."""

from __future__ import annotations

from typing import Optional

from torch import nn


class _FactorySpec:
    """Holds a quanter/observer class partially applied with kwargs."""

    def __init__(self, cls=None, **kwargs):
        self.cls = cls
        self.kwargs = kwargs

    def instance(self):
        return None if self.cls is None else self.cls(**self.kwargs)


def quanter_factory(cls, **kwargs):
    return _FactorySpec(cls, **kwargs)


class _Unset:
    """Sentinel: distinguishes "not overridden" from an explicit None
    (which exempts the layer from the global quanter)."""


_UNSET = _Unset()


class QuantConfig:
    def __init__(self, activation=None, weight=None):
        self._global_act = self._as_spec(activation)
        self._global_weight = self._as_spec(weight)
        self._layer_overrides = []   # (layer_instance, act, weight)
        self._type_overrides = []    # (layer_type, act, weight)

    @staticmethod
    def _as_spec(q):
        if q is None or q is _UNSET or isinstance(q, _FactorySpec):
            return q
        if isinstance(q, type):
            return _FactorySpec(q)
        raise TypeError(f"expected a quanter class or factory, got {q!r}")

    def add_layer_config(self, layer, activation=_UNSET, weight=_UNSET):
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for l in layers:
            self._layer_overrides.append(
                (l, self._as_spec(activation), self._as_spec(weight)))

    def add_type_config(self, layer_type, activation=_UNSET, weight=_UNSET):
        types = layer_type if isinstance(layer_type, (list, tuple)) \
            else [layer_type]
        for t in types:
            self._type_overrides.append(
                (t, self._as_spec(activation), self._as_spec(weight)))

    def _specs_for(self, layer: nn.Module):
        for inst, act, w in self._layer_overrides:
            if inst is layer:
                return (self._global_act if act is _UNSET else act,
                        self._global_weight if w is _UNSET else w)
        for t, act, w in self._type_overrides:
            if isinstance(layer, t):
                return (self._global_act if act is _UNSET else act,
                        self._global_weight if w is _UNSET else w)
        return self._global_act, self._global_weight

    def activation_quanter_for(self, layer) -> Optional[nn.Module]:
        act, _ = self._specs_for(layer)
        return act.instance() if act else None

    def weight_quanter_for(self, layer) -> Optional[nn.Module]:
        _, w = self._specs_for(layer)
        return w.instance() if w else None
