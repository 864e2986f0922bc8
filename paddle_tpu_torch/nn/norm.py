"""Normalization layers.

- ``RMSNorm`` (port of ``paddle_tpu/nn/layer/norm.py:113`` over
  ``nn/functional/norm.py:50``): the weight is a ``[hidden]`` parameter
  initialised to ones, and the forward is ``ops.rms_norm.rms_norm`` (the
  CUDA kernel on the card, the plain version on the CPU), its inputs
  cast by the AMP rule under the op name ``rms_norm``.
- ``LayerNorm`` (``nn/layer/norm.py:91`` over ``nn/functional/norm.py:27``):
  ``weight`` ones and ``bias`` zeros over ``normalized_shape`` (either
  left out with ``weight_attr=False``/``bias_attr=False``), the forward
  ``nn.functional.layer_norm`` (plain torch math in float32: no kernel
  in the JAX package either).
- The vision slice's norms (``nn/layer/norm.py:18-230``): the batch
  norms ``BatchNorm``, ``BatchNorm1D/2D/3D`` and ``SyncBatchNorm`` (on
  one card a batch norm over the local batch, as the reference's note
  says of an unsharded batch) with the reference's buffers ``_mean``
  (zeros) and ``_variance`` (ones), no ``num_batches_tracked``, and
  ``nn.functional.batch_norm``'s update rule; ``GroupNorm``,
  ``InstanceNorm1D/2D/3D``, ``LocalResponseNorm`` and ``SpectralNorm``
  (one power iteration a call from the ``weight_u``/``weight_v``
  parameters, which hold no gradient and are not updated, as the
  reference's).
"""

from __future__ import annotations

import torch
from torch import nn

from ..amp.auto_cast import cast as _amp_cast
from ..ops.rms_norm import rms_norm
from . import functional as F
from .common import materialize, meta_factory
from .functional import layer_norm


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = _amp_cast("rms_norm", x, self.weight)
        return rms_norm(x, w, self.epsilon)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = float(epsilon)
        fac = dict(device=device, dtype=dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(self._normalized_shape, **fac))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(self._normalized_shape, **fac))

    def reset_parameters(self):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={list(self._normalized_shape)}"


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype="float32"):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        fac = meta_factory(dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.empty((num_features,), **fac))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.empty((num_features,), **fac))
        f32 = dict(fac, dtype=torch.float32)
        self.register_buffer("_mean", torch.empty((num_features,), **f32))
        self.register_buffer("_variance", torch.empty((num_features,), **f32))
        materialize(self, device)

    def reset_parameters(self):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()
            self._mean.zero_()
            self._variance.fill_(1.0)

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, **factory):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCL" else "NHWC",
                         use_global_stats, name, **factory)


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, **factory):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         **factory)


class SyncBatchNorm(_BatchNormBase):
    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm replaced by a ``SyncBatchNorm``
        holding its parameters and buffers."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            p = next(layer.buffers())
            new = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format, device=p.device)
            new.load_state_dict(layer.state_dict())
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class GroupNorm(nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype="float32"):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        fac = meta_factory(dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.empty((num_channels,), **fac))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.empty((num_channels,), **fac))
        materialize(self, device)

    reset_parameters = LayerNorm.reset_parameters

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(nn.Module):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype="float32"):
        super().__init__()
        self._epsilon = epsilon
        fac = meta_factory(dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.empty((num_features,), **fac))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.empty((num_features,), **fac))
        materialize(self, device)

    reset_parameters = LayerNorm.reset_parameters

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(nn.Module):
    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", *, device=None):
        super().__init__()
        self._dim, self._power_iters, self._epsilon = dim, power_iters, epsilon
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        fac = meta_factory(dtype)
        self.weight_u = nn.Parameter(torch.empty((h,), **fac),
                                     requires_grad=False)
        self.weight_v = nn.Parameter(torch.empty((w,), **fac),
                                     requires_grad=False)
        materialize(self, device)

    def forward(self, weight):
        (w,) = _amp_cast("spectral_norm", weight)
        u, v = _amp_cast("spectral_norm", self.weight_u, self.weight_v)
        wm = w.movedim(self._dim, 0).reshape(w.shape[self._dim], -1)
        for _ in range(self._power_iters):
            v = wm.T @ u
            v = v / torch.clamp_min(torch.linalg.vector_norm(v),
                                    self._epsilon)
            u = wm @ v
            u = u / torch.clamp_min(torch.linalg.vector_norm(u),
                                    self._epsilon)
        return w / (u @ wm @ v)
