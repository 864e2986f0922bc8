"""Common layers and the model zoo's construction helpers.

- ``Dropout`` (port of ``paddle_tpu/nn/layer/common.py:52``): the layer
  form of ``nn.functional.dropout``, active in ``.train()`` only, its
  mask drawn from the key generator as the JAX package draws it.
- ``Linear`` (``common.py:16``) in torch's ``[out, in]`` layout, its
  forward ``nn.functional.linear`` (the AMP rule under ``linear``).
- The rest of ``nn/layer/common.py``: ``Identity``, ``Flatten``,
  ``Upsample`` and its two named forms, ``Pad1D/2D/3D``, ``ZeroPad2D``,
  ``PixelShuffle``/``PixelUnshuffle``, ``ChannelShuffle``, ``Unfold``,
  ``Fold``, ``Bilinear``, ``CosineSimilarity``, ``Dropout2D/3D``,
  ``AlphaDropout`` and ``Embedding``, each over its functional.
- ``reference_init``, ``meta_factory``, ``materialize`` and
  ``built_on_meta``: layers are built on ``meta`` and made in place on
  their device with the JAX package's initializers.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from ..amp.auto_cast import cast as _amp_cast
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


class Dropout2D(nn.Module):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(nn.Module):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(nn.Module):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


class Upsample(nn.Module):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class _PadNd(nn.Module):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_PadNd):
    pass


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadNd):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PixelShuffle(nn.Module):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(nn.Module):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(nn.Module):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Unfold(nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class Bilinear(nn.Module):
    """``x1 W x2 + b``: ``weight`` [out, in1, in2] (Xavier-uniform),
    ``bias`` [1, out] (zeros)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype="float32"):
        super().__init__()
        fac = meta_factory(dtype)
        self.weight = nn.Parameter(torch.empty(
            (out_features, in1_features, in2_features), **fac))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.empty((1, out_features), **fac))
        materialize(self, device)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Embedding(nn.Embedding):
    """A ``[num_embeddings, embedding_dim]`` table (N(0, 1)); with
    ``padding_idx`` that row starts at zero and the lookup returns zeros
    for it (the reference masks the output, so its gradient is zero
    too).  ``sparse`` is accepted and not read, as in the reference."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype="float32"):
        super().__init__(num_embeddings, embedding_dim, **meta_factory(dtype))
        self._padding_idx = padding_idx
        self.sparse = sparse
        materialize(self, device)

    def forward(self, x):
        (w,) = _amp_cast("embedding", self.weight)
        out = torch.nn.functional.embedding(x, w)
        if self._padding_idx is not None:
            out = torch.where((x == self._padding_idx)[..., None],
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)
        return out


class Linear(nn.Linear):
    """``x @ weight.T + bias`` through ``nn.functional.linear``, made on
    ``device`` (the card unless ``"cpu"``) with Xavier-normal weights
    and a zero bias; ``bias_attr=False`` drops the bias, as the
    reference's."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype="float32"):
        super().__init__(in_features, out_features,
                         bias=bias_attr is not False,
                         **meta_factory(dtype))
        materialize(self, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


LinearCompute = Linear


def _uniform_(t, limit, gen):
    t.uniform_(-limit, limit, generator=gen)


@torch.no_grad()
def reference_init(module: nn.Module, seed: int = 0) -> nn.Module:
    """The JAX package's default initializers, drawn by one
    ``torch.Generator`` of ``seed`` on the parameters' device in module
    order, each layer type listed:
    - ``Linear``: Xavier-normal weights, zero biases;
    - ``Embedding``: N(0, 1), the ``padding_idx`` row zero;
    - ``LayerNorm``, batch, group and instance norm: unit weights, zero
      biases; a batch norm's ``_mean`` zeros and ``_variance`` ones;
    - convolutions and their transposes: ``KaimingUniform(fan_in)``,
      ``U(+-sqrt(6 / fan_in))`` with ``fan_in = in / groups * prod(k)``,
      zero biases;
    - recurrent layers and cells: every weight and bias
      ``U(+-1 / sqrt(hidden_size))``;
    - ``PReLU``: its ``init`` constant; ``Bilinear``: Xavier-uniform,
      zero bias; ``SpectralNorm``: ``u``, ``v`` N(0, 1);
    - a bare parameter (a bias such as the tied decoder's): zeros."""
    from . import conv as _conv
    from . import norm as _norm
    from . import rnn as _rnn
    from .activation import PReLU
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
            if getattr(m, "_padding_idx", None) is not None:
                m.weight[m._padding_idx] = 0.0
        elif isinstance(m, (_norm.LayerNorm, _norm._BatchNormBase,
                            _norm.GroupNorm, _norm._InstanceNormBase)):
            m.reset_parameters()
        elif isinstance(m, _conv._ConvNd):
            _uniform_(m.weight, (6.0 / m._fan_in) ** 0.5, gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (_rnn._RNNBase, _rnn.RNNCellBase)):
            for p in m.parameters(recurse=False):
                _uniform_(p, 1.0 / m.hidden_size ** 0.5, gen)
        elif isinstance(m, PReLU):
            m.weight.fill_(m._init)
        elif isinstance(m, Bilinear):
            out_f, in1, in2 = m.weight.shape
            _uniform_(m.weight, (6.0 / (in1 * in2 + out_f * in2)) ** 0.5,
                      gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, _norm.SpectralNorm):
            m.weight_u.normal_(0.0, 1.0, generator=gen)
            m.weight_v.normal_(0.0, 1.0, generator=gen)
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
    unless ``"cpu"`` is asked for; ``"meta"``, or ``None`` inside a
    ``torch.device("meta")`` scope, leaves it where it is, for a parent
    that materializes it), then ``reference_init`` it from
    ``seed`` unless ``init=False``.  Parameters are made in place on the
    device, never staged through the host."""
    if str(device) == "meta" or (
            device is None and torch.get_default_device().type == "meta"):
        # built inside a parent's ``torch.device("meta")`` scope: the
        # parent materializes the whole
        return module
    from ..device import resolve_device
    module.to_empty(device=resolve_device(device))
    if init:
        reference_init(module, seed)
    return module


def built_on_meta(init):
    """Decorate a model's ``__init__``: its layers are built inside a
    ``torch.device("meta")`` scope, then the whole is materialized once
    on ``device=`` (the card unless ``"cpu"``) and initialised from
    ``seed=`` (``reference_init``).  A model built inside another's
    scope stays on ``meta`` for its parent."""

    @functools.wraps(init)
    def wrapper(self, *args, device=None, seed=0, **kwargs):
        with torch.device("meta"):
            init(self, *args, **kwargs)
        materialize(self, device, seed)

    return wrapper
