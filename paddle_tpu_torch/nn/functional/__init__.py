"""Functionals of the serving and training paths.

- ``swiglu`` and ``llama_rope`` (port of
  ``paddle_tpu/incubate/nn/functional/__init__.py:50-108``): with
  ``position_ids`` the rotation is plain torch math, without them it is
  the RoPE kernel (``ops/rope.py``), as in the JAX package.
- ``add``, ``multiply``, ``concat`` and ``split``: the tensor ops that
  the decoder layers and the vision zoo call, under the reference's op
  names (``paddle_tpu/tensor/{math,manipulation}.py``).
- ``linear`` and ``embedding`` in torch's layouts (``linear``'s weight
  is ``[out, in]``; the JAX package's is ``[in, out]``).
- ``layer_norm`` (``nn/functional/norm.py:27``): mean, population
  variance and ``rsqrt(var + eps)`` in float32, the affine in float32,
  one rounding back to x's dtype; ``gelu`` (``activation.py:47``, the
  erfc form of ``jax.nn.gelu`` or its tanh approximation), ``relu`` and
  ``tanh``.  Plain torch math: none of them is a kernel in the JAX
  package.
- The dropout family (``nn/functional/common.py:31-80``): ``dropout``,
  ``dropout2d``, ``dropout3d`` and ``alpha_dropout``.  A mask is
  ``uniform(key, shape) < 1 - p`` (``jax.random.bernoulli``) over the
  threefry bits of one draw of the key generator (``core.generator``),
  so masks are bit-equal to the JAX package's for the same seed and
  draw count.
- ``scaled_dot_product_attention`` and ``flash_attention``
  (``nn/functional/attention.py:21-107``): the flash-attention kernels
  when there is no mask and no dropout (and equal q/k lengths, the
  kernels' self-attention layout), else the ``_xla_attention`` math in
  plain torch on every device, with its dropout of the probabilities;
  the JAX package's gate also keeps dropout off its kernel.
- ``gather_tree`` (``nn/functional/decoding.py:21-51``): the beam
  backtrace, a reverse loop of gathers on the tensors' device.
- ``cross_entropy``, ``softmax_with_cross_entropy`` and ``nll_loss``
  (``nn/functional/loss.py:30-110``): hard and soft labels, class
  weights, label smoothing, every reduction, any axis and
  ``use_softmax=False``.
- The vision and OCR slice's functionals, one module each as in the
  reference: ``activation`` (the rest of the activations), ``conv``
  (convolutions and their transposes), ``pooling``, ``norm`` (batch,
  instance, group and local-response norm, ``normalize``), ``common``
  (``interpolate``, ``pad``, the shuffles, ``unfold``/``fold``, ...),
  ``vision`` (``affine_grid``, ``grid_sample``) and ``loss`` (the rest
  of the losses, ``ctc_loss`` and ``rnnt_loss``), re-exported here.

Each op passes its inputs through the AMP rule under the JAX package's
op name (``amp.auto_cast.cast``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...amp.auto_cast import cast as _amp_cast
from ...core import generator as _generator
from ...ops.flash_attention import NEG_INF
from ...ops.flash_attention import flash_attention as _flash
from ...ops.rope import apply_rope


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor = None) -> torch.Tensor:
    """``x @ weight.T + bias`` with ``weight`` ``[out, in]``."""
    x, weight, bias = _amp_cast("linear", x, weight, bias)
    return F.linear(x, weight, bias)


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    (weight,) = _amp_cast("embedding", weight)
    return F.embedding(ids, weight)


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """Normalize over the trailing ``normalized_shape`` axes in float32
    (population variance), then the float32 affine, then one cast back
    to x's dtype."""
    x, weight, bias = _amp_cast("layer_norm", x, weight, bias)
    n = 1 if isinstance(normalized_shape, int) else len(normalized_shape)
    axes = tuple(range(x.ndim - n, x.ndim))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=axes, keepdim=True)
    out = c * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


_SQRT_HALF = float(np.sqrt(0.5))
_SQRT_2_OVER_PI = float(np.sqrt(2 / np.pi))


@functools.lru_cache(maxsize=None)
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: JAX casts such a
    constant to x's dtype (``np.sqrt(0.5).astype(x.dtype)``); a Python
    scalar, unlike a 0-d tensor made from it, needs no host-to-device
    copy, so a CUDA graph can capture the product."""
    return float(torch.tensor(value, dtype=dtype))


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """``jax.nn.gelu``: ``0.5 * x * erfc(-x * sqrt(1/2))``, or with
    ``approximate`` ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715
    x^3)))``, in x's dtype."""
    (x,) = _amp_cast("gelu", x)
    if approximate:
        c = _in_dtype(_SQRT_2_OVER_PI, x.dtype)
        cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3))))
        return x * cdf
    return 0.5 * x * torch.special.erfc(-x * _in_dtype(_SQRT_HALF, x.dtype))


def relu(x: torch.Tensor) -> torch.Tensor:
    (x,) = _amp_cast("relu", x)
    return torch.relu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    (x,) = _amp_cast("tanh", x)
    return torch.tanh(x)


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` (the residual adds of the decoder layers)."""
    x, y = _amp_cast("add", x, y)
    return x + y


def multiply(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x * y`` (the vision zoo's squeeze-excite scales)."""
    x, y = _amp_cast("multiply", x, y)
    return x * y


def concat(xs, axis: int = 0) -> torch.Tensor:
    """``torch.cat`` under the reference's op name (the vision zoo's
    branch joins)."""
    return torch.cat(_amp_cast("concat", *xs), dim=axis)


def split(x: torch.Tensor, num: int, axis: int = 0):
    """``num`` equal chunks along ``axis``, as a list (ShuffleNet v2's
    channel split)."""
    (x,) = _amp_cast("split", x)
    return list(torch.chunk(x, num, dim=axis))


def swiglu(x: torch.Tensor, y: torch.Tensor = None) -> torch.Tensor:
    """``silu(x) * y``; with ``y=None`` x's last axis is split in two
    halves (gate, up)."""
    if y is None:
        (x,) = _amp_cast("swiglu", x)
        x, y = torch.chunk(x, 2, dim=-1)
    else:
        x, y = _amp_cast("swiglu", x, y)
    return F.silu(x) * y


def _rotate_half(v: torch.Tensor) -> torch.Tensor:
    v1, v2 = torch.chunk(v, 2, dim=-1)
    return torch.cat([-v2, v1], dim=-1)


def llama_rope(q: torch.Tensor, k: torch.Tensor,
               rotary_emb_base: float = 10000.0,
               position_ids: torch.Tensor = None):
    """HF-Llama rotate_half RoPE with concat(freqs, freqs) tables.
    q/k: [B, S, H, D]; position_ids: [B, S] (or [1, S], broadcast), or
    None for positions ``0 .. S-1``.  inv_freq, cos and sin are computed
    in fp32 and the rotation runs in fp32 before the cast back, exactly
    as the JAX package does.  Without position_ids q and k go through
    ``apply_rope`` (the RoPE kernel on the card, differentiable)."""
    q, k = _amp_cast("llama_rope", q, k)
    d = q.shape[-1]
    inv_freq = 1.0 / (rotary_emb_base ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=q.device) / d))
    if position_ids is None:
        t = torch.arange(q.shape[1], dtype=torch.float32, device=q.device)
        freqs = torch.outer(t, inv_freq)
        cos_h = torch.cos(freqs)[None, :, None, :]
        sin_h = torch.sin(freqs)[None, :, None, :]
        return apply_rope(q, cos_h, sin_h), apply_rope(k, cos_h, sin_h)
    freqs = position_ids.to(q.device)[..., None].float() * inv_freq
    cos_h = torch.cos(freqs)[:, :, None, :]
    sin_h = torch.sin(freqs)[:, :, None, :]
    cos2 = torch.cat([cos_h, cos_h], dim=-1)
    sin2 = torch.cat([sin_h, sin_h], dim=-1)

    def rotate_one(xa):
        xf = xa.float()
        return (xf * cos2 + _rotate_half(xf) * sin2).to(xa.dtype)

    return rotate_one(q), rotate_one(k)


# ---- dropout ----

def _weak(value, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX's weak type meets ``like``: a 0-d tensor of
    like's dtype (dividing by a tensor, not a Python scalar, keeps CUDA
    from multiplying by the reciprocal)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _keep_mask(k: _generator.Key, q: float, shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, q, shape)``: float32 threefry uniforms
    below float32 ``q``."""
    from ...inference import threefry    # (the package imports the models)
    keys = torch.tensor(k.tf, dtype=torch.int64, device=device)
    return threefry.uniform(keys, tuple(shape)) < float(np.float32(q))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability ``p`` (with ``axis``, whole
    slices: the mask has size 1 off those axes and broadcasts).
    ``upscale_in_train`` divides the kept ones by ``1 - p``;
    ``downscale_in_infer`` keeps them as they are and multiplies by
    ``1 - p`` outside training."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            (x,) = _amp_cast("dropout", x)
            return x * _weak(1.0 - p, x)
        return x
    k = _generator.draw()
    (x,) = _amp_cast("dropout", x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _keep_mask(k, 1.0 - p, shape, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / _weak(1.0 - p, x), _weak(0.0, x))
    return torch.where(keep, x, _weak(0.0, x))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: a dropped element takes ``-alpha *
    scale``, then an affine map restores the mean and variance."""
    if not training or p == 0.0:
        return x
    k = _generator.draw()
    (x,) = _amp_cast("alpha_dropout", x)
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = _keep_mask(k, 1.0 - p, x.shape, x.device)
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
    b_coef = -a_coef * alpha_p * p
    kept = torch.where(keep, x, _weak(alpha_p, x))
    return _weak(a_coef, kept) * kept + _weak(b_coef, kept)


# ---- attention ----

def _attention_math(q, k, v, mask=None, causal=False, dropout_p=0.0,
                    dropout_key=None):
    """``_xla_attention``: scores in q's dtype, causal mask -1e30 with
    the ``sk - sq`` offset, additive mask, fp32 softmax cast to q's
    dtype, then (with ``dropout_p`` and a key) the probabilities dropped
    and the kept ones divided by ``1 - p``; GQA by repeating kv heads.
    q/k/v: [B, S, H, D]."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if kt.shape[1] != qt.shape[1]:
        rep = qt.shape[1] // kt.shape[1]
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    if causal:
        sq, sk = logits.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, NEG_INF)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0 and dropout_key is not None:
        keep = _keep_mask(dropout_key, 1.0 - dropout_p, probs.shape,
                          probs.device)
        probs = torch.where(keep, probs / _weak(1.0 - dropout_p, probs),
                            _weak(0.0, probs))
    return torch.einsum("bhqk,bhkd->bhqd", probs, vt).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """q/k/v: [B, S, H, D] (the reference API layout).  Without a mask
    and dropout (and with equal q/k lengths) this is the flash-attention
    kernels on the card; otherwise the ``_xla_attention`` math in plain
    torch on every device, as the JAX package runs XLA there.  A dropout
    key is drawn only when ``dropout_p > 0`` in training."""
    query, key, value = _amp_cast("sdpa", query, key, value)
    p = dropout_p if training else 0.0
    if attn_mask is None and p == 0.0 and query.shape[1] == key.shape[1]:
        return _flash(query, key, value, causal=is_causal)
    dkey = _generator.draw() if p > 0.0 else None
    return _attention_math(query, key, value, attn_mask, is_causal, p, dkey)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """The reference's ``flash_attention`` API: the kernels without
    dropout (equal q/k lengths), else the ``_xla_attention`` math with
    dropout.  With ``return_softmax`` returns ``(out, None)``."""
    query, key, value = _amp_cast("flash_attention", query, key, value)
    p = dropout if training else 0.0
    if p == 0.0 and query.shape[1] == key.shape[1]:
        out = _flash(query, key, value, causal=causal)
    else:
        dkey = _generator.draw() if p > 0.0 else None
        out = _attention_math(query, key, value, None, causal, p, dkey)
    return (out, None) if return_softmax else out


# ---- decoding ----

def gather_tree(ids, parents):
    """Backtrace beam-search output ``ids [T, B, K]`` along ``parents [T,
    B, K]`` into beam-consistent sequences ``[T, B, K]``: the k-th output
    sequence is the token path that ends at beam k of the last step.  A
    reverse loop over time carrying each (batch, beam)'s current parent,
    one gather of the step's tokens and one of its parents a step (the
    reference's reverse ``lax.scan``); no host read, so a CUDA graph can
    capture it.  Array inputs become tensors; returns ``ids``' dtype."""
    ids = torch.as_tensor(ids)
    parents = torch.as_tensor(parents, device=ids.device)
    if ids.dim() != 3 or ids.shape != parents.shape:
        raise ValueError(
            f"gather_tree expects ids and parents of equal shape [T, B, K], "
            f"got {tuple(ids.shape)} vs {tuple(parents.shape)}")
    t, b, k = ids.shape
    parent = torch.arange(k, dtype=torch.int64,
                          device=ids.device).expand(b, k)
    out = [None] * t
    for i in range(t - 1, -1, -1):
        out[i] = torch.gather(ids[i], 1, parent)
        parent = torch.gather(parents[i], 1, parent).long()
    return torch.stack(out)


# ---- losses ----

def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy along ``axis``, the JAX package's rules:
    soft labels (``soft_label`` or a label of the input's shape), hard
    integer labels (the input's shape without ``axis``, or with a 1
    there) with ``ignore_index``, class ``weight`` (``mean`` is then the
    weighted mean, ``sum(w * loss) / max(sum(w), 1e-12)``),
    ``label_smoothing`` and ``use_softmax=False`` (``log(max(input,
    1e-30))``).  Hard-label ``mean`` divides by ``max(#valid, 1)``.
    ``log_softmax`` runs in the input's dtype, as
    ``jax.nn.log_softmax``."""
    input, label, weight = _amp_cast("cross_entropy", input, label, weight)
    ax = axis % input.ndim
    logp = (torch.log_softmax(input, dim=ax) if use_softmax
            else torch.log(torch.clamp_min(input, 1e-30)))
    n_classes = input.shape[ax]
    if soft_label or (label.ndim == input.ndim
                      and label.shape == input.shape):
        soft = label
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) \
                + label_smoothing / n_classes
        return _reduce(-torch.sum(soft * logp, dim=ax), reduction)
    idx = label.long()
    squeeze = False
    if idx.ndim == input.ndim:          # trailing [..., 1] label layout
        idx = idx.squeeze(ax)
        squeeze = True
    if label_smoothing > 0.0:
        classes = torch.arange(n_classes, device=idx.device).reshape(
            [n_classes if i == ax else 1 for i in range(input.ndim)])
        soft = (idx.unsqueeze(ax) == classes).to(logp.dtype)
        soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -torch.sum(soft * logp, dim=ax)
    else:
        safe = torch.where(idx == ignore_index, torch.zeros_like(idx), idx)
        loss = -torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
    valid = idx != ignore_index
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        sample_w = torch.where(
            valid, weight[torch.where(valid, idx, torch.zeros_like(idx))],
            torch.zeros((), dtype=weight.dtype, device=weight.device))
        loss = loss * sample_w
        if reduction == "mean":
            return loss.sum() / torch.clamp_min(sample_w.sum(), 1e-12)
    if reduction == "mean":
        n_valid = torch.clamp(valid.to(logp.dtype).sum(), min=1.0)
        return loss.sum() / n_valid
    if squeeze and reduction == "none":
        loss = loss.unsqueeze(ax)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """``cross_entropy(reduction="none")``; with ``return_softmax`` also
    the softmax of ``logits`` along ``axis``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if return_softmax:
        (sm_in,) = _amp_cast("softmax", logits)
        return loss, torch.softmax(sm_in, dim=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of log-probabilities ``input`` [N, C, ...]
    at hard labels [N, ...] (class axis 1), with ``ignore_index``, class
    ``weight`` and the three reductions of ``cross_entropy``."""
    input, weight = _amp_cast("nll_loss", input, weight)
    idx = label.long()
    safe = torch.where(idx == ignore_index, torch.zeros_like(idx), idx)
    loss = -torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    valid = idx != ignore_index
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        sw = torch.where(valid, weight[safe],
                         torch.zeros((), dtype=weight.dtype,
                                     device=weight.device))
        loss = loss * sw
        if reduction == "mean":
            return loss.sum() / torch.clamp_min(sw.sum(), 1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.to(input.dtype).sum(), min=1.0)
    return _reduce(loss, reduction)


# ---- the vision and OCR slice: one module each, as the reference's ----

from .activation import *  # noqa: E402,F401,F403
from .common import *  # noqa: E402,F401,F403
from .conv import *  # noqa: E402,F401,F403
from .loss import *  # noqa: E402,F401,F403
from .norm import *  # noqa: E402,F401,F403
from .pooling import *  # noqa: E402,F401,F403
from .vision import *  # noqa: E402,F401,F403
