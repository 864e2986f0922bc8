"""Common functionals: port of the rest of
``paddle_tpu/nn/functional/common.py`` (``linear`` and the dropout
family are in the package's ``__init__``) and of ``pad``
(``paddle_tpu/tensor/manipulation.py``); ``flatten`` is the facade's
``tensor.flatten``.

``interpolate`` follows the reference's two paths, whatever the mode's
name says:
- ``"nearest"`` on 2 spatial dimensions (``_resize_nearest``): source
  row ``int(float32(i) * float32(in / out))``, a gather;
- every other case (bilinear, bicubic, linear, trilinear, and nearest
  on 1 or 3 dimensions) is ``jax.image.resize``'s linear method
  (``_resize_linear_nd``): half-pixel centres, a triangle filter
  widened by ``in / out`` when downsampling (antialiased), each output's
  weights normalized over the input it reaches; ``align_corners`` and
  ``align_mode`` are accepted and not read, as in the reference.  The
  port builds the same per-dimension weight matrix in float32 and
  contracts each spatial axis with it.
"""

from __future__ import annotations

import numpy as np
import torch

from ...amp.auto_cast import cast as _amp_cast

__all__ = [
    "pad", "flatten", "interpolate", "upsample", "bilinear",
    "cosine_similarity", "pixel_shuffle", "pixel_unshuffle",
    "channel_shuffle", "label_smooth", "unfold", "fold", "zeropad2d",
]


def _pad_index(size, lo, hi, mode, device):
    """Source indices of a dimension padded by (lo, hi) in ``mode``
    (``numpy.pad``'s reflect, edge and wrap)."""
    i = torch.arange(-lo, size + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, size - 1)
    if mode == "circular":
        return i.remainder(size)
    period = 2 * (size - 1)
    j = i.remainder(period) if period else torch.zeros_like(i)
    return torch.where(j < size, j, period - j)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad by ``pad`` ((lo, hi) flat per dimension for every dimension,
    or for the trailing spatial ones given last dimension first, placed
    by ``data_format``) in ``constant``, ``reflect``, ``replicate`` or
    ``circular`` mode."""
    (x,) = _amp_cast("pad", x)
    pad = [int(p) for p in (pad.tolist() if isinstance(pad, torch.Tensor)
                            else pad)]
    nd = x.ndim
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        n_sp = len(pad) // 2
        spatial = [(pad[2 * i], pad[2 * i + 1]) for i in range(n_sp)][::-1]
        if data_format in ("NHWC", "NDHWC", "NLC"):
            width = [(0, 0)] + spatial + [(0, 0)]
        else:
            width = [(0, 0)] * (nd - n_sp) + spatial
    if mode == "constant":
        flat = []
        for lo, hi in reversed(width):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad mode must be constant, reflect, replicate "
                         f"or circular, got {mode!r}")
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, mode,
                                             x.device))
    return x


from ...tensor.manipulation import flatten  # noqa: E402,F401  (one definition)


def _resize_nearest(x, out_hw, channels_first):
    if channels_first:
        h, w = x.shape[2], x.shape[3]
    else:
        h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw

    def src(n_out, n_in):
        f = float(np.float32(n_in / n_out))
        return (torch.arange(n_out, dtype=torch.float32, device=x.device)
                * f).long()

    ax = 2 if channels_first else 1
    return x.index_select(ax, src(oh, h)).index_select(ax + 1, src(ow, w))


def _linear_weights(n_in, n_out, device):
    """``jax.image`` ``compute_weight_mat`` of the triangle kernel with
    antialiasing: the [n_in, n_out] float32 weights of one axis."""
    f32 = torch.float32
    inv = 1.0 / torch.tensor(n_out / n_in, dtype=f32, device=device)
    kscale = torch.clamp_min(inv, 1.0)
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv \
        - 0.5
    pos = torch.arange(n_in, dtype=f32, device=device)
    dist = (sample[None, :] - pos[:, None]).abs() / kscale
    w = torch.clamp_min(1.0 - dist, 0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_linear(x, out_spatial, channels_first):
    first = 2 if channels_first else 1
    y = x.float()
    for d, n_out in enumerate(out_spatial):
        ax = first + d
        n_in = y.shape[ax]
        if n_in == n_out:
            continue
        w = _linear_weights(n_in, n_out, x.device)
        y = torch.movedim(torch.tensordot(y, w, dims=([ax], [0])), -1, ax)
    return y.to(x.dtype)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    (x,) = _amp_cast("interpolate", x)
    n_sp = x.ndim - 2
    channels_first = data_format.startswith("NC")
    in_sp = x.shape[2:] if channels_first else x.shape[1:-1]
    if size is not None:
        sizes = size if isinstance(size, (list, tuple)) else [size] * n_sp
        out_sp = tuple(int(s.item()) if isinstance(s, torch.Tensor)
                       else int(s) for s in sizes)
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * n_sp
        out_sp = tuple(int(s * f) for s, f in zip(in_sp, sf))
    if mode == "nearest" and n_sp == 2:
        return _resize_nearest(x, out_sp, channels_first)
    return _resize_linear(x, out_sp, channels_first)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``x1 W x2 + b`` with ``weight`` [out, in1, in2]."""
    x1, x2, weight, bias = _amp_cast("bilinear", x1, x2, weight, bias)
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    x1, x2 = _amp_cast("cosine_similarity", x1, x2)
    dot = torch.sum(x1 * x2, dim=axis)
    na = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    nb = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp_min(na * nb, eps)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    (x,) = _amp_cast("pixel_shuffle", x)
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        oc = c // (r * r)
        out = x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(n, oc, h * r, w * r)
    n, h, w, c = x.shape
    oc = c // (r * r)
    out = x.reshape(n, h, w, r, r, oc).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(n, h * r, w * r, oc)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    (x,) = _amp_cast("pixel_unshuffle", x)
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        out = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return out.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    out = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    (x,) = _amp_cast("channel_shuffle", x)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        out = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
        return out.reshape(n, c, h, w)
    n, h, w, c = x.shape
    out = x.reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return out.reshape(n, h, w, c)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    label, prior_dist = _amp_cast("label_smooth", label, prior_dist)
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _pads4(p):
    pd = list(p) if isinstance(p, (list, tuple)) else [p] * 4
    return [pd[0], pd[0], pd[1], pd[1]] if len(pd) == 2 else pd


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C, H, W] -> [N, C * kh * kw, L], channel-major."""
    (x,) = _amp_cast("unfold", x)
    (kh, kw), st, dl = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    pd = _pads4(paddings)
    n, c = x.shape[:2]
    a = torch.nn.functional.pad(x, [pd[2], pd[3], pd[0], pd[1]])
    oh = (a.shape[2] - (dl[0] * (kh - 1) + 1)) // st[0] + 1
    ow = (a.shape[3] - (dl[1] * (kw - 1) + 1)) // st[1] + 1
    patches = [a[:, :, i * dl[0]:i * dl[0] + oh * st[0]:st[0],
                 j * dl[1]:j * dl[1] + ow * st[1]:st[1]]
               for i in range(kh) for j in range(kw)]
    return torch.stack(patches, dim=2).reshape(n, c * kh * kw, oh * ow)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of ``unfold``: overlapping patches add."""
    (x,) = _amp_cast("fold", x)
    os_, (kh, kw) = _pair(output_sizes), _pair(kernel_sizes)
    st, dl, pd = _pair(strides), _pair(dilations), _pads4(paddings)
    n, ckk, _ = x.shape
    c = ckk // (kh * kw)
    ph, pw = os_[0] + pd[0] + pd[1], os_[1] + pd[2] + pd[3]
    oh = (ph - (dl[0] * (kh - 1) + 1)) // st[0] + 1
    ow = (pw - (dl[1] * (kw - 1) + 1)) // st[1] + 1
    cols = x.reshape(n, c, kh, kw, oh, ow)
    out = torch.zeros((n, c, ph, pw), dtype=x.dtype, device=x.device)
    for i in range(kh):
        for j in range(kw):
            di, dj = i * dl[0], j * dl[1]
            out[:, :, di:di + oh * st[0]:st[0],
                dj:dj + ow * st[1]:st[1]] += cols[:, :, i, j]
    return out[:, :, pd[0]:ph - pd[1], pd[2]:pw - pd[3]]


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)
