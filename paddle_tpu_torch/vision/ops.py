"""Vision ops: port of ``paddle_tpu/vision/ops.py`` (detection
primitives).

None of them is a kernel in the reference (``roi_align``, ``roi_pool``,
``deform_conv2d`` and ``box_coder`` are XLA gathers and arithmetic; the
NMS pair is host numpy), so here they are torch ops and the same host
numpy:

- ``roi_align`` (:83) / ``RoIAlign`` and ``roi_pool`` (:142) /
  ``RoIPool``: bilinear samples on a fixed grid per bin (``2 x 2`` a bin
  unless ``sampling_ratio``, ``4 x 4`` for the pool), averaged or
  maxed.  ``_bilinear_sample`` clamps every sample to the border, as the
  reference's (:32).  The image of each RoI is the reference's
  ``jnp.repeat(arange(N), boxes_num, total_repeat_length=R)`` (:96,
  :154): when ``boxes_num`` sums past R the tail is cut, short of R the
  last image repeats.  Boxes and ``boxes_num`` take no gradient.
- ``deform_conv2d`` (:280) / ``DeformConv2D``: the bilinear gather of
  ``_bilinear_sample_zero`` (:58: a corner off the padded map adds
  zero) and one contraction with the kernel; v2's ``mask`` modulates
  each sample.  ``groups`` and ``deformable_groups`` other than 1 raise,
  as in the reference.
- ``box_coder`` (:381) and ``prior_box`` (:415): the reference's
  formulas; the priors and variances take no gradient.
- ``nms`` (:206) and ``matrix_nms`` (:239): the reference's host numpy;
  they return int64 (and float32) tensors on the input's device.

Every index is clamped into the map before a gather: a CUDA gather past
a tensor is a device fault, where XLA clamps.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn.common import materialize, meta_factory

__all__ = ["roi_align", "RoIAlign", "roi_pool", "RoIPool", "nms",
           "deform_conv2d", "DeformConv2D", "box_coder", "prior_box",
           "matrix_nms"]


def _gather(feat, img, yi, xi):
    """``feat[img, :, yi, xi]`` as ``[*grid, C]`` moved to ``[grid0, C,
    *grid[1:]]`` (``feat [N, C, H, W]``; ``img``, ``yi``, ``xi`` integer
    tensors that broadcast to the grid, already inside the map)."""
    out = feat[img, :, yi, xi]
    return out.movedim(-1, 1)


def _bilinear_sample(feat, img, ys, xs):
    """Bilinear samples of ``feat [N, C, H, W]`` at ``(ys, xs)`` (grids of
    shape ``[R, ...]``; ``img [R]`` the image of each row) -> ``[R, C,
    ...]``.  Samples off the map clamp to the border."""
    H, W = feat.shape[-2], feat.shape[-1]
    y0 = torch.clamp(torch.floor(ys), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    ly = torch.clamp(ys - y0, 0.0, 1.0)
    lx = torch.clamp(xs - x0, 0.0, 1.0)
    y0i, y1i, x0i, x1i = (t.long() for t in (y0, y1, x0, x1))
    im = img.reshape((-1,) + (1,) * (ys.ndim - 1))

    def w(t):
        return t.unsqueeze(1)

    v00 = _gather(feat, im, y0i, x0i)
    v01 = _gather(feat, im, y0i, x1i)
    v10 = _gather(feat, im, y1i, x0i)
    v11 = _gather(feat, im, y1i, x1i)
    return (w((1 - ly) * (1 - lx)) * v00 + w((1 - ly) * lx) * v01 +
            w(ly * (1 - lx)) * v10 + w(ly * lx) * v11)


def _bilinear_sample_zero(feat, img, ys, xs):
    """Like ``_bilinear_sample``, but a corner off the map adds zero (the
    reference's deformable-conv rule); a point wholly off it vanishes."""
    H, W = feat.shape[-2], feat.shape[-1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    y1 = y0 + 1
    x1 = x0 + 1
    ly = ys - y0
    lx = xs - x0
    im = img.reshape((-1,) + (1,) * (ys.ndim - 1))

    def corner(yc, xc, wt):
        valid = (yc >= 0) & (yc <= H - 1) & (xc >= 0) & (xc <= W - 1)
        yi = torch.clamp(yc, 0, H - 1).long()
        xi = torch.clamp(xc, 0, W - 1).long()
        return _gather(feat, im, yi, xi) * (wt * valid.to(wt.dtype)
                                             ).unsqueeze(1)

    return (corner(y0, x0, (1 - ly) * (1 - lx)) +
            corner(y0, x1, (1 - ly) * lx) +
            corner(y1, x0, ly * (1 - lx)) +
            corner(y1, x1, ly * lx))


def _roi_images(boxes_num, r, device):
    """``jnp.repeat(arange(N), boxes_num, total_repeat_length=r)``."""
    counts = np.asarray(boxes_num.detach().cpu().numpy()
                        if isinstance(boxes_num, torch.Tensor)
                        else boxes_num, np.int64).reshape(-1)
    img = np.repeat(np.arange(counts.shape[0]), counts)[:r]
    if img.shape[0] < r:
        fill = img[-1] if img.shape[0] else counts.shape[0] - 1
        img = np.concatenate([img, np.full(r - img.shape[0], fill)])
    return torch.from_numpy(img.astype(np.int64)).to(device)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _roi_grid(x, boxes, boxes_num, output_size, ns, corners):
    """The sample grid of every RoI: (images, ys, xs), each ys/xs
    ``[R, ph*ns, pw*ns]``; ``corners(b) -> (x1, y1, bin_h, bin_w)``."""
    ph, pw = _pair(output_size)
    b = boxes.detach()
    img = _roi_images(boxes_num, b.shape[0], x.device)
    x1, y1, bin_h, bin_w = corners(b)
    iy = (torch.arange(ph * ns, device=x.device, dtype=b.dtype) + 0.5) / ns
    ix = (torch.arange(pw * ns, device=x.device, dtype=b.dtype) + 0.5) / ns
    ys = y1[:, None] + iy[None, :] * bin_h[:, None]
    xs = x1[:, None] + ix[None, :] * bin_w[:, None]
    grid_y = ys[:, :, None].expand(-1, ph * ns, pw * ns)
    grid_x = xs[:, None, :].expand(-1, ph * ns, pw * ns)
    return img, grid_y, grid_x, (ph, pw)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign (Mask R-CNN): the mean of bilinear samples in each bin.
    x ``[N, C, H, W]``; boxes ``[R, 4]`` (x1, y1, x2, y2); boxes_num
    ``[N]`` RoIs per image, in order."""
    ns = sampling_ratio if sampling_ratio > 0 else 2
    offset = 0.5 if aligned else 0.0
    ph, pw = _pair(output_size)

    def corners(b):
        x1 = b[:, 0] * spatial_scale - offset
        y1 = b[:, 1] * spatial_scale - offset
        rw = b[:, 2] * spatial_scale - offset - x1
        rh = b[:, 3] * spatial_scale - offset - y1
        if not aligned:
            rw = torch.clamp_min(rw, 1.0)
            rh = torch.clamp_min(rh, 1.0)
        return x1, y1, rh / ph, rw / pw

    img, gy, gx, _ = _roi_grid(x, boxes, boxes_num, output_size, ns,
                               corners)
    vals = _bilinear_sample(x, img, gy, gx)
    r, c = vals.shape[0], vals.shape[1]
    return vals.reshape(r, c, ph, ns, pw, ns).mean(dim=(3, 5))


class RoIAlign(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self._output_size,
                         self._spatial_scale)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """RoIPool (Fast R-CNN): the max over a 4x-oversampled grid a bin (the
    reference's static-shape form of the max over a bin's cells)."""
    ns = 4
    ph, pw = _pair(output_size)

    def corners(b):
        x1 = torch.round(b[:, 0] * spatial_scale)
        y1 = torch.round(b[:, 1] * spatial_scale)
        x2 = torch.round(b[:, 2] * spatial_scale)
        y2 = torch.round(b[:, 3] * spatial_scale)
        rw = torch.clamp_min(x2 - x1 + 1, 1.0)
        rh = torch.clamp_min(y2 - y1 + 1, 1.0)
        return x1, y1, rh / ph, rw / pw

    img, gy, gx, _ = _roi_grid(x, boxes, boxes_num, output_size, ns,
                               corners)
    vals = _bilinear_sample(x, img, gy, gx)
    r, c = vals.shape[0], vals.shape[1]
    return vals.reshape(r, c, ph, ns, pw, ns).amax(dim=(3, 5))


class RoIPool(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._output_size,
                        self._spatial_scale)


def _host(x, dtype=None):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype) if dtype is not None else np.asarray(x)


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _iou_matrix(boxes):
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    xx1 = np.maximum(x1[:, None], x1[None, :])
    yy1 = np.maximum(y1[:, None], y1[None, :])
    xx2 = np.minimum(x2[:, None], x2[None, :])
    yy2 = np.minimum(y2[:, None], y2[None, :])
    inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
    union = area[:, None] + area[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Hard NMS on the host (a data-dependent output size); returns the
    kept indices by falling score."""
    b = _host(boxes, np.float32)
    n = b.shape[0]
    s = (_host(scores, np.float32) if scores is not None
         else np.arange(n, 0, -1, dtype=np.float32))
    if category_idxs is not None:
        # category-aware: offset boxes per category so they never overlap
        cidx = _host(category_idxs)
        max_coord = b.max() if n else 0.0
        b = b + (cidx[:, None].astype(np.float32) * (max_coord + 1.0))
    order = np.argsort(-s)
    iou = _iou_matrix(b)
    keep = []
    suppressed = np.zeros(n, bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = True
    keep = np.asarray(keep, np.int64)
    if top_k is not None:
        keep = keep[:top_k]
    return torch.from_numpy(keep).to(_device_of(boxes))


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=-1, keep_top_k=-1, use_gaussian=False,
               gaussian_sigma=2.0, name=None):
    """Matrix NMS (SOLOv2) of one image's ``[N, 4]`` boxes and ``[N]``
    scores; returns (decayed scores, kept indices)."""
    dev = _device_of(bboxes, scores)
    b = _host(bboxes, np.float32)
    s = _host(scores, np.float32)
    valid = np.nonzero(s >= score_threshold)[0]
    if nms_top_k > 0:
        valid = valid[np.argsort(-s[valid])[:nms_top_k]]
    else:
        valid = valid[np.argsort(-s[valid])]
    if valid.size == 0:
        return (torch.zeros((0,), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.int64, device=dev))
    bb, ss = b[valid], s[valid]
    iou = np.triu(_iou_matrix(bb), k=1)
    # compensate IoU: each suppressor's own max IoU with a higher-scored
    # box, row-indexed in the decay matrix (SOLOv2 eq. 4)
    iou_cmax = iou.max(axis=0)
    if use_gaussian:
        decay = np.exp(-(iou ** 2 - iou_cmax[:, None] ** 2) / gaussian_sigma)
        decay = decay.min(axis=0)
    else:
        decay = ((1 - iou) / np.maximum(1 - iou_cmax[:, None], 1e-10)) \
            .min(axis=0)
    decay = np.minimum(decay, 1.0)
    decayed = ss * decay
    mask = decayed >= post_threshold
    out_idx = valid[mask]
    out_scores = decayed[mask]
    order = np.argsort(-out_scores)
    if keep_top_k > 0:
        order = order[:keep_top_k]
    return (torch.from_numpy(np.ascontiguousarray(out_scores[order])).to(dev),
            torch.from_numpy(out_idx[order].astype(np.int64)).to(dev))


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1/v2 as a bilinear gather and one
    contraction.  x ``[N, Cin, H, W]``; offset ``[N, 2*kh*kw, Ho, Wo]``
    ((dy, dx) pairs); mask ``[N, kh*kw, Ho, Wo]`` (v2); weight ``[Cout,
    Cin, kh, kw]``."""
    if groups != 1 or deformable_groups != 1:
        raise NotImplementedError(
            "deform_conv2d: groups/deformable_groups > 1 are not supported, "
            "as in the reference (ROADMAP.md, \"Known differences of the "
            "hapi surface\")")
    stride, padding, dilation = _pair(stride), _pair(padding), \
        _pair(dilation)
    kh, kw = weight.shape[2], weight.shape[3]
    n, c, h, w_ = x.shape
    ho = (h + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (w_ + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    k = kh * kw
    xp = torch.nn.functional.pad(
        x, (padding[1], padding[1], padding[0], padding[0]))
    dev, f32 = x.device, torch.float32
    oy = torch.arange(ho, device=dev) * stride[0]
    ox = torch.arange(wo, device=dev) * stride[1]
    ky = torch.arange(kh, device=dev) * dilation[0]
    kx = torch.arange(kw, device=dev) * dilation[1]
    base_y = (ky[:, None, None, None] + oy[None, None, :, None]).to(f32) \
        .expand(kh, kw, ho, wo).reshape(1, k, ho, wo)
    base_x = (kx[None, :, None, None] + ox[None, None, None, :]).to(f32) \
        .expand(kh, kw, ho, wo).reshape(1, k, ho, wo)
    off = offset.reshape(n, k, 2, ho, wo)
    ys = base_y + off[:, :, 0]
    xs = base_x + off[:, :, 1]
    img = torch.arange(n, device=dev)
    vals = _bilinear_sample_zero(xp, img, ys, xs)      # [N, C, K, Ho, Wo]
    if mask is not None:
        vals = vals * mask.reshape(n, 1, k, ho, wo)
    cols = vals.reshape(n, c * k, ho * wo)
    out = torch.einsum("ok,nkp->nop", weight.reshape(weight.shape[0], c * k),
                       cols).reshape(n, weight.shape[0], ho, wo)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


class DeformConv2D(nn.Module):
    """``weight`` Xavier-normal (the reference's initializer, drawn from
    ``seed``), ``bias`` zeros unless ``bias_attr=False``; built on the
    card unless ``device="cpu"``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype="float32", seed=0):
        super().__init__()
        ks = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        fac = meta_factory(dtype)
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels // groups, ks[0], ks[1]), **fac))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.empty((out_channels,), **fac))
        materialize(self, device, init=False)
        if self.weight.device.type != "meta":
            self._init(seed)

    @torch.no_grad()
    def _init(self, seed):
        rf = self.weight[0, 0].numel()
        fan_in, fan_out = self.weight.shape[1] * rf, self.weight.shape[0] * rf
        gen = torch.Generator(device=self.weight.device).manual_seed(seed)
        self.weight.normal_(0.0, (2.0 / (fan_in + fan_out)) ** 0.5,
                            generator=gen)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, self._stride,
                             self._padding, self._dilation,
                             self._deformable_groups, self._groups, mask)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode or decode boxes against priors (the reference's
    ``box_coder``)."""
    norm = 0.0 if box_normalized else 1.0
    pb, pbv, tb = prior_box.detach(), prior_box_var.detach(), target_box
    pw = pb[:, 2] - pb[:, 0] + norm
    phh = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw * 0.5
    pcy = pb[:, 1] + phh * 0.5
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw * 0.5
        tcy = tb[:, 1] + th * 0.5
        dx = (tcx - pcx) / pw / pbv[:, 0]
        dy = (tcy - pcy) / phh / pbv[:, 1]
        dw = torch.log(tw / pw) / pbv[:, 2]
        dh = torch.log(th / phh) / pbv[:, 3]
        return torch.stack([dx, dy, dw, dh], dim=-1)
    # decode_center_size: tb holds deltas
    dcx = pbv[:, 0] * tb[..., 0] * pw + pcx
    dcy = pbv[:, 1] * tb[..., 1] * phh + pcy
    dw = torch.exp(pbv[:, 2] * tb[..., 2]) * pw
    dh = torch.exp(pbv[:, 3] * tb[..., 3]) * phh
    return torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                        dcx + dw * 0.5 - norm, dcy + dh * 0.5 - norm],
                       dim=-1)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    """SSD prior (anchor) boxes over a feature map, on the host; returns
    (boxes, variances) ``[H, W, K, 4]`` on ``input``'s device."""
    fh, fw = int(input.shape[2]), int(input.shape[3])
    ih, iw = float(image.shape[2]), float(image.shape[3])
    step_h = steps[1] or ih / fh
    step_w = steps[0] or iw / fw
    ars = list(aspect_ratios)
    if flip:
        ars += [1.0 / a for a in aspect_ratios if a != 1.0]

    boxes = []
    for ms in min_sizes:
        for ar in ars:
            w = ms * np.sqrt(ar)
            h = ms / np.sqrt(ar)
            boxes.append((w, h))
        if max_sizes:
            for mx in max_sizes:
                s = np.sqrt(ms * mx)
                boxes.append((s, s))
    k = len(boxes)
    cy = (np.arange(fh) + offset) * step_h
    cx = (np.arange(fw) + offset) * step_w
    grid_cx, grid_cy = np.meshgrid(cx, cy)
    out = np.zeros((fh, fw, k, 4), np.float32)
    for i, (w, h) in enumerate(boxes):
        out[:, :, i, 0] = (grid_cx - w / 2) / iw
        out[:, :, i, 1] = (grid_cy - h / 2) / ih
        out[:, :, i, 2] = (grid_cx + w / 2) / iw
        out[:, :, i, 3] = (grid_cy + h / 2) / ih
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          out.shape).copy()
    dev = _device_of(input)
    return torch.from_numpy(out).to(dev), torch.from_numpy(var).to(dev)
