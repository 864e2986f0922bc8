"""``affine_grid`` and ``grid_sample``: port of
``paddle_tpu/nn/functional/vision.py``, the reference's gathers in
torch ops (``grid_sample`` reads NCHW and returns NCHW; bilinear or
nearest, ``zeros`` padding masks taps outside, any other mode clamps)."""

from __future__ import annotations

import torch

from ...amp.auto_cast import cast as _amp_cast

__all__ = ["affine_grid", "grid_sample"]


def affine_grid(theta, out_shape, align_corners=True, name=None):
    (theta,) = _amp_cast("affine_grid", theta)
    n, c, h, w = [int(s) for s in out_shape]
    kw = dict(dtype=torch.float32, device=theta.device)
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, h, **kw)
        xs = torch.linspace(-1.0, 1.0, w, **kw)
    else:
        ys = (torch.arange(h, **kw) + 0.5) / h * 2 - 1
        xs = (torch.arange(w, **kw) + 0.5) / w * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nok->nhwo", base.to(theta.dtype), theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    x, grid = _amp_cast("grid_sample", x, grid)
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1) * (w - 1) / 2
        fy = (gy + 1) * (h - 1) / 2
    else:
        fx = ((gx + 1) * w - 1) / 2
        fy = ((gy + 1) * h - 1) / 2
    batch = torch.arange(n, device=x.device)[:, None, None]
    xl = x.permute(0, 2, 3, 1)                          # n, h, w, c

    def sample(ix, iy):
        ixc = torch.clamp(ix, 0, w - 1).long()
        iyc = torch.clamp(iy, 0, h - 1).long()
        vals = xl[batch, iyc, ixc]                      # n, gh, gw, c
        if padding_mode == "zeros":
            inside = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
            vals = vals * inside[..., None].to(vals.dtype)
        return vals

    if mode == "nearest":
        out = sample(torch.round(fx), torch.round(fy))
    else:
        x0, y0 = torch.floor(fx), torch.floor(fy)
        x1, y1 = x0 + 1, y0 + 1
        wa = (x1 - fx) * (y1 - fy)
        wb = (x1 - fx) * (fy - y0)
        wc = (fx - x0) * (y1 - fy)
        wd = (fx - x0) * (fy - y0)
        out = (sample(x0, y0) * wa[..., None] + sample(x0, y1) * wb[..., None]
               + sample(x1, y0) * wc[..., None]
               + sample(x1, y1) * wd[..., None])
    return out.permute(0, 3, 1, 2)
