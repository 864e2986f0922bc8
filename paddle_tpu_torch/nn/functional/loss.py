"""Losses: port of the rest of ``paddle_tpu/nn/functional/loss.py``
(``cross_entropy``, ``softmax_with_cross_entropy`` and ``nll_loss`` are
in the package's ``__init__``).

Each is the reference's formula in torch ops, its inputs cast by the
AMP rule under the reference's op name.  Two are dynamic programs:
- ``ctc_loss`` is the reference's own recurrence, not
  ``torch.nn.functional.ctc_loss``: float32 ``alpha`` over the
  blank-extended label, ``-1e30`` for an impossible path, ``+1e-37``
  inside each log, a row held past its ``input_lengths``, the two end
  states log-summed, and ``"mean"`` dividing each loss by its label
  length before the batch mean.  torch's op differs where a label cannot
  fit its input (inf, or 0 with ``zero_infinity``, against the
  reference's finite ``1e30``).  One loop step per time step (the
  reference's ``lax.scan``), differentiated by autograd.
- ``rnnt_loss`` is the reference's transducer lattice (log-softmax over
  the vocabulary, the blank and label arcs, FastEmit as the
  straight-through ``lp + lambda (lp - stop_gradient(lp))`` on the label
  arcs), one row per time step and one cell per label position.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...amp.auto_cast import cast as _amp_cast

__all__ = [
    "mse_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "log_loss", "square_error_cost", "sigmoid_focal_loss", "dice_loss",
    "ctc_loss", "rnnt_loss", "poisson_nll_loss",
    "multi_label_soft_margin_loss", "soft_margin_loss",
]

NEG_INF = -1e30


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    a, b = _amp_cast("mse_loss", input, label)
    return _reduce((a - b) ** 2, reduction)


def l1_loss(input, label, reduction="mean", name=None):
    a, b = _amp_cast("l1_loss", input, label)
    return _reduce((a - b).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    a, b = _amp_cast("smooth_l1_loss", input, label)
    d = (a - b).abs()
    return _reduce(torch.where(d < delta, 0.5 * d * d,
                               delta * (d - 0.5 * delta)), reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p, y, w = _amp_cast("binary_cross_entropy", input, label, weight)
    eps = 1e-12
    loss = -(y * torch.log(torch.clamp_min(p, eps))
             + (1 - y) * torch.log(torch.clamp_min(1 - p, eps)))
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    z, y, w, pw = _amp_cast("bce_with_logits", logit, label, weight,
                            pos_weight)
    if pw is None:
        loss = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    else:
        sp = torch.logaddexp(-z, torch.zeros_like(z))     # softplus(-z)
        loss = -(pw * y * -sp + (1 - y) * (-z - sp))
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    logp, t = _amp_cast("kl_div", input, label)
    if log_target:
        loss = torch.exp(t) * (t - logp)
    else:
        loss = t * (torch.log(torch.clamp_min(t, 1e-12)) - logp)
        loss = torch.where(t > 0, loss, torch.zeros_like(loss))
    if reduction == "batchmean":
        return loss.sum() / logp.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    a, b, y = _amp_cast("margin_ranking_loss", input, other,
                        label.detach())
    return _reduce(torch.clamp_min(-y * (a - b) + margin, 0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    a, y = _amp_cast("hinge_embedding_loss", input, label)
    return _reduce(torch.where(y == 1, a, torch.clamp_min(margin - a, 0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    a, b, y = _amp_cast("cosine_embedding_loss", input1, input2, label)
    cos = torch.sum(a * b, -1) / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), 1e-12)
    return _reduce(torch.where(y == 1, 1 - cos,
                               torch.clamp_min(cos - margin, 0.0)), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    a, pos, neg = _amp_cast("triplet_margin_loss", input, positive, negative)

    def dist(u, v):
        return torch.sum((u - v + epsilon).abs() ** p, dim=-1) ** (1.0 / p)

    d_neg = dist(a, neg)
    if swap:
        d_neg = torch.minimum(d_neg, dist(pos, neg))
    return _reduce(torch.clamp_min(dist(a, pos) - d_neg + margin, 0.0),
                   reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    p, y = _amp_cast("log_loss", input, label)
    return -(y * torch.log(p + epsilon) + (1 - y) * torch.log(1 - p + epsilon))


def square_error_cost(input, label, name=None):
    a, b = _amp_cast("square_error_cost", input, label)
    return (a - b) ** 2


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, y, norm = _amp_cast("sigmoid_focal_loss", logit, label, normalizer)
    p = torch.sigmoid(z)
    ce = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if norm is not None:
        loss = loss / norm
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    p, y = _amp_cast("dice_loss", input, label)
    oh = F.one_hot(y.squeeze(-1).long(), p.shape[-1]).to(p.dtype)
    dims = tuple(range(1, p.ndim))
    inter = torch.sum(p * oh, dim=dims)
    union = torch.sum(p, dim=dims) + torch.sum(oh, dim=dims)
    return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    a, y = _amp_cast("poisson_nll_loss", input, label.detach())
    loss = torch.exp(a) - y * a if log_input else \
        a - y * torch.log(a + epsilon)
    if full:
        stirling = y * torch.log(y + epsilon) - y + 0.5 * torch.log(
            2 * math.pi * (y + epsilon))
        loss = loss + torch.where(y > 1, stirling, torch.zeros_like(stirling))
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    z, y, w = _amp_cast("multi_label_soft_margin_loss", input,
                        label.detach(), weight)
    loss = -(y * F.logsigmoid(z) + (1 - y) * F.logsigmoid(-z)).mean(dim=-1)
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    z, y = _amp_cast("soft_margin_loss", input, label.detach())
    return _reduce(torch.log1p(torch.exp(-y * z)), reduction)


def _full(shape, value, like):
    return torch.full(shape, value, dtype=torch.float32, device=like.device)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC of ``log_probs`` [T, B, C] (log-softmax output) against padded
    ``labels`` [B, L]; float32 loss, see the module docstring."""
    (lp,) = _amp_cast("ctc_loss", log_probs)
    lp_b = lp.transpose(0, 1) if lp.ndim == 3 else lp        # [B, T, C]
    b, t_max, _ = lp_b.shape
    s = 2 * labels.shape[1] + 1
    dev = lp.device
    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels.to(dev).long()
    in_len = input_lengths.to(dev).long()
    lbl_len = label_lengths.to(dev).long()
    first = lp_b[:, 0, :].float()
    alpha = torch.cat([first[:, blank:blank + 1],
                       torch.gather(first, 1, ext[:, 1:2]),
                       _full((b, s - 2), NEG_INF, lp)], dim=1)
    same2 = torch.cat([torch.ones((b, 2), dtype=torch.bool, device=dev),
                       ext[:, 2:] == ext[:, :-2]], dim=1)
    pad1, pad2 = _full((b, 1), NEG_INF, lp), _full((b, 2), NEG_INF, lp)
    for t in range(1, t_max):
        probs = torch.gather(lp_b[:, t, :], 1, ext).float()
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.cat([pad2, alpha[:, :-2]], dim=1)
        a2 = torch.where(same2, NEG_INF, a2)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        new = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                            + torch.exp(a2 - m) + 1e-37) + probs
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    end1 = 2 * lbl_len
    ll1 = torch.gather(alpha, 1, end1[:, None])[:, 0]
    ll2 = torch.gather(alpha, 1, torch.clamp_min(end1 - 1, 0)[:, None])[:, 0]
    m = torch.maximum(ll1, ll2)
    loss = -(m + torch.log(torch.exp(ll1 - m) + torch.exp(ll2 - m)))
    if norm_by_times:
        loss = loss / in_len.to(loss.dtype)
    if reduction == "mean":
        return torch.mean(loss / lbl_len.to(loss.dtype))
    return _reduce(loss, reduction)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-Transducer loss of unnormalized logits ``input`` [B, T, U+1,
    V] against ``label`` [B, U]; see the module docstring."""
    if reduction not in ("none", "mean", "sum"):
        raise ValueError(
            f"rnnt_loss reduction must be none/mean/sum, got {reduction!r}")
    (acts,) = _amp_cast("rnnt_loss", input)
    if acts.ndim != 4:
        raise ValueError(f"rnnt_loss input must be [B, Tmax, Umax+1, V], "
                         f"got rank {acts.ndim}")
    b, t_max, u1, _ = acts.shape
    u = u1 - 1
    if tuple(label.shape) != (b, u):
        raise ValueError(f"rnnt_loss label must be [B, {u}] for input "
                         f"U+1={u1}, got {list(label.shape)}")
    dev = acts.device
    lp = torch.log_softmax(acts.float(), dim=-1)
    lp_blank = lp[:, :, :, blank]                              # [B, T, U+1]
    idx = label.to(dev).long()[:, None, :, None].expand(b, t_max, u, 1)
    lp_label = torch.gather(lp[:, :, :u, :], 3, idx)[..., 0]   # [B, T, U]
    if fastemit_lambda:
        lp_label = lp_label + fastemit_lambda * (lp_label - lp_label.detach())
    alpha = torch.cat([torch.zeros((b, 1), dtype=lp.dtype, device=dev),
                       torch.cumsum(lp_label[:, 0, :], dim=1)], dim=1)
    rows = [alpha]
    for t in range(1, t_max):
        from_blank = alpha + lp_blank[:, t - 1, :]
        a = from_blank[:, 0]
        cells = [a]
        for j in range(1, u1):
            a = torch.logaddexp(from_blank[:, j], a + lp_label[:, t, j - 1])
            cells.append(a)
        alpha = torch.stack(cells, dim=1)
        rows.append(alpha)
    all_rows = torch.stack(rows, dim=0)                        # [T, B, U+1]
    t_idx = torch.clamp(input_lengths.to(dev).long() - 1, 0, t_max - 1)
    u_idx = torch.clamp(label_lengths.to(dev).long(), 0, u)
    ar = torch.arange(b, device=dev)
    loss = -(all_rows[t_idx, ar, u_idx] + lp_blank[ar, t_idx, u_idx])
    return _reduce(loss.to(acts.dtype), reduction)
