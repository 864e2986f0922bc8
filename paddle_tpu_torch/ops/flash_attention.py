"""Flash attention: the CUDA kernels ``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu`` and ``csrc/flash_attention_bwd_twopass.cu``,
their plain PyTorch versions, and the autograd Function over them.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``: the forward
``_fwd_kernel`` (:161) behind ``_flash_fwd_impl`` (:400), the one-pass
backward ``_onepass_bwd_kernel`` (:292) behind ``_flash_bwd_onepass``
(:351), the two-pass backward ``_dq_kernel`` (:212) and ``_dkv_kernel``
(:248) behind ``_flash_bwd`` (:443), the ``delta = rowsum(dO * O)``
prologue (:443-452, XLA there, plain torch here), and
``flash_attention`` (:504-537) with its GQA and its ``ValueError``s.
``flash_attention_bwd`` reads the ``flash_onepass_bwd`` flag where the
reference reads it (:454-457): on (the default) the one-pass kernel, off
the dQ kernel and then the dK/dV kernel.

The arithmetic is the kernels': scale ``1/sqrt(D)``, mask value -1e30,
fp32 scores, softmax statistics and accumulation; ``P`` cast to v's
dtype before ``P V``, ``dS`` cast to the input dtype before ``dQ`` and
``dK``; LSE is kept compact, fp32 ``[B, Hq, Sq]``.  The public layout is
``[B, S, H, D]``; the kernels read it directly (no head-major copies).

GQA: the JAX package repeats K and V to Hq heads, so their gradients sum
over each group of G = Hq / Hkv query heads, in fp32, once.  The kernels
read kv head ``h // G`` directly.  Every backward core returns dK and dV
per KV head.  In bfloat16 the one-pass kernel and the two-pass dK/dV
kernel walk the group's query heads in one CTA, sum in fp32 registers
and write [B, Sk, Hkv, D] in k's dtype; in float32 both write fp32 per
QUERY head and their wrappers sum each group (``_group_sum``), as the
plain cores sum theirs, in the compute dtype.  The one-pass kernel sums
dQ with fp32 atomics across key blocks, so its last bits vary from run
to run on the card; the two-pass dQ kernel sums each query block's dQ
in one CTA and writes it once, so its dQ is the same on every run.

In bfloat16 the forward runs on the tensor cores (``mma.sync`` fed by
``cp.async``, ``csrc/flash_mma.cuh``), and so do the backward kernels'
dS K, P^T dO and dS^T Q (``csrc/flash_bwd_tc.cuh``); their S and dP run
on CUDA cores in the order of the plain version's float32 matmul, so P
and dS round as there.  In float32 every flash kernel runs on CUDA
cores, since TF32 would break the float32 tolerance.

``flash_attention`` runs the forward as the dispatcher op
``paddle_tpu_torch::flash_attention_fwd`` (``flash_attention_op``) with
its backward registered beside it, so that a selective checkpoint policy
(``distributed.recompute(policy="save_attn")``) can keep O and LSE and
the backward then does not run the forward kernel again.

``flash_attention_fwd``, ``_bwd_core_onepass``, ``_dq`` and ``_dkv``
launch the kernels for CUDA tensors (or raise on what they cannot take)
and run the plain versions for CPU tensors; nothing sends a CUDA tensor
to a plain version.  The TPU gates of ``should_use_pallas`` (``s %
128``, ``d`` in {64, 128, 256}, the VMEM budget) are not carried over;
the CUDA kernels take D in {64, 128} and any S.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build
from ..core.flags import flag

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

KERNEL_FWD = _build.register(_build.Kernel(
    "flash_attention_fwd", "ptt_flash_attention_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]))

KERNEL_BWD = _build.register(_build.Kernel(
    "flash_attention_bwd", "ptt_flash_attention_bwd",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]))

KERNEL_DQ = _build.register(_build.Kernel(
    "flash_attention_bwd_dq", "ptt_flash_attention_bwd_dq",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    source="flash_attention_bwd_twopass"))

KERNEL_DKV = _build.register(_build.Kernel(
    "flash_attention_bwd_dkv", "ptt_flash_attention_bwd_dkv",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    source="flash_attention_bwd_twopass"))


def _geometry(q, k, v, causal):
    """Shapes as ``flash_attention`` (:504-531) checks them; returns
    (B, Sq, Sk, Hq, Hkv, D)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be [B, Sq, Hq, D] and "
                         f"k, v the same [B, Sk, Hkv, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hk, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or head_dim")
    if hk < 1 or hq % hk:
        raise ValueError(
            f"flash_attention: q heads ({hq}) must be a multiple of "
            f"kv heads ({hk}) for GQA broadcast")
    if causal and sq != sk:
        raise ValueError(
            f"flash_attention: causal masking requires equal q/k lengths "
            f"(got {sq} vs {sk}); the kernel mask has no kv offset")
    return b, sq, sk, hq, hk, d


def _heads(x, g=1):
    """[B, S, H, D] -> [B, H*g, S, D], each head repeated g times."""
    x = x.permute(0, 2, 1, 3)
    return x.repeat_interleave(g, dim=1) if g > 1 else x


def _scores(q, k, causal, ct):
    """Scaled fp32 scores [B, Hq, Sq, Sk], masked to -1e30."""
    g = q.shape[2] // k.shape[2]
    s = (_heads(q.to(ct)) @ _heads(k.to(ct), g).transpose(-1, -2)) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        sq, sk = s.shape[-2:]
        above = torch.ones(sq, sk, dtype=torch.bool,
                           device=s.device).triu(1)
        s.masked_fill_(above, NEG_INF)
    return s


def flash_attention_fwd_plain(q, k, v, causal):
    """Plain forward on any device: returns (O [B, Sq, Hq, D] in q's
    dtype, LSE [B, Hq, Sq] in fp32; float64 stays float64)."""
    _geometry(q, k, v, causal)
    ct = torch.promote_types(q.dtype, torch.float32)
    s = _scores(q, k, causal, ct)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype).to(ct)
    o = p @ _heads(v.to(ct), q.shape[2] // k.shape[2])
    return o.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse


def _p_ds(q, k, v, do, lse, delta, causal):
    """P and dS [B, Hq, Sq, Sk] in the compute dtype, as both backward
    kernels rebuild them."""
    ct = torch.promote_types(q.dtype, torch.float32)
    p = torch.exp(_scores(q, k, causal, ct) - lse[..., None].to(ct))
    dp = _heads(do.to(ct)) @ _heads(v.to(ct), q.shape[2] // k.shape[2]) \
        .transpose(-1, -2)
    return p, p * (dp - delta[..., None].to(ct))


def _dq_of(q, k, ds):
    """scale * dS K with dS cast to k's dtype, summed in the compute
    dtype: [B, Hq, Sq, D]."""
    ct = torch.promote_types(q.dtype, torch.float32)
    g = q.shape[2] // k.shape[2]
    return (ds.to(k.dtype).to(ct) @ _heads(k.to(ct), g)) \
        * (1.0 / math.sqrt(q.shape[-1]))


def _dkv_of(q, do, p, ds):
    """dK = scale * dS^T Q with dS cast to q's dtype and dV = P^T dO with
    P cast to dO's dtype, PER QUERY HEAD: [B, Hq, Sk, D] each."""
    ct = torch.promote_types(q.dtype, torch.float32)
    dv = p.to(do.dtype).to(ct).transpose(-1, -2) @ _heads(do.to(ct))
    dk = (ds.to(q.dtype).to(ct).transpose(-1, -2) @ _heads(q.to(ct))) \
        * (1.0 / math.sqrt(q.shape[-1]))
    return dk, dv


def _dq_plain(q, k, v, do, lse, delta, causal):
    """The dQ kernel's contract in plain torch: dQ [B, Sq, Hq, D] in q's
    dtype."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal)
    return _dq_of(q, k, ds).permute(0, 2, 1, 3).to(q.dtype)


def _group_sum(x, hk):
    """[B, S, Hq, D] per query head -> [B, S, Hkv, D], each group of G =
    Hq / Hkv heads summed in x's dtype."""
    b, s, hq, d = x.shape
    return x.reshape(b, s, hk, hq // hk, d).sum(dim=3) if hq > hk else x


def _dkv_plain(q, k, v, do, lse, delta, causal):
    """The dK/dV kernel's contract in plain torch: dK, dV [B, Sk, Hkv, D]
    in k's dtype, each group of query heads summed in the compute
    dtype."""
    dk, dv = _dkv_of(q, do, *_p_ds(q, k, v, do, lse, delta, causal))
    return tuple(_group_sum(t.permute(0, 2, 1, 3), k.shape[2]).to(k.dtype)
                 for t in (dk, dv))


def _bwd_core_plain(q, k, v, do, lse, delta, causal):
    """The one-pass backward kernel's contract in plain torch, P and dS
    built once: dQ [B, Sq, Hq, D] and dK, dV [B, Sk, Hkv, D], each group
    of query heads summed, all in the compute dtype (fp32 for bf16
    inputs)."""
    p, ds = _p_ds(q, k, v, do, lse, delta, causal)
    dk, dv = (_group_sum(t.permute(0, 2, 1, 3), k.shape[2])
              for t in _dkv_of(q, do, p, ds))
    return _dq_of(q, k, ds).permute(0, 2, 1, 3), dk, dv


def _bwd_wiring(core, q, k, v, o, lse, do, causal):
    """delta, the backward core (dK and dV per KV head) and the casts."""
    _geometry(q, k, v, causal)
    ct = torch.promote_types(q.dtype, torch.float32)
    # rowsum(dO * O) in the compute dtype; O widens inside the product
    delta = do.to(ct, copy=True).mul_(o).sum(dim=-1).permute(0, 2, 1) \
        .contiguous()
    dq, dk, dv = core(q, k, v, do, lse, delta, causal)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal):
    """Plain backward on any device: (dQ, dK, dV) in the inputs'
    dtypes, from the forward's O and LSE and the output gradient."""
    return _bwd_wiring(_bwd_core_plain, q, k, v, o, lse, do, causal)


def _check_operands(q, k, v, causal, *more):
    """Raise on what the kernels cannot take; returns (B, Sq, Sk, Hq,
    Hkv, D)."""
    b, sq, sk, hq, hk, d = _geometry(q, k, v, causal)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("k", k), ("v", v)) + more:
        if t.dtype != q.dtype:
            raise TypeError(f"flash attention kernels need {name} dtype == "
                            f"q dtype, got {t.dtype} vs {q.dtype}")
    for name, t in (("k", k), ("v", v)) + more:
        if t.device != q.device:
            raise ValueError(f"flash attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in "
                         f"{_HEAD_DIMS}, got {d}")
    if b > 65535 or hq > 65535:
        raise ValueError(f"flash attention kernels take B, Hq <= 65535, got "
                         f"{b}, {hq}")
    if max(b * sq * hq, b * sk * hk) * d >= 2 ** 31:
        raise ValueError("flash attention kernels take < 2**31 elements per "
                         "operand")
    return b, sq, sk, hq, hk, d


def _contig(*ts):
    out = tuple(t.contiguous() for t in ts)
    for t in out:
        if t.data_ptr() % 16:
            raise ValueError("flash attention kernels need 16-byte aligned "
                             "operands")
    return out


def _fwd_cuda(q, k, v, causal):
    b, sq, sk, hq, hk, d = _check_operands(q, k, v, causal)
    q, k, v = _contig(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    if o.numel() == 0 or sk == 0:
        return o.zero_(), lse.fill_(NEG_INF)
    KERNEL_FWD.launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
        _build.ptr(lse), b, sq, sk, hq, hk, d, 1.0 / math.sqrt(d),
        int(causal), _DTYPES[q.dtype], _build.stream_ptr(q))
    return o, lse


def _check_bwd(q, k, v, do, lse, delta, causal):
    b, sq, sk, hq, hk, d = _check_operands(q, k, v, causal, ("do", do))
    if lse.shape != (b, hq, sq) or delta.shape != (b, hq, sq) \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"flash attention backward needs fp32 lse and delta "
                         f"of shape {(b, hq, sq)}")
    return b, sq, sk, hq, hk, d


def _bwd_core_cuda(q, k, v, do, lse, delta, causal):
    """fp32 dQ [B, Sq, Hq, D] and dK, dV [B, Sk, Hkv, D] from the one-pass
    kernel.  In bfloat16 the kernel sums each GQA group in fp32 registers
    and writes k's dtype; in float32 it writes fp32 per query head and
    the group is summed here."""
    b, sq, sk, hq, hk, d = _check_bwd(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta = _contig(q, k, v, do, lse, delta)
    dq = torch.zeros(b, sq, hq, d, dtype=torch.float32, device=q.device)
    heads = hq if q.dtype == torch.float32 else hk
    dk = torch.empty(b, sk, heads, d, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq, _group_sum(dk.zero_(), hk), _group_sum(dv.zero_(), hk)
    KERNEL_BWD.launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
        _build.ptr(lse), _build.ptr(delta), _build.ptr(dq), _build.ptr(dk),
        _build.ptr(dv), b, sq, sk, hq, hk, d, 1.0 / math.sqrt(d),
        int(causal), _DTYPES[q.dtype], _build.stream_ptr(q))
    return dq, _group_sum(dk, hk), _group_sum(dv, hk)


def _dq_cuda(q, k, v, do, lse, delta, causal):
    """dQ in q's dtype [B, Sq, Hq, D] from the dQ kernel."""
    b, sq, sk, hq, hk, d = _check_bwd(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta = _contig(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0 or sk == 0:
        return dq.zero_()
    KERNEL_DQ.launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
        _build.ptr(lse), _build.ptr(delta), _build.ptr(dq), b, sq, sk, hq,
        hk, d, 1.0 / math.sqrt(d), int(causal), _DTYPES[q.dtype],
        _build.stream_ptr(q))
    return dq


def _dkv_cuda(q, k, v, do, lse, delta, causal):
    """dK, dV [B, Sk, Hkv, D] in k's dtype from the dK/dV kernel.  In
    bfloat16 the kernel sums each GQA group in fp32 registers; in float32
    it writes fp32 per query head and the group is summed here."""
    b, sq, sk, hq, hk, d = _check_bwd(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta = _contig(q, k, v, do, lse, delta)
    heads = hq if q.dtype == torch.float32 else hk
    dk = torch.empty(b, sk, heads, d, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0 or sq == 0:
        return _group_sum(dk.zero_(), hk), _group_sum(dv.zero_(), hk)
    KERNEL_DKV.launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
        _build.ptr(lse), _build.ptr(delta), _build.ptr(dk), _build.ptr(dv),
        b, sq, sk, hq, hk, d, 1.0 / math.sqrt(d), int(causal),
        _DTYPES[q.dtype], _build.stream_ptr(q))
    return _group_sum(dk, hk), _group_sum(dv, hk)


def _on_device(cuda_fn, plain_fn, q, *args):
    if q.device.type == "cuda":
        return cuda_fn(q, *args)
    if q.device.type == "cpu":
        return plain_fn(q, *args)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def _bwd_core_onepass(q, k, v, do, lse, delta, causal):
    """The one-pass kernel for CUDA tensors, its plain core for CPU
    tensors."""
    return _on_device(_bwd_core_cuda, _bwd_core_plain, q, k, v, do, lse,
                      delta, causal)


def _dq(q, k, v, do, lse, delta, causal):
    """The dQ kernel for CUDA tensors, ``_dq_plain`` for CPU tensors."""
    return _on_device(_dq_cuda, _dq_plain, q, k, v, do, lse, delta, causal)


def _dkv(q, k, v, do, lse, delta, causal):
    """The dK/dV kernel for CUDA tensors, ``_dkv_plain`` for CPU
    tensors."""
    return _on_device(_dkv_cuda, _dkv_plain, q, k, v, do, lse, delta,
                      causal)


def _bwd_core_twopass(q, k, v, do, lse, delta, causal):
    """The two-pass route: the dQ pass, then the dK/dV pass."""
    return (_dq(q, k, v, do, lse, delta, causal),) \
        + _dkv(q, k, v, do, lse, delta, causal)


def flash_attention_fwd(q, k, v, causal):
    """(O, LSE) on q's device: the forward kernel for CUDA tensors, the
    plain version for CPU tensors."""
    return _on_device(_fwd_cuda, flash_attention_fwd_plain, q, k, v, causal)


def flash_attention_bwd(q, k, v, o, lse, do, causal):
    """(dQ, dK, dV) on q's device: delta, then the one-pass backward
    (``flash_onepass_bwd``, the default) or the dQ and dK/dV passes, each
    a kernel for CUDA tensors and its plain version for CPU tensors, then
    the casts."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    core = _bwd_core_onepass if flag("flash_onepass_bwd") \
        else _bwd_core_twopass
    return _bwd_wiring(core, q, k, v, o, lse, do, causal)


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd`` as a dispatcher op, so that a selective
    checkpoint policy sees it and can keep its outputs (the reference tags
    ``o`` and ``lse`` ``"attn_out"``, :437-439)."""
    o, lse = flash_attention_fwd(q, k, v, causal)
    return o, lse


@flash_attention_op.register_fake
def _(q, k, v, causal):
    return (torch.empty_like(q),
            q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                        dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal = causal


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
    return dq, dk, dv, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q, k, v, causal=False, block_q=None, block_k=None):
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] (Hq % Hkv == 0).  Returns
    O [B, Sq, Hq, D], differentiable in q, k and v.

    ``block_q``/``block_k`` are the TPU kernel's tile sizes: as there,
    given ones must divide the sequence lengths (else ``ValueError``);
    the CUDA kernels tile by 64 rows and mask the ragged edge
    themselves."""
    _geometry(q, k, v, causal)
    sq, sk = q.shape[1], k.shape[1]
    if (block_q is not None and sq % block_q) or \
            (block_k is not None and sk % block_k):
        raise ValueError(
            f"flash_attention: seq lengths (q={sq}, k={sk}) must be "
            f"divisible by block sizes (block_q={block_q}, "
            f"block_k={block_k})")
    return flash_attention_op(q, k, v, bool(causal))[0]
