"""Fused AdamW: the CUDA kernel ``csrc/fused_adamw.cu``, its plain
PyTorch version, and the stochastic rounding of bf16 moments that both
the kernel and the train step's unfused update use.

Port of ``paddle_tpu/ops/pallas/fused_optimizer.py``: ``_adamw_kernel``
(:71) behind ``fused_adamw_update`` (:243), with ``_adamw_math``
(:44-58) and ``_store`` (:61).  ``fused_adamw_update`` updates p, m and v
IN PLACE (the counterpart of the Pallas call's input/output aliases) and
returns them.

The arithmetic is ``_adamw_math``: decoupled decay first, then the
moments, then the bias corrections ``1 - exp(t * log(beta))`` (exactly 1
for a beta of 0), the reference kernel's form, which differs in the last
bits from the unfused step's ``beta ** t``.  p is cast back by round to
nearest even.  A bf16 moment is stored by stochastic rounding when
``seed`` is given (``(bits + (noise & 0xFFFF)) & 0xFFFF0000``, the
reference's rule) and by round to nearest even when it is not.

The noise is per element, as the Pallas kernel draws it, from a counter
hash of ``(seed, counter)``: ``noise = mix(mix(c ^ k) + k)`` with ``k =
mix(seed)`` and ``mix`` the "lowbias32" finalizer, in 32-bit arithmetic;
counter ``2 i`` for m and ``2 i + 1`` for v at flat index ``i``.  The
plain version computes it with int64 torch ops keeping the low 32 bits
(int64 wraparound preserves them), so the kernel and the plain version
draw identical noise and agree bit for bit on the card.

``chunk`` (the flat form's block size) and the 2-D/flat split are TPU
grid choices: accepted and ignored, as the flash wrapper treats
``block_q``/``block_k``.  The TPU tiling gate ``native_tileable`` has no
counterpart: the kernel takes any shape.

``fused_adamw_update`` launches the kernel for CUDA tensors (or raises
on what it cannot take) and runs ``fused_adamw_update_plain`` for CPU
tensors; nothing sends a CUDA tensor to the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF

KERNEL = _build.register(_build.Kernel(
    "fused_adamw", "ptt_fused_adamw",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_float] * 6
    + [ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p]))


def _mix32(x):
    """"lowbias32" on an int64 tensor (or a Python int) holding 32-bit
    values; products keep their low 32 bits."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def noise_bits(seed: int, counter: torch.Tensor) -> torch.Tensor:
    """32 random bits per counter (an int64 tensor of values below
    2**32) from a 32-bit ``seed``: the kernel's hash."""
    k = _mix32(int(seed) & _M32)
    return _mix32((_mix32(counter ^ k) + k) & _M32)


def seed_of(key: int) -> int:
    """The 32-bit seed of a 64-bit generator key (its low word)."""
    return int(key) & _M32


def stochastic_round_bf16(x: torch.Tensor, noise: torch.Tensor):
    """fp32 ``x`` to bf16 by the reference's rule: add the low 16 bits of
    ``noise`` (uint32 values in an int64 tensor that broadcasts against
    ``x``) below the bf16 mantissa, then truncate.  E[result] == x."""
    bits = x.to(torch.float32).contiguous().view(torch.int32) \
        .to(torch.int64) & _M32
    r = (bits + (noise & 0xFFFF)) & 0xFFFF0000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    return r.view(torch.float32).to(torch.bfloat16)


def _store_plain(dst, val, sr, seed, parity):
    """Write the fp32 ``val`` into ``dst`` (in place) in dst's dtype; a
    bf16 ``dst`` by stochastic rounding with the noise of counters
    ``2 i + parity`` when ``sr``."""
    if dst.dtype == torch.bfloat16 and sr:
        counter = torch.arange(val.numel(), dtype=torch.int64,
                               device=val.device) * 2 + parity
        dst.copy_(stochastic_round_bf16(val.reshape(-1),
                                        noise_bits(seed, counter))
                  .reshape(dst.shape))
    else:
        dst.copy_(val)


def adamw_scalars(lr, step, beta1, beta2, device):
    """(lr, bc1, bc2) as one fp32 tensor on ``device``, the kernel's
    ``scalars`` operand, which the parameters of one step share: the bias
    corrections ``1 - exp(t * log(beta))``, 1 for a beta of 0.  The
    exponent ``t * log(beta)`` is fp32, as in the reference; its exp is
    taken in float64 and rounded once to fp32, the correctly rounded fp32
    exp, so the card and the CPU get the same bits (fp32 ``exp`` may
    differ in the last bit between them, and ``1 - beta2**t`` cancels:
    one ulp of ``beta2**t`` is 1e-4 of ``bc2`` at t = 1)."""
    f32 = dict(dtype=torch.float32, device=device)
    lr_t = torch.as_tensor(lr, **f32).reshape(())
    t = torch.as_tensor(step, **f32).reshape(())

    def corr(beta):
        bt = torch.exp((t * math.log(beta)).double()).float() if beta > 0 \
            else torch.zeros((), **f32)
        return 1.0 - bt

    return torch.stack([lr_t, corr(beta1), corr(beta2)])


def _sr_wanted(m, v, seed):
    return seed is not None and torch.bfloat16 in (m.dtype, v.dtype)


def fused_adamw_update_plain(p, g, m, v, lr, step, beta1=0.9, beta2=0.999,
                             epsilon=1e-8, weight_decay=0.01, chunk=None,
                             seed=None, scalars=None):
    """The kernel's function in torch ops, on any device: p, m and v are
    updated in place and returned.  Each operation is one fp32 op, in
    the kernel's order, so on the card the two agree bit for bit."""
    sc = adamw_scalars(lr, step, beta1, beta2, p.device) \
        if scalars is None else scalars
    lr_t, bc1, bc2 = sc[0], sc[1], sc[2]
    sr = _sr_wanted(m, v, seed)
    with torch.no_grad():
        gf = g.float()
        pf = p.float() * (1.0 - lr_t * weight_decay)
        mn = beta1 * m.float() + (1.0 - beta1) * gf
        vn = beta2 * v.float() + ((1.0 - beta2) * gf) * gf
        den = torch.sqrt(vn / bc2) + epsilon
        p.copy_(pf - (lr_t * (mn / bc1)) / den)
        _store_plain(m, mn, sr, seed, 0)
        _store_plain(v, vn, sr, seed, 1)
    return p, m, v


def _check_operands(p, g, m, v):
    if p.dtype not in _DTYPES or m.dtype not in _DTYPES:
        raise TypeError(f"fused AdamW kernel takes float32 or bfloat16 p and "
                        f"moments, got {p.dtype} and {m.dtype}")
    if g.dtype != p.dtype or v.dtype != m.dtype:
        raise TypeError(f"fused AdamW kernel needs g in p's dtype and v in "
                        f"m's, got p {p.dtype} g {g.dtype} m {m.dtype} v "
                        f"{v.dtype}")
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.shape != p.shape:
            raise ValueError(f"fused AdamW: {name} shape {tuple(t.shape)} != "
                             f"p shape {tuple(p.shape)}")
        if t.device != p.device:
            raise ValueError(f"fused AdamW: {name} on {t.device}, p on "
                             f"{p.device}")
    for name, t in (("p", p), ("m", m), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"fused AdamW kernel updates {name} in place and "
                             f"needs it contiguous")
    if p.numel() >= 2 ** 31:
        raise ValueError(f"fused AdamW kernel takes < 2**31 elements, got "
                         f"{p.numel()}")


def _launch(p, g, m, v, sc, beta1, beta2, epsilon, weight_decay, seed):
    """One launch of the kernel on checked, contiguous operands, with
    (lr, bc1, bc2) in the fp32 device tensor ``sc``."""
    KERNEL.launch(
        _build.ptr(p), _build.ptr(g), _build.ptr(m), _build.ptr(v),
        _build.ptr(sc), p.numel(), beta1, 1.0 - beta1, beta2, 1.0 - beta2,
        epsilon, weight_decay, int(_sr_wanted(m, v, seed)),
        seed_of(seed or 0), _DTYPES[p.dtype], _DTYPES[m.dtype],
        _build.stream_ptr(p))


def _adamw_cuda(p, g, m, v, lr, step, beta1, beta2, epsilon, weight_decay,
                seed, scalars):
    _check_operands(p, g, m, v)
    if scalars is None:
        scalars = adamw_scalars(lr, step, beta1, beta2, p.device)
    elif scalars.dtype != torch.float32 or scalars.shape != (3,) \
            or scalars.device != p.device:
        raise ValueError(f"fused AdamW: scalars must be fp32 (lr, bc1, bc2) "
                         f"on {p.device}, got {scalars.dtype} "
                         f"{tuple(scalars.shape)} on {scalars.device}")
    if p.numel() == 0:
        return
    _launch(p, g.contiguous(), m, v, scalars.contiguous(), beta1, beta2,
            epsilon, weight_decay, seed)


def fused_adamw_update(p, g, m, v, lr, step, beta1=0.9, beta2=0.999,
                       epsilon=1e-8, weight_decay=0.01, chunk=None,
                       seed=None, scalars=None):
    """One fused AdamW step, in place.  p, g: the parameter's dtype; m,
    v: fp32 or bf16 moments (bf16 stored by stochastic rounding when
    ``seed``, a 32-bit integer, is given); lr: a float or an fp32 scalar
    tensor; step: the 1-based step count, an int or an fp32 scalar
    tensor.  ``scalars``: ``adamw_scalars(lr, step, beta1, beta2,
    p.device)`` made once for all the parameters of a step; when given,
    ``lr`` and ``step`` are not read.  Returns (p, m, v)."""
    if p.device.type == "cuda":
        _adamw_cuda(p, g, m, v, lr, step, beta1, beta2, epsilon,
                    weight_decay, seed, scalars)
        return p, m, v
    if p.device.type == "cpu":
        return fused_adamw_update_plain(p, g, m, v, lr, step, beta1, beta2,
                                        epsilon, weight_decay, chunk, seed,
                                        scalars)
    raise ValueError(f"fused_adamw_update: unsupported device {p.device}")
