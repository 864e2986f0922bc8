"""The port's training-path ops held against the JAX package on the CPU.

The same numpy inputs go through the JAX function and the port's
counterpart.  On the CPU the port's autograd Functions run their plain
versions (the Function's own wiring included: the flash backward's
delta, its GQA sum and its casts); the JAX side runs its Pallas kernels
in interpret mode, as its own tests do.  Tolerances, each with its
reason:
- RoPE, float32: ``atol 1e-6`` (the same fp32 products and sums; only
  the compilers' rounding order differs);
- flash forward, float32: ``atol 2e-5`` for O and LSE (blocked online
  softmax against one softmax over the row);
- flash gradients, float32: ``atol 2e-4, rtol 1e-3``, the JAX package's
  own bound for its kernel against XLA (``test_pallas_kernels.py:59``);
- RMSNorm gradients, float32: ``atol 1e-5`` (row reductions summed in a
  different order);
- cross entropy, float32: ``atol 1e-6``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn.functional.attention import _xla_attention
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import rms_norm as jrn
from paddle_tpu.ops.pallas import rope as jrp
import paddle_tpu_torch
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import rms_norm as trn
from paddle_tpu_torch.ops import rope as trp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _tables(s, d, base=10000.0):
    inv = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float32) / d))
    freqs = np.outer(np.arange(s, dtype=np.float32), inv)
    return (np.cos(freqs)[None, :, None, :].astype(np.float32),
            np.sin(freqs)[None, :, None, :].astype(np.float32))


# ---- RoPE ----

def test_rope_forward_and_grad_match_pallas_kernel():
    rng = np.random.default_rng(5)
    b, s, h, d = 1, 16, 2, 64
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    c = rng.standard_normal((b, s, h, d)).astype(np.float32)
    cos, sin = _tables(s, d)
    jy = jrp.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    jg = jax.grad(lambda a: jnp.sum(jrp.apply_rope(
        a, jnp.asarray(cos), jnp.asarray(sin)) * jnp.asarray(c)))(
            jnp.asarray(x))
    tx = _t(x, grad=True)
    ty = trp.apply_rope(tx, _t(cos), _t(sin))
    (ty * _t(c)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=0)
    assert trp.KERNEL.launches == 0


def test_rope_bf16_plain_rounds_one_fp32_result():
    """bfloat16: the rotation runs in fp32 and is cast once, so the port
    equals the fp32 rotation of the same bf16 input, rounded."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 8, 3, 32)).astype(
        np.float32)).to(torch.bfloat16)
    cos, sin = (_t(a) for a in _tables(8, 32))
    got = trp.apply_rope(x, cos, sin)
    assert got.dtype == torch.bfloat16
    want = trp.apply_rope_plain(x.float(), cos, sin).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_llama_rope_without_positions_is_the_kernel_route():
    """``position_ids=None`` builds the arange tables and goes through
    ``apply_rope``; it equals the explicit-position branch."""
    rng = np.random.default_rng(7)
    q = _t(rng.standard_normal((2, 12, 4, 16)).astype(np.float32))
    k = _t(rng.standard_normal((2, 12, 2, 16)).astype(np.float32))
    q1, k1 = tF.llama_rope(q, k, rotary_emb_base=500000.0)
    pos = torch.arange(12)[None, :].expand(2, 12)
    q2, k2 = tF.llama_rope(q, k, rotary_emb_base=500000.0, position_ids=pos)
    torch.testing.assert_close(q1, q2, atol=1e-6, rtol=0)
    torch.testing.assert_close(k1, k2, atol=1e-6, rtol=0)


# ---- flash attention ----

def _qkv(seed, b, s, hq, hk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, hq, d), (b, s, hk, d), (b, s, hk, d)))


def _jax_fwd(q, k, v, causal):
    """The Pallas forward kernel in interpret mode on the JAX package's
    own layout (kv heads repeated): O [B, S, Hq, D], LSE [B, Hq, S]."""
    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    kr = jnp.repeat(jnp.asarray(k), rep, axis=2)
    vr = jnp.repeat(jnp.asarray(v), rep, axis=2)
    bq, bk = jfa.best_blocks(s, s, d, jnp.float32, causal)
    o3, lse3 = jfa._flash_fwd_impl(jfa._heads_layout(jnp.asarray(q)),
                                   jfa._heads_layout(kr),
                                   jfa._heads_layout(vr), causal, bq, bk)
    o = jfa._unheads_layout(o3, b, hq)
    return np.asarray(o), np.asarray(lse3[:, :, 0]).reshape(b, hq, s)


@pytest.mark.parametrize("causal,hq,hk", [(False, 2, 2), (True, 2, 2),
                                          (True, 4, 2)])
def test_flash_forward_matches_pallas_kernel(causal, hq, hk):
    q, k, v = _qkv(0, 2, 256, hq, hk, 64)
    jo, jlse = _jax_fwd(q, k, v, causal)
    to, tlse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(to.numpy(), jo, atol=2e-5, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), jlse, atol=2e-5, rtol=0)
    out = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert torch.equal(out, to)
    assert tfa.KERNEL_FWD.launches == 0


@pytest.mark.parametrize("causal,hq,hk", [(False, 2, 2), (True, 2, 2),
                                          (True, 4, 2)])
def test_flash_gradients_match_onepass_kernel(causal, hq, hk):
    """jax.grad of ``fa.flash_attention`` runs ``_onepass_bwd_kernel``
    in interpret mode (``flash_onepass_bwd`` defaults to True)."""
    q, k, v = _qkv(1, 1, 256, hq, hk, 64)
    c = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)

    def loss(a, b_, c_):
        return jnp.sum(jfa.flash_attention(a, b_, c_, causal=causal)
                       * jnp.asarray(c))

    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    (tfa.flash_attention(tq, tk, tv, causal=causal) * _t(c)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   rtol=1e-3)
    assert tfa.KERNEL_BWD.launches == 0


def test_flash_ragged_length_and_bf16_casts():
    """S = 100 (not a multiple of any tile) runs; bfloat16 inputs give
    bfloat16 O and gradients, fp32 LSE, and stay within bf16 rounding of
    the float32 result."""
    q, k, v = _qkv(3, 1, 100, 4, 2, 64)
    tq, tk, tv = (_t(a).to(torch.bfloat16).requires_grad_() for a in
                  (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=True)
    o.float().sum().backward()
    assert o.dtype == tq.grad.dtype == tk.grad.dtype == torch.bfloat16
    _, lse = tfa.flash_attention_fwd(tq, tk, tv, True)
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 100)
    ref = tfa.flash_attention_fwd_plain(*(t.detach().float() for t in
                                          (tq, tk, tv)), True)[0]
    torch.testing.assert_close(o.float(), ref, atol=2e-2, rtol=2e-2)


def test_flash_gradcheck_float64():
    """The Function's backward (delta, core, GQA sum) is the derivative
    of its forward: gradcheck in float64 on the plain path."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
               for shape in ((1, 9, 4, 8), (1, 9, 2, 8), (1, 9, 2, 8)))
    assert torch.autograd.gradcheck(
        lambda a, b_, c_: tfa.flash_attention(a, b_, c_, causal=True),
        (q, k, v), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["gqa_heads", "causal_lengths",
                                  "block_not_dividing"])
def test_flash_attention_value_errors(case):
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    if case == "gqa_heads":
        with pytest.raises(ValueError, match="multiple of kv heads"):
            tfa.flash_attention(q, torch.zeros(1, 8, 3, 16),
                                torch.zeros(1, 8, 3, 16))
    elif case == "causal_lengths":
        with pytest.raises(ValueError, match="equal q/k lengths"):
            tfa.flash_attention(q, torch.zeros(1, 6, 2, 16),
                                torch.zeros(1, 6, 2, 16), causal=True)
    else:
        with pytest.raises(ValueError, match="divisible by block"):
            tfa.flash_attention(q, k, k, block_q=3)


def _flash_bad(case):
    q = torch.zeros(2, 8, 4, 64)
    k = torch.zeros(2, 8, 2, 64)
    bad = {
        "f64": (q.double(), k.double(), k.double(), TypeError),
        "mixed_dtype": (q, k.to(torch.bfloat16), k, TypeError),
        "head_dim_32": (torch.zeros(2, 8, 4, 32), torch.zeros(2, 8, 2, 32),
                        torch.zeros(2, 8, 2, 32), ValueError),
        "kv_shapes": (q, k, torch.zeros(2, 8, 1, 64), ValueError),
    }
    if case == "ok":
        return q, k, k, None
    return bad[case]


@pytest.mark.parametrize("case", ["ok", "f64", "mixed_dtype", "head_dim_32",
                                  "kv_shapes"])
def test_flash_kernel_operand_checks(case):
    """What the CUDA wrappers refuse before any launch (device-independent
    checks, run here on CPU tensors)."""
    q, k, v, exc = _flash_bad(case)
    if exc is None:
        assert tfa._check_operands(q, k, v, True) == (2, 8, 8, 4, 2, 64)
        return
    with pytest.raises(exc):
        tfa._check_operands(q, k, v, True)


@pytest.mark.parametrize("case", ["ok", "odd_d", "f64", "f64_tables",
                                  "table_shape"])
def test_rope_kernel_operand_checks(case):
    x = torch.zeros(2, 4, 3, 8)
    cos = torch.zeros(1, 4, 1, 4)
    args, exc = {
        "ok": ((x, cos, cos), None),
        "odd_d": ((torch.zeros(2, 4, 3, 7), torch.zeros(1, 4, 1, 3),
                   torch.zeros(1, 4, 1, 3)), ValueError),
        "f64": ((x.double(), cos, cos), TypeError),
        "f64_tables": ((x, cos.double(), cos), TypeError),
        "table_shape": ((x, torch.zeros(1, 5, 1, 4), cos), ValueError),
    }[case]
    if exc is None:
        trp._check_operands(*args)
        return
    with pytest.raises(exc):
        trp._check_operands(*args)


# ---- RMSNorm ----

def test_rms_norm_gradients_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 16, 128)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)
    jgx, jgw = jax.grad(lambda a, b_: jnp.sum(jrn.rms_norm(a, b_, 1e-5)
                                              * jnp.asarray(c)),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x, True), _t(w, True)
    (trn.rms_norm(tx, tw, 1e-5) * _t(c)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=1e-5,
                               rtol=1e-6)
    assert trn.KERNEL.launches == 0


def test_rms_norm_gradcheck_float64():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16))).requires_grad_()
    w = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(16)) \
        .requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b_: trn.rms_norm(a, b_, 1e-6),
                                    (x, w), eps=1e-6, atol=1e-7)


def test_rms_norm_bf16_grad_dtypes():
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16).requires_grad_()
    w = torch.ones(32, dtype=torch.bfloat16, requires_grad=True)
    trn.rms_norm(x, w).float().sum().backward()
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16


# ---- decode attention has no backward ----

def test_paged_decode_kernel_refuses_grad_mode():
    """On the card the paged decode kernel would return an output
    detached from q and the arenas; its wrapper raises instead (checked
    here through the device-independent operand checks)."""
    b, hkv, g, blk_len, nb, mb, d = 2, 2, 2, 4, 6, 3, 32
    q = torch.zeros(b, hkv * g, d, requires_grad=True)
    ka = torch.zeros(nb + 1, blk_len, hkv * d)
    tables = torch.zeros(b, mb, dtype=torch.int32)
    lens = torch.zeros(b, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        tda._check_operands(q, ka, ka, tables, lens)
    with torch.no_grad():
        assert tda._check_operands(q, ka, ka, tables, lens) == \
            (2, 4, 32, 2, 2)


# ---- attention and loss functionals ----

def test_sdpa_with_mask_matches_xla_attention():
    rng = np.random.default_rng(10)
    q, k, v = _qkv(11, 2, 16, 4, 2, 8)
    mask = np.where(rng.random((2, 1, 16, 16)) < 0.2, -1e9, 0.0) \
        .astype(np.float32)
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask=jnp.asarray(mask))
    got = tF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                          attn_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_sdpa_without_mask_is_flash_and_dropout_raises():
    q, k, v = _qkv(12, 1, 16, 4, 2, 8)
    got = tF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                          is_causal=True)
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    with pytest.raises(NotImplementedError, match="dropout"):
        tF.scaled_dot_product_attention(_t(q), _t(k), _t(v), dropout_p=0.1)
    # dropout is off outside training, as in the JAX package
    tF.scaled_dot_product_attention(_t(q), _t(k), _t(v), dropout_p=0.1,
                                    training=False)


@pytest.mark.parametrize("trailing", [False, True])
def test_cross_entropy_with_ignored_positions_matches_jax(trailing):
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int64)
    labels[0, :3] = -100
    labels[1, 5] = -100
    if trailing:
        labels = labels[..., None]
    want = paddle.nn.functional.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(labels),
        ignore_index=-100)
    got = tF.cross_entropy(_t(logits), _t(labels), ignore_index=-100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=1e-6, rtol=0)


def test_cross_entropy_all_ignored_is_zero():
    logits = torch.zeros(3, 5)
    labels = torch.full((3,), -100)
    assert float(tF.cross_entropy(logits, labels)) == 0.0


@pytest.mark.parametrize("kw", [dict(weight=torch.ones(5)),
                                dict(reduction="sum"),
                                dict(soft_label=True),
                                dict(label_smoothing=0.1),
                                dict(use_softmax=False)])
def test_cross_entropy_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        tF.cross_entropy(torch.zeros(3, 5), torch.zeros(3, dtype=torch.long),
                         **kw)


@pytest.mark.parametrize("flag,value", [
    ("FLAGS_use_decode_attention_kernel", False),
    ("FLAGS_use_int8_matmul_kernel", True),
    ("FLAGS_prefer_pallas_kernels", False),
])
def test_set_flags_refuses_the_unported_routes(flag, value):
    with pytest.raises(NotImplementedError, match=flag):
        paddle_tpu_torch.set_flags({flag: value})
