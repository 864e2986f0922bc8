"""The port's ``incubate.nn`` functionals and layers held against the JAX
package's on the CPU, on the same numpy inputs (the reference's
``tests/test_mmha.py`` and ``tests/test_pallas_kernels.py:262``):

- ``fused_rms_norm`` (with and without a weight, ``return_tuple``; it
  reads neither ``norm_bias`` nor ``begin_norm_axis``), ``fused_layer_norm``
  (``begin_norm_axis``), ``fused_linear`` (``[in, out]`` and
  ``transpose_weight``, bias), ``fused_bias_act`` (every activation),
  ``fused_dropout_add`` (masks bit-equal for the same seed), with input
  gradients;
- ``fused_rotary_position_embedding``: both rotation styles, q/k/v,
  ``time_major``, ``position_ids`` (a position past a built table's rows
  takes its last row, as JAX's gather clamps) and user tables, and the
  reference's own numpy formulas;
- ``masked_multihead_attention`` over steps against a full recompute and
  the JAX function (new caches too), the first step, a broadcastable and
  a short right-padded mask, the full-cache clamp, the shape errors;
- ``memory_efficient_attention`` (``scale`` and ``training`` not read);
- ``FusedFeedForward`` and ``FusedMultiHeadAttention`` with bridged
  weights.

Tolerance: float32 within ``1e-5`` of the reference's largest entry
(``max(1, |ref|)``); dropout masks bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.incubate import nn as jinc
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu_torch import core as tcore
from paddle_tpu_torch.incubate import nn as tinc
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import layer_state_from_jax

REL = 1e-5


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _both(jfn, tfn, inputs, diff=(0,), seed=7, rel=REL):
    """Both functions on numpy ``inputs``: values, and the gradients of
    ``<out, g>`` for a random cotangent with respect to ``diff``."""
    def jf(*arrs):
        full = list(map(jnp.asarray, inputs))
        for i, a in zip(diff, arrs):
            full[i] = a
        return jfn(*[JTensor(a) for a in full])._value

    want, vjp = jax.vjp(jf, *[jnp.asarray(inputs[i]) for i in diff])
    g = _rand(np.shape(want), seed)
    wgrads = vjp(jnp.asarray(g, dtype=want.dtype))
    tin = [torch.tensor(np.array(a, copy=True)) for a in inputs]
    for i in diff:
        tin[i].requires_grad_(True)
    got = tfn(*tin)
    _close(got.detach().numpy(), want, rel, "value")
    (got * torch.from_numpy(g)).sum().backward()
    for i, wg in zip(diff, wgrads):
        _close(tin[i].grad.numpy(), wg, rel, f"grad {i}")
    return got


@pytest.mark.parametrize("with_weight", [False, True])
def test_fused_rms_norm_matches_jax(with_weight):
    x, w, b = _rand((3, 5, 16), 1), _rand((16,), 2), _rand((16,), 3)
    if with_weight:
        _both(lambda a, c, d: JIF.fused_rms_norm(a, c, d, 1e-5, 1),
              lambda a, c, d: TIF.fused_rms_norm(a, c, d, 1e-5, 1),
              (x, w, b), diff=(0, 1))
    else:
        _both(lambda a: JIF.fused_rms_norm(a), lambda a: TIF.fused_rms_norm(a),
              (x,))
    (out,) = TIF.fused_rms_norm(torch.from_numpy(x), return_tuple=True)
    assert out.shape == x.shape


@pytest.mark.parametrize("axis", [-1, 2, 1])
def test_fused_layer_norm_matches_jax(axis):
    x = _rand((2, 3, 8), 4)
    shape = x.shape[axis:] if axis != -1 else x.shape[-1:]
    w, b = _rand(shape, 5), _rand(shape, 6)
    _both(lambda a, c, d: JIF.fused_layer_norm(a, c, d, 1e-5, axis),
          lambda a, c, d: TIF.fused_layer_norm(a, c, d, 1e-5, axis),
          (x, w, b), diff=(0, 1, 2))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_linear_matches_jax(transpose, bias):
    x = _rand((2, 3, 6), 7)
    w = _rand((5, 6) if transpose else (6, 5), 8)
    args = (x, w) + ((_rand((5,), 9),) if bias else ())
    _both(lambda *a: JIF.fused_linear(*a, transpose_weight=transpose),
          lambda *a: TIF.fused_linear(*a, transpose_weight=transpose),
          args, diff=tuple(range(len(args))))


@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "swiglu"])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_bias_act_matches_jax(act, bias):
    x = _rand((4, 8), 10)
    args = (x,) + ((_rand((8,), 11),) if bias else ())
    _both(lambda *a: JIF.fused_bias_act(*a, act_method=act),
          lambda *a: TIF.fused_bias_act(*a, act_method=act),
          args, diff=tuple(range(len(args))))


@pytest.mark.parametrize("p,training,mode", [
    (0.0, True, "upscale_in_train"), (0.3, True, "upscale_in_train"),
    (0.3, False, "upscale_in_train"), (0.5, True, "downscale_in_infer"),
    (0.5, False, "downscale_in_infer")])
def test_fused_dropout_add_matches_jax(p, training, mode):
    x, y = _rand((16, 32), 12), _rand((16, 32), 13)
    paddle.seed(5)
    tcore.generator.seed(5)
    want = np.asarray(JIF.fused_dropout_add(
        paddle.to_tensor(x), paddle.to_tensor(y), p, training, mode)._value)
    got = TIF.fused_dropout_add(torch.from_numpy(x), torch.from_numpy(y), p,
                                training, mode).numpy()
    _close(got, want, what="fused_dropout_add")
    np.testing.assert_array_equal(got == y, want == y)


# ---- rotary embedding ----

def _ref_tables(s, d, base=10000.0):
    exps = (np.arange(d) // 2) * 2.0 / d
    emb = np.outer(np.arange(s), 1.0 / base ** exps)
    return np.sin(emb), np.cos(emb)


def _ref_rotate(x, cos, sin, neox):
    if neox:
        rot = np.stack([-x[..., 1::2], x[..., 0::2]], axis=-1).reshape(
            x.shape)
    else:
        d = x.shape[-1]
        rot = np.concatenate([-x[..., d // 2:], x[..., :d // 2]], axis=-1)
    return x * cos + rot * sin


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_fused_rope_matches_jax(neox, time_major, n):
    s, b, h, d = 8, 2, 3, 16
    shape = (s, b, h, d) if time_major else (b, s, h, d)
    xs = [_rand(shape, 20 + i) for i in range(n)]
    kw = dict(use_neox_rotary_style=neox, time_major=time_major,
              rotary_emb_base=500000.0)
    want = JIF.fused_rotary_position_embedding(
        *[paddle.to_tensor(a) for a in xs], **kw)
    got = TIF.fused_rotary_position_embedding(
        *[torch.from_numpy(a) for a in xs], **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == n
    sin, cos = _ref_tables(s, d, 500000.0)
    bc = (slice(None), None, None, slice(None)) if time_major else \
        (None, slice(None), None, slice(None))
    for g, w, x in zip(got, want, xs):
        _close(g.numpy(), np.asarray(w._value), what="vs jax")
        _close(g.numpy(), _ref_rotate(x, cos[bc], sin[bc], neox), rel=2e-5,
               what="vs formula")


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("tables", [False, True])
def test_fused_rope_position_ids_and_user_tables(neox, tables):
    b, s, h, d = 2, 6, 2, 8
    q, k = _rand((b, s, h, d), 30), _rand((b, s, h, d), 31)
    # scrambled positions, one past the built table's rows (clamped)
    pos = np.array([[5, 0, 3, 1, 9, 2], [4, 4, 0, 5, 1, 7]])
    kw = dict(use_neox_rotary_style=neox)
    jkw, tkw = dict(kw), dict(kw)
    if tables:
        sin, cos = _ref_tables(12, d)
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
        jkw.update(sin=paddle.to_tensor(sin.astype(np.float32)),
                   cos=paddle.to_tensor(cos.astype(np.float32)))
        tkw.update(sin=torch.from_numpy(sin.astype(np.float32)),
                   cos=torch.from_numpy(cos.astype(np.float32)))
    jo = JIF.fused_rotary_position_embedding(
        paddle.to_tensor(q), paddle.to_tensor(k),
        position_ids=paddle.to_tensor(pos), **jkw)
    to = TIF.fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k),
        position_ids=torch.from_numpy(pos), **tkw)
    for g, w in zip(to, jo):
        _close(g.numpy(), np.asarray(w._value), what="vs jax")


def test_fused_rope_gradient_matches_jax():
    x = _rand((1, 4, 2, 8), 33)
    _both(lambda a: JIF.fused_rotary_position_embedding(
              a, use_neox_rotary_style=False),
          lambda a: TIF.fused_rotary_position_embedding(
              a, use_neox_rotary_style=False), (x,))


# ---- masked_multihead_attention (the reference's tests/test_mmha.py) ----

def _ref_step(qkv_steps, t):
    q = qkv_steps[t][:, 0]
    ks = np.stack([s[:, 1] for s in qkv_steps[:t + 1]], axis=2)
    vs = np.stack([s[:, 2] for s in qkv_steps[:t + 1]], axis=2)
    logits = np.einsum("bhd,bhsd->bhs", q, ks) / np.sqrt(q.shape[-1])
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    return np.einsum("bhs,bhsd->bhd", probs, vs).reshape(q.shape[0], -1)


def test_mmha_matches_full_recompute_and_jax_over_steps():
    b, h, d, max_seq, steps = 2, 4, 16, 8, 5
    rng = np.random.default_rng(0)
    jcache = paddle.to_tensor(np.zeros((2, b, h, max_seq, d), np.float32))
    tcache = torch.zeros((2, b, h, max_seq, d))
    qkv_steps = []
    for t in range(steps):
        qkv = rng.standard_normal((b, 3, h, d)).astype(np.float32)
        qkv_steps.append(qkv)
        lens = np.full(b, t, np.int64)
        jout, jcache = JIF.masked_multihead_attention(
            paddle.to_tensor(qkv.reshape(b, -1)), jcache,
            sequence_lengths=paddle.to_tensor(lens))
        before = tcache.clone()
        tout, new = TIF.masked_multihead_attention(
            torch.from_numpy(qkv.reshape(b, -1)), tcache,
            sequence_lengths=torch.from_numpy(lens))
        assert torch.equal(tcache, before)          # the input is kept
        tcache = new
        _close(tout.numpy(), _ref_step(qkv_steps, t), rel=2e-5,
               what="vs recompute")
        _close(tout.numpy(), np.asarray(jout._value), what="vs jax")
        np.testing.assert_array_equal(tcache.numpy(),
                                      np.asarray(jcache._value))


def test_mmha_first_step_defaults():
    b, h, d, max_seq = 1, 2, 8, 4
    qkv = _rand((b, 3, h, d), 1)
    out, cache = TIF.masked_multihead_attention(
        torch.from_numpy(qkv.reshape(b, -1)),
        torch.zeros((2, b, h, max_seq, d)))
    _close(out.numpy(), qkv[:, 2].reshape(b, -1))
    np.testing.assert_array_equal(cache[0, :, :, 0].numpy(), qkv[:, 1])


@pytest.mark.parametrize("mask_len,lens", [(4, 0), (3, 2), (6, 1)])
def test_mmha_masks_and_full_cache_clamp_match_jax(mask_len, lens):
    b, h, d, max_seq = 2, 2, 8, 4
    qkv = _rand((b, 3, h, d), 2)
    cache = _rand((2, b, h, max_seq, d), 3)
    mask = _rand((1, 1, 1, mask_len), 4)
    for seq in (lens, max_seq):                     # max_seq: the clamp
        sl = np.full(b, seq, np.int64)
        jo, jc = JIF.masked_multihead_attention(
            paddle.to_tensor(qkv.reshape(b, -1)), paddle.to_tensor(cache),
            src_mask=paddle.to_tensor(mask),
            sequence_lengths=paddle.to_tensor(sl))
        to, tc = TIF.masked_multihead_attention(
            torch.from_numpy(qkv.reshape(b, -1)), torch.from_numpy(cache),
            src_mask=torch.from_numpy(mask),
            sequence_lengths=torch.from_numpy(sl))
        _close(to.numpy(), np.asarray(jo._value), what=f"out at {seq}")
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc._value))
    np.testing.assert_array_equal(tc[0, :, :, -1].numpy(), qkv[:, 1])


def test_mmha_gradient_matches_jax():
    b, h, d, max_seq = 2, 2, 4, 5
    x = _rand((b, 3 * h * d), 5)
    cache = _rand((2, b, h, max_seq, d), 6)
    lens = np.array([1, 3])

    def jfn(a, c):
        return JIF.masked_multihead_attention(
            a, c, sequence_lengths=paddle.to_tensor(lens))[0]

    def tfn(a, c):
        return TIF.masked_multihead_attention(
            a, c, sequence_lengths=torch.from_numpy(lens))[0]

    _both(jfn, tfn, (x, cache), diff=(0, 1))


def test_mmha_validates_shapes():
    cache = torch.zeros((2, 1, 2, 4, 8))
    with pytest.raises(ValueError, match="3\\*H\\*D"):
        TIF.masked_multihead_attention(torch.zeros((1, 10)), cache)
    with pytest.raises(ValueError, match="cache_kv"):
        TIF.masked_multihead_attention(torch.zeros((1, 48)))
    with pytest.raises(ValueError, match="num_heads"):
        TIF.masked_multihead_attention(torch.zeros((1, 48)), cache,
                                       num_heads=3)


# ---- memory_efficient_attention ----

@pytest.mark.parametrize("bias", [False, True])
def test_memory_efficient_attention_matches_jax(bias):
    b, s, h, d = 2, 6, 4, 8
    q, k, v = (_rand((b, s, h, d), 40 + i) for i in range(3))
    args = (q, k, v) + ((_rand((b, 1, s, s), 43),) if bias else ())
    _both(lambda *a: JIF.memory_efficient_attention(*a, scale=3.0,
                                                    training=False),
          lambda *a: TIF.memory_efficient_attention(*a, scale=3.0,
                                                    training=False),
          args, diff=(0, 1, 2))


def test_memory_efficient_attention_gqa_is_the_flash_route():
    """Without a bias it is ``scaled_dot_product_attention``'s kernel
    route (the plain version here), GQA included."""
    from paddle_tpu_torch.nn import functional as TF
    q, k, v = (torch.from_numpy(_rand(sh, 50 + i)) for i, sh in
               enumerate([(1, 8, 4, 8), (1, 8, 2, 8), (1, 8, 2, 8)]))
    assert torch.equal(TIF.memory_efficient_attention(q, k, v),
                       TF.scaled_dot_product_attention(q, k, v))


# ---- layers ----

@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_fused_feed_forward_matches_jax(act):
    jl = jinc.FusedFeedForward(8, 16, dropout_rate=0.0, activation=act)
    tl = tinc.FusedFeedForward(8, 16, dropout_rate=0.0, activation=act,
                               device="cpu")
    arrays = {n: np.asarray(p._value) for n, p in jl.named_parameters()}
    tl.load_state_dict(layer_state_from_jax(arrays, tl))
    x = _rand((3, 8), 60)
    _close(tl(torch.from_numpy(x)).detach().numpy(),
           np.asarray(jl(paddle.to_tensor(x))._value))


def test_fused_multi_head_attention_matches_jax():
    jl = jinc.FusedMultiHeadAttention(16, 4)
    tl = tinc.FusedMultiHeadAttention(16, 4, device="cpu")
    arrays = {n: np.asarray(p._value) for n, p in jl.named_parameters()}
    tl.load_state_dict(layer_state_from_jax(arrays, tl))
    x = _rand((2, 5, 16), 61)
    _close(tl(torch.from_numpy(x)).detach().numpy(),
           np.asarray(jl(paddle.to_tensor(x))._value))
