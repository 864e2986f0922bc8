"""The port's input and attention functionals held against the JAX
package's on the CPU, on the same numpy inputs:

- ``embedding`` for ids in ``[-2V, 2V)``: an id in ``[-V, -1]`` wraps,
  any other out-of-range id gives a NaN row (``jnp.take``'s fill mode),
  with and without ``padding_idx`` (a literal ``x == padding_idx``), and
  ``nn.Embedding`` over it; in-range lookups bit-equal to a plain gather,
  gradients of in-range rows equal, padded rows' gradients zero;
- ``one_hot``: float32, a zero row outside ``[0, num_classes)``;
- ``flash_attn_unpadded`` (a length-0 and a length-1 sequence among the
  packed ones, causal or not, GQA, ``scale``) with input gradients;
- ``sparse_attention`` against the reference's dense-masked formula and
  the JAX function, with both masks, slots past ``offset[..., -1]`` and a
  fully masked row, with input gradients; ``sdp_kernel``.

Tolerance: float32 values and gradients within ``1e-5`` of the
reference's largest entry (``max(1, |ref|)``); lookups bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

REL = 1e-5


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, (what, err, tol)


# ---- embedding ----

@pytest.mark.parametrize("padding_idx", [None, 2, -1, 11])
@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_embedding_out_of_range_ids_match_jax(padding_idx, dtype):
    """Ids over [-2V, 2V): the parent's port raised ``IndexError`` here
    (and asserted on the card); the reference wraps [-V, -1] and gives NaN
    rows elsewhere."""
    v = 5
    w = _rand((v, 3), 1)
    ids = np.arange(-2 * v, 2 * v).reshape(4, -1).astype(dtype)
    want = np.asarray(JF.embedding(paddle.to_tensor(ids),
                                   paddle.to_tensor(w),
                                   padding_idx=padding_idx)._value)
    got = TF.embedding(torch.from_numpy(ids), torch.from_numpy(w),
                       padding_idx=padding_idx).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any()


def test_embedding_in_range_bit_equal_to_a_gather_and_gradients():
    v = 7
    w = _rand((v, 4), 2)
    ids = np.array([[0, 3, 6, 3], [1, 2, 2, 5]])
    tw = torch.tensor(w, requires_grad=True)
    out = TF.embedding(torch.from_numpy(ids), tw, padding_idx=2)
    plain = torch.nn.functional.embedding(torch.from_numpy(ids),
                                          torch.from_numpy(w))
    keep = torch.from_numpy(ids != 2)[..., None]
    assert torch.equal(out, torch.where(keep, plain, 0.0))
    g = _rand(out.shape, 3)
    (out * torch.from_numpy(g)).sum().backward()

    def jf(wa):
        return JF.embedding(JTensor(jnp.asarray(ids)), JTensor(wa),
                            padding_idx=2)._value

    _, vjp = jax.vjp(jf, jnp.asarray(w))
    (wg,) = vjp(jnp.asarray(g))
    _close(tw.grad.numpy(), wg, what="weight grad")
    assert float(tw.grad[2].abs().max()) == 0.0


def test_embedding_layer_uses_the_reference_lookup():
    layer = tnn.Embedding(4, 2, padding_idx=0, device="cpu")
    out = layer(torch.tensor([3, -1, 5, 0])).detach()
    w = layer.weight.detach()
    assert torch.equal(out[0], w[3]) and torch.equal(out[1], w[3])
    assert torch.isnan(out[2]).all()
    assert float(out[3].abs().max()) == 0.0


def test_embedding_keeps_the_positional_models_call():
    w = torch.from_numpy(_rand((6, 2)))
    ids = torch.tensor([[1, 5]])
    assert torch.equal(TF.embedding(ids, w), w[ids])


# ---- one_hot ----

@pytest.mark.parametrize("num_classes", [1, 4, 9])
def test_one_hot_matches_jax(num_classes):
    ids = np.array([[0, 3, 5], [-1, 8, 2]])
    want = np.asarray(paddle.nn.functional.one_hot(
        paddle.to_tensor(ids), num_classes)._value)
    got = TF.one_hot(torch.from_numpy(ids), num_classes)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---- flash_attn_unpadded ----

def _varlen_inputs(lens, hq, hkv, d, seed):
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    tot = int(cu[-1])
    return (_rand((tot, hq, d), seed), _rand((tot, hkv, d), seed + 1),
            _rand((tot, hkv, d), seed + 2), cu)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lens,hq,hkv,scale", [
    ((5, 3, 0, 1), 2, 2, 0.3),
    ((0, 6, 2), 4, 2, None),
    ((4, 4), 2, 1, 0.5),
])
def test_flash_attn_unpadded_matches_jax(causal, lens, hq, hkv, scale):
    d = 8
    q, k, v, cu = _varlen_inputs(lens, hq, hkv, d, 11)
    mx = max(lens)
    sc = scale if scale is not None else 1.0 / np.sqrt(d)

    def jf(qa, ka, va):
        return JF.flash_attn_unpadded(
            JTensor(qa), JTensor(ka), JTensor(va), JTensor(jnp.asarray(cu)),
            JTensor(jnp.asarray(cu)), mx, mx, sc, causal=causal)._value

    want, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    g = _rand(want.shape, 5)
    wgrads = vjp(jnp.asarray(g))
    tin = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = TF.flash_attn_unpadded(*tin, torch.from_numpy(cu),
                                 torch.from_numpy(cu), mx, mx, sc,
                                 causal=causal)
    _close(got.detach().numpy(), want, what="value")
    (got * torch.from_numpy(g)).sum().backward()
    for t, wg, name in zip(tin, wgrads, "qkv"):
        _close(t.grad.numpy(), wg, what=f"d{name}")


def test_flash_attn_unpadded_rows_equal_each_sequence_alone():
    """Packed q and k alike and causal: each sequence's rows are its own
    causal attention; a length-0 sequence adds no row."""
    lens, h, d = (6, 0, 3, 1), 2, 8
    q, k, v, cu = _varlen_inputs(lens, h, h, d, 3)
    out = TF.flash_attn_unpadded(*map(torch.from_numpy, (q, k, v, cu, cu)),
                                 6, 6, 1.0 / np.sqrt(d), causal=True)
    assert out.shape == q.shape
    for i, n in enumerate(lens):
        s, e = int(cu[i]), int(cu[i + 1])
        if n == 0:
            continue
        alone = TF.scaled_dot_product_attention(
            *[torch.from_numpy(a[s:e])[None] for a in (q, k, v)],
            is_causal=True)[0]
        _close(out[s:e].numpy(), alone.numpy(), what=f"sequence {i}")


# ---- sparse_attention ----

def _csr(mask):
    b, h, s, _ = mask.shape
    nnz = int(mask.sum(axis=(2, 3)).max())
    offset = np.zeros((b, h, s + 1), np.int32)
    cols = np.zeros((b, h, nnz), np.int32)
    for bi in range(b):
        for hi in range(h):
            rr, cc = np.nonzero(mask[bi, hi])
            offset[bi, hi, 1:] = np.cumsum(np.bincount(rr, minlength=s))
            cols[bi, hi, :len(cc)] = cc
    return offset, cols


def _dense_ref(q, k, v, mask):
    d = q.shape[-1]
    scores = np.einsum("bhsd,bhtd->bhst", q, k) / np.sqrt(d)
    scores = np.where(mask, scores, -1e30)
    e = np.exp(scores - scores.max(-1, keepdims=True))
    p = np.where(mask, e / e.sum(-1, keepdims=True), 0.0)
    return np.einsum("bhst,bhtd->bhsd", p, v)


@pytest.mark.parametrize("ragged", [False, True])
def test_sparse_attention_matches_dense_masked_and_jax(ragged):
    """A fixed-nnz pattern, and (ragged) one whose (b, h) pairs store
    fewer slots than nnz, so slots past offset[..., -1] must be dropped."""
    rng = np.random.default_rng(0)
    b, h, s, d = 2, 3, 8, 16
    q, k, v = (_rand((b, h, s, d), i) for i in range(3))
    mask = np.zeros((b, h, s, s), bool)
    for bi in range(b):
        for hi in range(h):
            for r in range(s):
                n = 1 + (r + hi) % 3 if ragged else 3
                mask[bi, hi, r, rng.choice(s, n, replace=False)] = True
    offset, cols = _csr(mask)
    got = TF.sparse_attention(*map(torch.from_numpy,
                                   (q, k, v, offset, cols))).numpy()
    want = np.asarray(JF.sparse_attention(
        *[paddle.to_tensor(a) for a in (q, k, v, offset, cols)])._value)
    _close(got, want, what="vs jax")
    _close(got, _dense_ref(q, k, v, mask), rel=2e-5, what="vs dense")


def test_sparse_attention_masks_fully_masked_rows_and_grads():
    b, h, s, d = 1, 2, 6, 8
    q, k, v = (_rand((b, h, s, d), 10 + i) for i in range(3))
    offset = np.tile(np.arange(0, s * s + 1, s, dtype=np.int32), (b, h, 1))
    cols = np.tile(np.tile(np.arange(s, dtype=np.int32), s), (b, h, 1))
    kp = np.ones((b, s), np.float32)
    kp[0, -2:] = 0.0
    am = np.tril(np.ones((s, s), np.float32))
    am[1] = 0.0                                   # row 1 fully masked

    def jf(qa, ka, va):
        return JF.sparse_attention(
            JTensor(qa), JTensor(ka), JTensor(va),
            JTensor(jnp.asarray(offset)), JTensor(jnp.asarray(cols)),
            key_padding_mask=paddle.to_tensor(kp),
            attn_mask=paddle.to_tensor(am))._value

    want, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    g = _rand(want.shape, 4)
    wgrads = vjp(jnp.asarray(g))
    tin = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = TF.sparse_attention(*tin, torch.from_numpy(offset),
                              torch.from_numpy(cols),
                              key_padding_mask=torch.from_numpy(kp),
                              attn_mask=torch.from_numpy(am))
    _close(got.detach().numpy(), want, what="value")
    assert float(got[:, :, 1].abs().max()) == 0.0
    (got * torch.from_numpy(g)).sum().backward()
    for t, wg, name in zip(tin, wgrads, "qkv"):
        _close(t.grad.numpy(), wg, what=f"d{name}")


def test_sdp_kernel_selects_nothing():
    q = torch.from_numpy(_rand((1, 4, 2, 8)))
    want = TF.scaled_dot_product_attention(q, q, q, is_causal=True)
    with TF.sdp_kernel(enable_flash=False, enable_math=True) as ctx:
        got = TF.scaled_dot_product_attention(q, q, q, is_causal=True)
    assert ctx.enable_flash is False and torch.equal(got, want)
