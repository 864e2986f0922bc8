"""The port's GPT held against the JAX package's on the CPU, module by
module, on the JAX model's weights carried by the weight bridge.

Tolerances, each with its reason:
- ``layer_norm``/``LayerNorm``: the reference's formula (float32
  throughout, one rounding at the end), but the row's float32 mean and
  variance are sums in another order (XLA's CPU reduction order is not
  torch's), so their last bits differ, and ``rsqrt`` carries that on:
  float32 within 8 ulps of ``max(|out|, 1)`` (about 3 seen); bfloat16
  within one bf16 ulp of the output (the float32 difference can move
  the one rounding);
- ``gelu`` (erfc form and tanh approximation) and ``tanh`` in float32:
  ``rtol 1e-6, atol 1e-6`` (XLA's and torch's ``erfc``/``tanh`` are
  different polynomial approximations, about 2e-6 apart relative to the
  value near the tails; ``relu`` is bit-equal);
- every attention form, a decoder layer, the model's logits and the
  pretraining loss in float32: ``atol 1e-5`` (both sides sum in float32
  in different orders);
- ``generate()`` greedy, sampled (the threefry stream) and beam:
  token-equal on this model (every position's top-2 margin is far above
  the logit error; the seeds are not chosen);
- ``recompute=True``: losses and gradients equal to the plain forward's
  bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.models.generation import init_kv_cache as j_cache
from paddle_tpu.models.generation import init_paged_kv_arena as j_arena
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion,
                                     gpt_state_from_jax, tiny_gpt_config)
from paddle_tpu_torch.models.convert import LINEAR_NAMES_BY_FAMILY
from paddle_tpu_torch.models.generation import init_kv_cache as t_cache
from paddle_tpu_torch.models.generation import init_paged_kv_arena as t_arena
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as TF

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bridge(seed=11, **kw):
    paddle.seed(seed)
    jnet = jmodels.GPTForCausalLM(jmodels.tiny_gpt_config(**kw))
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = GPTForCausalLM(tiny_gpt_config(**kw), device="cpu", init=False)
    tnet.load_state_dict(gpt_state_from_jax(arrays), strict=True)
    return jnet, tnet, arrays


@pytest.fixture(scope="module")
def pair():
    return _bridge()


def _np(t):
    return np.asarray(getattr(t, "_value", t))


def test_bridge_round_trips_every_tensor(pair):
    _jnet, tnet, arrays = pair
    state = tnet.state_dict()
    assert set(state) == set(arrays)
    n_linear = 0
    for name, arr in arrays.items():
        got = state[name].numpy()
        if name.split(".")[-2] in LINEAR_NAMES_BY_FAMILY["gpt"] and \
                name.endswith(".weight"):
            n_linear += 1
            assert got.shape == arr.shape[::-1], name
            got = got.T
        np.testing.assert_array_equal(got, arr, err_msg=name)
    assert n_linear == 4 * tiny_gpt_config().num_hidden_layers + 1
    # the fused projection splits as [b, s, 3, H, D] on both sides
    assert state["gpt.h.0.attn.qkv_proj.weight"].shape == (3 * 64, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((4, 7, 96)) + 0.5).astype(np.float32)
    w = rng.standard_normal((96,)).astype(np.float32)
    b = rng.standard_normal((96,)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(JF.layer_norm(JTensor(jnp.asarray(x, jdt)), 96,
                                    JTensor(jnp.asarray(w)),
                                    JTensor(jnp.asarray(b)),
                                    1e-5)._value).astype(np.float32)
    tx = torch.from_numpy(x.copy()).to(getattr(torch, dtype))
    got = TF.layer_norm(tx, 96, torch.from_numpy(w.copy()),
                        torch.from_numpy(b.copy()), 1e-5)
    assert got.dtype == tx.dtype
    ln = LayerNorm(96, 1e-5, device="cpu")
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
    assert torch.equal(ln(tx), got)
    got = got.float().numpy()
    if dtype == "float32":
        tol = 8 * 2.0 ** -23 * np.maximum(np.abs(want), 1.0)
        assert (np.abs(got - want) <= tol).all()
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_relu_tanh_match_jax(approximate):
    rng = np.random.default_rng(2)
    x = (4 * rng.standard_normal((1000,))).astype(np.float32)
    want = np.asarray(JF.gelu(JTensor(jnp.asarray(x)),
                              approximate=approximate)._value)
    got = TF.gelu(torch.from_numpy(x.copy()), approximate=approximate)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        TF.relu(torch.from_numpy(x.copy())).numpy(),
        np.asarray(JF.relu(JTensor(jnp.asarray(x)))._value))
    np.testing.assert_allclose(
        TF.tanh(torch.from_numpy(x.copy())).numpy(),
        np.asarray(JF.tanh(JTensor(jnp.asarray(x)))._value), rtol=1e-6,
        atol=1e-6)


def _x(rng, b, s, h=64):
    return rng.standard_normal((b, s, h)).astype(np.float32)


def test_attention_forward_prefill_and_layer_match_jax(pair):
    jnet, tnet, _ = pair
    rng = np.random.default_rng(3)
    x = _x(rng, 2, 9)
    ja, ta = jnet.gpt.h[0].attn, tnet.gpt.h[0].attn
    with torch.no_grad():
        np.testing.assert_allclose(ta(torch.from_numpy(x)).numpy(),
                                   _np(ja(JTensor(jnp.asarray(x)))),
                                   atol=ATOL, rtol=0)
        mask = np.where(rng.random((2, 1, 9, 9)) < 0.8, 0.0,
                        -1e4).astype(np.float32)
        np.testing.assert_allclose(
            ta(torch.from_numpy(x), torch.from_numpy(mask)).numpy(),
            _np(ja(JTensor(jnp.asarray(x)), JTensor(jnp.asarray(mask)))),
            atol=ATOL, rtol=0)
        tout, (tk, tv) = ta.prefill(torch.from_numpy(x))
        jout, (jk, jv) = ja.prefill(JTensor(jnp.asarray(x)))
        for t, j in ((tout, jout), (tk, jk), (tv, jv)):
            np.testing.assert_allclose(t.numpy(), _np(j), atol=ATOL, rtol=0)
        np.testing.assert_allclose(
            tnet.gpt.h[1](torch.from_numpy(x)).numpy(),
            _np(jnet.gpt.h[1](JTensor(jnp.asarray(x)))), atol=ATOL, rtol=0)


@pytest.mark.parametrize("form", ["dense", "paged", "paged_int8"])
def test_attention_decode_step_matches_jax(pair, form):
    """Three decode steps of one attention layer over the cache form: the
    dense (k, v) pair of ``generate()``, the paged triple and the int8
    5-tuple, row 1 a vacant slot in the paged forms (all-trash table)."""
    jnet, tnet, _ = pair
    cfg = tiny_gpt_config()
    h, d = cfg.num_attention_heads, cfg.head_dim
    ja, ta = jnet.gpt.h[0].attn, tnet.gpt.h[0].attn
    rng = np.random.default_rng(4)
    nb, blk, mb = 6, 4, 3
    lens = np.asarray([5, 0], np.int32)
    if form == "dense":
        (jk, jv), = j_cache(1, 2, 12, h, d, jnp.float32)
        (tk, tv), = t_cache(1, 2, 12, h, d, torch.float32, "cpu")
        jkv, tkv = (jk, jv), (tk, tv)
        lens = np.asarray([5, 2], np.int32)
    else:
        tables = np.asarray([[4, 1, 2], [nb] * mb], np.int32)
        jdt, tdt = (jnp.int8, torch.int8) if form == "paged_int8" else \
            (jnp.float32, torch.float32)
        jkv = tuple(j_arena(1, nb, blk, h, d, jdt)[0]) + (
            jnp.asarray(tables),)
        tkv = tuple(t_arena(1, nb, blk, h, d, tdt, "cpu")[0]) + (
            torch.from_numpy(tables),)
    with torch.no_grad():
        for step in range(3):
            x = _x(rng, 2, 1)
            jout, jkv = ja.decode_step(JTensor(jnp.asarray(x)), jkv,
                                       jnp.asarray(lens))
            tout, tkv = ta.decode_step(torch.from_numpy(x), tkv,
                                       torch.from_numpy(lens))
            rows = 2 if form == "dense" else 1
            np.testing.assert_allclose(tout.numpy()[:rows],
                                       _np(jout)[:rows], atol=ATOL, rtol=0)
            lens = lens + np.asarray([1, 1 if form == "dense" else 0],
                                     np.int32)
    for t, j in zip(tkv[:-1] if form != "dense" else tkv,
                    jkv[:-1] if form != "dense" else jkv):
        got, want = t.numpy().astype(np.float32), _np(j).astype(np.float32)
        if form != "dense":
            got, want = got[:nb], want[:nb]       # the trash row left out
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _paged(nl, h, d, nb, blk, row, int8):
    jdt, tdt = (jnp.int8, torch.int8) if int8 else (jnp.float32,
                                                    torch.float32)
    jkv = [tuple(e) + (jnp.asarray(row),)
           for e in j_arena(nl, nb, blk, h, d, jdt)]
    tkv = [tuple(e) + (torch.from_numpy(row),)
           for e in t_arena(nl, nb, blk, h, d, tdt, "cpu")]
    return jkv, tkv


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8kv"])
def test_chunk_prefill_verify_and_decode_match_jax(pair, int8):
    """Two prefill chunks of a 6-token prompt (the second's pad tail at
    positions past the prompt), one C=4 verify of row 0 beside a row
    outside spec mode, then a decode step: the model-level hooks over
    the paged cache, logits and arenas within ``atol 1e-5``."""
    jnet, tnet, _ = pair
    cfg = tiny_gpt_config()
    nl, h, d = tnet.kv_cache_spec()
    nb, blk, mb, c, n = 8, 4, 4, 4, 6
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (2 * c,)).astype(np.int32)
    prompt[n:] = 0
    row = np.asarray([[5, 2, 6, nb]], np.int32)
    jkv, tkv = _paged(nl, h, d, nb, blk, row, int8)
    with torch.no_grad():
        for start in (0, c):
            ids = prompt[None, start:start + c]
            jl, jkv = jnet.prefill_chunk(jnp.asarray(ids),
                                         jnp.asarray(start, jnp.int32),
                                         jnp.asarray(n, jnp.int32), jkv)
            tl, tkv = tnet.prefill_chunk(torch.from_numpy(ids), start, n,
                                         tkv)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL, rtol=0)
        tables = np.stack([row[0], np.full((mb,), nb, np.int32)])
        jkv = [tuple(e[:-1]) + (jnp.asarray(tables),) for e in jkv]
        tkv = [tuple(e[:-1]) + (torch.from_numpy(tables),) for e in tkv]
        toks = np.stack([rng.integers(0, cfg.vocab_size, (4,)),
                         np.zeros((4,))]).astype(np.int32)
        lens = np.asarray([n, 3], np.int32)
        n_valid = np.asarray([3, 0], np.int32)
        jl, jkv = jnet.verify_step(jnp.asarray(toks), jnp.asarray(lens),
                                   jnp.asarray(n_valid), jkv)
        tl, tkv = tnet.verify_step(torch.from_numpy(toks),
                                   torch.from_numpy(lens),
                                   torch.from_numpy(n_valid), tkv)
        assert tl.shape == (2, 4, cfg.vocab_size)
        np.testing.assert_allclose(tl[0, :3].numpy(), _np(jl)[0, :3],
                                   atol=ATOL, rtol=0)
        tok = np.asarray([toks[0, 2], 0], np.int32)
        lens = np.asarray([n + 3, 0], np.int32)
        jl, jkv = jnet.decode_step(jnp.asarray(tok), jnp.asarray(lens), jkv)
        tl, tkv = tnet.decode_step(torch.from_numpy(tok),
                                   torch.from_numpy(lens), tkv)
        np.testing.assert_allclose(tl[0].numpy(), _np(jl)[0], atol=ATOL,
                                   rtol=0)
    for te, je in zip(tkv, jkv):
        for ta, ja in zip(te[:-1], je[:-1]):
            np.testing.assert_allclose(
                ta.numpy()[:nb].astype(np.float32),
                _np(ja)[:nb].astype(np.float32), atol=ATOL, rtol=0)


def test_decode_clamps_positions_past_the_table(pair):
    """An idle slot's ``lens`` past the position table decodes (its
    position clamped at the edge) instead of gathering out of the
    table; the live row's logits are unchanged by it."""
    _jnet, tnet, _ = pair
    cfg = tiny_gpt_config()
    nl, h, d = tnet.kv_cache_spec()
    _, tkv = _paged(nl, h, d, 4, 4, np.asarray([[0, 1], [4, 4]], np.int32),
                    False)
    tok = torch.tensor([3, 0], dtype=torch.int32)
    with torch.no_grad():
        far, _ = tnet.decode_step(tok, torch.tensor(
            [2, cfg.max_position_embeddings + 5], dtype=torch.int32), tkv)
        _, tkv2 = _paged(nl, h, d, 4, 4,
                         np.asarray([[0, 1], [4, 4]], np.int32), False)
        near, _ = tnet.decode_step(tok, torch.tensor(
            [2, 0], dtype=torch.int32), tkv2)
    assert torch.isfinite(far).all()
    assert torch.equal(far[0], near[0])


def test_model_logits_and_criterion_match_jax(pair):
    jnet, tnet, _ = pair
    rng = np.random.default_rng(6)
    vocab = tiny_gpt_config().vocab_size
    ids = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    labels[1, :3] = -100
    jlogits = jnet(paddle.to_tensor(ids))
    want = jmodels.GPTPretrainingCriterion(jnet.config)(
        jlogits, paddle.to_tensor(labels))
    with torch.no_grad():
        loss, logits = tnet(torch.from_numpy(ids),
                            labels=torch.from_numpy(labels))
        crit = GPTPretrainingCriterion(tnet.config)(
            logits, torch.from_numpy(labels))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(loss), float(want), atol=ATOL, rtol=0)
    assert float(crit) == float(loss)


GEN = {"greedy": {}, "sampled": dict(do_sample=True, temperature=0.8,
                                     top_k=40, top_p=0.9, seed=7),
       "beam": dict(num_beams=3, length_penalty=1.0)}


@pytest.mark.parametrize("mode", list(GEN))
def test_generate_matches_jax(pair, mode):
    jnet, tnet, _ = pair
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 256, (3, 7)).astype(np.int32)
    lens = np.asarray([7, 4, 6], np.int32)
    kw = dict(max_new_tokens=8, compute_dtype="float32", **GEN[mode])
    want = _np(jnet.generate(paddle.to_tensor(ids.copy()),
                             seq_lens=lens.copy(), **kw))
    got = tnet.generate(ids.copy(), seq_lens=lens.copy(), **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_position_limit_raises_like_jax(pair):
    jnet, tnet, _ = pair
    limit = tiny_gpt_config().max_position_embeddings
    ids = np.zeros((1, 8), np.int32)
    for m in (limit - 8 + 2, limit):
        with pytest.raises(ValueError) as jerr:
            jnet.generate(paddle.to_tensor(ids), max_new_tokens=m)
        with pytest.raises(ValueError) as terr:
            tnet.generate(ids, max_new_tokens=m)
        assert str(terr.value) == str(jerr.value)
    # the last position that fits runs
    out = tnet.generate(ids, max_new_tokens=limit - 8 + 1,
                        compute_dtype="float32")
    assert out.shape == (1, limit - 8 + 1)


def test_tensor_parallel_names_its_queue_item():
    with pytest.raises(NotImplementedError, match="#14 Distributed"):
        GPTConfig(tensor_parallel=True)


def test_recompute_gives_equal_losses_and_gradients(pair):
    """Without dropout a recomputed layer is the same computation (with
    dropout each recomputed segment draws its masks from its own key,
    on both packages, so the masks and the loss differ)."""
    _jnet, _tnet, arrays = pair
    rng = np.random.default_rng(9)
    ids = torch.from_numpy(rng.integers(0, 256, (2, 12)).astype(np.int32))
    grads, losses = [], []
    for recompute in (False, True):
        net = GPTForCausalLM(tiny_gpt_config(
            recompute=recompute, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0), device="cpu", init=False)
        net.load_state_dict(gpt_state_from_jax(arrays))
        net.train()
        loss, _ = net(ids, labels=ids.long())
        losses.append(loss.detach())
        grads.append(torch.autograd.grad(loss, list(net.parameters())))
    assert torch.equal(losses[0], losses[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
