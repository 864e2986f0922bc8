"""Beam search of the port held against the JAX package on the CPU, on the
JAX model's weights carried by the weight bridge (float32, a tiny Llama):

- ``nn.functional.gather_tree`` equals the reference's on random trees;
- beam ``generate()`` equals JAX ``generate(num_beams=K)`` token for
  token, without and with an EOS that fires, with and without a length
  penalty, at a ragged ``seq_lens`` and at one new token;
- ``num_beams=1`` is greedy ``generate()``; beam with sampling raises the
  reference's ``ValueError``;
- ``top_k_desc`` orders ties as ``jax.lax.top_k`` does (lower index
  first).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.nn.functional import gather_tree as j_gather_tree
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)
from paddle_tpu_torch.models.generation import top_k_desc
from paddle_tpu_torch.nn.functional import gather_tree

P, C = 6, 24


@pytest.fixture(scope="module")
def bridged():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(31)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    yield jnet, tnet
    torch.set_num_threads(prev)


def _prompts(seed, b=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, tiny_llama_config().vocab_size,
                        (b, P)).astype(np.int32)


def _both(jnet, tnet, ids, **kw):
    """The same generate() call through both packages: (port, JAX)."""
    t = tnet.generate(ids.copy(), max_cache_len=C, compute_dtype="float32",
                      **kw)
    j = np.asarray(jnet.generate(paddle.to_tensor(ids.copy()),
                                 max_cache_len=C, compute_dtype="float32",
                                 **kw)._value)
    assert t.dtype == torch.int32
    return t.numpy(), j


@pytest.mark.parametrize("t,b,k", [(1, 1, 1), (5, 2, 3), (9, 3, 4)])
def test_gather_tree_matches_jax(t, b, k):
    rng = np.random.default_rng(t * 100 + k)
    ids = rng.integers(0, 50, (t, b, k)).astype(np.int32)
    parents = rng.integers(0, k, (t, b, k)).astype(np.int32)
    want = np.asarray(j_gather_tree(paddle.to_tensor(ids.copy()),
                                    paddle.to_tensor(parents.copy()))._value)
    got = gather_tree(torch.from_numpy(ids.copy()),
                      torch.from_numpy(parents.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gather_tree(ids, parents).numpy(), want)


def test_gather_tree_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="gather_tree"):
        gather_tree(np.zeros((2, 1, 3), np.int32), np.zeros((2, 1, 2),
                                                            np.int32))


def test_top_k_desc_breaks_ties_like_lax_top_k():
    x = np.array([[1.0, 3.0, 3.0, -2.0, 3.0, 0.5],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = top_k_desc(torch.from_numpy(x.copy()), 4)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("k,m,penalty,b", [(2, 7, 0.0, 2), (3, 6, 1.0, 2),
                                           (4, 8, 0.6, 3), (3, 1, 1.0, 2),
                                           (3, 5, 0.0, 1)])
def test_beam_generate_matches_jax(bridged, k, m, penalty, b):
    jnet, tnet = bridged
    ids = _prompts(k * 10 + m, b)
    lens = np.array([P, P - 2, P - 1][:b], np.int32)
    t, j = _both(jnet, tnet, ids, seq_lens=lens, max_new_tokens=m,
                 num_beams=k, length_penalty=penalty)
    assert t.shape == (b, m)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("penalty", [0.0, 1.0])
def test_beam_generate_with_eos_matches_jax(bridged, penalty):
    """An EOS taken from the beam output itself, so finished beams (which
    then offer only EOS at zero cost) and the pad after EOS occur."""
    jnet, tnet = bridged
    ids = _prompts(7)
    _t, free = _both(jnet, tnet, ids, max_new_tokens=8, num_beams=3,
                     length_penalty=penalty)
    eos = int(free[0, 2])
    t, j = _both(jnet, tnet, ids, max_new_tokens=8, num_beams=3,
                 length_penalty=penalty, eos_token_id=eos, pad_token_id=255)
    np.testing.assert_array_equal(t, j)
    assert (t == eos).any()


def test_one_beam_is_greedy(bridged):
    _jnet, tnet = bridged
    ids = _prompts(3)
    kw = dict(max_new_tokens=6, max_cache_len=C, compute_dtype="float32")
    np.testing.assert_array_equal(
        tnet.generate(ids, num_beams=1, **kw).numpy(),
        tnet.generate(ids, **kw).numpy())


def test_beam_with_sampling_raises(bridged):
    _jnet, tnet = bridged
    with pytest.raises(ValueError, match="beam"):
        tnet.generate(_prompts(1), num_beams=2, do_sample=True)
    with pytest.raises(ValueError, match="num_beams"):
        tnet.generate(_prompts(1), num_beams=0)
