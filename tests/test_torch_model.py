"""The port's Llama held against the JAX package's on the same weights,
carried over by the weight bridge: the bridge round-trips every tensor,
and chunked prefill plus paged decode steps give the same logits and
the same arenas (float32, ``atol 1e-4``: both sides sum in float32 in
different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.models.generation import init_paged_kv_arena as j_arena
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)
from paddle_tpu_torch.models.convert import LINEAR_NAMES
from paddle_tpu_torch.models.generation import init_paged_kv_arena as t_arena


@pytest.fixture(scope="module")
def pair():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(2024)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays), strict=True)
    yield jnet, tnet, arrays
    torch.set_num_threads(prev)


def test_bridge_round_trips_every_tensor(pair):
    _jnet, tnet, arrays = pair
    state = tnet.state_dict()
    assert set(state) == set(arrays)
    n_linear = 0
    for name, arr in arrays.items():
        got = state[name].numpy()
        if name.split(".")[-2] in LINEAR_NAMES:
            n_linear += 1
            assert got.shape == arr.shape[::-1], name     # [out, in]
            got = got.T
        np.testing.assert_array_equal(got, arr, err_msg=name)
    cfg = tiny_llama_config()
    assert n_linear == 7 * cfg.num_hidden_layers + 1


def test_chunk_prefill_then_paged_decode_matches_jax(pair):
    jnet, tnet, _ = pair
    cfg = tiny_llama_config()
    nl, hkv, d = cfg.num_hidden_layers, cfg.num_key_value_heads, \
        cfg.head_dim
    blk_len, nb, mb, c, n = 4, 8, 4, 4, 6
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (2 * c,)).astype(np.int32)
    prompt[n:] = 0
    row = np.asarray([[5, 2, 6, nb]], np.int32)      # trash-padded table
    jkv = [(k, v, jnp.asarray(row))
           for k, v in j_arena(nl, nb, blk_len, hkv, d, jnp.float32)]
    tkv = [(k, v, torch.from_numpy(row))
           for k, v in t_arena(nl, nb, blk_len, hkv, d, torch.float32,
                               "cpu")]
    with torch.no_grad():
        for start in (0, c):                      # two chunks, n_valid=6
            ids = prompt[None, start:start + c]
            jl, jkv = jnet.prefill_chunk(jnp.asarray(ids),
                                         jnp.asarray(start, jnp.int32),
                                         jnp.asarray(n, jnp.int32), jkv)
            tl, tkv = tnet.prefill_chunk(torch.from_numpy(ids), start, n,
                                         tkv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        # decode: row 0 continues the prompt, row 1 is a vacant slot
        # (all-trash table, frozen lens 0)
        tables = np.stack([row[0], np.full((mb,), nb, np.int32)])
        jkv = [(k, v, jnp.asarray(tables)) for k, v, _ in jkv]
        tkv = [(k, v, torch.from_numpy(tables)) for k, v, _ in tkv]
        tok = np.asarray([int(np.argmax(np.asarray(jl)[0])), 0], np.int32)
        lens = np.asarray([n, 0], np.int32)
        for _ in range(3):
            jl, jkv = jnet.decode_step(jnp.asarray(tok), jnp.asarray(lens),
                                       jkv)
            tl, tkv = tnet.decode_step(torch.from_numpy(tok),
                                       torch.from_numpy(lens), tkv)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4, rtol=0)
            tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
            lens = lens + np.asarray([1, 0], np.int32)
    for (jk, jv, _), (tk, tv, _) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4,
                                   rtol=0)
