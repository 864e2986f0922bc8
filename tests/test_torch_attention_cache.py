"""``LlamaAttention.forward(cache=)`` of the port held against the
reference on the CPU (float32, a tiny Llama's first attention on the JAX
model's weights, carried by the weight bridge): past K/V concatenated in
front of the new tokens' (post-RoPE, at the given ``position_ids``), the
causal mask of ``S_q`` queries over ``S_k`` keys bottom-right aligned.
The output within ``atol 1e-5`` and the returned cache within ``atol
1e-6`` of the reference's, for one new token, several, and the whole
sequence again with an empty past; without ``cache`` the call returns the
output alone, as before."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)

ATOL_OUT, ATOL_KV = 1e-5, 1e-6


@pytest.fixture(scope="module")
def bridged():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(5)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    yield jnet, tnet
    torch.set_num_threads(prev)


@pytest.mark.parametrize("past,new", [(5, 1), (4, 3), (0, 6)])
def test_attention_cache_matches_reference(bridged, past, new):
    jnet, tnet = bridged
    cfg = tiny_llama_config()
    hkv, d = cfg.num_key_value_heads, cfg.head_dim
    rng = np.random.default_rng(past * 10 + new)
    b = 2
    x = rng.standard_normal((b, new, cfg.hidden_size)).astype(np.float32)
    pk = rng.standard_normal((b, past, hkv, d)).astype(np.float32)
    pv = rng.standard_normal((b, past, hkv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(past, past + new, dtype=np.int32),
                          (b, new)).copy()
    jout, (jk, jv) = jnet.llama.layers[0].self_attn(
        paddle.to_tensor(x.copy()), paddle.to_tensor(pos.copy()),
        cache=(paddle.to_tensor(pk.copy()), paddle.to_tensor(pv.copy())))
    with torch.no_grad():
        tout, (tk, tv) = tnet.llama.layers[0].self_attn(
            torch.from_numpy(x.copy()), torch.from_numpy(pos.copy()),
            cache=(torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())))
    assert tout.shape == (b, new, cfg.hidden_size)
    assert tk.shape == tv.shape == (b, past + new, hkv, d)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout._value),
                               atol=ATOL_OUT, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk._value),
                               atol=ATOL_KV, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv._value),
                               atol=ATOL_KV, rtol=0)


def test_attention_cache_extends_prefill(bridged):
    """The cached step equals the last row of the whole-sequence forward:
    a prefill's K/V as the past, then the next token with cache=."""
    _jnet, tnet = bridged
    cfg = tiny_llama_config()
    attn = tnet.llama.layers[0].self_attn
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (1, 6, cfg.hidden_size)).astype(np.float32))
    with torch.no_grad():
        whole = attn(x)
        _, (k, v) = attn.prefill(x[:, :5])
        step, cache = attn(x[:, 5:], torch.tensor([[5]]), cache=(k, v))
    assert cache[0].shape[1] == 6
    np.testing.assert_allclose(step[:, 0].numpy(), whole[:, 5].numpy(),
                               atol=ATOL_OUT, rtol=0)
