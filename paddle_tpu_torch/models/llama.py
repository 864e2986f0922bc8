"""Llama: port of the serving and training surfaces of
``paddle_tpu/models/llama.py``.

What is here: ``LlamaConfig`` (the fields serving and training read),
``llama_3_8b_config``/``tiny_llama_config``, ``LlamaForCausalLM`` and
``LlamaPretrainingCriterion``.

- Serving: ``kv_cache_spec`` (:485), ``decode_step`` (:514) and
  ``prefill_chunk`` (:528) over the PAGED kv triple
  ``(k_arena, v_arena, block_tables)`` only, on top of the layer-level
  ``decode_step`` (:187) and ``chunk_step`` (:233).  K/V are written into
  the arenas IN PLACE (``index_put_``), which takes the place of JAX's
  buffer donation: the caller's arena tensors are the updated arenas.
- Training: the ``forward`` of every layer (:159-176, :332-345, :363-374,
  :416-420, :438-457) without a kv cache, with full recompute of each
  decoder layer when ``config.recompute`` and the model is in
  ``.train()``, and the unshifted criterion (:570-589).

Module and parameter names match the JAX model's ``named_parameters()``
so the weight bridge (``models/convert.py``) is a rename-free mapping.
The projections and ``lm_head`` are ``nn.Linear`` (a library GEMM, as
the JAX package leaves them to XLA); RMSNorm, RoPE (without position
ids), causal attention and paged decode attention run the port's CUDA
kernels on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device, to_dtype
from ..distributed.utils import recompute
from ..nn.functional import (cross_entropy, llama_rope,
                             scaled_dot_product_attention, swiglu)
from ..nn.norm import RMSNorm
from ..ops.decode_attention import (decode_attention_paged,
                                    paged_prefix_attention)
from .generation import paged_cache_scatter, paged_chunk_scatter

PagedKV = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    tensor_parallel: bool = False
    recompute: bool = False
    # None = full recompute of each decoder layer; the JAX package's
    # named save policies are not ported
    recompute_policy: Optional[str] = None
    fused_linear_loss: bool = False

    def __post_init__(self):
        unported = {"tie_word_embeddings": self.tie_word_embeddings,
                    "tensor_parallel": self.tensor_parallel,
                    "recompute_policy": self.recompute_policy is not None,
                    "fused_linear_loss": self.fused_linear_loss}
        for name, on in unported.items():
            if on:
                item = ("distributed" if name == "tensor_parallel"
                        else "training")
                raise NotImplementedError(
                    f"LlamaConfig({name}={getattr(self, name)!r}) is not "
                    f"ported (ROADMAP.md, Queue 1: {item})")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def llama_3_8b_config(**kw):
    return LlamaConfig(vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_hidden_layers=32,
                       num_attention_heads=32, num_key_value_heads=8,
                       rope_theta=500000.0, **kw)


def tiny_llama_config(**kw):
    return LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=128,
                       **kw)


def _linear(i, o, factory):
    return nn.Linear(i, o, bias=False, **factory)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, factory):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.head_dim = config.head_dim
        kv_out = config.num_key_value_heads * self.head_dim
        self.q_proj = _linear(h, h, factory)
        self.k_proj = _linear(h, kv_out, factory)
        self.v_proj = _linear(h, kv_out, factory)
        self.o_proj = _linear(h, h, factory)

    def _qkv_rope(self, x, position_ids):
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, -1, self.head_dim)
        k = self.k_proj(x).reshape(b, s, -1, self.head_dim)
        v = self.v_proj(x).reshape(b, s, -1, self.head_dim)
        q, k = llama_rope(q, k, rotary_emb_base=self.config.rope_theta,
                          position_ids=position_ids)
        return q, k, v

    def forward(self, x, position_ids=None, attention_mask=None,
                cache=None):
        """Training/full-sequence attention: causal flash attention
        without a mask (the kernels on the card), the masked math with
        one.  The dense kv-cache form is not ported."""
        if cache is not None:
            raise NotImplementedError(
                "LlamaAttention.forward with a dense kv cache is not ported "
                "(ROADMAP.md, Queue 1: LLMPredictor and the dense generate "
                "programs)")
        b, s, _ = x.shape
        q, k, v = self._qkv_rope(x, position_ids)
        out = scaled_dot_product_attention(q, k, v, attn_mask=attention_mask,
                                           is_causal=attention_mask is None)
        return self.o_proj(out.reshape(b, s, -1))

    def decode_step(self, x, kv: PagedKV, lens):
        """One cached decode step.  x: [B, 1, hidden]; kv: the paged
        triple; lens: [B] int32 write slot = last valid index after the
        write.  Returns (out [B, 1, hidden], kv)."""
        q, k, v = self._qkv_rope(x, lens[:, None])
        k_arena, v_arena, tables = kv
        paged_cache_scatter(k_arena, tables, lens, k[:, 0])
        paged_cache_scatter(v_arena, tables, lens, v[:, 0])
        out = decode_attention_paged(q[:, 0].contiguous(), k_arena, v_arena,
                                     tables, lens)
        return self.o_proj(out[:, None, :]), kv

    def chunk_step(self, x, kv: PagedKV, start: int, n_valid: int):
        """One chunked-prefill step of ONE sequence: x [1, C, hidden]
        at global positions ``start .. start+C-1``; K/V scattered
        through the slot's table (positions ``>= n_valid`` trash-
        routed), then causal attention over the written prefix."""
        b, c, _ = x.shape
        pos = start + torch.arange(c, dtype=torch.int32, device=x.device)
        q, k, v = self._qkv_rope(x, pos[None, :])
        k_arena, v_arena, tables = kv
        paged_chunk_scatter(k_arena, tables, start, n_valid, k[0])
        paged_chunk_scatter(v_arena, tables, start, n_valid, v[0])
        start_t = torch.full((1,), start, dtype=torch.int32, device=x.device)
        out = paged_prefix_attention(q, k_arena, v_arena, tables, start_t)
        return self.o_proj(out.reshape(b, c, -1)), kv


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, factory):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, m, factory)
        self.up_proj = _linear(h, m, factory)
        self.down_proj = _linear(m, h, factory)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, factory):
        super().__init__()
        self.self_attn = LlamaAttention(config, factory)
        self.mlp = LlamaMLP(config, factory)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **factory)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps,
                                                **factory)
        self._recompute = config.recompute

    def _forward_impl(self, x, position_ids=None, attention_mask=None):
        h = x + self.self_attn(self.input_layernorm(x), position_ids,
                               attention_mask)
        return h + self.mlp(self.post_attention_layernorm(h))

    def forward(self, x, position_ids=None, attention_mask=None):
        if self._recompute and self.training:
            return recompute(self._forward_impl, x, position_ids,
                             attention_mask)
        return self._forward_impl(x, position_ids, attention_mask)

    def decode_step(self, x, kv, lens):
        attn_out, kv = self.self_attn.decode_step(self.input_layernorm(x),
                                                  kv, lens)
        h = x + attn_out
        return h + self.mlp(self.post_attention_layernorm(h)), kv

    def chunk_step(self, x, kv, start, n_valid):
        attn_out, kv = self.self_attn.chunk_step(self.input_layernorm(x),
                                                 kv, start, n_valid)
        h = x + attn_out
        return h + self.mlp(self.post_attention_layernorm(h)), kv


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, factory):
        super().__init__()
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, **factory)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, factory)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            **factory)

    def forward(self, input_ids, position_ids=None, attention_mask=None):
        x = self.embed_tokens(input_ids.long())
        for layer in self.layers:
            x = layer(x, position_ids, attention_mask)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama with the paged serving surface and the training forward.

    ``device`` defaults to the CUDA card (``device="cpu"`` for tests);
    ``dtype`` is the parameter dtype.  Parameters are random from
    ``seed`` with the JAX package's initializers (Xavier-normal
    projections, N(0, 1) embedding, unit norms), drawn by a
    ``torch.Generator`` on the target device — a full-size model is
    built in place on the card, never on the host.  ``init=False``
    leaves them uninitialised for a following ``load_state_dict``.  The
    model starts in ``eval()`` mode, as serving wants; ``.train()``
    turns on ``config.recompute``."""

    def __init__(self, config: LlamaConfig, *, device: DeviceLike = None,
                 dtype="float32", seed: int = 0, init: bool = True):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        factory = {"device": "meta", "dtype": to_dtype(dtype)}
        self.llama = LlamaModel(config, factory)
        self.lm_head = _linear(config.hidden_size, config.vocab_size,
                               factory)
        self.to_empty(device=dev)
        if init:
            self.reset_parameters(seed)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        dev = next(self.parameters()).device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("embed_tokens.weight"):
                p.normal_(0.0, 1.0, generator=gen)
            else:       # Linear [out, in]: Xavier-normal
                fan_out, fan_in = p.shape
                p.normal_(0.0, (2.0 / (fan_in + fan_out)) ** 0.5,
                          generator=gen)

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                labels=None):
        """input_ids: [B, S] int.  Returns logits [B, S, vocab], or
        ``(loss, logits)`` with ``labels`` (``LlamaPretrainingCriterion``,
        unshifted)."""
        logits = self.lm_head(self.llama(input_ids, position_ids,
                                         attention_mask))
        if labels is not None:
            return LlamaPretrainingCriterion(self.config)(logits,
                                                          labels), logits
        return logits

    def kv_cache_spec(self):
        return (self.config.num_hidden_layers,
                self.config.num_key_value_heads, self.config.head_dim)

    def decode_step(self, tokens, lens, kvs: Sequence[PagedKV]
                    ) -> Tuple[torch.Tensor, List[PagedKV]]:
        """One cached decode step over all layers.  tokens: [B] int;
        lens: [B] int32; kvs: one paged triple per layer (updated in
        place).  Returns (logits [B, vocab], kvs)."""
        x = self.llama.embed_tokens(tokens[:, None].long())
        new_kvs = []
        for layer, kv in zip(self.llama.layers, kvs):
            x, kv = layer.decode_step(x, kv, lens)
            new_kvs.append(kv)
        x = self.llama.norm(x)
        return self.lm_head(x)[:, 0], new_kvs

    def prefill_chunk(self, ids, start: int, n_valid: int,
                      kvs: Sequence[PagedKV]
                      ) -> Tuple[torch.Tensor, List[PagedKV]]:
        """One chunked-prefill pass over all layers: ids [1, C] prompt
        tokens at global positions ``start .. start+C-1``; ``n_valid`` is
        the prompt's true length.  Returns the logits at prompt position
        ``n_valid - 1`` ([1, vocab]; meaningful only on the chunk that
        covers it) and the kvs."""
        c = ids.shape[1]
        x = self.llama.embed_tokens(ids.long())
        new_kvs = []
        for layer, kv in zip(self.llama.layers, kvs):
            x, kv = layer.chunk_step(x, kv, start, n_valid)
            new_kvs.append(kv)
        h = self.llama.norm(x)
        idx = min(max(n_valid - 1 - start, 0), c - 1)
        return self.lm_head(h[0, idx][None, :]), new_kvs


class LlamaPretrainingCriterion(nn.Module):
    """Mean cross entropy over the positions whose label is not
    ``ignore_index``.  Labels are used as given: despite the reference's
    "shifted" docstring, nothing is shifted (``models/llama.py:570-589``)."""

    def __init__(self, config: Optional[LlamaConfig] = None,
                 ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        return cross_entropy(logits, labels, ignore_index=self.ignore_index,
                             reduction="mean")
