"""Llama: port of the serving and training surfaces of
``paddle_tpu/models/llama.py``.

What is here: ``LlamaConfig`` (the fields serving and training read),
``llama_3_8b_config``/``tiny_llama_config``, ``LlamaForCausalLM`` and
``LlamaPretrainingCriterion``.

- Serving: ``kv_cache_spec`` (:485), ``decode_step`` (:514),
  ``prefill_chunk`` (:528) and ``verify_step`` (:549, the speculative
  verify forward) over the PAGED kv triple ``(k_arena, v_arena,
  block_tables)`` or the quantized 5-tuple ``(k_codes, v_codes,
  k_scales, v_scales, block_tables)`` of the int8 cache, on top of the
  layer-level ``decode_step`` (:187), ``chunk_step`` (:233) and
  ``verify_step`` (:271).  K/V are written into the arenas IN PLACE
  (``index_put_``), which takes the place of JAX's buffer donation: the
  caller's arena tensors are the updated arenas.  ``quant_projections``
  (:469) and the ``wq_linear`` projection sites (:133, :144-148,
  :339-345) carry quantized weights (``models/wquant.py``).
- Greedy ``generate()`` (``models/generation.py`` ``GenerationMixin``)
  over the dense ``(k, v)`` cache: ``prefill`` (:489, :178, :376) and the
  dense branch of ``decode_step`` (:222-229).
- Training: the ``forward`` of every layer (:159-176, :332-345, :363-374,
  :416-420, :438-457) without a kv cache, with full recompute of each
  decoder layer when ``config.recompute`` and the model is in
  ``.train()``, and the unshifted criterion (:570-589).

Module and parameter names match the JAX model's ``named_parameters()``
so the weight bridge (``models/convert.py``) is a rename-free mapping.
The projections and ``lm_head`` are ``nn.Linear`` (a library GEMM, as
the JAX package leaves them to XLA) unless a weight-quant context routes
a projection through the quantized-matmul kernel; RMSNorm, RoPE (without
position ids), causal attention, paged decode and verify attention (float
and int8 cache) and dense decode attention run the port's CUDA kernels on
the card.
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
                                    decode_attention_paged_multi,
                                    paged_prefix_attention)
from .generation import (GenerationMixin, cache_prefill_write, cache_scatter,
                         cached_decode_attention, paged_cache_scatter,
                         paged_cache_scatter_q, paged_chunk_scatter,
                         paged_chunk_scatter_q, paged_verify_scatter,
                         paged_verify_scatter_q)
from .wquant import wq_linear

# (k_arena, v_arena, tables) or, for the int8 cache, (k_codes, v_codes,
# k_scales, v_scales, tables); decode_step also takes generate()'s dense
# (k_cache, v_cache) pair
PagedKV = Tuple[torch.Tensor, ...]


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
    def __init__(self, config: LlamaConfig, factory, layer_idx: int = 0):
        super().__init__()
        self.config = config
        self.layer_idx = layer_idx
        h = config.hidden_size
        self.head_dim = config.head_dim
        kv_out = config.num_key_value_heads * self.head_dim
        self.q_proj = _linear(h, h, factory)
        self.k_proj = _linear(h, kv_out, factory)
        self.v_proj = _linear(h, kv_out, factory)
        self.o_proj = _linear(h, h, factory)

    def _o(self, t):
        """The output projection, quantized inside a weight-quant
        context (``wq_linear``)."""
        return wq_linear(self.o_proj, t, "o_proj", self.layer_idx)

    def _qkv_rope(self, x, position_ids):
        b, s, _ = x.shape
        li = self.layer_idx
        q = wq_linear(self.q_proj, x, "q_proj", li)
        k = wq_linear(self.k_proj, x, "k_proj", li)
        v = wq_linear(self.v_proj, x, "v_proj", li)
        q = q.reshape(b, s, -1, self.head_dim)
        k = k.reshape(b, s, -1, self.head_dim)
        v = v.reshape(b, s, -1, self.head_dim)
        q, k = llama_rope(q, k, rotary_emb_base=self.config.rope_theta,
                          position_ids=position_ids)
        return q, k, v

    def forward(self, x, position_ids=None, attention_mask=None,
                cache=None):
        """Training/full-sequence attention: causal flash attention
        without a mask (the kernels on the card), the masked math with
        one.  The reference's ``cache=`` form (past K/V concatenated in
        front of the new ones) is not ported; ``generate()`` runs on
        ``prefill`` and the dense branch of ``decode_step``."""
        if cache is not None:
            raise NotImplementedError(
                "LlamaAttention.forward(cache=...) (past K/V concatenated "
                "before the new tokens) is not ported (ROADMAP.md, Queue 1: "
                "LLMPredictor and the dense generate programs)")
        b, s, _ = x.shape
        q, k, v = self._qkv_rope(x, position_ids)
        out = scaled_dot_product_attention(q, k, v, attn_mask=attention_mask,
                                           is_causal=attention_mask is None)
        return self._o(out.reshape(b, s, -1))

    def prefill(self, x, position_ids=None):
        """Causal forward over a whole (right-padded) prompt that also
        returns the post-RoPE K/V planes ([B, S, H_kv, D]) for the dense
        generation cache."""
        b, s, _ = x.shape
        q, k, v = self._qkv_rope(x, position_ids)
        out = scaled_dot_product_attention(q, k, v, is_causal=True)
        return self._o(out.reshape(b, s, -1)), (k, v)

    def decode_step(self, x, kv: PagedKV, lens):
        """One cached decode step.  x: [B, 1, hidden]; kv: the paged
        triple, the int8 cache's 5-tuple (quantize on append, dequantize
        in the attention read) or ``generate()``'s dense (k_cache,
        v_cache) pair; lens: [B] int32 write slot = last valid index
        after the write.  Returns (out [B, 1, hidden], kv)."""
        q, k, v = self._qkv_rope(x, lens[:, None])
        q1 = q[:, 0].contiguous()
        if len(kv) == 2:
            k_cache, v_cache = kv
            cache_scatter(k_cache, lens, k[:, 0])
            cache_scatter(v_cache, lens, v[:, 0])
            out = cached_decode_attention(q1, k_cache, v_cache, lens)
        elif len(kv) == 5:
            k_arena, v_arena, k_s, v_s, tables = kv
            paged_cache_scatter_q(k_arena, k_s, tables, lens, k[:, 0])
            paged_cache_scatter_q(v_arena, v_s, tables, lens, v[:, 0])
            out = decode_attention_paged(q1, k_arena, v_arena, tables, lens,
                                         kv_scales=(k_s, v_s))
        else:
            k_arena, v_arena, tables = kv
            paged_cache_scatter(k_arena, tables, lens, k[:, 0])
            paged_cache_scatter(v_arena, tables, lens, v[:, 0])
            out = decode_attention_paged(q1, k_arena, v_arena, tables, lens)
        return self._o(out[:, None, :]), kv

    def chunk_step(self, x, kv: PagedKV, start: int, n_valid: int):
        """One chunked-prefill step of ONE sequence: x [1, C, hidden]
        at global positions ``start .. start+C-1``; K/V scattered
        through the slot's table (positions ``>= n_valid`` trash-
        routed), then causal attention over the written prefix."""
        b, c, _ = x.shape
        pos = start + torch.arange(c, dtype=torch.int32, device=x.device)
        q, k, v = self._qkv_rope(x, pos[None, :])
        start_t = torch.full((1,), start, dtype=torch.int32, device=x.device)
        if len(kv) == 5:
            k_arena, v_arena, k_s, v_s, tables = kv
            paged_chunk_scatter_q(k_arena, k_s, tables, start, n_valid, k[0])
            paged_chunk_scatter_q(v_arena, v_s, tables, start, n_valid, v[0])
            out = paged_prefix_attention(q, k_arena, v_arena, tables,
                                         start_t, kv_scales=(k_s, v_s))
        else:
            k_arena, v_arena, tables = kv
            paged_chunk_scatter(k_arena, tables, start, n_valid, k[0])
            paged_chunk_scatter(v_arena, tables, start, n_valid, v[0])
            out = paged_prefix_attention(q, k_arena, v_arena, tables,
                                         start_t)
        return self._o(out.reshape(b, c, -1)), kv

    def verify_step(self, x, kv: PagedKV, lens, n_valid):
        """One speculative-verify step over the paged cache: x holds C =
        K+1 tokens per row ([B, C, hidden]), the row's last emitted
        token plus K draft candidates, at per-row global positions
        ``lens[b] .. lens[b]+C-1``.  K/V scatter through each row's table
        with columns ``>= n_valid[b]`` trash-routed, then attention is
        causal per query offset (``decode_attention_paged_multi``)."""
        b, c, _ = x.shape
        pos = lens[:, None] + torch.arange(c, dtype=torch.int32,
                                           device=x.device)[None, :]
        q, k, v = self._qkv_rope(x, pos)
        q = q.contiguous()
        if len(kv) == 5:
            k_arena, v_arena, k_s, v_s, tables = kv
            paged_verify_scatter_q(k_arena, k_s, tables, lens, n_valid, k)
            paged_verify_scatter_q(v_arena, v_s, tables, lens, n_valid, v)
            out = decode_attention_paged_multi(q, k_arena, v_arena, tables,
                                               lens, kv_scales=(k_s, v_s))
        else:
            k_arena, v_arena, tables = kv
            paged_verify_scatter(k_arena, tables, lens, n_valid, k)
            paged_verify_scatter(v_arena, tables, lens, n_valid, v)
            out = decode_attention_paged_multi(q, k_arena, v_arena, tables,
                                               lens)
        return self._o(out.reshape(b, c, -1)), kv


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, factory, layer_idx: int = 0):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.layer_idx = layer_idx
        self.gate_proj = _linear(h, m, factory)
        self.up_proj = _linear(h, m, factory)
        self.down_proj = _linear(m, h, factory)

    def forward(self, x):
        li = self.layer_idx
        g = wq_linear(self.gate_proj, x, "gate_proj", li)
        u = wq_linear(self.up_proj, x, "up_proj", li)
        return wq_linear(self.down_proj, swiglu(g, u), "down_proj", li)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, factory, layer_idx: int = 0):
        super().__init__()
        self.self_attn = LlamaAttention(config, factory, layer_idx)
        self.mlp = LlamaMLP(config, factory, layer_idx)
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

    def prefill(self, x, position_ids=None):
        attn_out, kv = self.self_attn.prefill(self.input_layernorm(x),
                                              position_ids)
        h = x + attn_out
        return h + self.mlp(self.post_attention_layernorm(h)), kv

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

    def verify_step(self, x, kv, lens, n_valid):
        attn_out, kv = self.self_attn.verify_step(self.input_layernorm(x),
                                                  kv, lens, n_valid)
        h = x + attn_out
        return h + self.mlp(self.post_attention_layernorm(h)), kv


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, factory):
        super().__init__()
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, **factory)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, factory, i)
             for i in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            **factory)

    def forward(self, input_ids, position_ids=None, attention_mask=None):
        x = self.embed_tokens(input_ids.long())
        for layer in self.layers:
            x = layer(x, position_ids, attention_mask)
        return self.norm(x)


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """Llama with the paged serving surface, greedy ``generate()`` and
    the training forward.

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

    def quant_projections(self):
        """Per-layer ``{target: Linear}`` views of every hot projection
        (attention q/k/v/o and MLP gate/up/down), in layer order: the
        weight-quantization surface (``models/wquant.py``).  Embeddings,
        norms and ``lm_head`` stay float."""
        return [{"q_proj": l.self_attn.q_proj,
                 "k_proj": l.self_attn.k_proj,
                 "v_proj": l.self_attn.v_proj,
                 "o_proj": l.self_attn.o_proj,
                 "gate_proj": l.mlp.gate_proj,
                 "up_proj": l.mlp.up_proj,
                 "down_proj": l.mlp.down_proj}
                for l in self.llama.layers]

    def kv_cache_spec(self):
        return (self.config.num_hidden_layers,
                self.config.num_key_value_heads, self.config.head_dim)

    def prefill(self, ids, lens, kvs) -> Tuple[torch.Tensor, List]:
        """Prompt pass of ``generate()``: write the prompt's K/V into the
        dense (k_cache, v_cache) pairs ``kvs`` from slot 0 and return the
        logits at each row's last valid position ``lens[b] - 1`` only
        ([B, vocab]; the [B, S, vocab] logits are never formed)."""
        b = ids.shape[0]
        hidden, new_kvs = self._prefill_hidden(ids)
        out_kvs = [(cache_prefill_write(kc, k), cache_prefill_write(vc, v))
                   for (kc, vc), (k, v) in zip(kvs, new_kvs)]
        last = hidden[torch.arange(b, device=hidden.device),
                      lens.long() - 1]                         # [B, hidden]
        return self.lm_head(last[:, None, :])[:, 0], out_kvs

    def _prefill_hidden(self, ids):
        x = self.llama.embed_tokens(ids.long())
        kvs = []
        for layer in self.llama.layers:
            x, kv = layer.prefill(x)
            kvs.append(kv)
        return self.llama.norm(x), kvs

    def decode_step(self, tokens, lens, kvs: Sequence[PagedKV]
                    ) -> Tuple[torch.Tensor, List[PagedKV]]:
        """One cached decode step over all layers.  tokens: [B] int;
        lens: [B] int32; kvs: one paged triple (or int8 5-tuple, or
        dense (k, v) pair) per layer, updated in place.  Returns (logits
        [B, vocab], kvs)."""
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

    def verify_step(self, tokens, lens, n_valid, kvs: Sequence[PagedKV]
                    ) -> Tuple[torch.Tensor, List[PagedKV]]:
        """One speculative-verify pass over all layers: tokens [B, C],
        each row's last emitted token plus its K draft candidates, at
        per-row global positions ``lens[b] + c``; n_valid [B] int32
        counts each row's real columns.  Returns the logits at ALL C
        positions ([B, C, vocab]) and the kvs; columns ``>= n_valid[b]``
        compute trash-routed garbage the engine ignores."""
        x = self.llama.embed_tokens(tokens.long())
        new_kvs = []
        for layer, kv in zip(self.llama.layers, kvs):
            x, kv = layer.verify_step(x, kv, lens, n_valid)
            new_kvs.append(kv)
        return self.lm_head(self.llama.norm(x)), new_kvs


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
