"""GPT: port of ``paddle_tpu/models/gpt.py`` (GPT-2/3 topology: learned
position embeddings, pre-norm decoder blocks, exact-GELU MLP, causal
multi-head attention).

What is here: ``GPTConfig`` with ``gpt2_small_config``,
``gpt3_13b_config`` and ``tiny_gpt_config`` (:27-63), ``GPTAttention``
(:66), ``GPTMLP`` (:241), ``GPTDecoderLayer`` (:260), ``GPTModel``
(:304), ``GPTForCausalLM`` (:330) and ``GPTPretrainingCriterion`` (:475).

- Training: every layer's ``forward``; attention goes through
  ``scaled_dot_product_attention``, so without a mask and dropout it is
  the causal flash kernels on the card, with attention dropout the
  masked math and threefry masks, as in the reference.  A decoder layer
  is recomputed (``distributed.recompute``) when ``config.recompute`` and
  the model is in ``.train()``.
- Serving: ``kv_cache_spec`` (:391), ``decode_step`` (:413, and the
  layer's :122 in its three cache forms: the dense pair of
  ``generate()``, the paged triple and the int8 5-tuple),
  ``prefill_chunk`` (:426), ``verify_step`` (:451) and ``prefill``
  (:395), the same hooks the Llama port gives the engine, the speculative
  verify, ``generate()`` and ``LLMPredictor``.  K/V are written into the
  arenas in place.  ``quant_projections`` (:381) carries the fused
  ``qkv_proj``, ``out_proj``, ``fc_in`` and ``fc_out`` to the
  weight-quant plan; their biases join the quantized matmul's epilogue.
  GPT has no ``attn_projections``: an ``AdapterStore`` refuses it, as
  the reference's does.

Learned positions: a CUDA gather past the table is a device-side fault
that poisons the context.  So every ``wpe`` lookup is clamped to ``[0,
max_position_embeddings - 1]`` on the device: the chunk's and the
verify's pad tails (:437-438, :462-463, where the reference clamps too)
and the decode step's idle slots (whose rows the engine discards; the
reference's ``jnp.take`` fills such a row with NaN instead).
``generate()`` refuses positions past the table before it runs
(:357-379).

Module and parameter names are the JAX model's, so the weight bridge
(``models/convert.py`` ``gpt_state_from_jax``) is a rename-free mapping.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike
from ..distributed.utils import recompute
from ..nn.common import Dropout, materialize, meta_factory
from ..nn.functional import (add, cross_entropy, embedding, gelu,
                             scaled_dot_product_attention)
from ..nn.norm import LayerNorm
from .generation import (GenerationMixin, attend_chunk, attend_decode,
                         attend_verify, cache_prefill_write)
from .wquant import project, wq_linear

PagedKV = Tuple[torch.Tensor, ...]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    tensor_parallel: bool = False
    recompute: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.tensor_parallel:
            raise NotImplementedError(
                "GPTConfig(tensor_parallel=True) is not ported (ROADMAP.md, "
                "Queue 1: #14 Distributed)")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def gpt2_small_config(**kw):
    return GPTConfig(**kw)


def gpt3_13b_config(**kw):
    return GPTConfig(hidden_size=5120, num_hidden_layers=40,
                     num_attention_heads=40, intermediate_size=20480,
                     max_position_embeddings=2048, **kw)


def tiny_gpt_config(**kw):
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_hidden_layers", 2)
    kw.setdefault("num_attention_heads", 4)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("max_position_embeddings", 64)
    return GPTConfig(**kw)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, factory, layer_idx: int = 0):
        super().__init__()
        self.config = config
        self.layer_idx = int(layer_idx)
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        self.qkv_proj = nn.Linear(h, 3 * h, **factory)
        self.out_proj = nn.Linear(h, h, **factory)
        self.dropout_p = config.attention_probs_dropout_prob

    def _qkv(self, x):
        """The fused projection, split as the reference's ``[b, s, 3, H,
        D]`` (the bridge's transposed ``[3h, h]`` weight keeps that
        order): q, k, v each ``[b, s, H, D]``."""
        b, s, _ = x.shape
        qkv = wq_linear(self.qkv_proj, x, "qkv_proj", self.layer_idx)
        qkv = qkv.reshape(b, s, 3, self.num_heads, self.head_dim)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _out(self, t):
        return wq_linear(self.out_proj, t, "out_proj", self.layer_idx)

    def forward(self, x, attention_mask=None):
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        out = scaled_dot_product_attention(
            q, k, v, attn_mask=attention_mask,
            dropout_p=self.dropout_p if self.training else 0.0,
            is_causal=attention_mask is None)
        return self._out(out.reshape(b, s, self.num_heads * self.head_dim))

    def prefill(self, x):
        """Causal forward returning the K/V planes ([B, S, H, D]) for
        the dense generation cache."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        out = scaled_dot_product_attention(q, k, v, is_causal=True)
        return self._out(out.reshape(b, s, -1)), (k, v)

    def decode_step(self, x, kv: PagedKV, lens):
        """One cached decode step (kv heads == q heads: the grouped
        kernels run at G = 1).  kv is the dense (k_cache, v_cache) pair,
        the paged triple or the int8 cache's 5-tuple, written in place."""
        q, k, v = self._qkv(x)
        out = attend_decode(q[:, 0].contiguous(), k[:, 0], v[:, 0], kv,
                            lens)
        return self._out(out[:, None, :]), kv

    def chunk_step(self, x, kv: PagedKV, start: int, n_valid: int):
        """One chunked-prefill step of one sequence over the paged cache
        (positions are applied at the model level: GPT has no RoPE)."""
        b, c, _ = x.shape
        q, k, v = self._qkv(x)
        out = attend_chunk(q, k, v, kv, start, n_valid)
        return self._out(out.reshape(b, c, -1)), kv

    def verify_step(self, x, kv: PagedKV, lens, n_valid):
        """One speculative-verify step: C = K+1 tokens per row at global
        positions ``lens[b] + c``, columns ``>= n_valid[b]``
        trash-routed, attention causal per query offset."""
        b, c, _ = x.shape
        q, k, v = self._qkv(x)
        out = attend_verify(q.contiguous(), k, v, kv, lens, n_valid)
        return self._out(out.reshape(b, c, -1)), kv


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, factory, layer_idx: int = 0):
        super().__init__()
        self.layer_idx = int(layer_idx)
        h, m = config.hidden_size, config.intermediate_size
        self.fc_in = nn.Linear(h, m, **factory)
        self.fc_out = nn.Linear(m, h, **factory)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        li = self.layer_idx
        h = gelu(wq_linear(self.fc_in, x, "fc_in", li))
        return self.dropout(wq_linear(self.fc_out, h, "fc_out", li))


class GPTDecoderLayer(nn.Module):
    """Pre-norm block: x + attn(ln_1(x)); x + mlp(ln_2(x))."""

    def __init__(self, config: GPTConfig, factory, layer_idx: int = 0):
        super().__init__()
        eps = config.layer_norm_eps
        self.ln_1 = LayerNorm(config.hidden_size, eps, **factory)
        self.attn = GPTAttention(config, factory, layer_idx)
        self.ln_2 = LayerNorm(config.hidden_size, eps, **factory)
        self.mlp = GPTMLP(config, factory, layer_idx)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self._recompute = config.recompute

    def _forward_impl(self, x, attention_mask=None):
        x = add(x, self.dropout(self.attn(self.ln_1(x), attention_mask)))
        return add(x, self.mlp(self.ln_2(x)))

    def forward(self, x, attention_mask=None):
        if self._recompute and self.training:
            return recompute(self._forward_impl, x, attention_mask)
        return self._forward_impl(x, attention_mask)

    def _mlp_half(self, x, attn_out):
        x = x + self.dropout(attn_out)
        return x + self.mlp(self.ln_2(x))

    def prefill(self, x):
        a, kv = self.attn.prefill(self.ln_1(x))
        return self._mlp_half(x, a), kv

    def decode_step(self, x, kv, lens):
        a, kv = self.attn.decode_step(self.ln_1(x), kv, lens)
        return self._mlp_half(x, a), kv

    def chunk_step(self, x, kv, start, n_valid):
        a, kv = self.attn.chunk_step(self.ln_1(x), kv, start, n_valid)
        return self._mlp_half(x, a), kv

    def verify_step(self, x, kv, lens, n_valid):
        a, kv = self.attn.verify_step(self.ln_1(x), kv, lens, n_valid)
        return self._mlp_half(x, a), kv


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, factory):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size,
                                **factory)
        self.wpe = nn.Embedding(config.max_position_embeddings,
                                config.hidden_size, **factory)
        self.drop = Dropout(config.hidden_dropout_prob)
        self.h = nn.ModuleList([GPTDecoderLayer(config, factory, i)
                                for i in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_eps,
                              **factory)

    def embed(self, ids, pos):
        """``drop(wte(ids) + wpe(pos))``; ``pos`` is clamped into the
        position table on the device (see the module docstring)."""
        pos = pos.clamp(0, self.config.max_position_embeddings - 1)
        return self.drop(add(embedding(ids.long(), self.wte.weight),
                             embedding(pos.long(), self.wpe.weight)))

    def forward(self, input_ids, position_ids=None, attention_mask=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None, :]
        x = self.embed(input_ids, position_ids)
        for block in self.h:
            x = block(x, attention_mask)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module, GenerationMixin):
    """GPT with the training forward, the paged serving surface and
    ``generate()``.

    ``device`` defaults to the CUDA card (``device="cpu"`` for tests);
    ``dtype`` is the parameter dtype.  Parameters are random from
    ``seed`` with the JAX package's initializers (Xavier-normal
    projections and ``lm_head``, zero biases, N(0, 1) embeddings, unit
    LayerNorm weights), drawn by a ``torch.Generator`` on the target
    device: the model is built on ``meta`` and materialised in place, so
    13B never stages through the host.  ``init=False`` leaves them
    uninitialised for a following ``load_state_dict``.  The model starts
    in ``eval()`` mode."""

    def __init__(self, config: GPTConfig, *, device: DeviceLike = None,
                 dtype="float32", seed: int = 0, init: bool = True):
        super().__init__()
        self.config = config
        factory = meta_factory(dtype)
        self.gpt = GPTModel(config, factory)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=False, **factory)
        self.criterion = GPTPretrainingCriterion(config)
        materialize(self, device, seed, init)
        self.eval()

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                labels=None):
        """input_ids [B, S] int.  Returns logits [B, S, vocab], or
        ``(loss, logits)`` with ``labels`` (``GPTPretrainingCriterion``,
        unshifted, as the reference)."""
        hidden = self.gpt(input_ids, position_ids, attention_mask)
        logits = project(self.lm_head, hidden)
        if labels is not None:
            return self.criterion(logits, labels), logits
        return logits

    def generate(self, input_ids, seq_lens=None, max_new_tokens=32, **kw):
        """``GenerationMixin.generate`` after the reference's position
        check: prefill looks up ``0 .. S-1``, the last fed decode token
        sits at ``max_len + max_new_tokens - 2``; a position past the
        table raises ``ValueError`` instead of decoding with a clamped
        one."""
        s = input_ids.shape[1]
        limit = self.config.max_position_embeddings
        if seq_lens is None:
            max_len = s
        else:
            lens = seq_lens.cpu() if isinstance(seq_lens, torch.Tensor) \
                else seq_lens
            max_len = int(np.max(np.asarray(lens)))
        if s > limit or max_len + max_new_tokens - 1 > limit:
            raise ValueError(
                f"generate: positions up to "
                f"{max(s - 1, max_len + max_new_tokens - 2)} exceed "
                f"max_position_embeddings ({limit})")
        return GenerationMixin.generate(self, input_ids, seq_lens=seq_lens,
                                        max_new_tokens=max_new_tokens, **kw)

    def quant_projections(self):
        """Per-layer ``{target: Linear}`` views of every hot projection
        (fused qkv, out, MLP fc_in/fc_out, each with its bias), in layer
        order: the weight-quantization surface (``models/wquant.py``)."""
        return [{"qkv_proj": l.attn.qkv_proj,
                 "out_proj": l.attn.out_proj,
                 "fc_in": l.mlp.fc_in,
                 "fc_out": l.mlp.fc_out}
                for l in self.gpt.h]

    def kv_cache_spec(self):
        return (self.config.num_hidden_layers,
                self.config.num_attention_heads, self.config.head_dim)

    def _logits(self, h):
        return project(self.lm_head, self.gpt.ln_f(h))

    def prefill(self, ids, lens, kvs) -> Tuple[torch.Tensor, List]:
        """Prompt pass of ``generate()``: the prompt's K/V into the dense
        (k_cache, v_cache) pairs from slot 0, and the logits at each
        row's last valid position ``lens[b] - 1`` ([B, vocab])."""
        b, s = ids.shape
        pos = torch.arange(s, device=ids.device)[None, :]
        x = self.gpt.embed(ids, pos)
        out_kvs = []
        for block, (kc, vc) in zip(self.gpt.h, kvs):
            x, (k, v) = block.prefill(x)
            out_kvs.append((cache_prefill_write(kc, k),
                            cache_prefill_write(vc, v)))
        # a gather, not advanced indexing: no host read, so a CUDA graph
        # can capture it
        idx = (lens.long() - 1)[:, None, None].expand(b, 1, x.shape[-1])
        last = torch.gather(x, 1, idx)                         # [B, 1, h]
        return self._logits(last)[:, 0], out_kvs

    def decode_step(self, tokens, lens, kvs: Sequence[PagedKV]
                    ) -> Tuple[torch.Tensor, List[PagedKV]]:
        """One cached decode step over all layers: tokens [B] at
        positions ``lens`` (clamped into the table: an idle slot's lens
        may lie past it).  Returns (logits [B, vocab], kvs)."""
        x = self.gpt.embed(tokens[:, None], lens[:, None])
        new_kvs = []
        for block, kv in zip(self.gpt.h, kvs):
            x, kv = block.decode_step(x, kv, lens)
            new_kvs.append(kv)
        return self._logits(x)[:, 0], new_kvs

    def prefill_chunk(self, ids, start: int, n_valid: int,
                      kvs: Sequence[PagedKV]
                      ) -> Tuple[torch.Tensor, List[PagedKV]]:
        """One chunked-prefill pass: ids [1, C] at global positions
        ``start .. start+C-1`` (the pad tail's clamped at the table
        edge; its K/V are trash-routed).  Returns the logits at prompt
        position ``n_valid - 1`` ([1, vocab]) and the kvs."""
        c = ids.shape[1]
        pos = start + torch.arange(c, dtype=torch.int32, device=ids.device)
        x = self.gpt.embed(ids, pos[None, :])
        new_kvs = []
        for block, kv in zip(self.gpt.h, kvs):
            x, kv = block.chunk_step(x, kv, start, n_valid)
            new_kvs.append(kv)
        idx = min(max(n_valid - 1 - start, 0), c - 1)
        return self._logits(x[0, idx][None, :]), new_kvs

    def verify_step(self, tokens, lens, n_valid, kvs: Sequence[PagedKV]
                    ) -> Tuple[torch.Tensor, List[PagedKV]]:
        """One speculative-verify pass: tokens [B, C] at per-row
        positions ``lens[b] + c`` (the draft-pad tail's clamped at the
        table edge).  Returns the logits at all C positions ([B, C,
        vocab]) and the kvs."""
        c = tokens.shape[1]
        pos = lens[:, None] + torch.arange(c, dtype=torch.int32,
                                           device=tokens.device)[None, :]
        x = self.gpt.embed(tokens, pos)
        new_kvs = []
        for block, kv in zip(self.gpt.h, kvs):
            x, kv = block.verify_step(x, kv, lens, n_valid)
            new_kvs.append(kv)
        return self._logits(x), new_kvs


class GPTPretrainingCriterion(nn.Module):
    """Mean cross entropy over the positions whose label is not
    ``ignore_index`` (labels used as given, as the reference)."""

    def __init__(self, config: Optional[GPTConfig] = None,
                 ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        return cross_entropy(logits, labels, ignore_index=self.ignore_index,
                             reduction="mean")
