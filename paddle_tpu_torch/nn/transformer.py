"""Transformer layers: port of ``paddle_tpu/nn/layer/transformer.py``.

``MultiHeadAttention`` (:22, with ``Cache``, ``StaticCache`` and
``gen_cache``), ``TransformerEncoderLayer`` (:90, post-norm or
``normalize_before``), ``TransformerEncoder`` (:135),
``TransformerDecoderLayer`` (:163), ``TransformerDecoder`` (:226),
``Transformer`` (:255) and ``generate_square_subsequent_mask`` (:290).

Attention goes through the port's ``scaled_dot_product_attention`` and
keeps the reference's routes: without a mask and dropout and with equal
q/k lengths it is the flash kernel on the card; a mask, dropout or a
grown ``Cache`` runs the ``_xla_attention`` math.  Parameter names are
the reference's (``q_proj``, ``linear1``, ``norm1``, ...; Linear weights
``[out, in]``, transposed by the weight bridge).  A stack deep-copies
its layer, as the reference's does.

Each layer is built on ``meta`` and materialized on ``device`` (the
CUDA card unless ``"cpu"`` is asked for) with the reference's
initializers (``nn.common.reference_init``, a fixed seed: load trained
weights with ``load_state_dict``); ``device="meta"`` leaves it for a
parent to materialize.  ``Transformer`` materializes only the stacks it
builds: a ``custom_encoder``/``custom_decoder`` keeps its weights.  As in
the reference, a layer starts in training mode.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from . import functional as F
from .common import Dropout, Linear, materialize, meta_factory
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(nn.Module):
    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    class StaticCache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype="float32"):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        fac = meta_factory(dtype)
        self.q_proj = Linear(embed_dim, embed_dim, bias_attr=bias_attr, **fac)
        self.k_proj = Linear(kdim, embed_dim, bias_attr=bias_attr, **fac)
        self.v_proj = Linear(vdim, embed_dim, bias_attr=bias_attr, **fac)
        self.out_proj = Linear(embed_dim, embed_dim,
                               bias_attr=bias_attr, **fac)
        materialize(self, device)

    def _heads(self, t):
        return t.reshape(t.shape[0], -1, self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """``StaticCache``: the projected K/V of ``key``/``value`` (cross
        attention); otherwise an empty ``Cache`` ([B, 0, H, D]) that
        ``forward`` grows."""
        if type == MultiHeadAttention.StaticCache:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value if value is not None
                                        else key))
            return MultiHeadAttention.StaticCache(k, v)
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        k = torch.zeros(shape, dtype=key.dtype, device=key.device)
        return MultiHeadAttention.Cache(k, torch.zeros_like(k))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        b, sq = query.shape[0], query.shape[1]
        q = self._heads(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = MultiHeadAttention.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0)
        out = self.out_proj(out.reshape(b, sq, self.embed_dim))
        if isinstance(cache, MultiHeadAttention.Cache):
            return out, cache
        return out


def _get_activation(name):
    return {"relu": F.relu, "gelu": F.gelu}[name]


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype="float32"):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        fac = meta_factory(dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **fac)
        self.linear1 = Linear(d_model, dim_feedforward,
                              bias_attr=bias_attr, **fac)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model,
                              bias_attr=bias_attr, **fac)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **fac)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **fac)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = _get_activation(activation)
        materialize(self, device)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = F.add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = F.add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src, type=MultiHeadAttention.Cache)


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] +
            [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype="float32"):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        fac = meta_factory(dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **fac)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **fac)
        self.linear1 = Linear(d_model, dim_feedforward,
                              bias_attr=bias_attr, **fac)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model,
                              bias_attr=bias_attr, **fac)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **fac)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **fac)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, **fac)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = _get_activation(activation)
        materialize(self, device)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = F.add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
        tgt = F.add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = F.add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr, cache[1]))

    def gen_cache(self, memory):
        incr = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incr, static


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer] +
            [copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, c = layer(output, memory, tgt_mask, memory_mask,
                                  cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(nn.Module):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype="float32"):
        super().__init__()
        fac = meta_factory(dtype)
        built = []
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **fac)
            enc_norm = LayerNorm(d_model, **fac) if normalize_before \
                else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
            built.append(self.encoder)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **fac)
            dec_norm = LayerNorm(d_model, **fac) if normalize_before \
                else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
            built.append(self.decoder)
        self.d_model = d_model
        self.nhead = nhead
        # only the stacks built here: a custom encoder or decoder is kept
        # as given, as the reference keeps it
        for i, part in enumerate(built):
            materialize(part, device, seed=i)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """``[length, length]`` float32: 0 on and below the diagonal,
        -1e30 above it, on ``device`` (the CUDA card unless ``"cpu"``)."""
        from ..device import resolve_device
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.where(keep, 0.0, -1e30).to(torch.float32)
