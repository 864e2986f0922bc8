"""ERNIE / BERT encoders: port of ``paddle_tpu/models/ernie.py``.

``ErnieConfig`` with ``ernie_base_config`` and ``tiny_ernie_config``,
``ErnieEmbeddings`` (word + position + token type, LayerNorm, dropout),
``ErniePooler``, ``_attention_mask_from_ids`` (:89-97: ``-1e4`` at pads,
built in float32), ``ErnieModel`` (embeddings, a post-norm
``nn.TransformerEncoder``, the pooled ``[CLS]``), the sequence-
classification, token-classification and question-answering heads,
``ErniePretrainingHeads`` (MLM transform and decoder, NSP head),
``ErnieForPretraining``, ``ErniePretrainingCriterion`` and the ``Bert*``
aliases (:256-261).

The encoder's attention always carries the pad mask (built from the ids
when none is given), so it runs the masked ``_xla_attention`` math and
launches no flash kernel, as in the reference.  Tied pretraining heads
(``ErnieForPretraining``) decode with the word-embedding tensor itself,
transposed, plus ``cls.decoder_bias``: the heads keep no weight of their
own, and nothing is copied.

Every model class takes ``device=`` (the CUDA card unless ``"cpu"`` is
asked for), ``dtype=`` and ``seed=`` (the reference's initializers,
drawn on the device; ``init=False`` for a following
``load_state_dict``).  A model builds its parts on ``meta`` (the
embeddings, pooler and pretraining heads take the parent's factory
keywords, as the GPT and Llama layers do) and materializes itself once;
``device="meta"`` leaves an ``ErnieModel`` for the head that holds it.
Position ids are clamped into the position table, so no CUDA gather
leaves it.  A model starts in training mode, as the
reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..amp.auto_cast import cast as _amp_cast
from ..device import to_dtype
from ..nn import functional as F
from ..nn.common import Dropout, Linear, materialize, meta_factory
from ..nn.norm import LayerNorm
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer


@dataclass
class ErnieConfig:
    vocab_size: int = 18000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 4
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    dtype: str = "float32"


def ernie_base_config(**kw):
    return ErnieConfig(**kw)


def tiny_ernie_config(**kw):
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_hidden_layers", 2)
    kw.setdefault("num_attention_heads", 4)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("max_position_embeddings", 64)
    return ErnieConfig(**kw)


class ErnieEmbeddings(nn.Module):
    """word + position + token-type embeddings -> LayerNorm -> dropout."""

    def __init__(self, config: ErnieConfig, fac):
        super().__init__()
        h = config.hidden_size
        self.max_positions = config.max_position_embeddings
        self.word_embeddings = nn.Embedding(config.vocab_size, h, **fac)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h, **fac)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h,
                                                  **fac)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, **fac)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = position_ids.clamp(0, self.max_positions - 1)
        x = F.add(F.add(F.embedding(input_ids.long(),
                                    self.word_embeddings.weight),
                        F.embedding(pos.long(),
                                    self.position_embeddings.weight)),
                  F.embedding(token_type_ids.long(),
                              self.token_type_embeddings.weight))
        return self.dropout(self.layer_norm(x))


class ErniePooler(nn.Module):
    def __init__(self, config: ErnieConfig, fac):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size, **fac)

    def forward(self, hidden_states):
        return F.tanh(self.dense(hidden_states[:, 0]))


def _attention_mask_from_ids(input_ids, pad_token_id, dtype):
    """[b, s] token ids -> additive [b, 1, 1, s] mask (-1e4 at pads),
    built in float32 and cast to ``dtype``."""
    mask = (input_ids != pad_token_id).to(torch.float32)
    bias = (1.0 - mask)[:, None, None, :] * -1e4
    return bias.to(to_dtype(dtype))


class ErnieModel(nn.Module):
    """Embeddings -> N post-norm encoder layers -> pooled ``[CLS]``."""

    def __init__(self, config: ErnieConfig, *, device=None, dtype="float32",
                 seed=0, init=True):
        super().__init__()
        self.config = config
        fac = meta_factory(dtype)
        self.embeddings = ErnieEmbeddings(config, fac)
        encoder_layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob,
            act_dropout=0.0, layer_norm_eps=config.layer_norm_eps, **fac)
        self.encoder = TransformerEncoder(encoder_layer,
                                          config.num_hidden_layers)
        self.pooler = ErniePooler(config, fac)
        materialize(self, device, seed, init)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is None:
            attention_mask = _attention_mask_from_ids(
                input_ids, self.config.pad_token_id, "float32")
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        sequence_output = self.encoder(x, attention_mask)
        return sequence_output, self.pooler(sequence_output)


class ErnieForSequenceClassification(nn.Module):
    def __init__(self, config: ErnieConfig, num_classes: int = 2, *,
                 device=None, dtype="float32", seed=0, init=True):
        super().__init__()
        self.ernie = ErnieModel(config, **meta_factory(dtype))
        self.num_classes = num_classes
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 **meta_factory(dtype))
        materialize(self, device, seed, init)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels), logits
        return logits


class ErnieForTokenClassification(nn.Module):
    def __init__(self, config: ErnieConfig, num_classes: int = 2, *,
                 device=None, dtype="float32", seed=0, init=True):
        super().__init__()
        self.ernie = ErnieModel(config, **meta_factory(dtype))
        self.num_classes = num_classes
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 **meta_factory(dtype))
        materialize(self, device, seed, init)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None):
        seq, _ = self.ernie(input_ids, token_type_ids, position_ids,
                            attention_mask)
        logits = self.classifier(self.dropout(seq))
        if labels is not None:
            loss = F.cross_entropy(logits.reshape(-1, self.num_classes),
                                   labels.reshape(-1))
            return loss, logits
        return logits


class ErnieForQuestionAnswering(nn.Module):
    def __init__(self, config: ErnieConfig, *, device=None, dtype="float32",
                 seed=0, init=True):
        super().__init__()
        self.ernie = ErnieModel(config, **meta_factory(dtype))
        self.classifier = Linear(config.hidden_size, 2, **meta_factory(dtype))
        materialize(self, device, seed, init)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, _ = self.ernie(input_ids, token_type_ids, position_ids,
                            attention_mask)
        logits = self.classifier(seq)
        return logits[:, :, 0], logits[:, :, 1]


class ErniePretrainingHeads(nn.Module):
    """MLM transform + decoder and the NSP head.  With ``embedding`` (the
    word-embedding layer) the decoder is tied: its weight is that
    layer's weight, read at every call (never registered here, never
    copied), and ``decoder_bias`` is the heads' only decoder parameter;
    without it the decoder is a ``Linear`` of its own."""

    def __init__(self, config: ErnieConfig, fac,
                 embedding: nn.Embedding = None):
        super().__init__()
        h = config.hidden_size
        self.transform = Linear(h, h, **fac)
        self.activation = F.gelu if config.hidden_act == "gelu" else F.relu
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, **fac)
        # a plain attribute, not a submodule: the embedding's weight stays
        # registered once, under the embedding layer
        object.__setattr__(self, "_tied_embedding", embedding)
        if embedding is not None:
            self.decoder_bias = nn.Parameter(torch.empty(config.vocab_size,
                                                         **fac))
        else:
            self.decoder = Linear(h, config.vocab_size, **fac)
        self.seq_relationship = Linear(h, 2, **fac)

    @property
    def _tied(self):
        """The tied decoder weight (the word embedding's own tensor), or
        None."""
        e = self._tied_embedding
        return None if e is None else e.weight

    def forward(self, sequence_output, pooled_output):
        x = self.layer_norm(self.activation(self.transform(sequence_output)))
        tied = self._tied
        if tied is not None:
            x, w = _amp_cast("matmul", x, tied)
            prediction_scores = F.add(torch.matmul(x, w.t()),
                                      self.decoder_bias)
        else:
            prediction_scores = self.decoder(x)
        return prediction_scores, self.seq_relationship(pooled_output)


class ErnieForPretraining(nn.Module):
    def __init__(self, config: ErnieConfig, *, device=None, dtype="float32",
                 seed=0, init=True):
        super().__init__()
        self.config = config
        fac = meta_factory(dtype)
        self.ernie = ErnieModel(config, **fac)
        self.cls = ErniePretrainingHeads(
            config, fac, self.ernie.embeddings.word_embeddings)
        materialize(self, device, seed, init)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask)
        return self.cls(seq, pooled)


class ErniePretrainingCriterion(nn.Module):
    """MLM + NSP loss (``ignore_index`` masks the unmasked positions)."""

    def __init__(self, vocab_size: int, ignore_index: int = -100):
        super().__init__()
        self.vocab_size = vocab_size
        self.ignore_index = ignore_index

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels=None):
        mlm = F.cross_entropy(
            prediction_scores.reshape(-1, self.vocab_size),
            masked_lm_labels.reshape(-1), ignore_index=self.ignore_index,
            reduction="mean")
        if next_sentence_labels is None:
            return mlm
        nsp = F.cross_entropy(seq_relationship_score,
                              next_sentence_labels.reshape(-1),
                              reduction="mean")
        return F.add(mlm, nsp)


# BERT aliases: the same topology at this capability level
BertConfig = ErnieConfig
BertModel = ErnieModel
BertForSequenceClassification = ErnieForSequenceClassification
BertForTokenClassification = ErnieForTokenClassification
BertForQuestionAnswering = ErnieForQuestionAnswering
BertForPretraining = ErnieForPretraining
