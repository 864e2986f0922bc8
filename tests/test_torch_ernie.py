"""The port's ``nn.Transformer*`` layers and ERNIE/BERT models held
against the JAX package's on the CPU, on the JAX layers' weights carried
by the weight bridge (``ernie_state_from_jax``).

Tolerances (float32; both sides sum in different orders):
- layer and model outputs, heads and losses: ``atol 1e-5`` (``2e-5`` for
  the stacked ``Transformer``, whose encoder output feeds every decoder
  layer's cross attention; plus ``rtol 1e-5`` for the tied MLM scores,
  which reach about 17: dots with N(0, 1) embedding rows);
- three ``TrainStep`` calls of ``ErnieForSequenceClassification``
  (AdamW, lr 5e-3, the configured dropouts, masks drawn in the
  reference's trace order): losses ``rtol 1e-5``, parameters ``atol
  1e-5``, moments ``rtol 1e-4`` plus ``atol`` of ``1e-5`` times the
  tensor's largest entry, as ``test_torch_train.py``.  The attention's
  ``k_proj.bias`` is held to Adam's step size instead (``atol 2 * lr *
  steps``): its gradient is zero in exact arithmetic (one vector added
  to every key shifts a query's scores by one constant, which the
  softmax cancels, the additive pad mask included), so both sides'
  gradients are float32 noise of independent sign that Adam scales to
  about ``lr`` a step; its moments are held to be that noise (``|m| <
  1e-6``, ``v < 1e-12`` on both sides).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
import paddle_tpu_torch
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (ernie_state_from_jax,
                                     optimizer_state_from_jax,
                                     optimizer_state_to_jax,
                                     tiny_ernie_config)
from paddle_tpu_torch.models.convert import LINEAR_NAMES
from paddle_tpu_torch.optimizer import AdamW

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return np.asarray(getattr(t, "_value", t))


def _J(a):
    return JTensor(jnp.asarray(a))


def _bridge(jlayer, tlayer, train=False):
    arrays = {n: np.array(p._value, copy=True)
              for n, p in jlayer.named_parameters()}
    tlayer.load_state_dict(ernie_state_from_jax(arrays), strict=True)
    jlayer.train() if train else jlayer.eval()
    tlayer.train(train)
    return jlayer, tlayer


def _x(rng, b=2, s=7, h=32):
    return rng.standard_normal((b, s, h)).astype(np.float32)


def _mask(rng, b=2, s=7):
    keep = rng.random((b, 1, 1, s)) < 0.8
    keep[..., 0] = True
    return np.where(keep, 0.0, -1e4).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(_np(t.detach() if isinstance(t, torch.Tensor)
                                   else t), _np(j), atol=atol, rtol=0)


def test_multi_head_attention_caches_match_jax():
    paddle.seed(1)
    ja, ta = _bridge(jnn.MultiHeadAttention(32, 4),
                     tnn.MultiHeadAttention(32, 4, device="cpu"))
    rng = np.random.default_rng(1)
    q, mem, m = _x(rng), _x(rng, s=5), _mask(rng, s=5)
    with torch.no_grad():
        _close(ta(torch.from_numpy(q)), ja(_J(q)))
        _close(ta(torch.from_numpy(q), torch.from_numpy(mem),
                  attn_mask=torch.from_numpy(m)),
               ja(_J(q), _J(mem), attn_mask=_J(m)))
        # the growing Cache: two steps of one new token each
        tc, jc = ta.gen_cache(torch.from_numpy(q)), ja.gen_cache(_J(q))
        assert tuple(tc.k.shape) == (2, 0, 4, 8)
        for i in range(2):
            x = q[:, i:i + 1]
            tout, tc = ta(torch.from_numpy(x), cache=tc)
            jout, jc = ja(_J(x), cache=jc)
            _close(tout, jout)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
        # the StaticCache: cross attention over projected memory
        ts = ta.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem),
                          type=tnn.MultiHeadAttention.StaticCache)
        js = ja.gen_cache(_J(mem), _J(mem),
                          type=jnn.MultiHeadAttention.StaticCache)
        _close(ts.k, js.k)
        out = ta(torch.from_numpy(q), cache=ts)
        assert isinstance(out, torch.Tensor)
        _close(out, ja(_J(q), cache=js))


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_encoder_and_decoder_layers_match_jax(normalize_before, activation):
    kw = dict(dropout=0.1, activation=activation,
              normalize_before=normalize_before)
    paddle.seed(2)
    jenc, tenc = _bridge(
        jnn.TransformerEncoder(jnn.TransformerEncoderLayer(32, 4, 64, **kw),
                               2),
        tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
            32, 4, 64, device="cpu", **kw), 2))
    jdec, tdec = _bridge(
        jnn.TransformerDecoderLayer(32, 4, 64, **kw),
        tnn.TransformerDecoderLayer(32, 4, 64, device="cpu", **kw))
    rng = np.random.default_rng(2)
    src, tgt, m = _x(rng), _x(rng, s=4), _mask(rng)
    with torch.no_grad():
        mem = tenc(torch.from_numpy(src), torch.from_numpy(m))
        jmem = jenc(_J(src), _J(m))
        _close(mem, jmem)
        causal = tnn.Transformer.generate_square_subsequent_mask(4, "cpu")
        jcausal = jnn.Transformer.generate_square_subsequent_mask(4)
        np.testing.assert_array_equal(causal.numpy(), _np(jcausal))
        _close(tdec(torch.from_numpy(tgt), mem, causal,
                    torch.from_numpy(m)),
               jdec(_J(tgt), jmem, jcausal, _J(m)))
        # incremental decoding: the self-attention Cache and the cross
        # StaticCache, one token at a time
        tcache, jcache = tdec.gen_cache(mem), jdec.gen_cache(jmem)
        for i in range(2):
            tout, tcache = tdec(torch.from_numpy(tgt[:, i:i + 1]), mem,
                                cache=tcache)
            jout, jcache = jdec(_J(tgt[:, i:i + 1]), jmem, cache=jcache)
            _close(tout, jout)
        # the encoder with caches
        tout, _ = tenc(torch.from_numpy(src), cache=tenc.gen_cache(
            torch.from_numpy(src)))
        jout, _ = jenc(_J(src), cache=jenc.gen_cache(_J(src)))
        _close(tout, jout)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_matches_jax(normalize_before):
    paddle.seed(3)
    jt, tt = _bridge(
        jnn.Transformer(32, 4, 2, 2, 64, normalize_before=normalize_before),
        tnn.Transformer(32, 4, 2, 2, 64, normalize_before=normalize_before,
                        device="cpu"))
    rng = np.random.default_rng(3)
    src, tgt = _x(rng), _x(rng, s=5)
    causal = tnn.Transformer.generate_square_subsequent_mask(5, "cpu")
    with torch.no_grad():
        _close(tt(torch.from_numpy(src), torch.from_numpy(tgt),
                  tgt_mask=causal),
               jt(_J(src), _J(tgt), tgt_mask=_J(causal.numpy())),
               atol=2e-5)


@pytest.mark.parametrize("custom", ["encoder", "decoder", "both"])
def test_transformer_keeps_custom_stacks(custom):
    """A ``custom_encoder``/``custom_decoder`` is kept as the caller gave
    it: the same module, its bridged weights bit for bit.  Only the
    stack ``Transformer`` builds is bridged afterwards, so the output
    against the JAX ``Transformer`` on the same custom stacks shows
    the custom weights too."""
    paddle.seed(5)
    jenc, tenc = _bridge(
        jnn.TransformerEncoder(jnn.TransformerEncoderLayer(32, 4, 64), 2),
        tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
            32, 4, 64, device="cpu"), 2))
    jdec, tdec = _bridge(
        jnn.TransformerDecoder(jnn.TransformerDecoderLayer(32, 4, 64), 2),
        tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
            32, 4, 64, device="cpu"), 2))
    jkw, tkw = {}, {}
    if custom in ("encoder", "both"):
        jkw["custom_encoder"], tkw["custom_encoder"] = jenc, tenc
    if custom in ("decoder", "both"):
        jkw["custom_decoder"], tkw["custom_decoder"] = jdec, tdec
    given = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
             for k, m in tkw.items()}
    jt = jnn.Transformer(32, 4, 2, 2, 64, **jkw)
    tt = tnn.Transformer(32, 4, 2, 2, 64, device="cpu", **tkw)
    jt.eval()
    tt.eval()
    for k, params in given.items():
        part = tt.encoder if k == "custom_encoder" else tt.decoder
        assert part is tkw[k]
        for n, p in part.named_parameters():
            assert torch.equal(p, params[n]), n
    for k in ("encoder", "decoder"):
        if f"custom_{k}" not in tkw:
            _bridge(getattr(jt, k), getattr(tt, k))
    rng = np.random.default_rng(5)
    src, tgt = _x(rng), _x(rng, s=5)
    causal = tnn.Transformer.generate_square_subsequent_mask(5, "cpu")
    with torch.no_grad():
        _close(tt(torch.from_numpy(src), torch.from_numpy(tgt),
                  tgt_mask=causal),
               jt(_J(src), _J(tgt), tgt_mask=_J(causal.numpy())),
               atol=2e-5)


@pytest.fixture(scope="module")
def ernie_pair():
    paddle.seed(4)
    cfg = jmodels.tiny_ernie_config()
    jm = jmodels.ErnieModel(cfg)
    tm = tmodels.ErnieModel(tiny_ernie_config(), device="cpu", init=False)
    return _bridge(jm, tm)


def _ids(rng, b=3, s=12, pad_tail=(0, 4, 7)):
    ids = rng.integers(1, 256, (b, s)).astype(np.int32)
    for i, n in enumerate(pad_tail):
        if n:
            ids[i, -n:] = 0                              # pad_token_id
    types = (np.arange(s)[None, :] >= s // 2).astype(np.int32).repeat(b, 0)
    return ids, types


def test_ernie_model_outputs_match_jax(ernie_pair):
    jm, tm = ernie_pair
    rng = np.random.default_rng(5)
    ids, types = _ids(rng)
    tseq, tpool = tm(torch.from_numpy(ids), torch.from_numpy(types))
    jseq, jpool = jm(paddle.to_tensor(ids), paddle.to_tensor(types))
    _close(tseq, jseq)
    _close(tpool, jpool)
    from paddle_tpu.models.ernie import _attention_mask_from_ids as jmask
    from paddle_tpu_torch.models.ernie import _attention_mask_from_ids
    tmk = _attention_mask_from_ids(torch.from_numpy(ids), 0, "float32")
    assert tmk.dtype == torch.float32 and tuple(tmk.shape) == (3, 1, 1, 12)
    np.testing.assert_array_equal(tmk.numpy(),
                                  _np(jmask(paddle.to_tensor(ids), 0,
                                            "float32")))
    assert float(tmk.min()) == -1e4


HEADS = {"sequence": ("ErnieForSequenceClassification", dict(num_classes=3)),
         "token": ("ErnieForTokenClassification", dict(num_classes=5)),
         "qa": ("ErnieForQuestionAnswering", {})}


@pytest.mark.parametrize("head", list(HEADS))
def test_finetune_heads_match_jax(head):
    cls, kw = HEADS[head]
    paddle.seed(6)
    jm, tm = _bridge(getattr(jmodels, cls)(jmodels.tiny_ernie_config(), **kw),
                     getattr(tmodels, cls)(tiny_ernie_config(), device="cpu",
                                           init=False, **kw))
    rng = np.random.default_rng(6)
    ids, types = _ids(rng)
    with torch.no_grad():
        if head == "qa":
            for t, j in zip(tm(torch.from_numpy(ids)),
                            jm(paddle.to_tensor(ids))):
                _close(t, j)
            return
        labels = rng.integers(0, kw["num_classes"],
                              (3,) if head == "sequence" else (3, 12))
        tl, tlog = tm(torch.from_numpy(ids), torch.from_numpy(types),
                      labels=torch.from_numpy(labels))
        jl, jlog = jm(paddle.to_tensor(ids), paddle.to_tensor(types),
                      labels=paddle.to_tensor(labels))
    _close(tlog, jlog)
    _close(tl, jl)


def test_pretraining_tie_heads_and_criterion_match_jax():
    paddle.seed(7)
    jm, tm = _bridge(jmodels.ErnieForPretraining(jmodels.tiny_ernie_config()),
                     tmodels.ErnieForPretraining(tiny_ernie_config(),
                                                 device="cpu", init=False))
    # the decoder is the word embedding itself: one tensor, registered once
    emb = tm.ernie.embeddings.word_embeddings.weight
    assert tm.cls._tied is emb
    names = [n for n, _ in tm.named_parameters()]
    assert "cls.decoder_bias" in names and not any(
        n.startswith("cls.decoder.") for n in names)
    assert set(names) == {n for n, _ in jm.named_parameters()}
    rng = np.random.default_rng(7)
    ids, types = _ids(rng)
    tps, tsr = tm(torch.from_numpy(ids), torch.from_numpy(types))
    jps, jsr = jm(paddle.to_tensor(ids), paddle.to_tensor(types))
    np.testing.assert_allclose(tps.detach().numpy(), _np(jps), atol=ATOL,
                               rtol=1e-5)
    _close(tsr, jsr)
    mlm = np.full((3, 12), -100, np.int64)
    mlm[:, 2:5] = rng.integers(0, 256, (3, 3))
    nsp = rng.integers(0, 2, (3,))
    tcrit = tmodels.ErniePretrainingCriterion(256)
    jcrit = jmodels.ErniePretrainingCriterion(256)
    for labels in ((mlm,), (mlm, nsp)):
        tl = tcrit(tps, tsr, *(torch.from_numpy(a) for a in labels))
        jl = jcrit(jps, jsr, *(paddle.to_tensor(a) for a in labels))
        _close(tl, jl)
    # a step through the tie moves the embedding the decoder reads
    tl.backward()
    assert emb.grad is not None and tm.cls.decoder_bias.grad is not None
    with torch.no_grad():
        emb.add_(1.0)
    assert torch.equal(tm.cls._tied, emb)


def test_bert_aliases_and_configs():
    for name in ("Config", "Model", "ForSequenceClassification",
                 "ForTokenClassification", "ForQuestionAnswering",
                 "ForPretraining"):
        assert getattr(tmodels, "Bert" + name) is getattr(tmodels,
                                                          "Ernie" + name)
    for fn in ("ernie_base_config", "tiny_ernie_config"):
        assert dataclasses.asdict(getattr(tmodels, fn)()) == \
            dataclasses.asdict(getattr(jmodels, fn)())
    for fn in ("gpt2_small_config", "gpt3_13b_config", "tiny_gpt_config"):
        t, j = getattr(tmodels, fn)(), getattr(jmodels, fn)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.head_dim == j.head_dim


def test_llama_3_70b_config_fields_match_jax():
    t, j = tmodels.llama_3_70b_config(), jmodels.llama_3_70b_config()
    tf = dataclasses.asdict(t)
    jf = {k: v for k, v in dataclasses.asdict(j).items() if k in tf}
    assert tf == jf
    assert (t.hidden_size, t.num_hidden_layers, t.num_attention_heads,
            t.num_key_value_heads, t.head_dim) == (8192, 80, 64, 8, 128)


def _as_port(name, arr):
    arr = np.asarray(arr)
    parts = name.split(".")
    if parts[-1] == "weight" and parts[-2] in LINEAR_NAMES:
        return arr.T
    return arr


@pytest.fixture(scope="module")
def finetuned():
    """Three TrainSteps of the sequence classifier on one batch, the
    configured dropouts on (the pad mask sends attention down the math
    path, with its probability dropout)."""
    paddle.seed(8)
    jm = jmodels.ErnieForSequenceClassification(jmodels.tiny_ernie_config())
    tm = tmodels.ErnieForSequenceClassification(tiny_ernie_config(),
                                                device="cpu", init=False)
    jm, tm = _bridge(jm, tm, train=True)
    rng = np.random.default_rng(8)
    ids, types = _ids(rng, b=4, s=16, pad_tail=(0, 3, 9, 1))
    labels = rng.integers(0, 2, (4,))
    jopt = paddle.optimizer.AdamW(learning_rate=5e-3,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01)
    topt = AdamW(learning_rate=5e-3, parameters=tm.parameters(),
                 weight_decay=0.01)
    jstep = JTrainStep(jm, lambda n, a, t, y: n(a, t, labels=y)[0], jopt)
    tstep = TrainStep(tm, lambda n, a, t, y: n(a, t, labels=y)[0], topt)
    paddle.seed(10)
    paddle_tpu_torch.seed(10)
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(jstep(paddle.to_tensor(ids), paddle.to_tensor(types),
                              paddle.to_tensor(labels))))
        tl.append(float(tstep(ids, types, labels)))
    return dict(jm=jm, tm=tm, jstep=jstep, tstep=tstep, jl=jl, tl=tl)


def test_ernie_finetune_losses_match_jax(finetuned):
    np.testing.assert_allclose(finetuned["tl"], finetuned["jl"], rtol=1e-5,
                               atol=0)
    assert len(set(finetuned["tl"])) == 3


@pytest.mark.parametrize("what", ["param", "m", "v"])
def test_ernie_finetune_parameters_and_moments_match_jax(finetuned, what):
    tparams = dict(finetuned["tm"].named_parameters())
    tindex = {n: i for i, n in enumerate(tparams)}
    jstate, tstate = finetuned["jstep"]._state, finetuned["tstep"]._state
    for i, (name, p) in enumerate(finetuned["jm"].named_parameters()):
        j = tindex[name]
        if name.endswith("k_proj.bias"):
            if what == "param":
                np.testing.assert_allclose(tparams[name].detach().numpy(),
                                           _np(p._value), atol=2 * 5e-3 * 3,
                                           rtol=0, err_msg=name)
            else:
                bound = 1e-6 if what == "m" else 1e-12
                assert np.abs(tstate[j][what].numpy()).max() < bound, name
                assert np.abs(np.asarray(jstate[i][what])).max() < bound
            continue
        if what == "param":
            np.testing.assert_allclose(tparams[name].detach().numpy(),
                                       _as_port(name, p._value), atol=1e-5,
                                       rtol=0, err_msg=name)
            continue
        want = _as_port(name, jstate[i][what])
        np.testing.assert_allclose(tstate[j][what].numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"{name} {what}")


def test_ernie_optimizer_state_bridge_round_trips(finetuned):
    """The optimizer-state bridge over ERNIE's names, both ways, from
    one eager AdamW step on the bridged weights and equal gradients."""
    paddle.seed(12)
    jm, tm = _bridge(jmodels.ErnieForPretraining(jmodels.tiny_ernie_config()),
                     tmodels.ErnieForPretraining(tiny_ernie_config(),
                                                 device="cpu", init=False))
    rng = np.random.default_rng(0)
    tparams = dict(tm.named_parameters())
    for name, p in jm.named_parameters():
        g = rng.standard_normal(p._value.shape).astype(np.float32)
        p._grad = paddle.to_tensor(np.array(g, copy=True))
        tparams[name].grad = torch.from_numpy(
            np.ascontiguousarray(_as_port(name, g)))
    jopt = paddle.optimizer.AdamW(0.01, parameters=jm.parameters())
    topt = AdamW(0.01, parameters=tm.parameters())
    jopt.step()
    topt.step()
    jnames = [n for n, _ in jm.named_parameters()]
    tnames = list(tparams)
    jstate = {k: np.asarray(v._value) for k, v in jopt.state_dict().items()}
    tstate = topt.state_dict()
    bridged = optimizer_state_from_jax(jstate, jnames, tnames)
    assert set(bridged) == set(tstate)
    for k, v in tstate.items():
        np.testing.assert_allclose(bridged[k].numpy(), v.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    back = optimizer_state_to_jax(bridged, tnames, jnames)
    for k, v in jstate.items():
        assert np.array_equal(back[k], v), k
