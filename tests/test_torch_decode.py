"""The port's ``nn.BeamSearchDecoder`` and ``dynamic_decode`` held against
the JAX package's on the CPU (the reference's
``tests/test_beam_search.py:160-260``), and the slice as a whole: the
Llama-architecture decoder that ``chip_smoke.py`` phase 8b runs on the
card, written against the port's public API (``api_decoder_class``),
held against the same decoder written against the JAX package, with the
weights carried by ``models.layer_state_from_jax``.

- ``gather_tree``'s manual backtrace; ``tile_beam_merge_with_batch``;
- beam search over a toy cell: every beam size, an end token never
  emitted and one emitted at once (the early exit), a nest of states;
  ids, final scores, finished flags and lengths equal the reference's;
- a greedy ``Decoder`` subclass under ``impute_finished``,
  ``output_time_major`` and ``return_length``;
- the slice: prefill logits (float32) within ``1e-5`` of the largest;
  ``dynamic_decode`` beam ids, parents and lengths equal, scores within
  ``1e-5``; ``beam_size=1`` equal to a greedy argmax loop.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.nn import initializer as JI
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import layer_state_from_jax

REL = 1e-5


def _smoke():
    """``chip_smoke.py`` by path (the decoder its phase 8b runs)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_nn_api", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    if hasattr(t, "_value"):
        return np.asarray(t._value)
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t)


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def test_gather_tree_manual_backtrace():
    ids = np.array([[[2, 5]], [[6, 3]], [[1, 9]]], np.int64)
    parents = np.array([[[0, 0]], [[1, 0]], [[0, 1]]], np.int64)
    got = tnn.functional.gather_tree(torch.from_numpy(ids),
                                     torch.from_numpy(parents))
    want = np.array([[[5, 2]], [[6, 3]], [[1, 9]]], np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("beam", [1, 2, 3])
def test_tile_beam_merge_with_batch_matches_jax(beam):
    x = np.arange(12, dtype=np.float32).reshape(2, 3, 2)
    want = jnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        paddle.to_tensor(x), beam)
    got = tnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        torch.from_numpy(x), beam)
    np.testing.assert_array_equal(got.numpy(), _np(want))


# ---- the toy cell of the reference's test ----

def _toy_arrays(vocab, hidden, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(vocab, hidden)).astype(np.float32),
            rng.normal(size=(hidden, vocab)).astype(np.float32))


class _JToy(jnn.Layer):
    """h' = tanh(h + E[token]); logits = h' @ W; states a nest
    ``{"aux": (2 h, count), "h": h}`` when ``nest`` (keys in sorted order:
    JAX flattens a dict by sorted keys, torch by insertion)."""

    def __init__(self, emb, w, nest=False):
        super().__init__()
        self.emb, self.w, self.nest = jnp.asarray(emb), jnp.asarray(w), nest

    def forward(self, inputs, states):
        h = (states["h"] if self.nest else states)._value
        h2 = jnp.tanh(h + self.emb[inputs._value.astype(jnp.int32)])
        out = paddle.to_tensor(h2 @ self.w)
        if not self.nest:
            return out, paddle.to_tensor(h2)
        cnt = states["aux"][1]._value + 1
        return out, {"aux": (paddle.to_tensor(h2 * 2), paddle.to_tensor(cnt)),
                     "h": paddle.to_tensor(h2)}


class _TToy(tnn.Layer):
    def __init__(self, emb, w, nest=False):
        super().__init__()
        self.emb, self.w = torch.from_numpy(emb), torch.from_numpy(w)
        self.nest = nest

    def forward(self, inputs, states):
        h = states["h"] if self.nest else states
        h2 = torch.tanh(h + self.emb[inputs.long()])
        out = h2 @ self.w
        if not self.nest:
            return out, h2
        return out, {"aux": (h2 * 2, states["aux"][1] + 1), "h": h2}


def _toy_inits(h0, nest, pkg):
    wrap = paddle.to_tensor if pkg is paddle else torch.from_numpy
    if not nest:
        return wrap(h0)
    return {"aux": (wrap(h0 * 2), wrap(np.zeros(h0.shape[0], np.int32))),
            "h": wrap(h0)}


@pytest.mark.parametrize("nest", [False, True])
@pytest.mark.parametrize("beam,end", [(1, None), (3, None), (5, None),
                                      (3, "first"), (4, -1)])
def test_beam_search_over_a_toy_cell_matches_jax(beam, end, nest):
    vocab, hidden, b, steps = 11, 7, 2, 5
    emb, w = _toy_arrays(vocab, hidden, 4)
    h0 = np.random.default_rng(5).normal(size=(b, hidden)).astype(
        np.float32)
    if end is None:
        end = vocab + 5                     # never emitted
    elif end == "first":                    # row 0's first greedy token
        end = int(np.argmax(np.tanh(h0[0] + emb[1]) @ w))
    runs = []
    for pkg, nn_, cell in ((paddle, jnn, _JToy(emb, w, nest)),
                           (torch, tnn, _TToy(emb, w, nest))):
        dec = nn_.BeamSearchDecoder(cell, start_token=1, end_token=end,
                                    beam_size=beam)
        outs, final, lens = nn_.dynamic_decode(
            dec, inits=_toy_inits(h0, nest, pkg), max_step_num=steps - 1,
            return_length=True)
        runs.append((outs, final, lens))
    (jo, jf, jl), (to, tf, tl) = runs
    np.testing.assert_array_equal(_np(to), _np(jo))
    assert _np(to).shape[0] == b and _np(to).shape[2] == beam
    _close(_np(tf.log_probs), _np(jf.log_probs), what="scores")
    np.testing.assert_array_equal(_np(tf.finished), _np(jf.finished))
    np.testing.assert_array_equal(_np(tf.lengths), _np(jf.lengths))
    np.testing.assert_array_equal(_np(tl), _np(jl))
    jleaves = jax_leaves(jf.cell_states)
    tleaves = torch.utils._pytree.tree_leaves(tf.cell_states)
    assert len(jleaves) == len(tleaves)
    for a, c in zip(tleaves, jleaves):
        _close(_np(a), _np(c), what="cell states")


def jax_leaves(nest):
    import jax
    from paddle_tpu.core.tensor import Tensor
    return jax.tree_util.tree_leaves(
        nest, is_leaf=lambda x: isinstance(x, Tensor))


def test_dynamic_decode_stops_on_end_token():
    vocab, hidden = 9, 5
    emb, w = _toy_arrays(vocab, hidden, 6)
    h0 = np.zeros((1, hidden), np.float32)
    end = int(np.argmax(np.tanh(h0 + emb[1]) @ w))
    dec = tnn.BeamSearchDecoder(_TToy(emb, w), start_token=1,
                                end_token=end, beam_size=1)
    outs, _, lens = tnn.dynamic_decode(dec, inits=torch.from_numpy(h0),
                                       max_step_num=50, return_length=True)
    assert outs.shape[1] < 50 and int(outs[0, 0, 0]) == end
    jdec = jnn.BeamSearchDecoder(_JToy(emb, w), start_token=1,
                                 end_token=end, beam_size=1)
    jouts, _, jlens = jnn.dynamic_decode(jdec, inits=paddle.to_tensor(h0),
                                         max_step_num=50, return_length=True)
    np.testing.assert_array_equal(outs.numpy(), _np(jouts))
    np.testing.assert_array_equal(lens.numpy(), _np(jlens))  # the end counts


# ---- a greedy Decoder subclass (the non-beam path) ----

def _greedy_decoder(nn_, pkg, emb, w, end):
    class Greedy(nn_.Decoder):
        def initialize(self, inits):
            h = inits
            b = h.shape[0]
            if pkg is paddle:
                tok = paddle.to_tensor(np.ones(b, np.int32))
                done = paddle.to_tensor(np.zeros(b, bool))
            else:
                tok = torch.ones(b, dtype=torch.int32)
                done = torch.zeros(b, dtype=torch.bool)
            return tok, h, done

        def step(self, time, inputs, states, **kwargs):
            if pkg is paddle:
                h2 = jnp.tanh(states._value + jnp.asarray(emb)[
                    inputs._value.astype(jnp.int32)])
                tok = jnp.argmax(h2 @ jnp.asarray(w), axis=-1).astype(
                    jnp.int32)
                return (paddle.to_tensor(tok), paddle.to_tensor(h2),
                        paddle.to_tensor(tok), paddle.to_tensor(tok == end))
            h2 = torch.tanh(states + torch.from_numpy(emb)[inputs.long()])
            tok = torch.argmax(h2 @ torch.from_numpy(w), dim=-1).to(
                torch.int32)
            return tok, h2, tok, tok == end

    return Greedy()


@pytest.mark.parametrize("impute", [False, True])
@pytest.mark.parametrize("time_major", [False, True])
def test_greedy_decoder_impute_time_major_lengths_match_jax(impute,
                                                            time_major):
    vocab, hidden, b = 13, 6, 4
    emb, w = _toy_arrays(vocab, hidden, 8)
    h0 = np.random.default_rng(9).normal(size=(b, hidden)).astype(
        np.float32)
    first = np.argmax(np.tanh(h0 + emb[1]) @ w, axis=-1)
    end = int(first[1])                      # row 1 finishes at once
    runs = []
    for pkg, nn_ in ((paddle, jnn), (torch, tnn)):
        wrap = paddle.to_tensor if pkg is paddle else torch.from_numpy
        runs.append(nn_.dynamic_decode(
            _greedy_decoder(nn_, pkg, emb, w, end), inits=wrap(h0),
            max_step_num=6, output_time_major=time_major,
            impute_finished=impute, return_length=True))
    (jo, js, jl), (to, ts, tl) = runs
    np.testing.assert_array_equal(_np(to), _np(jo))
    _close(_np(ts), _np(js), what="final states")
    np.testing.assert_array_equal(_np(tl), _np(jl))
    assert _np(tl)[1] == 1


# ---- the slice: a decoder written against each package's API ----

SLICE = dict(vocab=96, hidden=32, heads=4, kv_heads=2, ffn=48, layers=2,
             max_seq=40, base=500000.0, eps=1e-5)


def _jax_decoder(cfg):
    """The decoder of ``chip_smoke.api_decoder_class`` written against
    the JAX package."""
    normal = jnn.ParamAttr(initializer=JI.Normal(0.0, 0.02))

    def unit(layer, n):
        return layer.create_parameter([n],
                                      default_initializer=JI.Constant(1.0))

    class Block(jnn.Layer):
        def __init__(self):
            super().__init__()
            h, d = cfg["hidden"], cfg["hidden"] // cfg["heads"]
            self.heads, self.kv_heads, self.d = cfg["heads"], \
                cfg["kv_heads"], d
            self.ln1, self.ln2 = unit(self, h), unit(self, h)
            self.wq = self.create_parameter([h, self.heads * d], normal)
            self.wk = self.create_parameter([h, self.kv_heads * d], normal)
            self.wv = self.create_parameter([h, self.kv_heads * d], normal)
            self.wo = self.create_parameter([self.heads * d, h], normal)
            self.w_gate_up = self.create_parameter([h, 2 * cfg["ffn"]],
                                                   normal)
            self.w_down = self.create_parameter([cfg["ffn"], h], normal)

        def qkv(self, x):
            b, s = x.shape[:2]
            h = JIF.fused_rms_norm(x, self.ln1, epsilon=cfg["eps"])
            q = paddle.reshape(JIF.fused_linear(h, self.wq),
                               [b, s, self.heads, self.d])
            k = paddle.reshape(JIF.fused_linear(h, self.wk),
                               [b, s, self.kv_heads, self.d])
            v = paddle.reshape(JIF.fused_linear(h, self.wv),
                               [b, s, self.kv_heads, self.d])
            q, k = JIF.fused_rotary_position_embedding(
                q, k, use_neox_rotary_style=False,
                rotary_emb_base=cfg["base"])
            return q, k, v

        def mlp(self, x):
            h = JIF.fused_rms_norm(x, self.ln2, epsilon=cfg["eps"])
            return x + JIF.fused_linear(
                JIF.swiglu(JIF.fused_linear(h, self.w_gate_up)), self.w_down)

        def forward(self, x):
            b, s = x.shape[:2]
            q, k, v = self.qkv(x)
            a = JIF.memory_efficient_attention(q, k, v)
            x = x + JIF.fused_linear(paddle.reshape(a, [b, s, -1]), self.wo)
            return self.mlp(x), k, v

        def decode(self, x, cache, lens, sin, cos):
            n = x.shape[0]
            g = self.heads // self.kv_heads
            h = JIF.fused_rms_norm(x, self.ln1, epsilon=cfg["eps"])
            q = paddle.reshape(JIF.fused_linear(h, self.wq),
                               [n, 1, self.heads, self.d])
            k = paddle.reshape(JIF.fused_linear(h, self.wk),
                               [n, 1, self.kv_heads, self.d])
            v = paddle.reshape(JIF.fused_linear(h, self.wv),
                               [n, self.kv_heads, self.d])
            q, k = JIF.fused_rotary_position_embedding(
                q, k, sin=sin, cos=cos,
                position_ids=paddle.reshape(lens, [n, 1]),
                use_neox_rotary_style=False)
            k = paddle.repeat_interleave(
                paddle.reshape(k, [n, self.kv_heads, self.d]), g, axis=1)
            v = paddle.repeat_interleave(v, g, axis=1)
            packed = paddle.concat([paddle.reshape(t, [n, -1])
                                    for t in (q, k, v)], axis=-1)
            out, new = JIF.masked_multihead_attention(
                packed, paddle.transpose(cache, [1, 0, 2, 3, 4]),
                sequence_lengths=lens)
            x = x + JIF.fused_linear(out, self.wo)
            return self.mlp(x), paddle.transpose(new, [1, 0, 2, 3, 4])

    class Decoder(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = self.create_parameter([cfg["vocab"], cfg["hidden"]],
                                               normal)
            self.blocks = jnn.LayerList([Block()
                                         for _ in range(cfg["layers"])])
            self.norm = unit(self, cfg["hidden"])
            self.lm_head = self.create_parameter(
                [cfg["hidden"], cfg["vocab"]], normal)

        def logits(self, x):
            return JIF.fused_linear(
                JIF.fused_rms_norm(x, self.norm, epsilon=cfg["eps"]),
                self.lm_head)

        def forward(self, ids):
            x = jnn.functional.embedding(ids, self.embed)
            kv = []
            for blk in self.blocks:
                x, k, v = blk(x)
                kv.append((k, v))
            return self.logits(x), kv

        def caches(self, kv):
            out = []
            for blk, (k, v) in zip(self.blocks, kv):
                b, s, hkv, d = k.shape
                g = blk.heads // hkv
                c = jnp.zeros((b, 2, blk.heads, cfg["max_seq"], d),
                              jnp.float32)
                for i, t in enumerate((k, v)):
                    rep = jnp.swapaxes(jnp.repeat(t._value, g, axis=2), 1, 2)
                    c = c.at[:, i, :, :s].set(rep)
                out.append(paddle.to_tensor(c))
            b, s = kv[0][0].shape[:2]
            return (*out, paddle.to_tensor(np.full(b, s, np.int64)))

        def tables(self):
            d = cfg["hidden"] // cfg["heads"]
            exps = (jnp.arange(d, dtype=jnp.float32) // 2) * 2.0 / d
            inv = 1.0 / (cfg["base"] ** exps)
            emb = jnp.outer(jnp.arange(cfg["max_seq"], dtype=jnp.float32),
                            inv)[None, :, None, :]
            return paddle.to_tensor(jnp.sin(emb)), \
                paddle.to_tensor(jnp.cos(emb))

        def step(self, ids, states):
            *caches, lens = states
            sin, cos = self.tables()
            x = jnn.functional.embedding(ids, self.embed)
            new = []
            for blk, cache in zip(self.blocks, caches):
                x, c = blk.decode(x, cache, lens, sin, cos)
                new.append(c)
            return self.logits(x), (*new, lens + 1)

    return Decoder()


@pytest.fixture(scope="module")
def slice_models():
    prev = tdevice._layer_device
    pt.set_device("cpu")
    try:
        tmodel = _smoke().api_decoder_class()(
            SLICE["vocab"], SLICE["hidden"], SLICE["heads"],
            SLICE["kv_heads"], SLICE["ffn"], SLICE["layers"],
            SLICE["max_seq"], SLICE["base"], SLICE["eps"], "float32")
    finally:
        tdevice._layer_device = prev
    jmodel = _jax_decoder(SLICE)
    arrays = {n: np.asarray(p._value) for n, p in jmodel.named_parameters()}
    missing, unexpected = tmodel.set_state_dict(
        layer_state_from_jax(arrays, tmodel))
    assert not missing and not unexpected, (missing, unexpected)
    ids = np.random.default_rng(3).integers(0, 90, (2, 12))
    return jmodel, tmodel, ids


def test_slice_prefill_logits_match_jax(slice_models):
    jmodel, tmodel, ids = slice_models
    jl, _ = jmodel(paddle.to_tensor(ids))
    with torch.no_grad():
        tl, _ = tmodel(torch.from_numpy(ids))
    _close(tl.numpy(), _np(jl), what="prefill logits")


def _keep_steps(nn_):
    class KeepSteps(nn_.BeamSearchDecoder):
        def finalize(self, outputs, final_states, sequence_lengths):
            ids, states = super().finalize(outputs, final_states,
                                           sequence_lengths)
            return (ids, outputs), states

    return KeepSteps


@pytest.mark.parametrize("beam,end", [(3, 95), (2, "emitted")])
def test_slice_beam_decode_matches_jax(slice_models, beam, end):
    jmodel, tmodel, ids = slice_models
    runs = []
    for nn_, model, wrap in ((jnn, jmodel, paddle.to_tensor),
                             (tnn, tmodel, torch.from_numpy)):
        with torch.no_grad():
            _, kv = model(wrap(ids))
            states = model.caches(kv)
            if end == "emitted":   # the first greedy token of row 0
                lg, _ = model.step(wrap(np.full(2, 91, np.int32)), states)
                end = int(np.argmax(_np(lg)[0]))
            dec = _keep_steps(nn_)(model.step, 91, end, beam)
            runs.append(nn_.dynamic_decode(dec, inits=states,
                                           max_step_num=6,
                                           return_length=True))
    ((jids, jraw), jfin, jlen), ((tids, traw), tfin, tlen) = runs
    np.testing.assert_array_equal(_np(tids), _np(jids))
    np.testing.assert_array_equal(_np(traw.predicted_ids),
                                  _np(jraw.predicted_ids))
    np.testing.assert_array_equal(_np(traw.parent_ids), _np(jraw.parent_ids))
    _close(_np(traw.scores), _np(jraw.scores), what="scores")
    np.testing.assert_array_equal(_np(tfin.lengths), _np(jfin.lengths))
    np.testing.assert_array_equal(_np(tlen), _np(jlen))
    for a, c in zip(tfin.cell_states, jfin.cell_states):
        _close(_np(a), _np(c), what="caches")


def test_slice_beam_one_equals_greedy(slice_models):
    _, tmodel, ids = slice_models
    smoke = _smoke()
    with torch.no_grad():
        _, kv = tmodel(torch.from_numpy(ids))
        states = tmodel.caches(kv)
        dec = tnn.BeamSearchDecoder(tmodel.step, 91, 95, 1)
        outs, _ = tnn.dynamic_decode(dec, inits=states, max_step_num=7)
        greedy = smoke._greedy(torch, tmodel, states, 91, outs.shape[1])
    np.testing.assert_array_equal(outs[..., 0].numpy(), greedy.numpy())
