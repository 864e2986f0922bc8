"""Token streaming out of the port's serving engine, held against the
JAX package's (``tests/test_streaming.py``, case for case):
``submit(stream=True)`` returns a ``TokenStream`` whose flushes land at
the dispatch-ahead harvest points, token for token the non-streamed
output, with no new forced-sync reason.

The same trace runs through both packages on the same weights (the
weight bridge): the flush boundaries, the dispatch and sync counters
are equal, and the tokens equal the JAX engine's up to each request's
first non-decisive position (teacher-forced top-2 margin <= 0.01)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import serving as jserving
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama_state_from_jax)
from paddle_tpu_torch.observability import MetricsRegistry

P, C, BL = 8, 40, 4
MARGIN = 0.01
SHARED = ("async_syncs", "async_harvests", "block_dispatches",
          "prefill_chunks", "decode_steps", "dispatched_tokens")


@pytest.fixture(scope="module")
def nets():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(1234)
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=1, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
    jnet = jmodels.LlamaForCausalLM(jmodels.LlamaConfig(**kw))
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(LlamaConfig(**kw), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    yield jnet, tnet
    torch.set_num_threads(prev)


def _mk(side, net):
    if side == "jax":
        return jserving.ServingEngine(
            net, num_slots=2, prompt_len=P, max_cache_len=C,
            steps_per_call=1, block_len=BL, chunk_len=4, num_blocks=12,
            compute_dtype="float32", registry=JaxRegistry())
    return tserving.ServingEngine(
        net, num_slots=2, prompt_len=P, max_cache_len=C, steps_per_call=1,
        block_len=BL, chunk_len=4, num_blocks=12, compute_dtype="float32",
        registry=MetricsRegistry(), device="cpu")


def _decisive(jnet, ids, out):
    """Positions of ``out`` (the JAX tokens after prompt ``ids``) before
    the first one whose teacher-forced top-2 margin is <= MARGIN."""
    s = np.concatenate([ids, out[:-1]])[None].astype(np.int32)
    lg = np.asarray(jnet(paddle.to_tensor(s))._value)[0]
    lg = lg[len(ids) - 1:len(ids) - 1 + len(out)]
    top2 = np.sort(lg, axis=-1)[:, -2:]
    close = np.flatnonzero(top2[:, 1] - top2[:, 0] <= MARGIN)
    return int(close[0]) if close.size else len(out)


def _combined(side, net, ids_a, ids_b):
    """Engine 1: streamed A beside plain B, the stream read after every
    step; engine 2: the same trace with nothing streamed."""
    e1 = _mk(side, net)
    mod = jserving if side == "jax" else tserving
    st = e1.submit(ids_a, max_new_tokens=6, stream=True, arrival_time=0.0)
    assert isinstance(st, mod.TokenStream)
    assert st.request.state == "queued" and not st.finished
    rb = e1.submit(ids_b, max_new_tokens=5, arrival_time=0.0)
    flushes, steps = [], 0
    while not (st.finished and rb.state in mod.TERMINAL_STATES):
        e1.step(now=0.0)
        e1._pool.check()
        chunk = st.read()
        flushes.append(chunk)
        steps += 1
        assert steps < 60
    tail = st.read()
    flushes.append(tail)
    e2 = _mk(side, net)
    ra2 = e2.submit(ids_a, max_new_tokens=6)
    rb2 = e2.submit(ids_b, max_new_tokens=5)
    e2.run()
    return dict(st=st, rb=rb, ra2=ra2, rb2=rb2, e1=e1, e2=e2,
                flushes=[f.tolist() for f in flushes])


@pytest.fixture(scope="module")
def traced(nets):
    jnet, tnet = nets
    rng = np.random.default_rng(7)
    ids_a = rng.integers(0, 128, (7,)).astype(np.int32)
    ids_b = rng.integers(0, 128, (6,)).astype(np.int32)
    return (ids_a, ids_b, _combined("jax", jnet, ids_a, ids_b),
            _combined("port", tnet, ids_a, ids_b))


def test_stream_vocabulary_closed():
    # streaming adds no sync reason: the closed vocabulary is the JAX
    # package's, unchanged
    assert tserving.ASYNC_SYNC_REASONS == jserving.ASYNC_SYNC_REASONS == (
        "eos", "budget", "mask", "penalty", "spec", "chunk_final",
        "resume", "preempt", "cancel", "drain")


def test_stream_token_exact_and_incremental(nets, traced):
    jnet, _ = nets
    ids_a, ids_b, j, t = traced
    streamed = np.concatenate([np.asarray(f, np.int32)
                               for f in t["flushes"]])
    # stream == non-streamed submit(), co-resident and on a twin engine
    assert np.array_equal(streamed, t["st"].request.output)
    assert np.array_equal(streamed, t["ra2"].output)
    assert np.array_equal(t["rb"].output, t["rb2"].output)
    nonempty = [f for f in t["flushes"] if f]
    assert len(nonempty) >= 3
    assert max(len(f) for f in nonempty) < streamed.size
    assert t["st"].n_read == streamed.size == 6
    assert t["st"].read().size == 0
    # the flush boundaries are the JAX engine's, step for step
    assert [len(f) for f in t["flushes"]] == [len(f) for f in j["flushes"]]
    # tokens: the JAX engine's at every decisive position
    for ids, jr, tr in ((ids_a, j["ra2"], t["ra2"]),
                        (ids_b, j["rb2"], t["rb2"])):
        upto = _decisive(jnet, ids, np.asarray(jr.output))
        assert upto >= 1
        np.testing.assert_array_equal(tr.output[:upto], jr.output[:upto])
    # streaming changed nothing about scheduling: the streamed and
    # unstreamed engines harvested and force-synced identically, and as
    # the JAX engines did
    s1, s2 = t["e1"].stats(), t["e2"].stats()
    js1 = j["e1"].stats()
    for k in SHARED:
        assert s1[k] == s2[k] == js1[k], k
    assert s1["async_syncs_by_reason"] == s2["async_syncs_by_reason"] \
        == js1["async_syncs_by_reason"]
    assert s1["async_harvests"] > 0


def test_stream_iterator_protocol(nets):
    """``for chunk in stream`` drives the engine itself and yields every
    token exactly once, pad tail included; its chunks are the JAX
    stream's."""
    jnet, tnet = nets
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 128, (6,)).astype(np.int32)
    out = {}
    for side, net in (("jax", jnet), ("port", tnet)):
        eng = _mk(side, net)
        st = eng.submit(ids, max_new_tokens=5, stream=True)
        chunks = list(st)
        assert all(c.size for c in chunks)
        assert st.finished and st.request.state == "finished"
        out[side] = chunks
    assert [c.size for c in out["port"]] == [c.size for c in out["jax"]]
    got = np.concatenate(out["port"])
    ref = np.concatenate(out["jax"])
    upto = _decisive(jnet, ids, ref)
    np.testing.assert_array_equal(got[:upto], ref[:upto])
    # and the port's own dense generate() agrees with its stream
    gen = tnet.generate(ids[None], max_new_tokens=5, max_cache_len=C,
                        compute_dtype="float32")
    assert np.array_equal(got, np.asarray(gen)[0])
