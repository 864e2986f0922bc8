"""The port's ServingEngine held against itself and against the JAX
engine on one mixed trace (module-scoped: both engines run it once).

The trace is the JAX serving test's mixed-length specs plus a shared-
prefix pair whose second request queues behind the first, so it is
admitted after the first's full prompt blocks are published and its
leading block is a digest-cache hit.  Both engines serve it in float32
on the same weights (the JAX model's, carried by the weight bridge):

- the port's tokens equal a fresh 1-slot port engine's, request by
  request (slot reuse and batching never change a token);
- the port's tokens equal the JAX engine's up to each request's first
  non-decisive position (top-2 margin of the teacher-forced JAX logits
  <= 0.01, where float32 summation order may flip an argmax), and at
  least 80% of all positions are compared;
- the scheduling decisions are identical: finish order, prefills,
  decode steps, block dispatches, peak queue and prefix hit rate.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)

P, C, BLK, CHUNK = 6, 32, 4, 4
SPECS = [(4, 7), (6, 2), (3, 7), (5, 2), (2, 7)]
MARGIN = 0.01


def _engine_kw():
    return dict(prompt_len=P, max_cache_len=C, steps_per_call=3,
                block_len=BLK, chunk_len=CHUNK, compute_dtype="float32")


def _trace(vocab):
    """(prompt, max_new) list: the shared-prefix pair's first request,
    the mixed specs, then the pair's second request (5 shared tokens:
    one full block plus one)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, (5,)).astype(np.int32)
    first = np.concatenate([shared, rng.integers(0, vocab, (1,))])
    second = np.concatenate([shared, rng.integers(0, vocab, (1,))])
    reqs = [(first.astype(np.int32), 5)]
    reqs += [(rng.integers(0, vocab, (n,)).astype(np.int32), m)
             for n, m in SPECS]
    reqs.append((second.astype(np.int32), 4))
    return reqs


def _serve(engine, trace):
    handles = [engine.submit(ids, max_new_tokens=m) for ids, m in trace]
    engine.run()
    return handles


def _margins(jnet, trace, outs):
    """Top-2 margin of the teacher-forced JAX logits at every output
    position: one batched causal forward over prompt + output[:-1],
    right-padded to one length (padding after a position cannot reach
    it)."""
    width = max(len(ids) + len(o) - 1 for (ids, _), o in zip(trace, outs))
    seqs = np.zeros((len(trace), width), np.int32)
    for i, ((ids, _), o) in enumerate(zip(trace, outs)):
        s = np.concatenate([ids, o[:-1]])
        seqs[i, :len(s)] = s
    logits = np.asarray(jnet(paddle.to_tensor(seqs))._value)
    out = []
    for i, ((ids, _), o) in enumerate(zip(trace, outs)):
        lg = logits[i, len(ids) - 1:len(ids) - 1 + len(o)]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        out.append(top2[:, 1] - top2[:, 0])
    return out


@pytest.fixture(scope="module")
def served():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(2024)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    trace = _trace(tiny_llama_config().vocab_size)

    teng = ServingEngine(tnet, num_slots=2, device="cpu", **_engine_kw())
    treqs = _serve(teng, trace)
    alone = []
    for ids, m in trace:
        one = ServingEngine(tnet, num_slots=1, device="cpu", **_engine_kw())
        alone.append(_serve(one, [(ids, m)])[0].output)
    jeng = JaxEngine(jnet, num_slots=2, async_dispatch=False,
                     prefix_cache_mode="digest", enable_preemption=False,
                     **_engine_kw())
    jreqs = _serve(jeng, trace)
    jouts = [r.output for r in jreqs]
    yield dict(trace=trace, teng=teng, treqs=treqs, alone=alone, jeng=jeng,
               jreqs=jreqs, margins=_margins(jnet, trace, jouts))
    torch.set_num_threads(prev)


def test_port_tokens_equal_fresh_single_slot_engine(served):
    for i, (req, want) in enumerate(zip(served["treqs"], served["alone"])):
        assert req.output.shape == (req.max_new_tokens,)
        np.testing.assert_array_equal(req.output, want, err_msg=f"req {i}")


def test_port_tokens_equal_jax_at_decisive_positions(served):
    compared = total = 0
    for treq, jreq, margin in zip(served["treqs"], served["jreqs"],
                                  served["margins"]):
        total += len(margin)
        undecided = np.flatnonzero(margin <= MARGIN)
        upto = int(undecided[0]) if undecided.size else len(margin)
        np.testing.assert_array_equal(treq.output[:upto],
                                      jreq.output[:upto])
        compared += upto
    assert compared >= 0.8 * total, (compared, total)


def test_scheduling_identical_to_jax_engine(served):
    teng, jeng = served["teng"], served["jeng"]
    ts, js = teng.stats(), jeng.stats()
    assert [r.request_id for r in teng._finished] == \
        [r.request_id for r in jeng._finished]
    for key in ("finished", "prefills", "decode_steps", "block_dispatches",
                "peak_queue", "prefix_hit_rate", "prefix_hits",
                "peak_blocks_in_use", "mean_slot_occupancy",
                "kv_bytes_swept"):
        assert ts[key] == js[key], key
    assert ts["prefix_hits"] > 0 and js["prefix_hits"] > 0
    assert ts["finished"] == len(served["trace"])
    assert teng.engine_spec() == jeng.engine_spec()


@pytest.mark.parametrize("kw", [
    {"do_sample": True},
    # int8 KV and int8/int4 weights are ported; what stays unported there
    # is a float KV dtype other than compute_dtype and quantized weights
    # on a tensor-parallel mesh
    {"kv_cache_dtype": "bfloat16"}, {"weight_dtype": "int8",
                                     "mesh": object()},
    {"mesh": object()}, {"role": "prefill"}, {"adapter_store": object()},
    {"host_cache_blocks": 8}, {"fault_injector": object()},
    {"async_dispatch": True}, {"async_depth": 2},
    {"prefix_cache_mode": "radix"}, {"enable_preemption": True},
    {"cache_dtype": "bfloat16"},
], ids=lambda kw: next(iter(kw)))
def test_unported_engine_features_raise(kw):
    net = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        ServingEngine(net, num_slots=1, prompt_len=4, max_cache_len=8,
                      compute_dtype="float32", device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    {"sampling": object()}, {"adapter": "a"},
    {"stream": True}, {"tenant": "t"}, {"max_queue_delay_s": 1.0},
], ids=lambda kw: next(iter(kw)))
def test_unported_submit_features_raise(kw):
    net = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    eng = ServingEngine(net, num_slots=1, prompt_len=4, max_cache_len=8,
                        compute_dtype="float32", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        eng.submit(np.zeros((3,), np.int32), **kw)


def test_submit_guards():
    net = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    eng = ServingEngine(net, num_slots=1, prompt_len=4, max_cache_len=8,
                        compute_dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="prompt"):
        eng.submit(np.zeros((5,), np.int32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.zeros((4,), np.int32), max_new_tokens=0)
    with pytest.raises(ValueError, match="blocks"):
        eng.submit(np.zeros((4,), np.int32), max_new_tokens=100)
    with pytest.raises(ValueError, match="seq_len"):
        eng.submit(np.zeros((4,), np.int32), seq_len=9)
