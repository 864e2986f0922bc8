"""The port's ServingEngine held against itself and against the JAX
engine on one mixed trace (module-scoped: both engines run it once).

The trace is the JAX serving test's mixed-length specs plus a shared-
prefix pair whose second request queues behind the first, so it is
admitted after the first's full prompt blocks are published and its
leading block is a digest-cache hit.  Both engines serve it in float32
on the same weights (the JAX model's, carried by the weight bridge),
both built with ``prefix_cache_mode="digest", enable_preemption=False``
(the port's defaults are now the reference's radix cache and
preemption; the fresh 1-slot port engines keep those defaults):

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
from paddle_tpu_torch.observability import MetricsRegistry as TorchRegistry
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

    teng = ServingEngine(tnet, num_slots=2, device="cpu",
                         async_dispatch=False,
                         prefix_cache_mode="digest", enable_preemption=False,
                         registry=TorchRegistry(), **_engine_kw())
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
    # int8 KV and int8/int4 weights are ported; what stays unported there
    # is a float KV dtype other than compute_dtype and quantized weights
    # on a tensor-parallel mesh.  adapter_store= and tenant_weights= (LoRA
    # and fair share) are ported: those two cases construct an engine
    # that serves
    {"kv_cache_dtype": "bfloat16"}, {"weight_dtype": "int8",
                                     "mesh": object()},
    {"mesh": object()}, {"adapter_store": "store"},
    {"tenant_weights": {"a": 1.0}}, {"cache_dtype": "bfloat16"},
], ids=lambda kw: next(iter(kw)))
def test_unported_engine_features_raise(kw):
    net = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    if "adapter_store" in kw or "tenant_weights" in kw:
        from paddle_tpu_torch.inference import AdapterStore, LoraAdapter
        reg = TorchRegistry()
        if "adapter_store" in kw:
            store = AdapterStore(net, slots=1, max_rank=2, dtype="float32",
                                 registry=reg, device="cpu")
            store.register(LoraAdapter.random(net.config, "a", rank=2,
                                              seed=1))
            kw = {"adapter_store": store}
        eng = ServingEngine(net, num_slots=1, prompt_len=4, max_cache_len=8,
                            compute_dtype="float32", device="cpu",
                            registry=reg, **kw)
        r = eng.submit(np.arange(3, dtype=np.int32), max_new_tokens=3,
                       adapter="a" if "adapter_store" in kw else None,
                       tenant="a")
        eng.run()
        assert r.state == "finished" and r.output.size == 3
        st = eng.stats()
        assert st["tenant_served_tokens"] == {"a": 6}
        assert st["lora_dispatches"] == (3 if "adapter_store" in kw else 0)
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        ServingEngine(net, num_slots=1, prompt_len=4, max_cache_len=8,
                      compute_dtype="float32", device="cpu", **kw)


@pytest.mark.parametrize("which", ["fault_injector", "registry"])
def test_observability_engine_keywords_serve(which):
    """``fault_injector=`` and ``registry=`` are ported: each constructs
    an engine that serves, the injector's armed alloc failure fires
    (and only delays admission), and a private registry holds exactly
    this engine's counts."""
    from paddle_tpu_torch.inference import FaultInjector
    net = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    fi, reg = FaultInjector(), TorchRegistry()
    kw = {"fault_injector": fi} if which == "fault_injector" \
        else {"registry": reg}
    if which == "fault_injector":
        fi.fail_allocs(2)
    eng = ServingEngine(net, num_slots=1, prompt_len=4, max_cache_len=8,
                        compute_dtype="float32", device="cpu", **kw)
    req = eng.submit(np.arange(3, dtype=np.int32), max_new_tokens=3)
    eng.run(wall_timeout_s=60)
    assert req.state == "finished" and req.output.shape == (3,)
    assert eng._pool.check()
    st = eng.stats()
    assert st["finished"] == 1
    assert st["useful_tokens"] + st["wasted_tokens"] \
        == st["dispatched_tokens"] > 0
    if which == "fault_injector":
        assert fi.events.count(("alloc_fail", None)) == 2
    else:
        assert eng.metrics_registry is reg
        assert reg.get("serving.requests_finished").value() == 1
        assert reg.get("serving.decode_steps").value() \
            == st["decode_steps"] > 0


@pytest.mark.parametrize("kw", [
    {"host_cache_blocks": 8}, {"prefix_cache_mode": "radix"},
    {"enable_preemption": True}, {"max_queue": 2},
    {"async_dispatch": True}, {"async_depth": 2}, {"async_depth": 3},
], ids=lambda kw: next(iter(kw)))
def test_overload_engine_keywords_construct(kw):
    """The keywords of preemption, the host tier, the radix cache, the
    bounded queue and the dispatch-ahead pipeline are ported: they
    construct an engine that serves."""
    net = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    eng = ServingEngine(net, num_slots=1, prompt_len=4, max_cache_len=8,
                        compute_dtype="float32", device="cpu", **kw)
    req = eng.submit(np.arange(3, dtype=np.int32), max_new_tokens=2,
                     max_queue_delay_s=5.0)
    eng.run()
    assert req.state == "finished" and req.output.shape == (2,)
    assert eng._pool.check()


@pytest.mark.parametrize("mode", ["radix", "digest"])
def test_dropped_engine_frees_its_arenas(mode):
    """The pool's and the host tier's callbacks hold the engine weakly:
    with the cyclic garbage collector off, dropping an engine that served
    (and demoted to its host tier) frees its arenas at once."""
    import gc
    import weakref
    net = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    rng = np.random.default_rng(1)
    eng = ServingEngine(net, num_slots=1, prompt_len=8, max_cache_len=16,
                        block_len=2, num_blocks=8, compute_dtype="float32",
                        device="cpu", prefix_cache_mode=mode)
    for _ in range(3):
        eng.submit(rng.integers(0, 256, (8,)).astype(np.int32),
                   max_new_tokens=4)
        eng.run()
    assert eng._pool.check()
    if mode == "radix":
        assert eng.stats()["swap_blocks_out"] > 0
    arena, engine = weakref.ref(eng._arenas[0]), weakref.ref(eng)
    was = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert engine() is None and arena() is None
    finally:
        if was:
            gc.enable()


def test_engine_defaults_are_the_reference_engines():
    """``ServingEngine()`` defaults: the radix cache, preemption on, a
    host tier of 4 x num_blocks, dispatch-ahead at depth 1."""
    net = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    eng = ServingEngine(net, num_slots=2, prompt_len=4, max_cache_len=8,
                        compute_dtype="float32", device="cpu")
    assert eng.async_dispatch is True and eng.async_depth == 1
    assert eng.prefix_cache_mode == "radix" and eng._radix is not None
    assert eng.enable_preemption and eng.max_queue is None
    assert eng._host_tier.cache_capacity == 4 * eng.num_blocks
    off = ServingEngine(net, num_slots=2, prompt_len=4, max_cache_len=8,
                        compute_dtype="float32", device="cpu",
                        enable_prefix_cache=False)
    assert off.prefix_cache_mode == "none" and off._radix is None
    with pytest.raises(ValueError, match="prefix_cache_mode"):
        ServingEngine(net, num_slots=1, prompt_len=4, max_cache_len=8,
                      compute_dtype="float32", device="cpu",
                      prefix_cache_mode="lru")
    with pytest.raises(ValueError, match="host_cache_blocks"):
        ServingEngine(net, num_slots=1, prompt_len=4, max_cache_len=8,
                      compute_dtype="float32", device="cpu",
                      host_cache_blocks=-1)
    with pytest.raises(ValueError, match="max_queue"):
        ServingEngine(net, num_slots=1, prompt_len=4, max_cache_len=8,
                      compute_dtype="float32", device="cpu", max_queue=0)


@pytest.mark.parametrize("kw", [
    {"adapter": "a"}, {"tenant": "t"},
], ids=lambda kw: next(iter(kw)))
def test_unported_submit_features_raise(kw):
    """submit(adapter=) and submit(tenant=) are ported: without a store an
    adapter is refused with the JAX engine's ValueError, and with one the
    request serves; a tenant's request serves and is charged to it."""
    from paddle_tpu_torch.inference import AdapterStore, LoraAdapter
    net = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    reg = TorchRegistry()
    store = None
    if "adapter" in kw:
        eng = ServingEngine(net, num_slots=1, prompt_len=4, max_cache_len=8,
                            compute_dtype="float32", device="cpu",
                            registry=TorchRegistry())
        with pytest.raises(ValueError, match="adapter_store"):
            eng.submit(np.zeros((3,), np.int32), max_new_tokens=2, **kw)
        store = AdapterStore(net, slots=1, max_rank=2, dtype="float32",
                             registry=reg, device="cpu")
        store.register(LoraAdapter.random(net.config, "a", rank=2, seed=1))
    eng = ServingEngine(net, num_slots=1, prompt_len=4, max_cache_len=8,
                        compute_dtype="float32", device="cpu", registry=reg,
                        adapter_store=store)
    r = eng.submit(np.zeros((3,), np.int32), max_new_tokens=2, **kw)
    eng.run()
    assert r.state == "finished" and r.output.size == 2
    assert eng.stats()["tenant_served_tokens"] == {kw.get("tenant",
                                                          "default"): 5}
    if store is not None:
        assert reg.get("serving.lora.gathers").value() == 2
        assert store.hbm_resident() == ["a"] and store.check()


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
