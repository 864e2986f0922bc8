"""Quantized serving of the port (int8 KV cache with int8 or int4
weights) held against the JAX package on the CPU, on the JAX model's
weights carried by the weight bridge.

- Model layer: one ``prefill_chunk`` and several ``decode_step``s over
  int8 arenas under an int8 and an int4 weight context give logits,
  codes and scales within ``atol 1e-5`` of the JAX model's under the JAX
  plan (float32; both plans are bit-identical).
- Engine layer (one module-scoped trace per weight dtype, the trace of
  ``tests/test_torch_serving.py``): the port engine with
  ``kv_cache_dtype="int8"`` against the JAX engine
  (``async_dispatch=False, prefix_cache_mode="digest",
  enable_preemption=False``): identical scheduling counters,
  ``engine_spec()`` and modeled ``weight_bytes_swept``; tokens equal up to
  each request's first non-decisive position (top-2 margin <= 0.01 of the
  JAX model's teacher-forced logits under the same quantized
  configuration), with agreement seen at 80% of all positions or more;
  and token-exact against a fresh 1-slot port engine.
- The validation errors of the JAX package's ``weight_dtype`` and
  ``kv_cache_dtype`` checks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference.llm import build_weight_quant_plan as j_plan
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.generation import init_paged_kv_arena as j_arena
from paddle_tpu.models.wquant import wquant_context as j_wquant
from paddle_tpu.observability.metrics import MetricsRegistry
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference.llm import (build_weight_quant_plan,
                                            normalize_weight_dtype)
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)
from paddle_tpu_torch.models.generation import init_paged_kv_arena as t_arena
from paddle_tpu_torch.models.wquant import wquant_context as t_wquant

P, C, BLK, CHUNK = 6, 32, 4, 4
SPECS = [(4, 7), (6, 2), (3, 7), (5, 2), (2, 7)]
MARGIN = 0.01
WDS = ("int8", "int4")


def _engine_kw(wd):
    return dict(prompt_len=P, max_cache_len=C, steps_per_call=3,
                block_len=BLK, chunk_len=CHUNK, compute_dtype="float32",
                kv_cache_dtype="int8", weight_dtype=wd)


def _trace(vocab):
    """``tests/test_torch_serving.py``'s trace: a shared-prefix pair
    around the mixed specs, the second of the pair hitting one block."""
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


def _j_kvs(nl, nb, hkv, d, row):
    return [tuple(e) + (jnp.asarray(row),)
            for e in j_arena(nl, nb, BLK, hkv, d, jnp.int8)]


def _margins(jnet, jplan, trace, outs):
    """Top-2 margins of the JAX model's teacher-forced logits under the
    quantized configuration (int8 arenas, the plan's weights): the
    prompt as one chunk, then one decode step per emitted token."""
    cfg = jmodels.tiny_llama_config()
    nl, hkv, d = cfg.num_hidden_layers, cfg.num_key_value_heads, \
        cfg.hidden_size // cfg.num_attention_heads
    mb = C // BLK
    row = np.arange(mb, dtype=np.int32)[None, :]
    ctx = jplan.bind(jplan.flat_values())
    out = []
    for (ids, _), o in zip(trace, outs):
        n = len(ids)
        kvs = _j_kvs(nl, mb, hkv, d, row)
        rows = []
        with j_wquant(ctx):
            lg, kvs = jnet.prefill_chunk(
                jnp.asarray(ids[None, :]), jnp.asarray(0, jnp.int32),
                jnp.asarray(n, jnp.int32), kvs)
            rows.append(np.asarray(lg)[0])
            for t in range(len(o) - 1):
                lg, kvs = jnet.decode_step(
                    jnp.asarray([o[t]], jnp.int32),
                    jnp.asarray([n + t], jnp.int32), kvs)
                rows.append(np.asarray(lg)[0])
        top2 = np.sort(np.stack(rows), axis=-1)[:, -2:]
        out.append(top2[:, 1] - top2[:, 0])
    return out


@pytest.fixture(scope="module")
def bridged():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(2024)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    yield jnet, tnet
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def served(bridged):
    jnet, tnet = bridged
    trace = _trace(tiny_llama_config().vocab_size)
    runs = {}
    for wd in WDS:
        teng = ServingEngine(tnet, num_slots=2, device="cpu", **_engine_kw(wd))
        treqs = _serve(teng, trace)
        alone = [_serve(ServingEngine(tnet, num_slots=1, device="cpu",
                                      **_engine_kw(wd)), [(ids, m)])[0].output
                 for ids, m in trace]
        # a private registry: the JAX engine's stats() are deltas of its
        # registry, and the two engines must not read each other's counts
        jeng = JaxEngine(jnet, num_slots=2, async_dispatch=False,
                         prefix_cache_mode="digest", enable_preemption=False,
                         registry=MetricsRegistry(), **_engine_kw(wd))
        jreqs = _serve(jeng, trace)
        runs[wd] = dict(
            teng=teng, treqs=treqs, alone=alone, jeng=jeng, jreqs=jreqs,
            margins=_margins(jnet, j_plan(jnet, wd), trace,
                             [r.output for r in jreqs]))
    return trace, runs


@pytest.mark.parametrize("wd", WDS)
def test_model_layer_matches_jax_under_int8_kv(bridged, wd):
    """Two prefill chunks (the second with a pad tail) then 3 decode
    steps with a vacant second row, over int8 arenas, under the weight
    plan of ``wd``."""
    jnet, tnet = bridged
    cfg = tiny_llama_config()
    nl, hkv, d = cfg.num_hidden_layers, cfg.num_key_value_heads, \
        cfg.head_dim
    nb, mb, c, n = 8, 4, 4, 6
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, cfg.vocab_size, (2 * c,)).astype(np.int32)
    row = np.asarray([[5, 2, 6, nb]], np.int32)
    jkv = _j_kvs(nl, nb, hkv, d, row)
    tkv = [tuple(e) + (torch.from_numpy(row),)
           for e in t_arena(nl, nb, BLK, hkv, d, torch.int8, "cpu")]
    jplan, tplan = j_plan(jnet, wd), build_weight_quant_plan(tnet, wd)
    jctx, tctx = jplan.bind(jplan.flat_values()), tplan.context()

    def check(tl, jl, tkv, jkv):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=0)
        for te, je in zip(tkv, jkv):
            for ta, ja in zip(te[:4], je[:4]):
                assert ta.dtype == torch.int8 or ta.dtype == torch.float32
                np.testing.assert_allclose(ta.numpy().astype(np.float32),
                                           np.asarray(ja).astype(np.float32),
                                           atol=1e-5, rtol=0)

    with torch.no_grad(), j_wquant(jctx), t_wquant(tctx):
        for start in (0, c):
            ids = prompt[None, start:start + c]
            jl, jkv = jnet.prefill_chunk(jnp.asarray(ids),
                                         jnp.asarray(start, jnp.int32),
                                         jnp.asarray(n, jnp.int32), jkv)
            tl, tkv = tnet.prefill_chunk(torch.from_numpy(ids), start, n,
                                         tkv)
        check(tl, jl, tkv, jkv)
        tables = np.stack([row[0], np.full((mb,), nb, np.int32)])
        jkv = [tuple(e[:4]) + (jnp.asarray(tables),) for e in jkv]
        tkv = [tuple(e[:4]) + (torch.from_numpy(tables),) for e in tkv]
        tok = np.asarray([int(np.argmax(np.asarray(jl)[0])), 0], np.int32)
        lens = np.asarray([n, 0], np.int32)
        for _ in range(3):
            jl, jkv = jnet.decode_step(jnp.asarray(tok), jnp.asarray(lens),
                                       jkv)
            tl, tkv = tnet.decode_step(torch.from_numpy(tok),
                                       torch.from_numpy(lens), tkv)
            check(tl, jl, tkv, jkv)
            tok = np.asarray([int(np.argmax(np.asarray(jl)[0])), 0],
                             np.int32)
            lens = lens + np.asarray([1, 0], np.int32)


@pytest.mark.parametrize("wd", WDS)
def test_quant_engine_tokens_equal_fresh_single_slot_engine(served, wd):
    _trace_, runs = served
    r = runs[wd]
    for i, (req, want) in enumerate(zip(r["treqs"], r["alone"])):
        assert req.output.shape == (req.max_new_tokens,)
        np.testing.assert_array_equal(req.output, want, err_msg=f"req {i}")


@pytest.mark.parametrize("wd", WDS)
def test_quant_engine_tokens_equal_jax_at_decisive_positions(served, wd):
    _trace_, runs = served
    r = runs[wd]
    compared = total = 0
    for treq, jreq, margin in zip(r["treqs"], r["jreqs"], r["margins"]):
        total += len(margin)
        undecided = np.flatnonzero(margin <= MARGIN)
        upto = int(undecided[0]) if undecided.size else len(margin)
        np.testing.assert_array_equal(treq.output[:upto], jreq.output[:upto])
        # positions whose agreement was seen: all of a request whose
        # tokens agree throughout, else those up to the first tie
        same = np.array_equal(treq.output, jreq.output)
        compared += len(margin) if same else upto
    assert compared >= 0.8 * total, (compared, total)


@pytest.mark.parametrize("wd", WDS)
def test_quant_engine_scheduling_and_spec_identical_to_jax(served, wd):
    trace, runs = served
    teng, jeng = runs[wd]["teng"], runs[wd]["jeng"]
    ts, js = teng.stats(), jeng.stats()
    assert [r.request_id for r in teng._finished] == \
        [r.request_id for r in jeng._finished]
    for key in ("finished", "prefills", "prefill_chunks", "decode_steps",
                "block_dispatches", "peak_queue", "prefix_hit_rate",
                "prefix_hits", "peak_blocks_in_use", "mean_slot_occupancy",
                "weight_dtype", "kv_cache_dtype", "weight_bytes_swept",
                "kv_bytes_swept"):
        assert ts[key] == js[key], key
    assert ts["prefix_hits"] > 0
    assert ts["finished"] == len(trace)
    assert ts["weight_dtype"] == wd and ts["kv_cache_dtype"] == "int8"
    spec = teng.engine_spec()
    assert spec == jeng.engine_spec()
    assert teng._digest_salt == b"ptpu-paged-kv/int8"


def test_quant_engine_streams_fewer_weight_bytes(served, bridged):
    """Modeled weight bytes per forward: float > int8 > int4."""
    _jnet, tnet = bridged
    _trace_, runs = served
    per = {wd: runs[wd]["teng"]._weight_sweep_bytes for wd in WDS}
    fl = ServingEngine(tnet, num_slots=1, device="cpu",
                       **dict(_engine_kw(None), kv_cache_dtype=None))
    assert fl._weight_sweep_bytes > per["int8"] > per["int4"]
    assert fl.engine_spec()["kv_row_bytes"] > \
        runs["int8"]["teng"].engine_spec()["kv_row_bytes"]


def test_weight_dtype_validation(bridged):
    _jnet, tnet = bridged
    with pytest.raises(ValueError, match="weight_dtype"):
        normalize_weight_dtype("int7")
    with pytest.raises(ValueError, match="int8.*int4|int4.*int8"):
        normalize_weight_dtype("int32")
    assert normalize_weight_dtype(None) is None
    assert normalize_weight_dtype("bfloat16") is None
    assert normalize_weight_dtype("float32") is None
    assert normalize_weight_dtype("int8") == "int8"
    assert normalize_weight_dtype("int4") == "int4"
    with pytest.raises(ValueError, match="weight_dtype"):
        ServingEngine(tnet, num_slots=1, device="cpu",
                      **dict(_engine_kw("uint8"), kv_cache_dtype=None))


def test_kv_cache_dtype_rejects_int4_with_hint(bridged):
    _jnet, tnet = bridged
    with pytest.raises(ValueError, match="weight_dtype='int4'"):
        ServingEngine(tnet, num_slots=1, device="cpu",
                      **dict(_engine_kw(None), kv_cache_dtype="int4"))
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ServingEngine(tnet, num_slots=1, device="cpu",
                      **dict(_engine_kw(None), kv_cache_dtype="int16"))


def test_int4_weights_compose_with_int8_kv(served):
    _trace_, runs = served
    eng = runs["int4"]["teng"]
    st = eng.stats()
    assert eng.weight_dtype == "int4" and eng.kv_cache_dtype == "int8"
    assert st["weight_bytes_swept"] > 0
    assert eng.engine_spec()["weight_dtype"] == "int4"
