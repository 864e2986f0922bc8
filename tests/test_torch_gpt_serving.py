"""GPT through the port's serving surfaces, held against the JAX package on
the CPU, on the JAX model's weights carried by the weight bridge: the
twin of the reference's ``test_serving_engine.py::
test_gpt_paged_serving_parity``, ``test_speculative.py::
test_gpt_spec_parity`` and ``test_llm_predictor.py::
test_gpt_session_matches_generate``, kept cheap (tiny GPT, float32).

- Engine (one module-scoped trace per mode: float, int8 KV, int8 weights,
  int4 weights, each quantized projection with its bias in the kernel's
  epilogue): the port's tokens equal a fresh 1-slot port engine's,
  request by request; equal the JAX engine's up to each request's first
  non-decisive position (top-2 margin <= 0.01 of the JAX model's
  teacher-forced logits in the same configuration), with at least 80%
  of all positions compared; and the scheduling counters, the modeled
  ``weight_bytes_swept``/``kv_bytes_swept`` and ``engine_spec()`` equal.
- ``spec_decode`` with a GPT ``ModelDrafter`` over the target (every
  draft accepted) and over another GPT (rejections and rollback), token
  for token and counter for counter against the JAX spec engine (the
  trace's seed leaves every position decisive).
- The learned-position table's edge: ``max_position_embeddings ==
  max_cache_len``, requests running to the last position, the chunk's
  pad tail past the table.
- ``LLMPredictor`` on GPT equals ``generate()`` and the JAX session; the
  artifact carries the family and loads back as a GPT; an artifact
  without a family loads as Llama; another model is refused.
- An ``AdapterStore`` over GPT is refused as the reference refuses it.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import LLMPredictor as JaxPredictor
from paddle_tpu.inference.llm import build_weight_quant_plan as j_plan
from paddle_tpu.inference.lora import AdapterStore as JaxAdapterStore
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.inference.speculative import ModelDrafter as JaxModelDrafter
from paddle_tpu.models.generation import init_paged_kv_arena as j_arena
from paddle_tpu.models.wquant import wquant_context as j_wquant
from paddle_tpu.observability.metrics import MetricsRegistry
from paddle_tpu_torch.inference import (AdapterStore, LLMPredictor,
                                        ModelDrafter, ServingEngine)
from paddle_tpu_torch.inference.llm import ARTIFACT_SUFFIX
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_state_from_jax, tiny_gpt_config,
                                     tiny_llama_config)
from paddle_tpu_torch.observability import MetricsRegistry as TorchRegistry

P, C, BLK, CHUNK = 6, 32, 4, 4
SPECS = [(4, 7), (6, 2), (3, 7), (5, 2), (2, 7)]
MARGIN = 0.01
MODES = {"float": {}, "int8kv": dict(kv_cache_dtype="int8"),
         "int8w": dict(weight_dtype="int8"),
         "int4w": dict(weight_dtype="int4")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bridge(seed, **kw):
    paddle.seed(seed)
    jnet = jmodels.GPTForCausalLM(jmodels.tiny_gpt_config(**kw))
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = GPTForCausalLM(tiny_gpt_config(**kw), device="cpu", init=False)
    tnet.load_state_dict(gpt_state_from_jax(arrays), strict=True)
    return jnet, tnet


@pytest.fixture(scope="module")
def bridged():
    return _bridge(11)


def _engine_kw(**kw):
    return dict(dict(prompt_len=P, max_cache_len=C, steps_per_call=3,
                     block_len=BLK, chunk_len=CHUNK, compute_dtype="float32"),
                **kw)


def _lockstep():
    return dict(async_dispatch=False, prefix_cache_mode="digest",
                enable_preemption=False)


def _trace(vocab, seed=0):
    """A shared-prefix pair around mixed specs: the pair's second request
    queues behind the first and hits its published full block."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, (5,)).astype(np.int32)
    first = np.concatenate([shared, rng.integers(0, vocab, (1,))])
    second = np.concatenate([shared, rng.integers(0, vocab, (1,))])
    reqs = [(first.astype(np.int32), 5)]
    reqs += [(rng.integers(0, vocab, (n,)).astype(np.int32), m)
             for n, m in SPECS]
    reqs.append((second.astype(np.int32), 4))
    return reqs


def _serve(engine, trace, spec=None):
    handles = [engine.submit(ids, max_new_tokens=m, spec_decode=spec)
               for ids, m in trace]
    engine.run(max_iters=500)
    return handles


def _margins(jnet, trace, outs, kw, max_cache_len=C):
    """Top-2 margins of the JAX model's teacher-forced logits in the
    engine's configuration (int8 or float arenas, the weight plan): the
    prompt as one chunk, then one decode step per emitted token."""
    nl, h, d = jnet.kv_cache_spec()
    mb = max_cache_len // BLK
    row = jnp.asarray(np.arange(mb, dtype=np.int32)[None, :])
    int8 = kw.get("kv_cache_dtype") == "int8"
    wd = kw.get("weight_dtype")
    ctx = None
    if wd is not None:
        plan = j_plan(jnet, wd)
        ctx = plan.bind(plan.flat_values())
    out = []
    for (ids, _), o in zip(trace, outs):
        n = len(ids)
        kvs = [tuple(e) + (row,) for e in j_arena(
            nl, mb, BLK, h, d, jnp.int8 if int8 else jnp.float32)]
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
def served(bridged):
    jnet, tnet = bridged
    trace = _trace(tiny_gpt_config().vocab_size)
    runs = {}
    for mode, kw in MODES.items():
        teng = ServingEngine(tnet, num_slots=2, device="cpu",
                             registry=TorchRegistry(), **_lockstep(),
                             **_engine_kw(**kw))
        treqs = _serve(teng, trace)
        alone = [_serve(ServingEngine(tnet, num_slots=1, device="cpu",
                                      **_engine_kw(**kw)),
                        [(ids, m)])[0].output for ids, m in trace]
        jeng = JaxEngine(jnet, num_slots=2, registry=MetricsRegistry(),
                         **_lockstep(), **_engine_kw(**kw))
        jreqs = _serve(jeng, trace)
        runs[mode] = dict(teng=teng, treqs=treqs, alone=alone, jeng=jeng,
                          jreqs=jreqs, margins=_margins(
                              jnet, trace, [r.output for r in jreqs], kw))
    return trace, runs


@pytest.mark.parametrize("mode", list(MODES))
def test_gpt_engine_tokens_equal_fresh_single_slot_engine(served, mode):
    _trace_, runs = served
    r = runs[mode]
    for i, (req, want) in enumerate(zip(r["treqs"], r["alone"])):
        assert req.output.shape == (req.max_new_tokens,)
        np.testing.assert_array_equal(req.output, want, err_msg=f"req {i}")


@pytest.mark.parametrize("mode", list(MODES))
def test_gpt_engine_tokens_equal_jax_at_decisive_positions(served, mode):
    _trace_, runs = served
    r = runs[mode]
    compared = total = 0
    for treq, jreq, margin in zip(r["treqs"], r["jreqs"], r["margins"]):
        total += len(margin)
        undecided = np.flatnonzero(margin <= MARGIN)
        upto = int(undecided[0]) if undecided.size else len(margin)
        np.testing.assert_array_equal(treq.output[:upto], jreq.output[:upto])
        compared += upto
    assert compared >= 0.8 * total, (compared, total)


@pytest.mark.parametrize("mode", list(MODES))
def test_gpt_engine_counters_identical_to_jax(served, mode):
    trace, runs = served
    teng, jeng = runs[mode]["teng"], runs[mode]["jeng"]
    ts, js = teng.stats(), jeng.stats()
    assert [r.request_id for r in teng._finished] == \
        [r.request_id for r in jeng._finished]
    for key in ("finished", "prefills", "prefill_chunks", "decode_steps",
                "block_dispatches", "peak_queue", "prefix_hit_rate",
                "prefix_hits", "peak_blocks_in_use", "mean_slot_occupancy",
                "weight_dtype", "kv_cache_dtype", "weight_bytes_swept",
                "kv_bytes_swept"):
        assert ts[key] == js[key], key
    assert ts["prefix_hits"] > 0 and ts["finished"] == len(trace)
    assert teng.engine_spec() == jeng.engine_spec()


def test_gpt_quantized_weights_stream_fewer_bytes_biases_included(served,
                                                                 bridged):
    """Modeled weight bytes per forward: float > int8 > int4, and the
    quantized engines still count the projections' float biases (the
    JAX engine's counter, held equal above)."""
    _jnet, tnet = bridged
    _trace_, runs = served
    per = {m: runs[m]["teng"]._weight_sweep_bytes
           for m in ("float", "int8w", "int4w")}
    assert per["float"] > per["int8w"] > per["int4w"]
    bias = sum(lin.bias.numel() for layer in tnet.quant_projections()
               for lin in layer.values())
    wq = runs["int4w"]["teng"]._wq
    assert per["int4w"] >= wq.bytes_swept() + 4 * bias


# ---------------------------------------------------------------------------
# speculative decoding with GPT drafters
# ---------------------------------------------------------------------------

K, CTX = 3, 24
SPEC_TRACE = [(5, 9, K), (8, 6, K), (3, 11, 2), (7, 5, None), (6, 8, K)]


@pytest.fixture(scope="module")
def spec_served(bridged):
    jnet, tnet = bridged
    jother, tother = _bridge(77, num_hidden_layers=1)
    rng = np.random.default_rng(6)
    trace = [(rng.integers(0, 256, (n,)).astype(np.int32), m, k)
             for n, m, k in SPEC_TRACE]
    kw = dict(max_context=CTX, max_draft=K, compute_dtype="float32")
    ekw = _engine_kw(prompt_len=8, max_cache_len=40, steps_per_call=2)
    runs = {}
    for name, (jd, td) in {"target": (jnet, tnet),
                           "other": (jother, tother)}.items():
        teng = ServingEngine(tnet, num_slots=2, device="cpu",
                             drafter=ModelDrafter(td, **kw),
                             registry=TorchRegistry(), **_lockstep(), **ekw)
        jeng = JaxEngine(jnet, num_slots=2, drafter=JaxModelDrafter(jd, **kw),
                         registry=MetricsRegistry(), **_lockstep(), **ekw)
        out = []
        for eng in (teng, jeng):
            hs = [eng.submit(ids, max_new_tokens=m, spec_decode=k)
                  for ids, m, k in trace]
            eng.run(max_iters=500)
            out.append(hs)
        runs[name] = dict(teng=teng, jeng=jeng, treqs=out[0], jreqs=out[1])
    plain = ServingEngine(tnet, num_slots=2, device="cpu",
                          registry=TorchRegistry(), **_lockstep(), **ekw)
    preqs = [plain.submit(ids, max_new_tokens=m) for ids, m, _ in trace]
    plain.run(max_iters=500)
    return trace, runs, preqs


@pytest.mark.parametrize("drafter", ["target", "other"])
def test_gpt_spec_engine_matches_jax_and_plain(spec_served, bridged,
                                               drafter):
    jnet, tnet = bridged
    trace, runs, preqs = spec_served
    r = runs[drafter]
    for (ids, m, _k), treq, jreq, preq in zip(trace, r["treqs"], r["jreqs"],
                                              preqs):
        np.testing.assert_array_equal(treq.output, jreq.output)
        np.testing.assert_array_equal(treq.output, preq.output)
        padded = np.zeros((8,), np.int32)
        padded[:ids.size] = ids
        want = tnet.generate(padded[None], seq_lens=np.array([ids.size]),
                             max_new_tokens=m, max_cache_len=40,
                             compute_dtype="float32").numpy()[0]
        np.testing.assert_array_equal(treq.output, want)
    ts, js = r["teng"].stats(), r["jeng"].stats()
    spec_keys = [k for k in js if k.startswith("spec_")]
    assert spec_keys
    for key in spec_keys + ["decode_steps", "block_dispatches",
                            "weight_bytes_swept", "kv_bytes_swept"]:
        assert ts[key] == js[key], key
    if drafter == "target":
        assert ts["spec_acceptance_rate"] == 1.0
    else:
        assert ts["spec_acceptance_rate"] < 1.0


# ---------------------------------------------------------------------------
# the position table's edge
# ---------------------------------------------------------------------------

EDGE = dict(prompt_len=8, max_cache_len=16, steps_per_call=2, block_len=4,
            chunk_len=4, compute_dtype="float32")


def test_gpt_engine_at_the_position_table_edge_matches_jax():
    """``max_position_embeddings == max_cache_len``: prompts whose
    second chunk's pad tail lies past the table and requests that
    decode up to the table's last position, in both engines."""
    jnet, tnet = _bridge(5, max_position_embeddings=16)
    rng = np.random.default_rng(3)
    trace = [(rng.integers(0, 256, (n,)).astype(np.int32), 16 - n)
             for n in (7, 8, 5, 3)]
    teng = ServingEngine(tnet, num_slots=2, device="cpu",
                         registry=TorchRegistry(), **_lockstep(), **EDGE)
    jeng = JaxEngine(jnet, num_slots=2, registry=MetricsRegistry(),
                     **_lockstep(), **EDGE)
    treqs, jreqs = _serve(teng, trace), _serve(jeng, trace)
    margins = _margins(jnet, trace, [r.output for r in jreqs], {},
                       max_cache_len=16)
    compared = 0
    for treq, jreq, margin, (ids, m) in zip(treqs, jreqs, margins, trace):
        assert treq.output.shape == (m,) and ids.size + m == 16
        undecided = np.flatnonzero(margin <= MARGIN)
        upto = int(undecided[0]) if undecided.size else len(margin)
        np.testing.assert_array_equal(treq.output[:upto], jreq.output[:upto])
        compared += upto
    assert compared >= 0.8 * sum(m for _ids, m in trace)


# ---------------------------------------------------------------------------
# LLMPredictor and its artifact
# ---------------------------------------------------------------------------

def test_gpt_session_matches_generate_and_jax(bridged):
    jnet, tnet = bridged
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 256, (2, 4))
    kw = dict(batch=2, prompt_len=4, max_cache_len=16, steps_per_call=3,
              compute_dtype="float32")
    got = LLMPredictor(tnet, **kw).generate(ids, max_new_tokens=6)
    want = tnet.generate(ids.astype(np.int32), max_new_tokens=6,
                         max_cache_len=16, compute_dtype="float32").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, JaxPredictor(jnet, **kw).generate(ids, max_new_tokens=6))


def test_artifact_families_round_trip(bridged, tmp_path):
    _jnet, tnet = bridged
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 256, (2, 4))
    kw = dict(batch=2, prompt_len=4, max_cache_len=16, steps_per_call=3,
              compute_dtype="float32")
    llama = LlamaForCausalLM(tiny_llama_config(), device="cpu", seed=3)
    for net, family in ((tnet, "gpt"), (llama, "llama")):
        pred = LLMPredictor(net, **kw)
        want = pred.generate(ids, max_new_tokens=5)
        path = str(tmp_path / family)
        pred.save(path)
        with open(path + ARTIFACT_SUFFIX, "rb") as f:
            blob = pickle.load(f)
        assert blob["family"] == family
        assert blob["config"] == dataclasses.asdict(net.config)
        back = LLMPredictor.load(path, device="cpu")
        assert type(back._model) is type(net)
        np.testing.assert_array_equal(back.generate(ids, max_new_tokens=5),
                                      want)
    # an artifact written before the family key existed is a Llama one
    del blob["family"]
    with open(path + ARTIFACT_SUFFIX, "wb") as f:
        pickle.dump(blob, f)
    back = LLMPredictor.load(path, device="cpu")
    assert isinstance(back._model, LlamaForCausalLM)
    np.testing.assert_array_equal(back.generate(ids, max_new_tokens=5), want)
    blob["family"] = "ernie"
    with open(path + ARTIFACT_SUFFIX, "wb") as f:
        pickle.dump(blob, f)
    with pytest.raises(ValueError, match="family 'ernie'"):
        LLMPredictor.load(path, device="cpu")


def test_artifact_refuses_another_model(bridged, tmp_path):
    _jnet, tnet = bridged

    class OtherLM(GPTForCausalLM):
        pass

    other = OtherLM(tiny_gpt_config(), device="cpu")
    pred = LLMPredictor(other, batch=1, prompt_len=4, max_cache_len=8,
                        compute_dtype="float32")
    with pytest.raises(NotImplementedError,
                       match="Known differences of the dense generation "
                             "programs"):
        pred.save(str(tmp_path / "other"))


def test_adapter_store_refuses_gpt_like_jax(bridged):
    jnet, tnet = bridged
    with pytest.raises(ValueError) as jerr:
        JaxAdapterStore(jnet, slots=1, max_rank=2, dtype="float32",
                        registry=MetricsRegistry())
    with pytest.raises(ValueError) as terr:
        AdapterStore(tnet, slots=1, max_rank=2, dtype="float32",
                     registry=TorchRegistry(), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "attn_projections" in str(terr.value)
