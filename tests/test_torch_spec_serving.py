"""Greedy speculative decoding of the port held against the JAX package on
the CPU, on the JAX models' weights carried by the weight bridge.

- Model layer: ``verify_step`` logits (the spec rows' real columns) and
  arenas (the trash row left out) within ``atol 1e-5`` of the JAX
  model's, over a float cache, the int8 5-tuple, and int8 KV under int8
  and int4 weight plans; the dense ``prefill`` and greedy ``generate()``
  against JAX's.
- Engine layer (one module-scoped trace): the port's spec engine with a
  ``ModelDrafter`` over the target and over another model against the
  JAX spec engine with the same drafters (both with
  ``prefix_cache_mode="digest", enable_preemption=False``, the JAX one
  with ``async_dispatch=False`` too): tokens equal up
  to each request's first non-decisive position (teacher-forced top-2
  margin <= 0.01), and, on this trace where every position is decisive,
  the ``spec_*`` counters, the scheduling counters and the modeled
  ``kv_bytes_swept`` / ``weight_bytes_swept`` equal.
- The port against itself: spec tokens (n-gram, target and other-model
  drafters; float and int8 cache) equal the non-spec engine's, greedy
  ``generate()``'s, and a fresh 1-slot spec engine's.
- What stays unported (LoRA, a mesh) raises ``NotImplementedError``; a
  spec request with a token mask raises the reference's ``ValueError``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference.llm import build_weight_quant_plan as j_plan
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.inference.speculative import ModelDrafter as JaxModelDrafter
from paddle_tpu.models.generation import init_paged_kv_arena as j_arena
from paddle_tpu.models.wquant import wquant_context as j_wquant
from paddle_tpu.observability.metrics import MetricsRegistry
from paddle_tpu_torch.observability import (
    MetricsRegistry as TorchRegistry)
from paddle_tpu_torch.inference import (DfaTokenMask, ModelDrafter,
                                        NGramDrafter, SamplingParams,
                                        ServingEngine, build_spec_verify)
from paddle_tpu_torch.inference.llm import build_weight_quant_plan
from paddle_tpu_torch.models import (GenerationConfig, LlamaForCausalLM,
                                     llama_state_from_jax, tiny_llama_config)
from paddle_tpu_torch.models.generation import init_paged_kv_arena as t_arena
from paddle_tpu_torch.models.wquant import wquant_context as t_wquant

P, C, BLK, CHUNK = 8, 40, 4, 4
K, CTX = 3, 24            # spec_decode / max_draft, drafter context grid
MARGIN = 0.01
# (prompt length, max_new_tokens, spec_decode): spec rows beside a plain one
SPECS = [(5, 9, K), (8, 6, K), (3, 11, 2), (7, 5, None), (6, 8, K)]


def _engine_kw(**kw):
    return dict(prompt_len=P, max_cache_len=C, steps_per_call=2,
                block_len=BLK, chunk_len=CHUNK, compute_dtype="float32",
                **kw)


def _trace(vocab):
    """The requests of SPECS from a seed whose every output position is
    decisive (smallest teacher-forced top-2 margin 0.0203 > MARGIN), so
    the two packages' tokens, drafts and counters can be held equal."""
    rng = np.random.default_rng(6)
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), m, k)
            for n, m, k in SPECS]


def _serve(engine, trace, spec=True):
    handles = [engine.submit(ids, max_new_tokens=m,
                             spec_decode=k if spec else None)
               for ids, m, k in trace]
    engine.run(max_iters=500)
    return handles


def _margins(jnet, trace, outs):
    """Top-2 margin of the JAX model's teacher-forced logits at every
    output position (one batched causal forward over prompt +
    output[:-1], right-padded)."""
    width = max(len(ids) + len(o) - 1 for (ids, _, _), o in zip(trace, outs))
    seqs = np.zeros((len(trace), width), np.int32)
    for i, ((ids, _, _), o) in enumerate(zip(trace, outs)):
        s = np.concatenate([ids, o[:-1]])
        seqs[i, :len(s)] = s
    logits = np.asarray(jnet(paddle.to_tensor(seqs))._value)
    out = []
    for i, ((ids, _, _), o) in enumerate(zip(trace, outs)):
        lg = logits[i, len(ids) - 1:len(ids) - 1 + len(o)]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        out.append(top2[:, 1] - top2[:, 0])
    return out


def _bridge(seed, cfg):
    paddle.seed(seed)
    jnet = jmodels.LlamaForCausalLM(cfg)
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(
        dataclasses.replace(tiny_llama_config(),
                            num_hidden_layers=cfg.num_hidden_layers),
        device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    return jnet, tnet


@pytest.fixture(scope="module")
def bridged():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    target = _bridge(2024, jmodels.tiny_llama_config())
    other = _bridge(77, dataclasses.replace(jmodels.tiny_llama_config(),
                                            num_hidden_layers=1))
    yield target, other
    torch.set_num_threads(prev)


def _drafters(bridged):
    (jnet, tnet), (jother, tother) = bridged
    kw = dict(max_context=CTX, max_draft=K, compute_dtype="float32")
    return {"target": (JaxModelDrafter(jnet, **kw), ModelDrafter(tnet, **kw)),
            "other": (JaxModelDrafter(jother, **kw),
                      ModelDrafter(tother, **kw))}


@pytest.fixture(scope="module")
def served(bridged):
    (jnet, tnet), _other = bridged
    trace = _trace(tiny_llama_config().vocab_size)
    runs = {}
    for name, (jdr, tdr) in _drafters(bridged).items():
        teng = ServingEngine(tnet, num_slots=2, device="cpu", drafter=tdr,
                             async_dispatch=False,
                             prefix_cache_mode="digest",
                             enable_preemption=False,
                             registry=TorchRegistry(), **_engine_kw())
        treqs = _serve(teng, trace)
        jeng = JaxEngine(jnet, num_slots=2, drafter=jdr,
                         async_dispatch=False, prefix_cache_mode="digest",
                         enable_preemption=False, registry=MetricsRegistry(),
                         **_engine_kw())
        jreqs = _serve(jeng, trace)
        runs[name] = dict(teng=teng, treqs=treqs, jeng=jeng, jreqs=jreqs)
    plain = ServingEngine(tnet, num_slots=2, device="cpu",
                          async_dispatch=False,
                          prefix_cache_mode="digest", enable_preemption=False,
                          registry=TorchRegistry(), **_engine_kw())
    preqs = _serve(plain, trace, spec=False)
    jplain = JaxEngine(jnet, num_slots=2, async_dispatch=False,
                       prefix_cache_mode="digest", enable_preemption=False,
                       registry=MetricsRegistry(), **_engine_kw())
    _serve(jplain, trace, spec=False)
    margins = _margins(jnet, trace, [r.output for r in preqs])
    return dict(trace=trace, runs=runs, plain=plain, preqs=preqs,
                jplain=jplain, margins=margins)


def _decisive_upto(margin):
    undecided = np.flatnonzero(margin <= MARGIN)
    return int(undecided[0]) if undecided.size else len(margin)


# ---------------------------------------------------------------------------
# model layer
# ---------------------------------------------------------------------------

def _prefill_both(jnet, tnet, jkv, tkv, prompt, n, start=0):
    ids = prompt[None, :]
    jl, jkv = jnet.prefill_chunk(jnp.asarray(ids), jnp.asarray(start,
                                                               jnp.int32),
                                 jnp.asarray(n, jnp.int32), jkv)
    tl, tkv = tnet.prefill_chunk(torch.from_numpy(ids), start, n, tkv)
    return jl, jkv, tl, tkv


@pytest.mark.parametrize("mode", ["float", "int8kv", "int8kv_int8w",
                                  "int8kv_int4w"])
def test_verify_step_matches_jax(bridged, mode):
    """A 6-token prompt prefilled into row 0's blocks, then one C=4
    verify: row 0 with 3 real columns (the 4th trash-routed), row 1
    outside spec mode (all-trash table, n_valid 0).  Logits of row 0's
    real columns and every arena row but the trash row agree within
    1e-5, under the weight plan of ``mode``."""
    (jnet, tnet), _ = bridged
    cfg = tiny_llama_config()
    nl, hkv, d = cfg.num_hidden_layers, cfg.num_key_value_heads, \
        cfg.head_dim
    nb, mb, n, cq = 8, 4, 6, 4
    int8 = mode != "float"
    rng = np.random.default_rng(31)
    prompt = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)
    row = np.asarray([[5, 2, 6, nb]], np.int32)
    jdt, tdt = (jnp.int8, torch.int8) if int8 else (jnp.float32,
                                                    torch.float32)
    jkv = [tuple(e) + (jnp.asarray(row),)
           for e in j_arena(nl, nb, BLK, hkv, d, jdt)]
    tkv = [tuple(e) + (torch.from_numpy(row),)
           for e in t_arena(nl, nb, BLK, hkv, d, tdt, "cpu")]
    wd = mode.split("_")[1][:4] if mode.count("_") else None
    jctx = tctx = None
    if wd is not None:
        jplan = j_plan(jnet, wd)
        jctx, tctx = jplan.bind(jplan.flat_values()), \
            build_weight_quant_plan(tnet, wd).context()
    with torch.no_grad(), j_wquant(jctx), t_wquant(tctx):
        _, jkv, _, tkv = _prefill_both(jnet, tnet, jkv, tkv, prompt, n)
        tables = np.stack([row[0], np.full((mb,), nb, np.int32)])
        jkv = [tuple(e[:-1]) + (jnp.asarray(tables),) for e in jkv]
        tkv = [tuple(e[:-1]) + (torch.from_numpy(tables),) for e in tkv]
        toks = np.stack([rng.integers(0, cfg.vocab_size, (cq,)),
                         np.zeros((cq,))]).astype(np.int32)
        lens = np.asarray([n, 3], np.int32)
        n_valid = np.asarray([3, 0], np.int32)
        jl, jkv = jnet.verify_step(jnp.asarray(toks), jnp.asarray(lens),
                                   jnp.asarray(n_valid), jkv)
        tl, tkv = tnet.verify_step(torch.from_numpy(toks),
                                   torch.from_numpy(lens),
                                   torch.from_numpy(n_valid), tkv)
    assert tl.shape == (2, cq, cfg.vocab_size)
    np.testing.assert_allclose(tl[0, :3].numpy(), np.asarray(jl)[0, :3],
                               atol=1e-5, rtol=0)
    for te, je in zip(tkv, jkv):
        for ta, ja in zip(te[:-1], je[:-1]):
            np.testing.assert_allclose(
                ta.numpy()[:nb].astype(np.float32),
                np.asarray(ja)[:nb].astype(np.float32), atol=1e-5, rtol=0)
    assert torch.isfinite(tl).all()


def test_dense_prefill_and_generate_match_jax(bridged, served):
    (jnet, tnet), _ = bridged
    cfg = tiny_llama_config()
    nl, hkv, d = tnet.kv_cache_spec()
    rng = np.random.default_rng(8)
    ids = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    lens = np.asarray([7, 4], np.int32)
    from paddle_tpu.models.generation import init_kv_cache as j_cache
    from paddle_tpu_torch.models.generation import init_kv_cache as t_cache
    jl, jkv = jnet.prefill(jnp.asarray(ids), jnp.asarray(lens),
                           j_cache(nl, 2, 12, hkv, d, jnp.float32))
    with torch.no_grad():
        tl, tkv = tnet.prefill(torch.from_numpy(ids), torch.from_numpy(lens),
                               t_cache(nl, 2, 12, hkv, d, torch.float32,
                                       "cpu"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=0)
        for te, je in zip(tkv, jkv):
            for ta, ja in zip(te, je):
                np.testing.assert_allclose(ta.numpy(), np.asarray(ja),
                                           atol=1e-5, rtol=0)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        jl2, _ = jnet.decode_step(jnp.asarray(tok), jnp.asarray(lens), jkv)
        tl2, _ = tnet.decode_step(torch.from_numpy(tok),
                                  torch.from_numpy(lens), tkv)
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-5,
                                   rtol=0)
    # greedy generate() per trace request: equal to JAX's at decisive
    # positions, to the port's non-spec engine everywhere
    for (p, m, _k), preq, margin in zip(served["trace"], served["preqs"],
                                        served["margins"]):
        padded = np.zeros((P,), np.int32)
        padded[:p.size] = p
        t_out = tnet.generate(padded[None], seq_lens=np.array([p.size]),
                              max_new_tokens=m, max_cache_len=C,
                              compute_dtype="float32")
        assert t_out.dtype == torch.int32 and t_out.shape == (1, m)
        j_out = np.asarray(jnet.generate(
            paddle.to_tensor(padded[None]), seq_lens=np.array([p.size]),
            max_new_tokens=m, max_cache_len=C,
            compute_dtype="float32")._value)[0]
        upto = _decisive_upto(margin)
        np.testing.assert_array_equal(t_out[0, :upto].numpy(), j_out[:upto])
        np.testing.assert_array_equal(t_out[0].numpy(), preq.output)


def test_model_drafter_proposes_jax_drafts(bridged):
    (jnet, tnet), _ = bridged
    for name, (jdr, tdr) in _drafters(bridged).items():
        rng = np.random.default_rng(len(name))
        for n in (3, 9, CTX + 5):          # the last one left-truncates
            ctx = rng.integers(0, 256, (n,)).astype(np.int32)
            for k in (1, K):
                np.testing.assert_array_equal(tdr.propose(ctx, k),
                                              jdr.propose(ctx, k))
        assert tdr.propose(ctx, 0).size == 0
    with pytest.raises(ValueError, match="max_context"):
        ModelDrafter(tnet, max_context=0)


# ---------------------------------------------------------------------------
# engine layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drafter", ["target", "other"])
def test_spec_engine_tokens_equal_jax_at_decisive_positions(served,
                                                            drafter):
    r = served["runs"][drafter]
    compared = total = 0
    for treq, jreq, margin in zip(r["treqs"], r["jreqs"], served["margins"]):
        assert treq.state == "finished"
        upto = _decisive_upto(margin)
        np.testing.assert_array_equal(treq.output[:upto], jreq.output[:upto])
        compared += upto
        total += len(margin)
    assert compared == total, "the trace is chosen all-decisive"


@pytest.mark.parametrize("drafter", ["target", "other"])
def test_spec_counters_equal_jax(served, drafter):
    r = served["runs"][drafter]
    ts, js = r["teng"].stats(), r["jeng"].stats()
    for key in ("spec_verify_steps", "spec_draft_hits", "spec_draft_misses",
                "spec_draft_tokens", "spec_accepted_tokens",
                "spec_acceptance_rate", "spec_mean_accepted_len",
                "finished", "prefills", "prefill_chunks", "decode_steps",
                "block_dispatches", "busy_slot_steps", "peak_queue",
                "blocks_in_use", "peak_blocks_in_use", "kv_bytes_swept",
                "weight_bytes_swept"):
        assert ts[key] == js[key], key
    assert [q.request_id for q in r["teng"]._finished] == \
        [q.request_id for q in r["jeng"]._finished]
    assert ts["spec_verify_steps"] > 0 and ts["blocks_in_use"] == 0
    if drafter == "target":
        # the draft model is the target: every draft verifies
        assert ts["spec_acceptance_rate"] == 1.0
        assert ts["spec_mean_accepted_len"] > 1.0
    else:
        # another model's drafts are rejected: rollback runs
        assert ts["spec_draft_tokens"] > ts["spec_accepted_tokens"]


def test_non_spec_kv_sweep_equals_jax(served):
    ts, js = served["plain"].stats(), served["jplain"].stats()
    for key in ("kv_bytes_swept", "weight_bytes_swept", "decode_steps",
                "spec_verify_steps"):
        assert ts[key] == js[key], key
    assert ts["kv_bytes_swept"] > 0 and ts["spec_verify_steps"] == 0


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float_kv", "int8_kv"])
@pytest.mark.parametrize("drafter", ["ngram", "target", "other"])
def test_spec_tokens_equal_non_spec_and_single_slot(bridged, served, drafter,
                                                    kv):
    """Greedy equivalence inside the port: the spec engine's tokens equal
    the non-spec engine's on the same cache dtype, and a fresh 1-slot
    spec engine's per request (slot reuse and batching change no token).
    The n-gram drafter finds nothing to propose in the random model's
    short outputs, so its trace runs 24 tokens per request, long enough
    for the model's loops to give it drafts to verify."""
    (_jnet, tnet), _ = bridged
    trace = served["trace"]
    if drafter == "ngram":
        trace = [(ids, 24, k) for ids, _m, k in trace]
    dr = None if drafter == "ngram" else _drafters(bridged)[drafter][1]
    kw = _engine_kw(kv_cache_dtype=kv)
    if drafter != "ngram" and kv is None:
        sreqs = served["runs"][drafter]["treqs"]
    else:
        eng = ServingEngine(tnet, num_slots=2, device="cpu", drafter=dr, **kw)
        sreqs = _serve(eng, trace)
        st = eng.stats()
        assert st["spec_verify_steps"] > 0 and st["blocks_in_use"] == 0
        if drafter == "ngram":
            assert isinstance(eng._drafter, NGramDrafter)
            assert 0 < st["spec_accepted_tokens"] < st["spec_draft_tokens"]
    preqs = served["preqs"] if kv is None and drafter != "ngram" else \
        _serve(ServingEngine(tnet, num_slots=2, device="cpu", **kw), trace,
               spec=False)
    for s, p in zip(sreqs, preqs):
        np.testing.assert_array_equal(s.output, p.output)
    for (ids, m, k), s in zip(trace, sreqs):
        one = ServingEngine(tnet, num_slots=1, device="cpu", drafter=dr, **kw)
        alone = _serve(one, [(ids, m, k)])[0]
        np.testing.assert_array_equal(alone.output, s.output)


def test_spec_submit_guards_and_default_drafter(bridged):
    (_jnet, tnet), _ = bridged
    eng = ServingEngine(tnet, num_slots=1, device="cpu", **_engine_kw())
    with pytest.raises(ValueError, match="spec_decode"):
        eng.submit(np.zeros((4,), np.int32), spec_decode=0)
    # a REJECTED spec submit neither widens the verify width nor
    # installs the default drafter
    with pytest.raises(ValueError, match="max_cache_len"):
        eng.submit(np.zeros((4,), np.int32), max_new_tokens=100,
                   spec_decode=5)
    assert eng._spec_k_max == 0 and eng._drafter is None
    eng.submit(np.zeros((4,), np.int32), max_new_tokens=3, spec_decode=2)
    assert eng._spec_k_max == 2 and isinstance(eng._drafter, NGramDrafter)


@pytest.mark.parametrize("case", ["sampling_with_spec", "lora", "mesh"])
def test_unported_spec_compositions_raise(bridged, case):
    (_jnet, tnet), _ = bridged
    if case == "sampling_with_spec":
        # sampling composes with spec (speculative sampling); a token
        # mask does not, as in the reference
        eng = ServingEngine(tnet, num_slots=1, device="cpu", **_engine_kw())
        table = np.zeros((1, tiny_llama_config().vocab_size), np.int32)
        with pytest.raises(ValueError, match="token-mask"):
            eng.submit(np.zeros((3,), np.int32), spec_decode=2,
                       sampling=SamplingParams(
                           mask_processor=DfaTokenMask(table)))
        return
    kw = {"lora": {"adapter_store": object()},
          "mesh": {"mesh": object()}}[case]
    with pytest.raises(NotImplementedError, match="not ported"):
        ServingEngine(tnet, num_slots=1, device="cpu", drafter=NGramDrafter(),
                      **_engine_kw(**kw))


def test_build_spec_verify_guards_and_generate_raises(bridged):
    (_jnet, tnet), _ = bridged
    cfg = GenerationConfig()
    with pytest.raises(ValueError, match="steps"):
        build_spec_verify(tnet, cfg, 0)
    with pytest.raises(ValueError, match="mask"):
        build_spec_verify(tnet, cfg, 4, samp_flags=(True, False, False, True))
    for kw in ({"lora": True}, {"shard": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build_spec_verify(tnet, cfg, 4, **kw)
    ids = np.zeros((1, 4), np.int32)
    # beam generate() is ported (tests/test_torch_beam.py); with sampling
    # it raises the reference's ValueError
    assert tnet.generate(ids, num_beams=2, max_new_tokens=3,
                         compute_dtype="float32").shape == (1, 3)
    with pytest.raises(ValueError, match="beam"):
        tnet.generate(ids, num_beams=2, do_sample=True)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tnet.generate(ids, max_new_tokens=0)
    with pytest.raises(ValueError, match="seq_lens"):
        tnet.generate(ids, seq_lens=np.array([5]), compute_dtype="float32")
