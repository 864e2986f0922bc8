"""The port's sampled serving engine held against the JAX engine built the
same way, in lockstep on a step clock the test owns (the harness of
``tests/test_torch_async.py``), at ``async_dispatch=False`` and at
``async_depth`` 1 and 3.

The trace mixes greedy rows with seeded and seedless temperature rows,
top-k/top-p rows, a repetition-penalty row, a DFA-mask row, a mask row
whose grammar dead-ends, a row preempted between steps and resumed, and
a late request that hits the radix prefix cache.  For each arm the step
count, the finish order, every integer counter both engines' ``stats()``
report (the four sample counters among them) and the forced syncs by
reason (``mask`` and ``penalty`` charged) are equal, and the tokens are
equal up to each request's first non-decisive position: for a sampled
position the top-two margin of the JAX side's teacher-forced perturbed
scores (processed logits / T, filtered, plus the Gumbel noise of the same
key) must exceed 0.01, for a greedy one that of the processed logits.

Also: a seeded request's stream does not depend on the batch around it,
its slot, prefix hits or engine restarts (``tests/test_sampling.py:151``);
a sampled spec engine with ``ModelDrafter``s over the target and over
another model matches the JAX spec engine (``sample_resamples``
included); and ``do_sample=True`` and ``submit(sampling=)`` construct
while every other unported keyword still raises, naming its item.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import sampling as J
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.inference.speculative import ModelDrafter as JaxModelDrafter
from paddle_tpu.models.generation import filter_top_k_top_p as j_filter
from paddle_tpu.observability.metrics import MetricsRegistry
from paddle_tpu_torch.observability import (
    MetricsRegistry as TorchRegistry)
from paddle_tpu_torch.inference import (DfaTokenMask, ModelDrafter,
                                        SamplingParams, ServingEngine)
from paddle_tpu_torch.inference.serving import (ASYNC_SYNC_REASONS,
                                                TERMINAL_STATES)
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)

MARGIN = 0.01
ARMS = (0, 1, 3)            # 0: async_dispatch=False
V = tiny_llama_config().vocab_size
KW = dict(num_slots=3, prompt_len=8, max_cache_len=40, steps_per_call=2,
          block_len=4, chunk_len=4, num_blocks=24, compute_dtype="float32")
SAMPLE_KEYS = ("sampled_tokens", "greedy_tokens", "masked_tokens",
               "sample_resamples")


class StepClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _bridge(seed, layers=None):
    cfg = jmodels.tiny_llama_config()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    paddle.seed(seed)
    jnet = jmodels.LlamaForCausalLM(cfg)
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(dataclasses.replace(
        tiny_llama_config(), num_hidden_layers=cfg.num_hidden_layers),
        device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    return jnet, tnet


@pytest.fixture(scope="module")
def bridged():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _bridge(2024), _bridge(77, layers=1)
    torch.set_num_threads(prev)


def _walk_table():
    """A grammar that never ends: even states allow tokens 10..59, odd
    states 60..109, each token flips the parity."""
    t = np.full((2, V), -1, np.int32)
    t[0, 10:60] = 1
    t[1, 60:110] = 0
    return t


def _end_table():
    """A grammar that ends after three tokens: 20..29, then 30..39, then
    40..49, then nothing."""
    t = np.full((4, V), -1, np.int32)
    t[0, 20:30] = 1
    t[1, 30:40] = 2
    t[2, 40:50] = 3
    return t


def _trace(api):
    """Stages of (submissions, actions by step); ``api`` is the package's
    (SamplingParams, DfaTokenMask)."""
    SP, Dfa = api
    rng = np.random.default_rng(21)
    p = [rng.integers(0, V, (n,)).astype(np.int32)
         for n in (6, 5, 7, 4, 8, 6, 5, 3)]
    shared = np.concatenate([p[4][:4], rng.integers(0, V, (3,)).astype(
        np.int32)])
    first = [
        dict(prompt_ids=p[0], max_new_tokens=10),
        dict(prompt_ids=p[1], max_new_tokens=9,
             sampling=SP(temperature=0.8, seed=7)),
        dict(prompt_ids=p[2], max_new_tokens=8,
             sampling=SP(temperature=1.2)),
        dict(prompt_ids=p[3], max_new_tokens=9,
             sampling=SP(temperature=0.9, top_k=20, top_p=0.9, seed=3)),
        dict(prompt_ids=p[4], max_new_tokens=8,
             sampling=SP(temperature=0.0, repetition_penalty=1.3)),
        dict(prompt_ids=p[5], max_new_tokens=8,
             sampling=SP(temperature=1.0, seed=4,
                         mask_processor=Dfa(_walk_table()))),
        dict(prompt_ids=p[6], max_new_tokens=7,
             sampling=SP(temperature=0.0, mask_processor=Dfa(_end_table()))),
    ]
    second = [dict(prompt_ids=shared, max_new_tokens=6,
                   sampling=SP(temperature=0.7, top_p=0.8, seed=11)),
              dict(prompt_ids=p[7], max_new_tokens=5,
                   sampling=SP(temperature=0.9, repetition_penalty=1.2,
                               seed=5))]
    # request 1 (seeded, sampled) is preempted between steps and resumes
    return [(first, {5: ("preempt", 1)}), (second, {})]


def _build(cls, net, arm, **extra):
    clock = StepClock()
    if cls is JaxEngine:
        extra["registry"] = MetricsRegistry()
    else:
        extra.update(device="cpu", registry=TorchRegistry())
    mode = dict(async_dispatch=False) if arm == 0 else dict(
        async_dispatch=True, async_depth=arm)
    return cls(net, clock=clock, **mode, **KW, **extra), clock


def _drive(eng, clock, stages):
    reqs, steps = [], 0
    for subs, actions in stages:
        first = len(reqs)
        for s in subs:
            reqs.append(eng.submit(**copy.deepcopy(s)))
        start = steps
        while any(r.state not in TERMINAL_STATES for r in reqs):
            act = actions.get(steps - start)
            if act is not None:
                r = reqs[first + act[1]]
                if r.state in ("prefill", "decode"):
                    eng._preempt(r)
            eng.step(clock.now)
            clock.now += 1.0
            steps += 1
            eng._pool.check()
            assert steps < 400, "engine did not drain"
    eng.run()
    eng._pool.check()
    return reqs, steps


def _real_len(req):
    """Emitted tokens before a mask row's grammar ended (the rest pad)."""
    mp = req.sampling.mask_processor if req.sampling is not None else None
    if mp is None:
        return len(req.output)
    table, s = mp.table, mp.start_state
    for t, tok in enumerate(req.output):
        s = int(table[s, int(tok)])
        if not (table[s] >= 0).any():
            return t + 1
    return len(req.output)


def _margins(jnet, req):
    """Per output position of a JAX request: the top-two margin of the
    scores that decide it, from the teacher-forced logits of the JAX
    model (positions after a grammar's end read +inf: both engines pad
    them)."""
    ids = req.prompt[:req.seq_len]
    out = np.asarray(req.output)
    n = _real_len(req)
    s = np.concatenate([ids, out[:-1]])[None]
    lg = np.asarray(jnet(paddle.to_tensor(s))._value)[0]
    lg = lg[len(ids) - 1:len(ids) - 1 + len(out)]
    sp = req.sampling or J.GREEDY
    mp = sp.mask_processor
    state = mp.start_state if mp is not None else None
    margins = np.full((len(out),), np.inf)
    for t in range(n):
        row = jnp.asarray(lg[t:t + 1])
        if sp.needs_penalty:
            pres = np.zeros((1, V), bool)
            pres[0, ids] = True
            pres[0, out[:t]] = True
            pen = jnp.where(row > 0, row / sp.repetition_penalty,
                            row * sp.repetition_penalty)
            row = jnp.where(jnp.asarray(pres), pen, row)
        if mp is not None:
            allowed = mp.table[state] >= 0
            row = row + jnp.asarray(np.where(allowed, 0.0, J.MASK_BIAS)
                                    .astype(np.float32))[None]
            state = int(mp.table[state, int(out[t])])
        if not sp.is_greedy:
            temp, top_k, top_p, _g = J.row_planes(sp)
            row = row / np.float32(temp)
            if top_k > 0 or top_p < 1.0:
                row = j_filter(row, jnp.asarray([top_k]),
                               jnp.asarray([top_p], jnp.float32))
            key = J._fold_keys(jnp.asarray(req.samp_base[None]),
                               jnp.asarray([t]), 1)[0]
            row = row + jax.random.gumbel(key, (V,))[None]
        top2 = np.sort(np.asarray(row)[0])[-2:]
        margins[t] = top2[1] - top2[0]
    return margins


def _int_stats(eng):
    return {k: v for k, v in eng.stats().items() if type(v) is int}


@pytest.fixture(scope="module")
def runs(bridged):
    (jnet, tnet), _ = bridged
    out = {}
    for arm in ARMS:
        jeng, jclock = _build(JaxEngine, jnet, arm)
        jreqs, jsteps = _drive(jeng, jclock,
                               _trace((J.SamplingParams, J.DfaTokenMask)))
        teng, tclock = _build(ServingEngine, tnet, arm)
        treqs, tsteps = _drive(teng, tclock,
                               _trace((SamplingParams, DfaTokenMask)))
        out[arm] = dict(jeng=jeng, jreqs=jreqs, teng=teng, treqs=treqs,
                        steps=(tsteps, jsteps))
    out["margins"] = [_margins(jnet, r) for r in out[0]["jreqs"]]
    return out


@pytest.mark.parametrize("arm", ARMS)
def test_sampled_schedule_and_counters_equal_jax(runs, arm):
    run = runs[arm]
    teng, jeng = run["teng"], run["jeng"]
    assert run["steps"][0] == run["steps"][1]
    assert [r.request_id for r in teng._finished] == \
        [r.request_id for r in jeng._finished]
    assert [r.state for r in run["treqs"]] == [r.state for r in run["jreqs"]]
    ts, js = _int_stats(teng), _int_stats(jeng)
    shared = sorted(k for k in ts if k in js)
    assert set(SAMPLE_KEYS) | {"decode_steps", "block_dispatches",
                               "preemptions", "preempt_resumes",
                               "prefix_hits", "kv_bytes_swept"} <= \
        set(shared)
    for key in shared:
        assert ts[key] == js[key], (arm, key, ts[key], js[key])
    tst, jst = teng.stats(), jeng.stats()
    assert tst["async_syncs_by_reason"] == jst["async_syncs_by_reason"]
    assert set(tst["async_syncs_by_reason"]) == set(ASYNC_SYNC_REASONS)
    assert ts["preemptions"] == ts["preempt_resumes"] == 1
    assert ts["prefix_hits"] > 0
    assert ts["sampled_tokens"] > 0 and ts["greedy_tokens"] > 0
    assert ts["masked_tokens"] > 0
    if arm:
        by = tst["async_syncs_by_reason"]
        assert by["mask"] > 0 and by["penalty"] > 0, by
    # the decode programs built: both caches key on (total steps, flag
    # bucket, lora)
    jkeys = sorted({(k[0], tuple(k[1]), k[2]) for k in jeng._blocks})
    tkeys = sorted(teng._blocks)
    assert tkeys == jkeys


@pytest.mark.parametrize("arm", ARMS)
def test_sampled_tokens_equal_jax_at_decisive_positions(runs, arm):
    run = runs[arm]
    compared = total = 0
    for treq, jreq, margin in zip(run["treqs"], run["jreqs"],
                                  runs["margins"]):
        tout, jout = np.asarray(treq.output), np.asarray(jreq.output)
        assert len(tout) == len(jout) == len(margin)
        undecided = np.flatnonzero(margin <= MARGIN)
        upto = int(undecided[0]) if undecided.size else len(margin)
        np.testing.assert_array_equal(tout[:upto], jout[:upto])
        compared += upto
        total += len(margin)
    print(f"sampled serving, arm {arm}: {compared} of {total} positions "
          f"compared")
    # a row is compared up to its first undecided draw, and the short
    # random prompts of the tiny model leave near-ties (48 of 70 here)
    assert compared >= 0.5 * total


def test_arms_equal_each_other_and_masks_hold(runs):
    """The three port arms emit the same tokens (positions re-derived
    from host truth plus the pending steps), and every mask row's tokens
    are legal under its DFA."""
    base = [r.output.tolist() for r in runs[0]["treqs"]]
    for arm in ARMS[1:]:
        assert [r.output.tolist() for r in runs[arm]["treqs"]] == base
    for r in runs[0]["treqs"]:
        mp = r.sampling.mask_processor if r.sampling else None
        if mp is None:
            continue
        s = mp.start_state
        for tok in r.output[:_real_len(r)]:
            assert mp.table[s, int(tok)] >= 0, (r.request_id, r.output)
            s = mp.table[s, int(tok)]
    ended = runs[0]["treqs"][6]
    assert _real_len(ended) == 3 and ended.state == "finished"
    assert (ended.output[3:] == 0).all()


def test_seeded_streams_independent_of_batch(bridged):
    """A seeded request's stream is a function of (seed, prompt): alone
    in an engine, in a mixed batch through 2 slots with slot reuse and
    prefix hits, and in a fresh engine it is the same; greedy-degenerate
    rows (temperature 0, top_k = 1) in the sampled mix equal plain greedy
    rows; seedless requests get distinct streams."""
    (_jnet, tnet), _ = bridged
    rng = np.random.default_rng(3)
    ids = rng.integers(1, V, (7,)).astype(np.int32)
    sp = dict(temperature=0.9, top_k=12, top_p=0.95)
    kw = dict(num_slots=2, prompt_len=8, max_cache_len=24, steps_per_call=3,
              block_len=4, chunk_len=4, compute_dtype="float32",
              device="cpu")
    e = ServingEngine(tnet, **kw)
    a = e.submit(ids, max_new_tokens=7, sampling=SamplingParams(seed=7, **sp))
    e.run()
    stream7 = a.output.copy()
    e2 = ServingEngine(tnet, **kw)
    g = e2.submit(ids, max_new_tokens=7)
    s7 = e2.submit(ids, max_new_tokens=7,
                   sampling=SamplingParams(seed=7, **sp))
    t0 = e2.submit(ids, max_new_tokens=7,
                   sampling=SamplingParams(temperature=0.0))
    k1 = e2.submit(ids, max_new_tokens=3,
                   sampling=SamplingParams(temperature=0.8, top_k=1))
    s8 = e2.submit(ids, max_new_tokens=7,
                   sampling=SamplingParams(seed=8, **sp))
    e2.run()
    np.testing.assert_array_equal(s7.output, stream7)
    np.testing.assert_array_equal(t0.output, g.output)
    np.testing.assert_array_equal(k1.output, g.output[:3])
    assert not np.array_equal(s8.output, stream7)
    st = e2.stats()
    assert st["prefix_hits"] > 0
    assert st["sampled_tokens"] >= 14 and st["greedy_tokens"] >= 17
    e3 = ServingEngine(tnet, **kw)
    c = e3.submit(ids, max_new_tokens=7,
                  sampling=SamplingParams(seed=7, **sp))
    e3.run()
    np.testing.assert_array_equal(c.output, stream7)
    np.testing.assert_array_equal(c.samp_base, np.asarray(
        jax.random.PRNGKey(7), np.uint32))
    n1 = e3.submit(ids, max_new_tokens=5, sampling=SamplingParams(**sp))
    n2 = e3.submit(ids, max_new_tokens=5, sampling=SamplingParams(**sp))
    assert not np.array_equal(n1.samp_base, n2.samp_base)
    np.testing.assert_array_equal(n1.samp_base, np.asarray(
        jax.random.fold_in(jax.random.PRNGKey(0), n1.request_id), np.uint32))
    e3.run()
    # engine-default sampling: a replayed submission order reproduces
    outs = []
    for _ in range(2):
        ed = ServingEngine(tnet, do_sample=True, temperature=0.9, top_k=12,
                           seed=11, **kw)
        d1 = ed.submit(ids, max_new_tokens=5)
        d2 = ed.submit(ids[:6], max_new_tokens=5)
        ed.run()
        outs.append((d1.output.copy(), d2.output.copy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


SPEC_KW = dict(num_slots=2, prompt_len=8, max_cache_len=40,
               steps_per_call=2, block_len=4, chunk_len=4,
               compute_dtype="float32", async_dispatch=False,
               prefix_cache_mode="digest", enable_preemption=False)


def _spec_trace(SP):
    rng = np.random.default_rng(6)
    return [(rng.integers(0, V, (n,)).astype(np.int32), m, k, s)
            for n, m, k, s in ((5, 9, 3, SP(temperature=0.8, seed=1)),
                               (8, 6, 3, SP(temperature=1.0, top_k=30,
                                            seed=2)),
                               (3, 10, 2, None),
                               (7, 5, 3, SP(temperature=0.9, top_p=0.9,
                                            repetition_penalty=1.2,
                                            seed=3)))]


@pytest.mark.parametrize("drafter", ["target", "other"])
def test_sampled_spec_engine_equals_jax(bridged, drafter):
    (jnet, tnet), (jother, tother) = bridged
    dkw = dict(max_context=24, max_draft=3, compute_dtype="float32")
    jd, td = ((JaxModelDrafter(jnet, **dkw), ModelDrafter(tnet, **dkw))
              if drafter == "target" else
              (JaxModelDrafter(jother, **dkw), ModelDrafter(tother, **dkw)))
    jeng = JaxEngine(jnet, drafter=jd, registry=MetricsRegistry(), **SPEC_KW)
    teng = ServingEngine(tnet, drafter=td, device="cpu",
                         registry=TorchRegistry(), **SPEC_KW)
    jreqs = [jeng.submit(ids, max_new_tokens=m, spec_decode=k, sampling=s)
             for ids, m, k, s in _spec_trace(J.SamplingParams)]
    treqs = [teng.submit(ids, max_new_tokens=m, spec_decode=k, sampling=s)
             for ids, m, k, s in _spec_trace(SamplingParams)]
    jeng.run(max_iters=500)
    teng.run(max_iters=500)
    compared = total = 0
    all_decisive = True
    for treq, jreq in zip(treqs, jreqs):
        margin = _margins(jnet, jreq)
        undecided = np.flatnonzero(margin <= MARGIN)
        upto = int(undecided[0]) if undecided.size else len(margin)
        all_decisive &= upto == len(margin)
        np.testing.assert_array_equal(treq.output[:upto], jreq.output[:upto])
        compared += upto
        total += len(margin)
    print(f"sampled spec ({drafter} drafter): {compared} of {total} "
          f"positions compared")
    assert compared >= 0.75 * total
    ts, js = teng.stats(), jeng.stats()
    assert ts["spec_verify_steps"] > 0 and ts["sampled_tokens"] > 0
    if drafter == "other":
        assert ts["sample_resamples"] > 0
    # the trace's every position is decisive (30 of 30), so the draws,
    # drafts and counters can be held equal
    assert all_decisive
    for key in SAMPLE_KEYS + ("spec_verify_steps", "spec_draft_tokens",
                              "spec_accepted_tokens", "decode_steps"):
        assert ts[key] == js[key], (key, ts[key], js[key])


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=object()), "#10"),
    (dict(adapter_store="store"), "#7"), (dict(tenant_weights={"a": 1.0}),
                                          "#7")],
    ids=lambda x: next(iter(x)) if isinstance(x, dict) else x)
def test_sampling_constructs_other_keywords_still_raise(bridged, kw, item):
    """The sampling engine serves; ``mesh=`` (#10) still raises.  The #7
    keywords are ported: ``adapter_store=`` and ``tenant_weights=`` build
    a sampling engine that serves a seeded sampled row on an adapter and
    a tenant, beside a default-sampled base row, and the store and the
    tenant ledger see the run."""
    from paddle_tpu_torch.inference import AdapterStore, LoraAdapter
    (_jnet, tnet), _ = bridged
    base = dict(num_slots=1, prompt_len=4, max_cache_len=12,
                compute_dtype="float32", device="cpu")
    eng = ServingEngine(tnet, do_sample=True, temperature=0.7, top_p=0.9,
                        **base)
    r = eng.submit(np.arange(3, dtype=np.int32), max_new_tokens=3,
                   sampling=SamplingParams(temperature=0.5, seed=1))
    d = eng.submit(np.arange(3, dtype=np.int32), max_new_tokens=3)
    eng.run()
    assert r.state == d.state == "finished"
    assert eng.stats()["sampled_tokens"] == 6
    ids = np.arange(3, dtype=np.int32)
    if item == "#10":
        with pytest.raises(NotImplementedError, match=item):
            ServingEngine(tnet, **base, **kw)
    else:
        reg = TorchRegistry()
        if "adapter_store" in kw:
            store = AdapterStore(tnet, slots=1, max_rank=2,
                                 dtype="float32", registry=reg,
                                 device="cpu")
            store.register(LoraAdapter.random(tnet.config, "a", rank=2,
                                              seed=5, scale=0.2))
            kw = dict(adapter_store=store)
        e7 = ServingEngine(tnet, do_sample=True, temperature=0.7,
                           top_p=0.9, registry=reg, **base, **kw)
        ra = e7.submit(ids, max_new_tokens=3,
                       sampling=SamplingParams(temperature=0.5, seed=1),
                       adapter="a" if "adapter_store" in kw else None,
                       tenant="a")
        rb = e7.submit(ids, max_new_tokens=3, tenant="b")
        e7.run()
        assert ra.state == rb.state == "finished"
        st = e7.stats()
        assert st["sampled_tokens"] == 6
        assert st["tenant_served_tokens"] == {"a": 6, "b": 6}
        assert st["lora_dispatches"] == (3 if "adapter_store" in kw else 0)
        if "adapter_store" not in kw:
            # same seed, same row, no adapter: the base engine's stream
            np.testing.assert_array_equal(ra.output, r.output)
    # submit(adapter=) without a store is the JAX engine's ValueError;
    # submit(tenant=) serves
    with pytest.raises(ValueError, match="adapter_store"):
        eng.submit(ids, max_new_tokens=3, adapter="a")
    t = eng.submit(ids, max_new_tokens=3, tenant="t")
    eng.run()
    assert t.state == "finished"
    assert eng.stats()["tenant_served_tokens"]["t"] == 6
    with pytest.raises(ValueError, match="SamplingParams"):
        eng.submit(ids, max_new_tokens=3, sampling="greedy")
    with pytest.raises(ValueError, match="no legal first"):
        eng.submit(ids, max_new_tokens=3, sampling=SamplingParams(
            mask_processor=DfaTokenMask(np.full((1, V), -1, np.int32))))
    with pytest.raises(ValueError, match="vocabulary"):
        eng.submit(ids, max_new_tokens=3, sampling=SamplingParams(
            mask_processor=DfaTokenMask(np.zeros((1, 7), np.int32))))
    assert eng._pool.in_use() == 0 and not eng._queue


@pytest.mark.parametrize("which", ["fault_injector", "registry",
                                   "flight_recorder"])
def test_sampled_engine_serves_with_observability_keyword(bridged, which):
    """``fault_injector=``, ``registry=`` and ``flight_recorder=`` are
    ported: each constructs a sampling engine that serves a seeded
    sampled request and a default-sampled one, and the keyword's object
    sees the run (the injector's forced swap fires and the request
    resumes to the same tokens, the private registry counts the sampled
    tokens, the recorder holds both lifecycles)."""
    from paddle_tpu_torch.inference import FaultInjector
    from paddle_tpu_torch.observability import FlightRecorder
    (_jnet, tnet), _ = bridged
    base = dict(num_slots=2, prompt_len=4, max_cache_len=12,
                compute_dtype="float32", device="cpu", do_sample=True,
                temperature=0.7, top_p=0.9)

    def serve(**kw):
        eng = ServingEngine(tnet, **base, **kw)
        r = eng.submit(np.arange(3, dtype=np.int32), max_new_tokens=6,
                       sampling=SamplingParams(temperature=0.5, seed=1))
        d = eng.submit(np.arange(3, dtype=np.int32), max_new_tokens=6)
        for _ in range(2):
            eng.step()
        return eng, r, d

    ref, r0, d0 = serve(registry=TorchRegistry())
    ref.run()
    obj = {"fault_injector": FaultInjector(), "registry": TorchRegistry(),
           "flight_recorder": FlightRecorder()}[which]
    eng, r, d = serve(**{which: obj})
    if which == "fault_injector":
        obj.force_swap(r.request_id)
    eng.run(wall_timeout_s=60)
    assert r.state == d.state == "finished"
    np.testing.assert_array_equal(r.output, r0.output)
    np.testing.assert_array_equal(d.output, d0.output)
    assert eng._pool.check()
    if which == "fault_injector":
        assert ("forced_swap", r.request_id) in obj.events
        assert eng.stats()["preemptions"] == 1
    elif which == "registry":
        assert eng.metrics_registry is obj
        assert obj.get("serving.sample.sampled_tokens").value() == 12
    else:
        for q in (r, d):
            kinds = [e.kind for e in obj.timeline(q.request_id)]
            assert kinds[:3] == ["submit", "admit", "prefill_chunk"]
            assert kinds[-1] == "finish"
        assert "finished at step" in eng.explain(r.request_id)
