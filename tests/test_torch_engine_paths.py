"""Engine paths of the port's ServingEngine held against the JAX engine,
and greedy ``generate()`` at a ragged batch held against the JAX model.

Both engines serve the same 7-request trace, in float32 on the same
weights (the JAX model's, carried by the weight bridge), eight ways:
mixed priorities, deadlines and future arrivals; a pool of 6 blocks
(requests wait for blocks to retire); ``static_batching=True``; an
``eos_token_id`` that fires; ``prefix_cache_mode="none"``; a 5-block
pool under priorities and arrivals with preemption on, where a
priority arrival swaps a running request out to host RAM
(``preempt_pressure``); the reference engine's defaults, the radix
cache with preemption (``radix``); and the radix cache over a 5-block
pool with an eighth request that arrives late and shares request 0's
first block after that block was demoted to the host tier, so it is
promoted back (``radix_host_tier``).  Both engines are built with the
same ``prefix_cache_mode`` ("digest" unless the path sets it) and
``enable_preemption`` (off unless the path sets it), the JAX one with
``async_dispatch=False``, and both run on a step clock the test owns
(``step(now)`` with now = 0, 1, 2, ..., the same ``clock`` injected for
the engines' own time stamps), so deadlines and arrivals are decided on
the same times.  For each path: the finish order, every integer counter
that both engines' ``stats()`` report, and the tokens up to each
request's first non-decisive position (top-2 margin of the
teacher-forced JAX logits <= 0.01, where float32 summation order may
flip an argmax) are equal, and at least 80% of all positions are
compared.  Each JAX engine gets its own ``MetricsRegistry`` (its
``stats()`` are registry deltas).

The same harness holds eleven compositions on the speculative trace of
``tests/test_torch_spec_serving.py`` (plus a sixth request): spec
decoding with a ``ModelDrafter`` over the target and over a 1-layer
model of another seed, each under an 8-block pool and under priorities,
deadlines and arrivals; the other-model drafter with static batching
and with ``prefix_cache_mode="none"``; int8 KV under an 8-block pool;
int8 KV + int8 weights under priorities; int8 KV with the other-model
drafter under an 8-block pool; int4 weights with the target drafter
under priorities (all with the digest cache and preemption off, as the
reference engine runs them so configured); and the 8-block-pool
target-drafter case again with the radix cache and preemption.  Each
compares the step count, the finish order, every shared integer counter
(``spec_*`` among them) and the tokens at decisive positions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.inference.speculative import ModelDrafter as JaxModelDrafter
from paddle_tpu.observability.metrics import MetricsRegistry
from paddle_tpu_torch.inference import ModelDrafter, ServingEngine
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)

P, C, BLK, CHUNK = 6, 32, 4, 4
MARGIN = 0.01
PAD = 7   # the EOS path's pad id: a finished stream is padded with it
# (prompt length, max_new_tokens, priority, deadline_s, arrival step)
SPECS = [(4, 12, 0, None, 0), (6, 3, 1, None, 0), (3, 10, 0, 4.0, 0),
         (5, 2, 2, None, 2), (2, 12, 0, 2.0, 3), (6, 6, 1, 6.0, 3),
         (4, 8, 0, None, 9)]
PATHS = {
    "priority_deadline_arrival": dict(),
    "pool_pressure": dict(num_blocks=6),
    "static_batching": dict(static_batching=True),
    "eos": dict(eos=True, pad_token_id=PAD),
    "prefix_cache_none": dict(prefix_cache_mode="none"),
    "preempt_pressure": dict(num_blocks=5, enable_preemption=True),
    "radix": dict(prefix_cache_mode="radix", enable_preemption=True),
    "radix_host_tier": dict(num_blocks=5, prefix_cache_mode="radix",
                            enable_preemption=True),
}
# the paths whose requests carry SPECS' priorities and deadlines, and
# those whose requests arrive at SPECS' arrival steps
PRIORITY_PATHS = ("priority_deadline_arrival", "preempt_pressure")
ARRIVAL_PATHS = PRIORITY_PATHS + ("radix_host_tier",)
# radix_host_tier's eighth request: request 0's first block (4 tokens)
# plus 2 of its own, arriving at step 10 (max_new_tokens, arrival step)
LATE_SHARER = (3, 10)


def _engine_kw():
    return dict(prompt_len=P, max_cache_len=C, steps_per_call=3,
                block_len=BLK, chunk_len=CHUNK, compute_dtype="float32",
                num_slots=2)


def _trace(vocab):
    """The specs' prompts; requests 0 and 5 share a 4-token prefix (one
    full block), so the digest cache can hit; then the late sharer's
    prompt (used by radix_host_tier only)."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n, *_ in SPECS]
    prompts[5][:4] = prompts[0][:4]
    late = np.concatenate([prompts[0][:4], np.random.default_rng(9).integers(
        0, vocab, (2,)).astype(np.int32)])
    return prompts + [late]


def _submissions(prompts, path):
    """The submit() keywords of ``path``'s requests, in order."""
    subs = []
    for ids, (_n, m, prio, dl, arr) in zip(prompts, SPECS):
        kw = dict(prompt_ids=ids, max_new_tokens=m)
        if path in PRIORITY_PATHS:
            kw.update(priority=prio, deadline_s=dl)
        if path in ARRIVAL_PATHS:
            kw.update(arrival_time=float(arr))
        subs.append(kw)
    if path == "radix_host_tier":
        subs.append(dict(prompt_ids=prompts[len(SPECS)],
                         max_new_tokens=LATE_SHARER[0],
                         arrival_time=float(LATE_SHARER[1])))
    return subs


class StepClock:
    """The engines' clock: the test sets it to the step number."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _drive(engine, clock, subs, path):
    """Submit the trace and step the engine on its step clock until
    every request has finished; returns the requests and the step
    count."""
    reqs = [engine.submit(**{k: (v.copy() if isinstance(v, np.ndarray)
                                 else v) for k, v in kw.items()})
            for kw in subs]
    steps = 0
    while len(engine._finished) < len(reqs):
        engine.step(clock.now)
        steps += 1
        clock.now += 1.0
        engine._pool.check()
        assert steps < 400, f"{path}: engine did not drain"
    return reqs, steps


def _margins(jnet, prompts, outs):
    """Top-2 margin of the teacher-forced JAX logits at every output
    position of every request."""
    width = max(len(ids) + len(o) - 1 for ids, o in zip(prompts, outs))
    seqs = np.zeros((len(prompts), max(width, 1)), np.int32)
    for i, (ids, o) in enumerate(zip(prompts, outs)):
        s = np.concatenate([ids, o[:-1]])
        seqs[i, :len(s)] = s
    logits = np.asarray(jnet(paddle.to_tensor(seqs))._value)
    out = []
    for i, (ids, o) in enumerate(zip(prompts, outs)):
        lg = logits[i, len(ids) - 1:len(ids) - 1 + len(o)]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        out.append(top2[:, 1] - top2[:, 0])
    return out


def _engines(jnet, tnet, opts, eos_id=None, engine_kw=None, drafters=None):
    opts = dict(opts)
    eos = opts.pop("eos", False)
    opts.setdefault("prefix_cache_mode", "digest")
    opts.setdefault("enable_preemption", False)
    if eos:
        opts["eos_token_id"] = eos_id
    kw = dict(_engine_kw() if engine_kw is None else engine_kw, **opts)
    jdr, tdr = drafters if drafters is not None else (None, None)
    tclock, jclock = StepClock(), StepClock()
    teng = ServingEngine(tnet, device="cpu", async_dispatch=False,
                         clock=tclock, drafter=tdr, **kw)
    jeng = JaxEngine(jnet, async_dispatch=False,
                     registry=MetricsRegistry(), clock=jclock, drafter=jdr,
                     **kw)
    return (teng, tclock), (jeng, jclock)


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
    """Every path through both engines, once.  The EOS id is the first
    token of request 0's output in the first path (JAX engine), at a
    position >= 1 before its last, that did not come up before it, so
    it fires there and the rest of the stream is padding."""
    jnet, tnet = bridged
    prompts = _trace(tiny_llama_config().vocab_size)
    runs, eos = {}, None
    for path in PATHS:
        (teng, tclock), (jeng, jclock) = _engines(
            jnet, tnet, PATHS[path], None if eos is None else eos[0])
        subs = _submissions(prompts, path)
        treqs, tsteps = _drive(teng, tclock, subs, path)
        jreqs, jsteps = _drive(jeng, jclock, subs, path)
        if eos is None:
            out0 = [int(x) for x in jreqs[0].output]
            pos = next(i for i in range(1, len(out0) - 1)
                       if out0[i] not in out0[:i] and out0[i] != PAD
                       and any(x != PAD for x in out0[i + 1:]))
            eos = (out0[pos], pos)
        jouts = [np.asarray(r.output) for r in jreqs]
        runs[path] = dict(teng=teng, jeng=jeng, treqs=treqs, jreqs=jreqs,
                          steps=(tsteps, jsteps), eos=eos,
                          margins=_margins(jnet, [kw["prompt_ids"]
                                                  for kw in subs], jouts))
    return runs


@pytest.mark.parametrize("path", list(PATHS))
def test_finish_order_and_counters_equal_jax(served, path):
    run = served[path]
    teng, jeng = run["teng"], run["jeng"]
    assert run["steps"][0] == run["steps"][1]
    assert [r.request_id for r in teng._finished] == \
        [r.request_id for r in jeng._finished]
    ts, js = teng.stats(), jeng.stats()
    shared = sorted(k for k in ts if k in js and type(ts[k]) is int)
    assert {"finished", "prefills", "decode_steps", "block_dispatches",
            "peak_queue", "prefix_hits", "peak_blocks_in_use",
            "kv_bytes_swept"} <= set(shared)
    for key in shared:
        assert ts[key] == js[key], (path, key, ts[key], js[key])
    assert ts["finished"] == len(run["treqs"])
    assert teng.engine_spec() == jeng.engine_spec()


@pytest.mark.parametrize("path", list(PATHS))
def test_tokens_equal_jax_at_decisive_positions(served, path):
    run = served[path]
    compared = total = 0
    for treq, jreq, margin in zip(run["treqs"], run["jreqs"],
                                  run["margins"]):
        tout, jout = np.asarray(treq.output), np.asarray(jreq.output)
        total += len(margin)
        undecided = np.flatnonzero(margin <= MARGIN)
        upto = int(undecided[0]) if undecided.size else len(margin)
        np.testing.assert_array_equal(tout[:upto], jout[:upto])
        if upto == len(margin):
            assert len(tout) == len(jout)
        compared += upto
    assert compared >= 0.8 * total, (path, compared, total)


def test_paths_do_what_they_name(served):
    """Each path engages what it names: priorities, deadlines and
    arrivals change the finish order against the same trace served
    first come first served, the small pool fills and takes more steps,
    static batching takes more steps than continuous batching, EOS stops
    request 0 at its chosen position, and without a prefix cache nothing
    hits."""
    def order(path):
        return [r.request_id for r in served[path]["teng"]._finished]

    assert order("priority_deadline_arrival") != order("prefix_cache_none")
    cont = served["prefix_cache_none"]["steps"][0]
    pool = served["pool_pressure"]
    assert pool["teng"].stats()["peak_blocks_in_use"] == 6
    assert pool["steps"][0] > cont
    assert served["static_batching"]["steps"][0] > cont
    run = served["eos"]
    eos_id, pos = run["eos"]
    for reqs in (run["treqs"], run["jreqs"]):
        out0 = [int(x) for x in reqs[0].output]
        assert out0[pos] == eos_id and out0[pos + 1:] == \
            [PAD] * (SPECS[0][1] - pos - 1)
    assert served["prefix_cache_none"]["teng"].stats()["prefix_hits"] == 0
    assert served["pool_pressure"]["teng"].stats()["prefix_hits"] > 0
    for path in PATHS:
        st = served[path]["teng"].stats()
        assert (st["preemptions"] > 0) == (path == "preempt_pressure")
        assert st["preempt_resumes"] == st["preemptions"]
        assert st["blocks_in_use"] == 0 and st["swapped_waiting"] == 0
        assert (st["prefix_host_hits"] > 0) == (path == "radix_host_tier")
    assert served["radix"]["teng"].stats()["prefix_hits"] > 0
    tier = served["radix_host_tier"]["teng"].stats()
    assert tier["host_swapin_blocks"] == 1 and tier["swap_blocks_out"] > 1


@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos_pad"])
def test_generate_ragged_batch_matches_jax(bridged, eos):
    """Greedy ``generate()`` at B=3 with ragged ``seq_lens`` (7, 3, 5):
    the port's tokens equal the JAX model's; with an EOS that fires
    (the JAX model's own token at row 1, step 2) and ``pad_token_id=7``,
    rows past their EOS hold the pad id in both."""
    jnet, tnet = bridged
    vocab = tiny_llama_config().vocab_size
    rng = np.random.default_rng(12)
    ids = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    lens = np.asarray([7, 3, 5], np.int32)
    for i, n in enumerate(lens):
        ids[i, n:] = 0
    kw = dict(seq_lens=lens, max_new_tokens=8, max_cache_len=16,
              compute_dtype="float32")

    def both(**extra):
        j = np.asarray(jnet.generate(paddle.to_tensor(ids), **kw,
                                     **extra)._value)
        t = tnet.generate(torch.from_numpy(ids), **kw, **extra)
        assert t.dtype == torch.int32 and tuple(t.shape) == (3, 8)
        return j, t.numpy()

    j, t = both()
    if eos:
        eos_id = int(j[1, 2])
        j, t = both(eos_token_id=eos_id, pad_token_id=7)
        row = list(j[1])
        assert row[2] == eos_id and row[3:] == [7] * 5
    np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# compositions on the speculative trace
# ---------------------------------------------------------------------------

SP, SC, SK, SCTX = 8, 40, 3, 24   # prompt_len, max_cache_len, K, context
# tests/test_torch_spec_serving.py's five requests and a sixth:
# (prompt length, max_new_tokens, spec_decode)
SPEC_TRACE = [(5, 9, SK), (8, 6, SK), (3, 11, 2), (7, 5, None), (6, 8, SK),
              (4, 7, 2)]
# the priority, deadline_s and arrival step of each, under "slo"
SPEC_SLO = [(0, None, 0), (1, None, 0), (0, 4.0, 0), (2, None, 2),
            (0, 2.0, 3), (1, 6.0, 3)]
COMPOSITIONS = {
    "target_pool8": dict(drafter="target", num_blocks=8),
    "target_slo": dict(drafter="target", slo=True),
    "other_pool8": dict(drafter="other", num_blocks=8),
    "other_slo": dict(drafter="other", slo=True),
    "other_static": dict(drafter="other", static_batching=True),
    "other_prefix_none": dict(drafter="other", prefix_cache_mode="none"),
    "int8kv_pool8": dict(drafter="target", kv_cache_dtype="int8",
                         num_blocks=8),
    "int8kv_int8w_slo": dict(drafter="target", kv_cache_dtype="int8",
                             weight_dtype="int8", slo=True),
    "int8kv_other_pool8": dict(drafter="other", kv_cache_dtype="int8",
                               num_blocks=8),
    "int4w_target_slo": dict(drafter="target", weight_dtype="int4",
                             slo=True),
    "target_pool8_radix_preempt": dict(drafter="target", num_blocks=8,
                                       prefix_cache_mode="radix",
                                       enable_preemption=True),
}
# the share of output positions that must be decisive, and so compared:
# int4 weights move the logits so far from the float model's that fewer
# positions are decisive (26 of 46 on this trace)
MIN_COMPARED = {"int4w_target_slo": 0.5}


def _spec_engine_kw():
    return dict(prompt_len=SP, max_cache_len=SC, steps_per_call=2,
                block_len=BLK, chunk_len=CHUNK, compute_dtype="float32",
                num_slots=2)


def _spec_submissions(slo):
    rng = np.random.default_rng(6)
    vocab = tiny_llama_config().vocab_size
    subs = []
    for (n, m, k), (prio, dl, arr) in zip(SPEC_TRACE, SPEC_SLO):
        kw = dict(prompt_ids=rng.integers(0, vocab, (n,)).astype(np.int32),
                  max_new_tokens=m, spec_decode=k)
        if slo:
            kw.update(priority=prio, deadline_s=dl, arrival_time=float(arr))
        subs.append(kw)
    return subs


def _paged_margins(jnet, subs, outs, kv_dtype, wd):
    """Top-2 margins of the JAX model's teacher-forced logits in the
    composition's configuration (paged arenas of ``kv_dtype``, weights
    under ``wd``'s plan): the prompt as one chunk, then one decode step
    per emitted token."""
    import contextlib

    import jax.numpy as jnp
    from paddle_tpu.inference.llm import build_weight_quant_plan as j_plan
    from paddle_tpu.models.generation import init_paged_kv_arena as j_arena
    from paddle_tpu.models.wquant import wquant_context as j_wquant
    cfg = jmodels.tiny_llama_config()
    nl, hkv = cfg.num_hidden_layers, cfg.num_key_value_heads
    d = cfg.hidden_size // cfg.num_attention_heads
    mb = SC // BLK
    row = jnp.asarray(np.arange(mb, dtype=np.int32)[None, :])
    ctx = contextlib.nullcontext()
    if wd is not None:
        plan = j_plan(jnet, wd)
        ctx = j_wquant(plan.bind(plan.flat_values()))
    dt = jnp.int8 if kv_dtype == "int8" else jnp.float32
    out = []
    with ctx:
        for kw, o in zip(subs, outs):
            ids = kw["prompt_ids"]
            n = len(ids)
            kvs = [tuple(e) + (row,) for e in j_arena(nl, mb, BLK, hkv, d, dt)]
            lg, kvs = jnet.prefill_chunk(
                jnp.asarray(ids[None, :]), jnp.asarray(0, jnp.int32),
                jnp.asarray(n, jnp.int32), kvs)
            rows = [np.asarray(lg)[0]]
            for t in range(len(o) - 1):
                lg, kvs = jnet.decode_step(
                    jnp.asarray([o[t]], jnp.int32),
                    jnp.asarray([n + t], jnp.int32), kvs)
                rows.append(np.asarray(lg)[0])
            top2 = np.sort(np.stack(rows), axis=-1)[:, -2:]
            out.append(top2[:, 1] - top2[:, 0])
    return out


@pytest.fixture(scope="module")
def other_bridged():
    """A 1-layer model of another seed, in both packages: the drafter
    whose proposals the target rejects."""
    paddle.seed(77)
    jcfg = dataclasses.replace(jmodels.tiny_llama_config(),
                               num_hidden_layers=1)
    jnet = jmodels.LlamaForCausalLM(jcfg)
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(dataclasses.replace(tiny_llama_config(),
                                                num_hidden_layers=1),
                            device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    return jnet, tnet


@pytest.fixture(scope="module")
def composed(bridged, other_bridged):
    """Every composition through both engines, once."""
    jnet, tnet = bridged
    dkw = dict(max_context=SCTX, max_draft=SK, compute_dtype="float32")
    runs = {}
    for name, comp in COMPOSITIONS.items():
        opts = dict(comp)
        dm = {"target": (jnet, tnet), "other": other_bridged}[
            opts.pop("drafter")]
        slo = opts.pop("slo", False)
        (teng, tclock), (jeng, jclock) = _engines(
            jnet, tnet, opts, engine_kw=_spec_engine_kw(),
            drafters=(JaxModelDrafter(dm[0], **dkw),
                      ModelDrafter(dm[1], **dkw)))
        subs = _spec_submissions(slo)
        treqs, tsteps = _drive(teng, tclock, subs, name)
        jreqs, jsteps = _drive(jeng, jclock, subs, name)
        runs[name] = dict(
            teng=teng, jeng=jeng, treqs=treqs, jreqs=jreqs,
            steps=(tsteps, jsteps),
            margins=_paged_margins(jnet, subs, [r.output for r in jreqs],
                                   opts.get("kv_cache_dtype"),
                                   opts.get("weight_dtype")))
    return runs


@pytest.mark.parametrize("name", list(COMPOSITIONS))
def test_composition_matches_jax(composed, name):
    run = composed[name]
    teng, jeng = run["teng"], run["jeng"]
    assert run["steps"][0] == run["steps"][1]
    assert [r.request_id for r in teng._finished] == \
        [r.request_id for r in jeng._finished]
    ts, js = teng.stats(), jeng.stats()
    shared = sorted(k for k in ts if k in js and type(ts[k]) is int)
    assert {"spec_verify_steps", "spec_accepted_tokens", "prefix_hits",
            "peak_blocks_in_use", "kv_bytes_swept"} <= set(shared)
    for key in shared:
        assert ts[key] == js[key], (name, key, ts[key], js[key])
    assert ts["finished"] == len(SPEC_TRACE)
    assert ts["spec_verify_steps"] > 0
    if "pool8" in name:
        assert ts["peak_blocks_in_use"] == 8
    compared = total = 0
    for treq, jreq, margin in zip(run["treqs"], run["jreqs"],
                                  run["margins"]):
        total += len(margin)
        undecided = np.flatnonzero(margin <= MARGIN)
        upto = int(undecided[0]) if undecided.size else len(margin)
        np.testing.assert_array_equal(treq.output[:upto],
                                      jreq.output[:upto])
        compared += upto
    assert compared >= MIN_COMPARED.get(name, 0.8) * total, \
        (name, compared, total)
