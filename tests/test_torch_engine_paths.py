"""Engine paths of the port's ServingEngine held against the JAX engine,
and greedy ``generate()`` at a ragged batch held against the JAX model.

Both engines serve the same 7-request trace, in float32 on the same
weights (the JAX model's, carried by the weight bridge), five ways:
mixed priorities, deadlines and future arrivals; a pool of 6 blocks
(requests wait for blocks to retire); ``static_batching=True``; an
``eos_token_id`` that fires; and ``prefix_cache_mode="none"``.  Both
are built as the port runs the reference engine: ``prefix_cache_mode``
given to both ("digest" unless the path sets it), ``async_dispatch=
False``, ``enable_preemption=False``, and a step clock the test owns
(``step(now)`` with now = 0, 1, 2, ..., the same ``clock`` injected for
the engines' own time stamps), so deadlines and arrivals are decided on
the same times.  For each path: the finish order, every integer counter
that both engines' ``stats()`` report, and the tokens up to each
request's first non-decisive position (top-2 margin of the
teacher-forced JAX logits <= 0.01, where float32 summation order may
flip an argmax) are equal, and at least 80% of all positions are
compared.  Each JAX engine gets its own ``MetricsRegistry`` (its
``stats()`` are registry deltas).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.observability.metrics import MetricsRegistry
from paddle_tpu_torch.inference import ServingEngine
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
}


def _engine_kw():
    return dict(prompt_len=P, max_cache_len=C, steps_per_call=3,
                block_len=BLK, chunk_len=CHUNK, compute_dtype="float32",
                num_slots=2)


def _trace(vocab):
    """The specs' prompts; requests 0 and 5 share a 4-token prefix (one
    full block), so the digest cache can hit."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n, *_ in SPECS]
    prompts[5][:4] = prompts[0][:4]
    return prompts


class StepClock:
    """The engines' clock: the test sets it to the step number."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _drive(engine, clock, prompts, path):
    """Submit the trace and step the engine on its step clock until
    every request has finished; returns the requests and the step
    count."""
    reqs = []
    for ids, (_n, m, prio, dl, arr) in zip(prompts, SPECS):
        kw = {}
        if path == "priority_deadline_arrival":
            kw = dict(priority=prio, deadline_s=dl, arrival_time=float(arr))
        reqs.append(engine.submit(ids, max_new_tokens=m, **kw))
    steps = 0
    while len(engine._finished) < len(reqs):
        engine.step(clock.now)
        steps += 1
        clock.now += 1.0
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


def _engines(jnet, tnet, path, eos_id):
    opts = dict(PATHS[path])
    eos = opts.pop("eos", False)
    opts.setdefault("prefix_cache_mode", "digest")
    if eos:
        opts["eos_token_id"] = eos_id
    tclock, jclock = StepClock(), StepClock()
    teng = ServingEngine(tnet, device="cpu", clock=tclock, **_engine_kw(),
                         **opts)
    jeng = JaxEngine(jnet, async_dispatch=False, enable_preemption=False,
                     registry=MetricsRegistry(), clock=jclock,
                     **_engine_kw(), **opts)
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
            jnet, tnet, path, None if eos is None else eos[0])
        treqs, tsteps = _drive(teng, tclock, prompts, path)
        jreqs, jsteps = _drive(jeng, jclock, prompts, path)
        if eos is None:
            out0 = [int(x) for x in jreqs[0].output]
            pos = next(i for i in range(1, len(out0) - 1)
                       if out0[i] not in out0[:i] and out0[i] != PAD
                       and any(x != PAD for x in out0[i + 1:]))
            eos = (out0[pos], pos)
        jouts = [np.asarray(r.output) for r in jreqs]
        runs[path] = dict(teng=teng, jeng=jeng, treqs=treqs, jreqs=jreqs,
                          steps=(tsteps, jsteps), eos=eos,
                          margins=_margins(jnet, prompts, jouts))
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
    assert ts["finished"] == len(SPECS)
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
