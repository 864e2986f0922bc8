"""Preemption, host-RAM swap, cancel, the bounded queue and queue-delay
timeouts of the port's engine, held against the JAX engine
(``enable_preemption=True, async_dispatch=False``, the digest cache so
that only preemption moves blocks) and against itself.

Both engines run each trace in lockstep on a step clock the test owns,
from the same submissions and the same between-step actions
(``_preempt``, ``cancel``).  Before every action and step the JAX
engine's arena bytes are copied into the port's, so a swap-out gathers
the same source bytes in both: the swap records' ``tok``/``lens``/block
counts/phases are equal, every host parcel's rows are byte-equal to the
JAX parcel's (float32; int8 codes and f32 scales), and after every step
the request states and every integer counter of ``stats()`` are equal.
Tokens are equal to the JAX engine's up to each request's first
non-decisive position (teacher-forced top-2 margin <= 0.01).  Without
the copy, the port's resumed requests are token-exact against the same
trace served uninterrupted.

Traces: a strictly-worse-victim pressure preemption and its equal-class
twin that must not preempt (the JAX package's ``tests/test_overload.py``
:162); ``_preempt`` forced mid-prefill and mid-decode, float32 and int8;
``cancel()`` in the queued, prefill, decode and swapped phases; the
bounded queue's shedding and ``AdmissionError``; a queue-delay timeout
beside a deadline that is not a kill; a ``ModelDrafter`` spec row
preempted and resumed.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference.serving import AdmissionError as JaxAdmissionError
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.inference.speculative import ModelDrafter as JaxModelDrafter
from paddle_tpu.observability.metrics import MetricsRegistry
from paddle_tpu_torch.inference import (AdmissionError, ModelDrafter,
                                        ServingEngine)
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)

P, C, BLK, CHUNK = 12, 32, 4, 4
MARGIN = 0.01


class StepClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


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


def _kw(**extra):
    kw = dict(prompt_len=P, max_cache_len=C, steps_per_call=2,
              block_len=BLK, chunk_len=CHUNK, compute_dtype="float32",
              prefix_cache_mode="digest", enable_preemption=True)
    kw.update(extra)
    return kw


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    vocab = tiny_llama_config().vocab_size
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _copy_arenas(jeng, teng):
    for ja, ta in zip(jeng._arenas, teng._arenas):
        ta.copy_(torch.from_numpy(np.array(np.asarray(ja), copy=True)))


def _swap_view(req):
    s = req.swap
    return None if s is None else (s.host_key, s.n_blocks, s.tok, s.lens,
                                   s.state)


def _assert_parcels_equal(jeng, teng):
    assert sorted(jeng._host_tier.keys()) == sorted(teng._host_tier.keys())
    for k in jeng._host_tier.keys():
        je, te = jeng._host_tier.entry(k), teng._host_tier.entry(k)
        assert (te.reason, te.n_blocks) == (je.reason, je.n_blocks)
        for jr, tr in zip(je.rows, te.rows):
            jr = np.asarray(jr)
            assert tr.dtype == jr.dtype and tr.shape == jr.shape
            np.testing.assert_array_equal(tr.view(np.uint8),
                                          jr.view(np.uint8))


def _int_stats(eng):
    return {k: v for k, v in eng.stats().items() if type(v) is int}


class Run:
    """One engine, its clock and its requests (by submission index)."""

    def __init__(self, eng, clock):
        self.eng, self.clock, self.reqs, self.returned = eng, clock, [], []
        self.swaps = []

    def busy(self):
        e = self.eng
        return bool(e._queue or e._swapped
                    or any(s is not None for s in e._slots))


def _drive(runs, subs, actions, copy=False, max_steps=300):
    """Step every run in lockstep.  ``subs`` maps a step to the
    ``submit`` keyword dicts issued just before it, ``actions`` a step to
    ``fn(run)`` called just before it.  With two runs (JAX, port) and
    ``copy``, the JAX arenas are copied into the port's before the
    actions, and states, swap records, parcels and counters are compared
    after every action and step."""
    step = 0
    last = max(list(subs) + list(actions) + [0])
    while step <= last or any(r.busy() for r in runs):
        for kw in subs.get(step, []):
            for r in runs:
                r.reqs.append(r.eng.submit(**{
                    k: (v.copy() if isinstance(v, np.ndarray) else v)
                    for k, v in kw.items()}))
        if copy:
            _copy_arenas(runs[0].eng, runs[1].eng)
        if step in actions:
            for r in runs:
                actions[step](r)
        if len(runs) == 2:
            _compare(*runs, parcels=copy)
        for r in runs:
            r.returned.append([q.request_id for q in r.eng.step(
                r.clock.now)])
            r.clock.now += 1.0
            r.eng._pool.check()
        if len(runs) == 2:
            _compare(*runs, parcels=copy)
        step += 1
        assert step < max_steps, "trace did not drain"


def _compare(jrun, trun, parcels):
    assert [(q.state, q.preempt_count, _swap_view(q)) for q in trun.reqs] \
        == [(q.state, q.preempt_count, _swap_view(q)) for q in jrun.reqs]
    ts, js = _int_stats(trun.eng), _int_stats(jrun.eng)
    assert ts == {k: js[k] for k in ts if k in js}
    if parcels:
        _assert_parcels_equal(jrun.eng, trun.eng)


def _pair(jnet, tnet, kw, jkw=None):
    jclock, tclock = StepClock(), StepClock()
    jeng = JaxEngine(jnet, async_dispatch=False, registry=MetricsRegistry(),
                     clock=jclock, **kw, **(jkw or {}))
    teng = ServingEngine(tnet, device="cpu", async_dispatch=False,
                         clock=tclock, **kw)
    return [Run(jeng, jclock), Run(teng, tclock)]


def _port(tnet, kw, drafter=None):
    clock = StepClock()
    eng = ServingEngine(tnet, device="cpu", clock=clock, drafter=drafter,
                        **kw)
    return Run(eng, clock)


def _assert_tokens_match_jax(jnet, jreqs, treqs):
    compared = total = 0
    for jr, tr in zip(jreqs, treqs):
        if jr.state != "finished":
            continue
        ids = jr.prompt[:jr.seq_len]
        s = np.concatenate([ids, jr.output[:-1]])[None]
        lg = np.asarray(jnet(paddle.to_tensor(s))._value)[0]
        lg = lg[len(ids) - 1:len(ids) - 1 + len(jr.output)]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        close = np.flatnonzero(margin <= MARGIN)
        upto = int(close[0]) if close.size else len(margin)
        np.testing.assert_array_equal(tr.output[:upto], jr.output[:upto])
        compared += upto
        total += len(margin)
    assert total and compared >= 0.8 * total, (compared, total)


# ---------------------------------------------------------------------------
# pressure preemption
# ---------------------------------------------------------------------------

def _pressure_trace():
    long_ids, short_ids = _prompts(5, (4, 4))
    # long: 4 + 10 - 1 = 13 tokens -> 4 blocks of 4 in a pool of 5, so
    # the short priority-1 arrival (2 blocks) admits only by preemption;
    # then the same pair at equal priority, where the arrival must wait
    subs = {0: [dict(prompt_ids=long_ids, max_new_tokens=10, priority=0)],
            2: [dict(prompt_ids=short_ids, max_new_tokens=5, priority=1)],
            40: [dict(prompt_ids=long_ids, max_new_tokens=10)],
            41: [dict(prompt_ids=short_ids, max_new_tokens=5)]}
    return subs


def test_pressure_preempts_strictly_worse_victim_as_jax(bridged):
    jnet, tnet = bridged
    kw = _kw(num_slots=2, num_blocks=5, steps_per_call=1)
    runs = _pair(jnet, tnet, kw)
    seen = {}

    def after_arrival(run):
        seen.setdefault(id(run), []).append(
            [q.state for q in run.reqs])
    _drive(runs, _pressure_trace(), {3: after_arrival, 42: after_arrival},
           copy=True)
    jrun, trun = runs
    # the long request was swapped out for the priority-1 arrival, and
    # the equal-class twin waited instead of preempting
    assert seen[id(trun)][0][0] == "swapped"
    assert seen[id(trun)][1] == ["finished", "finished", "decode", "queued"]
    st = trun.eng.stats()
    assert st["preemptions"] == st["preempt_resumes"] == 1
    assert st["swap_blocks_out"] == st["swap_blocks_in"] == 4
    assert st["swap_bytes_out"] == 4 * BLK * trun.eng._kv_row_bytes
    assert st["swap_host_blocks"] == 0 and st["blocks_in_use"] == 0
    assert trun.returned == jrun.returned
    _assert_tokens_match_jax(jnet, jrun.reqs, trun.reqs)
    # the port alone: the preempted request's tokens equal an engine's
    # with room for both (no preemption)
    alone = _port(tnet, _kw(num_slots=2, steps_per_call=1))
    _drive([alone], _pressure_trace(), {})
    assert alone.eng.stats()["preemptions"] == 0
    for a, b in zip(alone.reqs, trun.reqs):
        np.testing.assert_array_equal(a.output, b.output)


# ---------------------------------------------------------------------------
# forced preemption in prefill and decode
# ---------------------------------------------------------------------------

def _forced_trace():
    a, b, c = _prompts(11, (10, 6, 9))
    return {0: [dict(prompt_ids=a, max_new_tokens=8),
                dict(prompt_ids=b, max_new_tokens=10)],
            3: [dict(prompt_ids=c, max_new_tokens=6)]}


def _preempt_first(state, log):
    def act(run):
        req = next(q for q in run.reqs if q.state == state)
        run.eng._preempt(req)
        log.append((req.request_id, _swap_view(req)[1:]))
    return act


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_forced_preempt_prefill_and_decode_as_jax(bridged, kv):
    """``_preempt`` at the same steps in both engines, once mid-prefill
    (step 1: the 10-token prompt has one chunk of three) and twice
    mid-decode (steps 5 and 10, the second the late arrival): equal swap records and byte-equal parcels; the port's
    resumed tokens equal its uninterrupted run's."""
    jnet, tnet = bridged
    kw = _kw(num_slots=2, kv_cache_dtype=None if kv == "float32" else kv)
    runs = _pair(jnet, tnet, kw)
    jlog, tlog = [], []
    acts = {1: lambda r: _preempt_first("prefill", tlog if r is runs[1]
                                        else jlog)(r),
            5: lambda r: _preempt_first("decode", tlog if r is runs[1]
                                        else jlog)(r),
            10: lambda r: _preempt_first("decode", tlog if r is runs[1]
                                         else jlog)(r)}
    _drive(runs, _forced_trace(), acts, copy=True)
    assert tlog == jlog
    assert [s[-1] for _rid, s in tlog] == ["prefill", "decode", "decode"]
    st = runs[1].eng.stats()
    assert st["preemptions"] == st["preempt_resumes"] == 3
    assert st["swap_blocks_out"] == st["swap_blocks_in"] > 0
    assert st["swap_host_blocks"] == 0 and st["swapped_waiting"] == 0
    _assert_tokens_match_jax(jnet, runs[0].reqs, runs[1].reqs)
    # the port alone, no arena copy: resumed == uninterrupted, bit for bit
    port_log = []
    hit = _port(tnet, kw)
    _drive([hit], _forced_trace(),
           {1: _preempt_first("prefill", port_log),
            5: _preempt_first("decode", port_log),
            10: _preempt_first("decode", port_log)})
    clean = _port(tnet, kw)
    _drive([clean], _forced_trace(), {})
    assert hit.eng.stats()["preemptions"] == 3
    for a, b in zip(hit.reqs, clean.reqs):
        assert a.state == b.state == "finished"
        np.testing.assert_array_equal(a.output, b.output)


# ---------------------------------------------------------------------------
# cancel in every phase
# ---------------------------------------------------------------------------

def test_cancel_in_every_phase_as_jax(bridged):
    jnet, tnet = bridged
    r0, r1, r2, r3, r4 = _prompts(21, (4, 12, 4, 5, 6))
    subs = {0: [dict(prompt_ids=r0, max_new_tokens=16),
                dict(prompt_ids=r1, max_new_tokens=6),
                dict(prompt_ids=r2, max_new_tokens=5),
                dict(prompt_ids=r3, max_new_tokens=6)],
            9: [dict(prompt_ids=r4, max_new_tokens=5)]}
    verdicts = {}

    def cancel(i, expect_state, preempt=False):
        def act(run):
            req = run.reqs[i]
            assert req.state == expect_state
            if preempt:
                run.eng._preempt(req)
                assert req.state == "swapped"
            in_use = run.eng._pool.in_use()
            ok = run.eng.cancel(req.request_id)
            verdicts.setdefault(id(run), []).append(
                (ok, req.state, req.output.size, run.eng._pool.in_use()
                 <= in_use, run.eng.cancel(req.request_id)))
        return act

    acts = {2: lambda r: (cancel(1, "prefill")(r), cancel(2, "queued")(r)),
            4: cancel(0, "decode", preempt=True),
            5: cancel(3, "decode")}
    runs = _pair(jnet, tnet, _kw(num_slots=2))
    _drive(runs, subs, acts, copy=True)
    jrun, trun = runs
    assert verdicts[id(trun)] == verdicts[id(jrun)]
    assert all(ok and st == "cancelled" and freed and not again
               for ok, st, _n, freed, again in verdicts[id(trun)])
    assert [q.output.size for q in trun.reqs] == [16, 6, 5, 6, 5]
    st = trun.eng.stats()
    assert st["cancelled"] == 4 and st["finished"] == 1
    assert st["preemptions"] == 1 and st["preempt_resumes"] == 0
    assert st["swap_host_blocks"] == 0 and st["blocks_in_use"] == 0
    assert not trun.eng.cancel(12345)
    _assert_tokens_match_jax(jnet, jrun.reqs, trun.reqs)


# ---------------------------------------------------------------------------
# bounded queue and timeouts
# ---------------------------------------------------------------------------

def _bounded_queue(eng, err_cls, clock):
    """The JAX package's shedding sequence (host-only: arrivals far in
    the future never admit); returns what it saw."""
    ids = _prompts(9, (4,))[0]
    far = 1e18
    seen = []
    a = eng.submit(ids, max_new_tokens=3, arrival_time=far, priority=1)
    b = eng.submit(ids, max_new_tokens=3, arrival_time=far, priority=0)
    with pytest.raises(err_cls) as ei:
        eng.submit(ids, max_new_tokens=3, arrival_time=far, priority=0)
    seen.append((ei.value.queue_depth, ei.value.max_queue, len(eng._queue)))
    hi = eng.submit(ids, max_new_tokens=3, arrival_time=far, priority=5)
    seen.append((b.state, b.finish_time, b.output.size, a.state, hi.state))
    c = eng.submit(ids, max_new_tokens=3, arrival_time=far, priority=5,
                   deadline_s=1.0)
    d = eng.submit(ids, max_new_tokens=3, arrival_time=far, priority=5,
                   deadline_s=0.5)
    seen.append([r.state for r in (a, b, c, d, hi)])
    with pytest.raises(err_cls):
        eng.submit(ids, max_new_tokens=3, arrival_time=far, spec_decode=7)
    seen.append((eng._spec_k_max, eng._drafter is None))
    seen.append(eng.stats()["shed"])
    eng._pool.check()
    return seen


def test_bounded_queue_shed_and_admission_error_as_jax(bridged):
    jnet, tnet = bridged
    (jrun, trun) = _pair(jnet, tnet, _kw(num_slots=1, max_queue=2))
    jseen = _bounded_queue(jrun.eng, JaxAdmissionError, jrun.clock)
    tseen = _bounded_queue(trun.eng, AdmissionError, trun.clock)
    assert tseen == jseen
    assert tseen[-1] == 5 and tseen[2] == ["shed", "shed", "queued",
                                           "queued", "shed"]
    # expired queued entries are swept before shedding: a full queue of
    # past-SLO requests times out and the equal-class arrival is taken
    ids = _prompts(9, (4,))[0]
    for eng_cls, net, extra in (
            (JaxEngine, jnet, dict(async_dispatch=False,
                                   registry=MetricsRegistry())),
            (ServingEngine, tnet, dict(device="cpu",
                                       async_dispatch=False))):
        clock = StepClock()
        eng = eng_cls(net, clock=clock, **_kw(num_slots=1, max_queue=1),
                      **extra)
        old = eng.submit(ids, max_new_tokens=3, max_queue_delay_s=0.0)
        clock.now = 1.0
        fresh = eng.submit(ids, max_new_tokens=3)
        assert old.state == "timeout" and fresh.state == "queued"
        st = eng.stats()
        assert (st["timeouts"], st["shed"]) == (1, 0)


def test_queue_delay_timeout_and_deadline_not_a_kill_as_jax(bridged):
    """One slot held by a long request; two arrive at step 1: the one
    with a 2.5 s queue-delay bound times out at the step whose clock
    passes it (and is returned by that step), the one whose deadline
    passes while it waits is not killed and finishes late."""
    jnet, tnet = bridged
    a, b, d = _prompts(13, (4, 4, 4))
    subs = {0: [dict(prompt_ids=a, max_new_tokens=12)],
            1: [dict(prompt_ids=b, max_new_tokens=3, max_queue_delay_s=2.5),
                dict(prompt_ids=d, max_new_tokens=3, deadline_s=1.0)]}
    runs = _pair(jnet, tnet, _kw(num_slots=1))
    _drive(runs, subs, {}, copy=True)
    jrun, trun = runs
    assert trun.returned == jrun.returned
    assert trun.returned[4] == [1]     # waited 3 s > 2.5 at step 4
    assert [q.state for q in trun.reqs] == ["finished", "timeout",
                                            "finished"]
    assert trun.reqs[1].output.size == 3
    assert trun.eng.stats()["timeouts"] == 1
    assert trun.reqs[2].finish_time > trun.reqs[2].deadline
    _assert_tokens_match_jax(jnet, jrun.reqs, trun.reqs)


# ---------------------------------------------------------------------------
# a speculative row preempted and resumed
# ---------------------------------------------------------------------------

def test_spec_row_preempted_and_resumed(bridged):
    """A ``ModelDrafter`` (over the target) spec row beside a plain row,
    preempted mid-decode: equal to the JAX spec engine's swap record,
    parcel, counters and tokens; and the port's resumed spec row equals
    its uninterrupted run, the spec row frozen out of the plain block
    after the resume."""
    jnet, tnet = bridged
    # a seed whose greedy outputs are decisive at every position
    # (smallest teacher-forced top-2 margin 0.041), so the drafts, the
    # acceptances and the tokens of both packages can be held equal
    s_ids, p_ids = _prompts(32, (6, 5))
    subs = {0: [dict(prompt_ids=s_ids, max_new_tokens=10, spec_decode=2),
                dict(prompt_ids=p_ids, max_new_tokens=9)]}
    dkw = dict(max_context=24, max_draft=2, compute_dtype="float32")
    kw = _kw(num_slots=2)
    jclock, tclock = StepClock(), StepClock()
    runs = [Run(JaxEngine(jnet, async_dispatch=False,
                          registry=MetricsRegistry(), clock=jclock,
                          drafter=JaxModelDrafter(jnet, **dkw), **kw),
                jclock),
            Run(ServingEngine(tnet, device="cpu", async_dispatch=False,
                              clock=tclock,
                              drafter=ModelDrafter(tnet, **dkw), **kw),
                tclock)]
    logs = {}

    def act(run):
        req = run.reqs[0]
        assert req.state == "decode" and req.spec_k == 2
        run.eng._preempt(req)
        logs[id(run)] = _swap_view(req)
    _drive(runs, subs, {3: act}, copy=True)
    jrun, trun = runs
    assert logs[id(trun)] == logs[id(jrun)]
    st = trun.eng.stats()
    assert st["preemptions"] == st["preempt_resumes"] == 1
    assert st["spec_verify_steps"] > 0
    assert st["spec_accepted_tokens"] == jrun.eng.stats()[
        "spec_accepted_tokens"]
    _assert_tokens_match_jax(jnet, jrun.reqs, trun.reqs)
    frozen = []

    def act_port(run):
        run.eng._preempt(run.reqs[0])
        run.eng._admit(run.clock.now, [])
        slot = run.reqs[0].slot
        frozen.append((run.reqs[0].state, bool(run.eng._done[slot])))
    hit = _port(tnet, kw, ModelDrafter(tnet, **dkw))
    _drive([hit], subs, {3: act_port})
    clean = _port(tnet, kw, ModelDrafter(tnet, **dkw))
    _drive([clean], subs, {})
    assert frozen == [("decode", True)]
    for a, b in zip(hit.reqs, clean.reqs):
        np.testing.assert_array_equal(a.output, b.output)
