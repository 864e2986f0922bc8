"""The port's dispatch-ahead serving (``async_dispatch=True``, the
reference engine's default) held against the JAX engine built the same
way, at ``async_depth`` 1 and 3, and against the port's own lockstep arm
(``async_dispatch=False``).

Both engines serve in float32 on the same weights (the JAX model's,
carried by the weight bridge), on a step clock the test owns
(``step(now)`` with now = 0, 1, 2, ..., the same ``clock`` injected for
their own time stamps), with ``BlockPool.check()`` after every step and
a final ``run()`` that drains whatever is still pending.  The traces:

- the eight engine paths of ``tests/test_torch_engine_paths.py``
  (priorities, deadlines and arrivals; a 6-block pool; static batching;
  an EOS that fires; no prefix cache; preemption under pressure; the
  radix cache; the radix cache's host tier);
- the greedy rows of the reference's own pipeline traces:
  ``tests/test_serving_async.py`` (prefix sharers, a spec row beside a
  plain one, a preemption between steps) and
  ``tests/test_serving_depth.py`` (an EOS-cut row beside a budget-bound
  one, a solo long rider that reaches fused windows, then the EOS-cut
  prompt alone, whose in-flight EOS leaves ghost dispatches to drain);
  their
  sampled and token-masked rows belong to the sampled half and are left
  out;
- an overload trace that charges ``preempt``, ``resume`` and ``cancel``:
  a priority arrival preempts a decoding request while a harvest is
  pending, finishes at its first token, the victim resumes while the
  next harvest is pending, and a running request is cancelled between
  steps.

For each trace and depth the step count, the finish order, every
integer counter both engines' ``stats()`` report (``async_syncs``,
``async_harvests`` and ``async_depth`` among them), the forced syncs by
reason and the decode programs built (by total scanned steps) are
equal, and the tokens are equal up to each request's first non-decisive
position (top-2 margin of the teacher-forced JAX logits <= 0.01).  Each
JAX engine gets its own ``MetricsRegistry``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.observability.metrics import MetricsRegistry
from paddle_tpu_torch.observability import (
    MetricsRegistry as TorchRegistry)
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference.serving import (ASYNC_SYNC_REASONS,
                                                TERMINAL_STATES)
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)

MARGIN = 0.01
DEPTHS = (1, 3)
# the share of output positions that must be decisive, and so compared:
# the reference traces' short random prompts leave more near-ties on
# the tiny model (25 of 46 and 35 of 46 positions)
MIN_COMPARED = {"serving_async": 0.5, "serving_depth": 0.5}
PAD = 7
# tests/test_torch_engine_paths.py's trace: (prompt length,
# max_new_tokens, priority, deadline_s, arrival step)
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
PRIORITY_PATHS = ("priority_deadline_arrival", "preempt_pressure")
ARRIVAL_PATHS = PRIORITY_PATHS + ("radix_host_tier",)
LATE_SHARER = (3, 10)
# the reference traces and the overload trace, at the reference
# engine's defaults (the radix cache, preemption on)
REF_TRACES = ("serving_async", "serving_depth", "overload")


class StepClock:
    """The engines' clock: the test sets it to the step number."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


class AlwaysDraft:
    """The reference async trace's drafter: the context's last token,
    repeated.  numpy only, so both engines take the same object."""

    def propose(self, context, k):
        return np.repeat(np.asarray(context[-1:], np.int32), k)


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


def _gen(jnet, ids, max_new, eos=None):
    out = jnet.generate(paddle.to_tensor(ids[None, :]),
                        max_new_tokens=max_new, max_cache_len=40,
                        eos_token_id=eos, compute_dtype="float32")
    return np.asarray(out._value)[0]


# ---------------------------------------------------------------------------
# traces: engine keywords plus a list of stages, each a list of
# submissions and the steps to run after them (None: until every
# request so far is terminal), with actions keyed by step number
# ---------------------------------------------------------------------------

def _path_trace(path, vocab, eos_id):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n, *_ in SPECS]
    prompts[5][:4] = prompts[0][:4]
    opts = dict(PATHS[path])
    if opts.pop("eos", False):
        opts["eos_token_id"] = eos_id
    opts.setdefault("prefix_cache_mode", "digest")
    opts.setdefault("enable_preemption", False)
    kw = dict(prompt_len=6, max_cache_len=32, steps_per_call=3,
              block_len=4, chunk_len=4, compute_dtype="float32",
              num_slots=2, **opts)
    subs = []
    for ids, (_n, m, prio, dl, arr) in zip(prompts, SPECS):
        s = dict(prompt_ids=ids, max_new_tokens=m)
        if path in PRIORITY_PATHS:
            s.update(priority=prio, deadline_s=dl)
        if path in ARRIVAL_PATHS:
            s.update(arrival_time=float(arr))
        subs.append(s)
    if path == "radix_host_tier":
        late = np.concatenate([prompts[0][:4], np.random.default_rng(
            9).integers(0, vocab, (2,)).astype(np.int32)])
        subs.append(dict(prompt_ids=late, max_new_tokens=LATE_SHARER[0],
                         arrival_time=float(LATE_SHARER[1])))
    return kw, [(subs, None, {})]


def _ref_trace(name, vocab, jnet):
    rng = np.random.default_rng(99)
    kw = dict(num_slots=2, prompt_len=8, max_cache_len=40,
              steps_per_call=1, block_len=4, chunk_len=4, num_blocks=12,
              compute_dtype="float32")
    if name == "serving_async":
        # tests/test_serving_async.py::_drive, greedy rows: prefix
        # sharers a and c; a spec row beside a plain one; then f and h
        # decode 4 steps and f is preempted between steps
        shared = rng.integers(0, vocab, (4,)).astype(np.int32)
        ids_a = rng.integers(0, vocab, (7,)).astype(np.int32)
        ids_a[:4] = shared
        ids_b = rng.integers(0, vocab, (6,)).astype(np.int32)
        ids_c = rng.integers(0, vocab, (7,)).astype(np.int32)
        ids_c[:4] = shared
        kw.update(drafter="always")
        return kw, [
            ([dict(prompt_ids=ids_a, max_new_tokens=7),
              dict(prompt_ids=ids_c, max_new_tokens=5)], None, {}),
            ([dict(prompt_ids=ids_a, max_new_tokens=6, spec_decode=2),
              dict(prompt_ids=ids_b, max_new_tokens=6)], None, {}),
            ([dict(prompt_ids=ids_c, max_new_tokens=8),
              dict(prompt_ids=ids_a, max_new_tokens=14)], None,
             {4: ("preempt", 0)})]
    if name == "serving_depth":
        # tests/test_serving_depth.py::_drive, greedy rows: an EOS that
        # cuts a's stream beside budget-bound b, then a solo long rider d
        ids_a = rng.integers(0, vocab, (6,)).astype(np.int32)
        ids_b = rng.integers(0, vocab, (7,)).astype(np.int32)
        rng.integers(0, vocab, (6,))               # c: sampled, left out
        ids_d = rng.integers(0, vocab, (7,)).astype(np.int32)
        # the EOS: a's greedy token at the first position >= 2 that did
        # not come up before it, so it cuts a's stream there
        seq = [int(x) for x in _gen(jnet, ids_a, 10)]
        kw.update(eos_token_id=next(seq[i] for i in range(2, len(seq))
                                    if seq[i] not in seq[:i]))
        # ... and a's prompt again, alone, so the last rider finishes by
        # EOS (test_depth_flush_retires_target_guards' solo rider): at
        # depth 3 its EOS is seen one harvest late, behind device-frozen
        # ghost dispatches that run()'s drain flushes
        return kw, [
            ([dict(prompt_ids=ids_a, max_new_tokens=10),
              dict(prompt_ids=ids_b, max_new_tokens=12)], None, {}),
            ([dict(prompt_ids=ids_d, max_new_tokens=14)], None, {}),
            ([dict(prompt_ids=ids_a, max_new_tokens=10)], None, {})]
    # overload: 3 slots over 10 blocks of 4; a takes 6 blocks, b 4; c
    # (priority 1, 2 blocks) arrives at step 4, preempts b, finishes at
    # its first token, and b resumes; a is cancelled at step 9
    ids = [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (4, 4, 6)]
    kw.update(num_slots=3, num_blocks=10, prompt_len=6, max_cache_len=24)
    return kw, [([dict(prompt_ids=ids[0], max_new_tokens=20),
                  dict(prompt_ids=ids[1], max_new_tokens=13),
                  dict(prompt_ids=ids[2], max_new_tokens=1, priority=1,
                       arrival_time=4.0)], None, {9: ("cancel", 0)})]


def _build(cls, net, kw, depth, **extra):
    kw = dict(kw)
    if kw.pop("drafter", None) == "always":
        kw["drafter"] = AlwaysDraft()
    clock = StepClock()
    # a private registry each: stats() are deltas of the engine's
    # registry, and engines must not read each other's counts
    extra["registry"] = (MetricsRegistry() if cls is JaxEngine
                         else TorchRegistry())
    arm = dict(async_dispatch=False) if depth == 0 else dict(
        async_dispatch=True, async_depth=depth)
    return cls(net, clock=clock, **arm, **kw, **extra), clock


def _drive(eng, clock, stages, tag):
    """Run ``stages`` on the step clock; every stage's requests reach a
    terminal state before the next stage submits.  Returns the requests
    and the step count."""
    reqs, steps = [], 0
    for subs, _n, actions in stages:
        first = len(reqs)
        for s in subs:
            s = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                 for k, v in s.items()}
            if "arrival_time" in s:
                s["arrival_time"] += clock.now
            reqs.append(eng.submit(**s))
        start = steps
        while any(r.state not in TERMINAL_STATES for r in reqs):
            act = actions.get(steps - start)
            if act is not None:
                what, idx = act
                r = reqs[first + idx]
                if what == "cancel":
                    eng.cancel(r.request_id)
                elif r.state in ("prefill", "decode"):
                    eng._preempt(r)
            eng.step(clock.now)
            clock.now += 1.0
            steps += 1
            eng._pool.check()
            assert steps < 400, f"{tag}: engine did not drain"
    eng.run()
    eng._pool.check()
    return reqs, steps


def _margins(jnet, reqs):
    out = []
    for r in reqs:
        ids = r.prompt[:r.seq_len]
        s = np.concatenate([ids, r.output[:-1]])[None]
        lg = np.asarray(jnet(paddle.to_tensor(s))._value)[0]
        lg = lg[len(ids) - 1:len(ids) - 1 + len(r.output)]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        out.append(top2[:, 1] - top2[:, 0])
    return out


def _int_stats(eng):
    return {k: v for k, v in eng.stats().items() if type(v) is int}


@pytest.fixture(scope="module")
def runs(bridged):
    """Every trace through the JAX engine and the port at depth 1 and 3,
    and through the port's lockstep arm, once."""
    jnet, tnet = bridged
    vocab = tiny_llama_config().vocab_size
    eos = None
    out = {}
    for name in list(PATHS) + list(REF_TRACES):
        if name in PATHS:
            if eos is None:
                # the first path's request 0 (JAX, lockstep): a token at
                # a position >= 1 before its last that did not come up
                # before it, so the EOS path fires there
                kw, stages = _path_trace(name, vocab, None)
                jeng, jclock = _build(JaxEngine, jnet, kw, 0)
                jreqs, _ = _drive(jeng, jclock, stages, name)
                o = [int(x) for x in jreqs[0].output]
                eos = next(o[i] for i in range(1, len(o) - 1)
                           if o[i] not in o[:i] and o[i] != PAD)
            kw, stages = _path_trace(name, vocab, eos)
        else:
            kw, stages = _ref_trace(name, vocab, jnet)
        arms = {}
        for depth in DEPTHS:
            jeng, jclock = _build(JaxEngine, jnet, kw, depth)
            jreqs, jsteps = _drive(jeng, jclock, stages, name)
            teng, tclock = _build(ServingEngine, tnet, kw, depth,
                                  device="cpu")
            treqs, tsteps = _drive(teng, tclock, stages, name)
            arms[depth] = dict(jeng=jeng, jreqs=jreqs, teng=teng,
                               treqs=treqs, steps=(tsteps, jsteps))
        leng, lclock = _build(ServingEngine, tnet, kw, 0, device="cpu")
        lreqs, lsteps = _drive(leng, lclock, stages, name)
        out[name] = dict(arms=arms, lock=dict(eng=leng, reqs=lreqs,
                                              steps=lsteps),
                         margins=_margins(jnet, arms[1]["jreqs"]))
    return out


CASES = [(name, d) for name in list(PATHS) + list(REF_TRACES)
         for d in DEPTHS]


@pytest.mark.parametrize("name,depth", CASES)
def test_async_schedule_and_counters_equal_jax(runs, name, depth):
    arm = runs[name]["arms"][depth]
    teng, jeng = arm["teng"], arm["jeng"]
    assert arm["steps"][0] == arm["steps"][1]
    assert [r.request_id for r in teng._finished] == \
        [r.request_id for r in jeng._finished]
    assert [r.state for r in arm["treqs"]] == [r.state for r in arm["jreqs"]]
    ts, js = _int_stats(teng), _int_stats(jeng)
    shared = sorted(k for k in ts if k in js)
    assert {"async_syncs", "async_harvests", "async_depth",
            "block_dispatches", "decode_steps", "kv_bytes_swept",
            "finished"} <= set(shared)
    for key in shared:
        assert ts[key] == js[key], (name, depth, key, ts[key], js[key])
    tst, jst = teng.stats(), jeng.stats()
    assert tst["async_syncs_by_reason"] == jst["async_syncs_by_reason"]
    assert set(tst["async_syncs_by_reason"]) == set(ASYNC_SYNC_REASONS)
    assert tst["async_dispatch"] is jst["async_dispatch"] is True
    # the decode programs built: both caches key on (total scanned steps,
    # sampling flags, lora)
    assert sorted(teng._blocks) == sorted(
        (k[0], tuple(bool(f) for f in k[1]), k[2]) for k in jeng._blocks)
    assert not teng._pend_q and not teng._lazy_parcels


@pytest.mark.parametrize("name,depth", CASES)
def test_async_tokens_equal_jax_at_decisive_positions(runs, name, depth):
    run = runs[name]
    arm = run["arms"][depth]
    compared = total = 0
    for treq, jreq, margin in zip(arm["treqs"], arm["jreqs"],
                                  run["margins"]):
        tout, jout = np.asarray(treq.output), np.asarray(jreq.output)
        assert len(tout) == len(jout) == len(margin)
        total += len(margin)
        undecided = np.flatnonzero(margin <= MARGIN)
        upto = int(undecided[0]) if undecided.size else len(margin)
        np.testing.assert_array_equal(tout[:upto], jout[:upto])
        compared += upto
    assert compared >= MIN_COMPARED.get(name, 0.75) * total, \
        (name, depth, compared, total)


@pytest.mark.parametrize("name", list(PATHS) + list(REF_TRACES))
def test_async_depth1_equals_port_lockstep(runs, name):
    """Depth 1 keeps the lockstep arm's scheduling bit for bit: tokens
    exactly equal, the same steps and every scheduling counter equal;
    the lockstep arm charges no sync and harvests nothing late."""
    run = runs[name]
    arm, lock = run["arms"][1], run["lock"]
    for a, s in zip(arm["treqs"], lock["reqs"]):
        np.testing.assert_array_equal(a.output, s.output)
        assert a.state == s.state
    assert arm["steps"][0] == lock["steps"]
    sa, sl = _int_stats(arm["teng"]), _int_stats(lock["eng"])
    for key in sa:
        if key not in ("async_syncs", "async_harvests"):
            assert sa[key] == sl[key], (name, key)
    assert sl["async_syncs"] == sl["async_harvests"] == 0


def test_async_depth3_fuses_windows(runs):
    """At depth 3 the eventless solo rider of the depth trace dispatches
    fused windows: fewer block dispatches than the lockstep arm for the
    same tokens, and a program of 3 steps that the lockstep arm never
    builds."""
    run = runs["serving_depth"]
    arm, lock = run["arms"][3], run["lock"]
    for a, s in zip(arm["treqs"], lock["reqs"]):
        np.testing.assert_array_equal(a.output, s.output)
    sa, sl = arm["teng"].stats(), lock["eng"].stats()
    assert sa["block_dispatches"] < sl["block_dispatches"]
    assert sa["async_harvests"] > 0
    assert any(k[0] == 3 for k in arm["teng"]._blocks)
    assert not any(k[0] == 3 for k in lock["eng"]._blocks)
    # EOS left the per-iteration sync path at depth 3
    assert sa["async_syncs_by_reason"]["eos"] < \
        run["arms"][1]["teng"].stats()["async_syncs_by_reason"]["eos"]


def test_every_forced_sync_reason_is_charged(runs):
    """The port charges every forced-sync reason the greedy engine can
    meet, as the JAX engine does (equal counts are held per trace
    above), and the pipeline really deferred harvests."""
    fired = {}
    for run in runs.values():
        for arm in run["arms"].values():
            for k, v in arm["teng"].stats()["async_syncs_by_reason"].items():
                fired[k] = fired.get(k, 0) + v
    for reason in ("cancel", "preempt", "resume", "chunk_final", "spec",
                   "eos", "drain", "budget"):
        assert fired[reason] > 0, (reason, fired)
    assert fired["mask"] == fired["penalty"] == 0
    assert runs["priority_deadline_arrival"]["arms"][1]["teng"].stats()[
        "async_harvests"] > 0


def test_lazy_demotion_parcels_match_lockstep_and_jax(bridged, runs):
    """radix_host_tier at depth 1: demotions reach the host tier as lazy
    parcels that resolve at the step's harvest point, byte-equal to the
    port's lockstep arm's (the same arithmetic) and, with the JAX
    engine's arena bytes copied into the port's before every step, to
    the JAX engine's."""
    jnet, tnet = bridged
    vocab = tiny_llama_config().vocab_size
    kw, stages = _path_trace("radix_host_tier", vocab, None)
    subs = stages[0][0]

    def parcels(eng):
        return {k: [np.asarray(r) for r in eng._host_tier.entry(k).rows]
                for k in eng._host_tier.keys()}

    engines = {
        "async": _build(ServingEngine, tnet, kw, 1, device="cpu"),
        "lock": _build(ServingEngine, tnet, kw, 0, device="cpu"),
        "jax": _build(JaxEngine, jnet, kw, 1),
        "async_copied": _build(ServingEngine, tnet, kw, 1, device="cpu")}
    lazy = []
    real = engines["async"][0]._radix.demote

    def demote(block, rows, dtypes=None):
        lazy.append(callable(rows))
        return real(block, rows, dtypes)
    engines["async"][0]._radix.demote = demote
    reqs = {name: [eng.submit(**{k: (v.copy() if isinstance(v, np.ndarray)
                                     else v) for k, v in s.items()})
                   for s in subs]
            for name, (eng, _c) in engines.items()}
    seen = 0
    for _step in range(200):
        if all(r.state in TERMINAL_STATES for r in reqs["jax"]):
            break
        jeng = engines["jax"][0]
        ceng = engines["async_copied"][0]
        for ja, ta in zip(jeng._arenas, ceng._arenas):
            ta.copy_(torch.from_numpy(np.array(np.asarray(ja), copy=True)))
        for eng, clock in engines.values():
            eng.step(clock.now)
            clock.now += 1.0
            eng._pool.check()
        for name in ("async", "async_copied"):
            eng = engines[name][0]
            assert not eng._lazy_parcels
            assert all(e.resolved for e in eng._host_tier._entries.values())
        pa, pl = parcels(engines["async"][0]), parcels(engines["lock"][0])
        assert pa.keys() == pl.keys()
        for k in pa:
            for x, y in zip(pa[k], pl[k]):
                np.testing.assert_array_equal(x.view(np.uint8),
                                              y.view(np.uint8))
        pc, pj = parcels(ceng), parcels(jeng)
        assert pc.keys() == pj.keys()
        for k in pc:
            for x, y in zip(pc[k], pj[k]):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x.view(np.uint8),
                                              y.view(np.uint8))
        seen = max(seen, len(pa))
    assert seen > 0 and lazy and all(lazy)
    st = engines["async"][0].stats()
    assert st["prefix_host_hits"] > 0 and st["swap_blocks_out"] > 1


@pytest.mark.parametrize("kw,match", [
    (dict(async_depth=0), "async_depth"),
    (dict(async_dispatch=False, async_depth=2), "async_dispatch=True"),
], ids=["depth0", "depth2_lockstep"])
def test_async_constructor_guards(bridged, kw, match):
    """The reference engine's guards: ``async_depth < 1`` raises, and
    ``async_depth > 1`` without ``async_dispatch`` raises."""
    _jnet, tnet = bridged
    with pytest.raises(ValueError, match=match):
        ServingEngine(tnet, num_slots=1, prompt_len=4, max_cache_len=8,
                      compute_dtype="float32", device="cpu", **kw)


def test_graph_launch_accounting_helpers():
    """A captured graph's launch accounting (``ops/_build.py``): the
    launches made inside ``launches_taken_out`` leave the kernel counts
    as they were and land in the record; ``add_launches`` charges the
    record once per replay."""
    from paddle_tpu_torch.ops import KERNELS, _build
    names = sorted(KERNELS)[:2]
    before = {n: KERNELS[n].launches for n in KERNELS}
    record = {}
    with _build.launches_taken_out(record):
        KERNELS[names[0]].launches += 3
        KERNELS[names[1]].launches += 1
    assert {n: KERNELS[n].launches for n in KERNELS} == before
    assert record == {names[0]: 3, names[1]: 1}
    try:
        _build.add_launches(record)
        _build.add_launches(record)
        assert KERNELS[names[0]].launches == before[names[0]] + 6
        assert KERNELS[names[1]].launches == before[names[1]] + 2
    finally:
        for n in KERNELS:
            KERNELS[n].launches = before[n]
