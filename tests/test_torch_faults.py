"""The port's fault injector (``inference/faultinject.py``) driven
through the port's engine and the JAX engine on the JAX package's
engine-level fault traces, each engine with its own ``FaultInjector``
built and armed the same way:

- ``alloc_wedge`` (``tests/test_overload.py``: the no-wedge and stall
  guard): an exhausted pool wedges admission until
  ``run(wall_timeout_s=)`` raises ``EngineStalledError`` with the
  pool's state, stalled steps trip the same guard, a finite burst only
  delays, and a swap-wedged request naps instead of hot-spinning; each
  clears and drains;
- ``swapin_tier`` (``tests/test_prefixcache.py``): failed host-tier
  swap-ins degrade to recompute, clearing restores host hits, forced
  tier evictions punch holes that recompute refills;
- ``replica``: a latched kill (``ReplicaKilledError``), a permanent stall
  (``EngineStalledError``) and a poisoned harvest
  (``PoisonedDispatchError``), each raised before any state changes;
- ``combined``: an allocation failure, a forced swap, a 50 ms stall and
  a tier eviction in one trace whose requests all finish.

Time is a fake clock per engine that only ``time.sleep`` advances (the
engines' naps, the injected stalls), so the wall guards trip after the
same steps in both packages.  Per trace the two engines raise the same
exception classes, their injectors record the same fired faults, their
flight records are equal modulo wall, their counters and gauges equal
and ``stats()`` equal on every shared key that is not a time, the pool
audits clean after every phase, and tokens are equal up to each
request's first non-decisive position (JAX teacher-forced top-2 margin
<= 0.01)."""

import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import faultinject as jfault
from paddle_tpu.inference import serving as jserving
from paddle_tpu.observability import flightrec as jflightrec
from paddle_tpu.observability.metrics import MetricsRegistry
from paddle_tpu_torch.inference import faultinject as tfault
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)
from paddle_tpu_torch.observability import FlightRecorder
from paddle_tpu_torch.observability import MetricsRegistry as TorchRegistry

P, C = 12, 32
MARGIN = 0.01
TRACES = ("alloc_wedge", "swapin_tier", "replica", "combined")


class FakeClock:
    """Engine time that only the patched ``time.sleep`` advances."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


class Pkg:
    """One package's engine class, injector, exceptions, recorder and
    registry, so a trace reads the same for both."""

    def __init__(self, serving, fault, recorder, registry, net, **extra):
        self.serving, self.fault = serving, fault
        self.recorder, self.registry = recorder, registry
        self.net, self.extra = net, extra

    def engine(self, fi, clock, **kw):
        return self.serving.ServingEngine(
            self.net, compute_dtype="float32", fault_injector=fi,
            clock=clock, registry=self.registry(),
            flight_recorder=self.recorder(), **self.extra, **kw)


class Log:
    """What a trace observed: the exceptions raised, in order, and the
    engines, injectors, requests and checkpoints it made."""

    def __init__(self):
        self.raised, self.engines, self.reqs, self.notes = [], [], [], []

    def expect(self, exc, fn):
        with pytest.raises(exc) as ei:
            fn()
        self.raised.append(type(ei.value).__name__)
        return str(ei.value)


def _drain(eng, clock):
    while (eng._queue or eng._swapped
           or any(s is not None for s in eng._slots)):
        eng.step(clock.now)
        eng._pool.check()


def _trace_alloc_wedge(pkg, log, rng_seed=17):
    rng = np.random.default_rng(rng_seed)
    ids = rng.integers(0, 256, (4,)).astype(np.int32)
    fi, clock = pkg.fault.FaultInjector(), FakeClock()
    eng = pkg.engine(fi, clock, num_slots=1, prompt_len=P, max_cache_len=C)
    log.engines.append((eng, fi))
    fi.fail_allocs(None)
    w = eng.submit(ids, max_new_tokens=1)
    msg = log.expect(pkg.serving.EngineStalledError,
                     lambda: eng.run(wall_timeout_s=0.15))
    assert "queued=1" in msg and "blocks free" in msg
    assert "fault_injector=armed" in msg
    eng._pool.check()
    fi.clear_alloc_failures()
    eng.run(wall_timeout_s=120)
    assert w.state == "finished"
    eng._pool.check()
    # stalled steps that make no progress trip the guard too
    fi.stall_steps(100, 0.05)
    fi.fail_allocs(None)
    w2 = eng.submit(ids, max_new_tokens=1)
    log.expect(pkg.serving.EngineStalledError,
               lambda: eng.run(wall_timeout_s=0.1))
    eng._pool.check()
    fi._stalls.clear()
    fi.clear_alloc_failures()
    eng.run(wall_timeout_s=120)
    assert w2.state == "finished"
    # a finite alloc-failure burst delays admission but never wedges
    n0 = fi.events.count(("alloc_fail", None))
    fi.fail_allocs(3)
    w3 = eng.submit(ids, max_new_tokens=1)
    eng.run(wall_timeout_s=120)
    assert w3.state == "finished"
    assert fi.events.count(("alloc_fail", None)) == n0 + 3
    # a swap-wedged engine naps between resume attempts
    w4 = eng.submit(ids, max_new_tokens=3)
    eng.step(clock.now)
    assert w4.state == "decode"
    eng._preempt(w4, reason="test")
    assert w4.state == "swapped"
    fi.fail_allocs(None)
    n1 = fi.events.count(("alloc_fail", None))
    log.expect(pkg.serving.EngineStalledError,
               lambda: eng.run(wall_timeout_s=0.15))
    spins = fi.events.count(("alloc_fail", None)) - n1
    assert 0 < spins < 2000, spins
    fi.clear_alloc_failures()
    eng.run(wall_timeout_s=120)
    assert w4.state == "finished"
    eng._pool.check()
    log.reqs.append([w, w2, w3, w4])


def _trace_swapin_tier(pkg, log):
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 256, (4,)).astype(np.int32)
    big = rng.integers(0, 256, (10,)).astype(np.int32)
    fi, clock = pkg.fault.FaultInjector(), FakeClock()
    eng = pkg.engine(fi, clock, num_slots=1, prompt_len=P, max_cache_len=C,
                     steps_per_call=1, block_len=2, chunk_len=4,
                     num_blocks=7)
    log.engines.append((eng, fi))
    reqs = [eng.submit(shared, max_new_tokens=2)]
    _drain(eng, clock)
    reqs.append(eng.submit(big, max_new_tokens=2))   # demotes the shared
    _drain(eng, clock)
    assert eng.stats()["host_cache_blocks"] > 0
    fi.fail_swapins(None)
    reqs.append(eng.submit(shared, max_new_tokens=2))
    _drain(eng, clock)
    s = eng.stats()
    assert s["prefix_host_hits"] == 0 and s["host_swapin_blocks"] == 0
    assert ("swapin_fail", None) in fi.events
    assert s["host_cache_blocks"] < 7
    log.notes.append({k: s[k] for k in (
        "prefix_host_hits", "host_swapin_blocks", "host_cache_blocks",
        "prefix_hits", "prefix_misses", "swap_blocks_out")})
    fi.clear_swapin_failures()
    reqs.append(eng.submit(big, max_new_tokens=2))
    _drain(eng, clock)
    reqs.append(eng.submit(shared, max_new_tokens=2))
    _drain(eng, clock)
    assert eng.stats()["prefix_host_hits"] >= 1
    reqs.append(eng.submit(big, max_new_tokens=2))
    _drain(eng, clock)
    assert eng.stats()["host_cache_blocks"] > 0
    fi.force_tier_evicts(16)
    eng.step(clock.now)
    eng._pool.check()
    assert eng.stats()["host_cache_blocks"] == 0
    assert ("tier_evict", None) in fi.events
    reqs.append(eng.submit(shared, max_new_tokens=2))
    _drain(eng, clock)
    assert eng._pool.in_use() == 0
    eng._pool.check()
    log.reqs.append(reqs)


def _streams(reqs):
    return [list(r.tokens) for r in reqs]


def _trace_replica(pkg, log):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32) for n in (8, 6)]
    fi, clock = pkg.fault.FaultInjector(), FakeClock()
    eng = pkg.engine(fi, clock, num_slots=2, prompt_len=P, max_cache_len=C,
                     steps_per_call=2)
    log.engines.append((eng, fi))
    reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
    for _ in range(4):
        eng.step(clock.now)
    assert all(r.state == "decode" for r in reqs)
    # a latched kill: raised before any scheduling work, every step
    before = _streams(reqs)
    fi.kill_at_step(eng._step_idx + 1)
    for _ in range(2):
        log.expect(pkg.serving.ReplicaKilledError,
                   lambda: eng.step(clock.now))
    assert _streams(reqs) == before
    eng._pool.check()
    fi.clear_replica_faults()
    eng.step(clock.now)
    # a permanent stall: the watchdog's verdict, latched until cleared
    fi.stall_forever()
    before = _streams(reqs)
    for _ in range(2):
        log.expect(pkg.serving.EngineStalledError,
                   lambda: eng.step(clock.now))
    assert _streams(reqs) == before
    fi.clear_replica_faults()
    eng.step(clock.now)
    eng._pool.check()
    # a poisoned harvest: raised before the outputs become host truth
    fi.poison_at_step(eng._step_idx + 1)
    before = _streams(reqs)
    log.expect(pkg.serving.PoisonedDispatchError,
               lambda: eng.step(clock.now))
    assert _streams(reqs) == before
    assert all(0 <= t < 256 for r in reqs for t in r.tokens)
    assert ("poison", None) in fi.events
    eng._pool.check()
    log.reqs.append(reqs)


def _trace_combined(pkg, log):
    """The card's phase 3g (e) at the tiny size: 4 slots over a small
    pool, an allocation failure, a forced swap, a 50 ms stall and a tier
    eviction, then every request finishes."""
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (12, 10, 12, 8)]
    fi, clock = pkg.fault.FaultInjector(), FakeClock()
    eng = pkg.engine(fi, clock, num_slots=4, prompt_len=P, max_cache_len=C,
                     block_len=4, num_blocks=20, chunk_len=8)
    log.engines.append((eng, fi))
    warm = eng.submit(prompts[3], max_new_tokens=2)
    _drain(eng, clock)                      # cached blocks to reclaim
    fi.fail_allocs(1)
    reqs = [eng.submit(p, max_new_tokens=m)
            for p, m in zip(prompts[:3], (10, 12, 8))]
    for _ in range(3):
        eng.step(clock.now)
    fi.force_swap(reqs[0].request_id)
    fi.stall_steps(1, 0.05)
    eng.step(clock.now)
    # swapped out at the top of the step; a slot and blocks are free, so
    # it resumed in the same step's admission
    assert ("forced_swap", reqs[0].request_id) in fi.events
    assert eng.stats()["preempt_resumes"] == 1
    fi.force_tier_evicts(2)
    eng.run(wall_timeout_s=120)
    assert all(r.state == "finished" for r in reqs)
    eng._pool.check()
    reg = eng.metrics_registry
    stall = reg.get("serving.fault.stall_seconds").summary()
    assert stall["count"] == 1 and stall["sum"] >= 0.05
    # the fake clock moves only in the stall: host seconds exclude it
    assert reg.get("serving.step.host_seconds").summary()["sum"] == 0.0
    assert eng.stats()["preemptions"] == 1
    log.reqs.append([warm] + reqs)


RUNNERS = {"alloc_wedge": _trace_alloc_wedge,
           "swapin_tier": _trace_swapin_tier,
           "replica": _trace_replica, "combined": _trace_combined}


@pytest.fixture(scope="module")
def traced():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(2024)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    pkgs = {"jax": Pkg(jserving, jfault, jflightrec.FlightRecorder,
                       MetricsRegistry, jnet),
            "port": Pkg(tserving, tfault, FlightRecorder, TorchRegistry,
                        tnet, device="cpu")}
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name in TRACES:
            for side, pkg in pkgs.items():
                log = Log()
                clocks = []

                def fake_sleep(s, clocks=clocks):
                    clocks[-1].now += s
                real_engine = pkg.engine

                def engine(fi, clock, real_engine=real_engine,
                           clocks=clocks, **kw):
                    clocks.append(clock)
                    return real_engine(fi, clock, **kw)
                pkg.engine = engine
                mp.setattr(time, "sleep", fake_sleep)
                try:
                    RUNNERS[name](pkg, log)
                finally:
                    mp.undo()
                    pkg.engine = real_engine
                out[(name, side)] = log
    finally:
        mp.undo()
        torch.set_num_threads(prev)
    return jnet, out


def _pair(traced, name):
    _jnet, out = traced
    return out[(name, "jax")], out[(name, "port")]


def _strip(events):
    return [(e.seq, e.step, e.request, e.kind,
             tuple(sorted((k, str(v)) for k, v in e.attrs.items())))
            for e in events]


@pytest.mark.parametrize("name", TRACES)
def test_same_exceptions_and_fired_faults(traced, name):
    j, t = _pair(traced, name)
    assert t.raised == j.raised
    assert bool(t.raised) == (name in ("alloc_wedge", "replica"))
    for (je, jfi), (te, tfi) in zip(j.engines, t.engines):
        assert tfi.events == jfi.events
        te._pool.check()


@pytest.mark.parametrize("name", TRACES)
def test_flight_records_equal(traced, name):
    j, t = _pair(traced, name)
    for (je, _), (te, _) in zip(j.engines, t.engines):
        tev = te.flight_recorder.events()
        assert tev and _strip(tev) == _strip(je.flight_recorder.events())
        for r in t.reqs[0]:
            assert te.explain(r.request_id) == je.explain(r.request_id)


@pytest.mark.parametrize("name", TRACES)
def test_counters_and_stats_equal(traced, name):
    j, t = _pair(traced, name)
    for (je, _), (te, _) in zip(j.engines, t.engines):
        treg, jreg = te.metrics_registry, je.metrics_registry
        for inst in treg.names():
            ts, js = treg.get(inst)._snap(), jreg.get(inst)._snap()
            if ts["type"] == "histogram":
                assert {k: c["count"] for k, c in ts["values"].items()} == \
                    {k: c["count"] for k, c in js["values"].items()}, inst
            else:
                assert ts == js, inst
        tst, jst = te.stats(), je.stats()
        for k in tst:
            if k in jst and not k.startswith("mean_") \
                    and not k.endswith("_seconds"):
                assert tst[k] == jst[k], (k, tst[k], jst[k])
        assert tst["useful_tokens"] + tst["wasted_tokens"] \
            == tst["dispatched_tokens"]
    assert t.notes == j.notes


@pytest.mark.parametrize("name", TRACES)
def test_tokens_equal_jax_at_decisive_positions(traced, name):
    jnet, _out = traced
    j, t = _pair(traced, name)
    compared = total = 0
    for jr, tr in zip(j.reqs[0], t.reqs[0]):
        assert tr.state == jr.state
        ids = jr.prompt[:jr.seq_len]
        out = np.asarray(jr.tokens, np.int32)
        s = np.concatenate([ids, out[:-1]])[None]
        lg = np.asarray(jnet(paddle.to_tensor(s))._value)[0]
        lg = lg[len(ids) - 1:len(ids) - 1 + len(out)]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        close = np.flatnonzero(top2[:, 1] - top2[:, 0] <= MARGIN)
        upto = int(close[0]) if close.size else len(out)
        np.testing.assert_array_equal(np.asarray(tr.tokens)[:upto],
                                      out[:upto])
        compared += upto
        total += len(out)
    # the traces resubmit the same prompts, so one undecided position
    # repeats in every copy: at least half of all positions are compared
    assert total and compared >= 0.5 * total, (compared, total)
