"""Replica failover and exact-state request migration through the port's
router, held against the JAX package's on the traces of
``tests/test_failover.py``, case for case: the health model over
injected replica faults (kill, poisoned dispatch, permanent stall),
exact-bytes KV migration through the host tier, deterministic recompute
from the prompt, the bounded retry budget with the ``failed`` terminal,
probation and readmission, and the seeded random-fault soak (``slow``,
as the JAX package marks it).

Each trace runs through both packages on the same weights, every engine
and router with private registries and recorders and the pools audited
after every router step.  The port is token-exact against its own
no-fault twin (streams spliced, sampled and spec rows included); its
router events, failover counters and migrated bytes equal the JAX
router's; greedy rows equal the JAX tokens up to the first non-decisive
position (teacher-forced top-2 margin <= 0.01; the LoRA row's margins
read from the JAX model with its adapter merged).  Each replica holds
its own ``AdapterStore`` with the trace's adapter, so the LoRA row
migrates like any other and its tokens equal the port's merged-weights
``generate()``."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import faultinject as jfault
from paddle_tpu.inference import lora as jlora
from paddle_tpu.inference import prefixcache as jprefix
from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference import serving as jserving
from paddle_tpu.inference.sampling import SamplingParams as JaxSP
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.models import lora as jmlora
from paddle_tpu.observability.flightrec import FlightRecorder as JaxRecorder
from paddle_tpu_torch.inference import faultinject as tfault
from paddle_tpu_torch.inference import lora as tlora
from paddle_tpu_torch.inference import prefixcache as tprefix
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.sampling import SamplingParams as TorchSP
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama_state_from_jax)
from paddle_tpu_torch.models import lora as tmlora
from paddle_tpu_torch.observability import FlightRecorder, MetricsRegistry

P, C, BL = 32, 48, 4
MARGIN = 0.01


class Pkg:
    def __init__(self, name, net, serving, router, fault, prefix, lora,
                 registry, recorder, sp, **extra):
        self.name, self.net = name, net
        self.serving, self.router, self.fault = serving, router, fault
        self.prefix, self.lora = prefix, lora
        self.Registry, self.Recorder, self.SP = registry, recorder, sp
        self.extra = extra

    def mk(self, *, registry=None, recorder=None, injector=None, **kw):
        return self.serving.ServingEngine(
            self.net, num_slots=2, prompt_len=P, max_cache_len=C,
            steps_per_call=1, block_len=BL, chunk_len=4, num_blocks=16,
            compute_dtype="float32",
            registry=registry if registry is not None else self.Registry(),
            flight_recorder=recorder, fault_injector=injector, **kw,
            **self.extra)

    def Router(self, engines, **kw):
        kw.setdefault("registry", self.Registry())
        return self.router.Router(engines, **kw)

    def store(self, adapters, registry):
        s = self.lora.AdapterStore(self.net, slots=2, max_rank=4,
                                   dtype="float32", registry=registry,
                                   **self.extra)
        for ad in adapters:
            s.register(ad)
        return s


@pytest.fixture(scope="module")
def pkgs():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(1234)
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=1, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
    jnet = jmodels.LlamaForCausalLM(jmodels.LlamaConfig(**kw))
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(LlamaConfig(**kw), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    yield {"jax": Pkg("jax", jnet, jserving, jrouter, jfault, jprefix,
                      jlora, JaxRegistry, JaxRecorder, JaxSP),
           "port": Pkg("port", tnet, tserving, trouter, tfault, tprefix,
                       tlora, MetricsRegistry, FlightRecorder, TorchSP,
                       device="cpu")}
    torch.set_num_threads(prev)


def _decisive(jnet, ids, out):
    s = np.concatenate([ids, out[:-1]])[None].astype(np.int32)
    lg = np.asarray(jnet(paddle.to_tensor(s))._value)[0]
    lg = lg[len(ids) - 1:len(ids) - 1 + len(out)]
    top2 = np.sort(lg, axis=-1)[:, -2:]
    close = np.flatnonzero(top2[:, 1] - top2[:, 0] <= MARGIN)
    return int(close[0]) if close.size else len(out)


def _hold_greedy(jnet, prompts, touts, jouts):
    """Tokens equal the JAX tokens up to each request's first non-decisive
    position; at least half of all positions are compared."""
    compared = total = 0
    for ids, tout, jout in zip(prompts, touts, jouts):
        jout = np.asarray(jout, np.int32)
        upto = _decisive(jnet, np.asarray(ids, np.int32), jout)
        np.testing.assert_array_equal(np.asarray(tout)[:upto], jout[:upto])
        compared += upto
        total += len(jout)
    assert total and compared >= 0.5 * total, (compared, total)


def _strip(events):
    return [(e.seq, e.step, e.request, e.kind,
             tuple(sorted((k, str(v)) for k, v in e.attrs.items())))
            for e in events]


def _drain(pkg, rt, handles, *, streams=(), max_steps=150):
    flushes = {id(s): [] for s in streams}
    steps = 0
    while any(h.state not in pkg.serving.TERMINAL_STATES for h in handles):
        rt.step(now=0.0)
        for e in rt.engines:
            e._pool.check()
        for s in streams:
            c = s.read()
            if c.size:
                flushes[id(s)].append(c)
        steps += 1
        assert steps < max_steps, "trace did not drain"
    return flushes


def test_failover_units(pkgs):
    """Dispatch-free surface: injector arming, the fault classifier,
    the closed vocabularies (the JAX package's), ``HostTier.transfer``
    accounting, router construction guards and ``migrate_in``
    validation (messages as the JAX engine's)."""
    t, j = pkgs["port"], pkgs["jax"]
    inj = tfault.FaultInjector()
    with pytest.raises(ValueError, match="step must be"):
        inj.kill_at_step(0)
    with pytest.raises(ValueError, match="unknown replica fault"):
        inj.arm_replica_fault("meteor")
    inj.kill_at_step(3)
    assert not inj.take_kill(2)
    assert inj.take_kill(3) and inj.take_kill(7)
    inj.clear_replica_faults()
    assert not inj.take_kill(99)

    assert trouter._classify_fault(
        tserving.ReplicaKilledError("x")) == "kill"
    assert trouter._classify_fault(
        tserving.PoisonedDispatchError("x")) == "poison"
    assert trouter._classify_fault(
        tserving.EngineStalledError("x")) == "stall"
    for name in ("REPLICA_FAULTS", "FAILOVER_PATHS", "PROBE_OUTCOMES",
                 "HEALTH_STATES"):
        assert getattr(trouter, name) == getattr(jrouter, name), name
    assert tserving.TERMINAL_STATES == jserving.TERMINAL_STATES
    assert "failed" in tserving.TERMINAL_STATES

    src, dst = tprefix.HostTier(), tprefix.HostTier(cache_capacity_blocks=1)
    rows = [np.arange(8, dtype=np.float32).reshape(2, 4) + k
            for k in range(3)]
    k = src.put([r.copy() for r in rows], 2, "preempt",
                ("float32",) * 3)
    k2 = src.transfer(k, dst)
    assert k2 is not None and src.entry(k) is None
    assert dst.blocks("preempt") == 2 and src.blocks("preempt") == 0
    for a, b in zip(rows, dst.entry(k2).rows):
        assert np.array_equal(a, b)
    assert dst.entry(k2).dtypes == ("float32",) * 3
    assert src.audit() == [] and dst.audit() == []
    kc = src.put([r.copy() for r in rows], 2, "cache")
    assert src.transfer(kc, dst) is None
    assert src.entry(kc) is not None
    assert src.transfer(12345, dst) is None
    kl = src.put(lambda: [r.copy() for r in rows], 1, "preempt")
    k3 = src.transfer(kl, dst)
    assert dst.entry(k3).resolved

    eng = t.mk()
    with pytest.raises(ValueError, match="retry_budget"):
        t.Router([eng], retry_budget=-1)
    with pytest.raises(ValueError, match="probe_interval"):
        t.Router([eng], probe_interval=0)
    with pytest.raises(ValueError, match="probation_steps"):
        t.Router([eng], probation_steps=-1)
    rt = t.Router([eng])
    assert rt.health == ["healthy"]
    jeng = j.mk()
    assert sorted(rt.stats()) == sorted(j.Router([jeng]).stats())

    ids = np.arange(6, dtype=np.int32) + 1
    for e, pk in ((eng, t), (jeng, j)):
        msgs = []
        with pytest.raises(ValueError, match="not a preempt entry") as ei:
            e.migrate_in(ids, max_new_tokens=4,
                         parcel={"key": 999, "n_blocks": 2, "tok": 0,
                                 "lens": 6, "phase": "decode"})
        msgs.append(str(ei.value))
        pk_ = e._host_tier.put([np.zeros((2, BL, 4), np.float32)
                                for _ in range(2)], 2, "preempt")
        for parcel, kw, pat in (
                ({"n_blocks": 3, "phase": "decode"}, {}, "swap record says"),
                ({"n_blocks": 2, "phase": "verify"}, {}, "phase must be"),
                ({"n_blocks": 2, "phase": "decode"},
                 {"max_new_tokens": 2, "tokens": [1, 2]},
                 "nothing left to decode")):
            kw.setdefault("max_new_tokens", 4)
            with pytest.raises(ValueError, match=pat) as ei:
                e.migrate_in(ids, parcel=dict(parcel, key=pk_, tok=0,
                                              lens=6), **kw)
            msgs.append(str(ei.value))
        e._host_tier.drop(pk_)
        e._pool.check()
        pk.msgs = msgs
    assert t.msgs == j.msgs


def _combined(pkg):
    """The combined failover trace in two arms: the no-fault twin, and
    the same trace with one request force-swapped to the host tier and
    its replica then killed.  Row 3 rides the LoRA adapter ``fo_a0``."""
    rng = np.random.default_rng(77)
    ad = pkg.lora.LoraAdapter.random(pkg.net.config, "fo_a0", rank=4,
                                     seed=91, scale=0.05)
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32)
               for n in (8, 7, 7, 5, 8)]
    news = [7, 4, 4, 3, 5]
    samp = pkg.SP(temperature=0.8, top_k=0, seed=7)
    term = pkg.serving.TERMINAL_STATES

    def build(inject):
        injs = [pkg.fault.FaultInjector() if inject else None
                for _ in range(2)]
        engs = []
        for i in range(2):
            reg = pkg.Registry()
            engs.append(pkg.mk(registry=reg, injector=injs[i],
                               adapter_store=pkg.store([ad], reg)))
        rrec = pkg.Recorder()
        rt = pkg.Router(engs, affinity=True, flight_recorder=rrec)
        return rt, engs, injs, rrec

    def submit_all(rt):
        st = rt.submit(prompts[0], max_new_tokens=news[0], policy="chat",
                       arrival_time=0.0)
        hs = [st.request,
              rt.submit(prompts[1], max_new_tokens=news[1], sampling=samp,
                        arrival_time=0.0),
              rt.submit(prompts[2], max_new_tokens=news[2], spec_decode=2,
                        arrival_time=0.0),
              rt.submit(prompts[3], max_new_tokens=news[3],
                        adapter=ad.name, arrival_time=0.0),
              rt.submit(prompts[4], max_new_tokens=news[4],
                        arrival_time=0.0)]
        return hs, st

    rtA, _e, _i, _r = build(False)
    hsA, stA = submit_all(rtA)
    flA = _drain(pkg, rtA, hsA, streams=[stA])
    log = {"prompts": prompts, "news": news, "adapter": ad,
           "refs": [np.asarray(h.output) for h in hsA],
           "catA": np.concatenate(flA[id(stA)])}

    rt, engs, injs, rrec = build(True)
    hs, st = submit_all(rt)
    rt.step(now=0.0)
    assert all(h.engine is not None for h in hs)
    vi = hs[0].engine
    victim, vinj = engs[vi], injs[vi]
    flushes = []
    for _ in range(4):
        rt.step(now=0.0)
        c = st.read()
        if c.size:
            flushes.append(c)
    assert hs[0].state == "decode" and len(hs[0].tokens) >= 1
    vinj.force_swap(hs[0].request_id)
    vinj.fail_allocs(None)
    rt.step(now=0.0)
    assert hs[0].state == "swapped"
    vblocks = hs[0]._req.swap.n_blocks
    ent = victim._host_tier.entry(hs[0]._req.swap.host_key)
    log["parcel"] = [np.array(r, copy=True) for r in ent.rows]
    affected = [h for h in hs if h.engine == vi and h.state not in term]
    vinj.kill_at_step(victim._step_idx + 1)
    rt.step(now=0.0)
    assert rt.health[vi] == "unhealthy"
    log["after_kill"] = {k: rt.stats()[k] for k in (
        "replica_faults", "failover_requests", "health")}
    while any(h.state not in term for h in hs):
        rt.step(now=0.0)
        for e in engs:
            e._pool.check()
        c = st.read()
        if c.size:
            flushes.append(c)
    log.update(vi=vi, vblocks=vblocks, n_affected=len(affected),
               outs=[np.asarray(h.output) for h in hs],
               states=[h.state for h in hs],
               catB=np.concatenate(flushes),
               row_bytes=victim.block_len * victim._kv_row_bytes)
    rs = rt.stats()
    log["stats"] = {k: rs[k] for k in (
        "migrated_blocks", "migrated_bytes", "failed", "replica_faults",
        "failover_requests", "probes", "readmissions")}
    log["explain"] = [rt.explain(h.router_id) for h in hs]
    probes_failed = rt._m.probes.value(outcome="fail")
    vinj.clear_replica_faults()
    vinj.clear_alloc_failures()
    steps = 0
    while rt.health[vi] != "healthy":
        rt.step(now=0.0)
        steps += 1
        assert steps < 12
    log["probes"] = (probes_failed, rt._m.probes.value(outcome="pass"),
                     rt.stats()["readmissions"], steps)
    h2 = rt.submit(prompts[0], max_new_tokens=2, arrival_time=0.0)
    _drain(pkg, rt, [h2])
    log["h2"] = (h2.state, np.asarray(h2.output))
    log["events"] = _strip(rrec.events())
    log["rrec"], log["rt"], log["hs"] = rrec, rt, hs
    return log


@pytest.fixture(scope="module")
def combined(pkgs):
    return _combined(pkgs["jax"]), _combined(pkgs["port"])


def test_failover_combined_kill_with_migration(pkgs, combined):
    j, t = combined
    tnet = pkgs["port"].net
    # token-exact against the no-fault twin: streamed, sampled, spec,
    # LoRA and plain rows; the stream spliced without double-emitting
    assert t["states"] == ["finished"] * 5
    for i in range(5):
        assert np.array_equal(t["outs"][i], t["refs"][i]), i
    assert np.array_equal(t["catA"], t["catB"])
    # greedy rows: the port's generate() (the LoRA row's over merged
    # weights), and the JAX tokens
    for i in (0, 2, 3, 4):
        def gen():
            return np.asarray(tnet.generate(
                t["prompts"][i][None], max_new_tokens=t["news"][i],
                max_cache_len=C, compute_dtype="float32"))[0]
        if i == 3:
            with tmlora.merged_adapter(tnet, t["adapter"]):
                want = gen()
        else:
            want = gen()
        assert np.array_equal(t["refs"][i], want), i
    _hold_greedy(pkgs["jax"].net, [t["prompts"][i] for i in (0, 2, 4)],
                 [t["outs"][i] for i in (0, 2, 4)],
                 [j["outs"][i] for i in (0, 2, 4)])
    with jmlora.merged_adapter(pkgs["jax"].net, j["adapter"]):
        _hold_greedy(pkgs["jax"].net, [t["prompts"][3]], [t["outs"][3]],
                     [j["outs"][3]])
    # the migration moved exactly the victim's parcel, whose bytes are
    # the JAX parcel's up to the decisive tokens (float32 K/V agree to
    # rounding, not bit for bit: the two models' matmuls differ)
    assert t["vblocks"] == j["vblocks"] > 0
    assert t["stats"]["migrated_blocks"] == t["vblocks"]
    assert t["stats"]["migrated_bytes"] == t["vblocks"] * t["row_bytes"]
    assert [r.shape for r in t["parcel"]] == [r.shape for r in j["parcel"]]
    assert [r.dtype for r in t["parcel"]] == [r.dtype for r in j["parcel"]]
    for a, b in zip(t["parcel"], j["parcel"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # the failover story is the JAX router's, counter for counter and
    # event for event
    assert t["vi"] == j["vi"] and t["n_affected"] == j["n_affected"]
    assert t["after_kill"] == j["after_kill"]
    assert t["after_kill"]["replica_faults"] == 1
    assert t["after_kill"]["failover_requests"] == t["n_affected"]
    assert t["stats"] == j["stats"] and t["stats"]["failed"] == 0
    assert t["events"] == j["events"]
    assert t["explain"] == j["explain"]
    vi = t["vi"]
    fails = [e for e in t["rrec"].events() if e.kind == "fail"]
    migrs = [e for e in t["rrec"].events() if e.kind == "migrate"]
    retries = [e for e in t["rrec"].events() if e.kind == "retry"]
    assert len(fails) == t["n_affected"]
    assert all(e.attrs["fault"] == "kill" and e.attrs["engine"] == vi
               for e in fails)
    assert len(migrs) == 1 and migrs[0].request == t["hs"][0].router_id
    assert {k: migrs[0].attrs[k] for k in ("engine", "src", "blocks")} == \
        {"engine": 1 - vi, "src": vi, "blocks": t["vblocks"]}
    assert len(retries) == t["n_affected"] - 1
    assert f"failed over to engine {1 - vi} (migrated " in t["explain"][0]
    assert "at exact bytes" in t["explain"][0]
    # probation and readmission, then the readmitted replica serves
    assert t["probes"] == j["probes"]
    assert t["probes"][0] >= 1 and t["probes"][1:3] == (1, 1)
    assert t["h2"][0] == "finished"
    assert np.array_equal(t["h2"][1], t["refs"][0][:2])


def _poison_stall_budget(pkg):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32) for n in (8, 6)]
    log = {"prompts": prompts}
    injs = [pkg.fault.FaultInjector(), pkg.fault.FaultInjector()]
    engs = [pkg.mk(injector=injs[i]) for i in range(2)]
    rrec = pkg.Recorder()
    rt = pkg.Router(engs, flight_recorder=rrec)
    hs = [rt.submit(p, max_new_tokens=4, arrival_time=0.0) for p in prompts]
    rt.step(now=0.0)
    vi = hs[0].engine
    for _ in range(2):
        rt.step(now=0.0)
    injs[vi].poison_at_step(engs[vi]._step_idx + 1)
    rt.step(now=0.0)
    log["poison"] = (rt.stats()["replica_faults"],
                     rt._m.replica_faults.value(fault="poison"))
    _drain(pkg, rt, hs)
    log["outs"] = [np.asarray(h.output) for h in hs]
    assert all(h.state == "finished" for h in hs)
    assert all(0 <= x < 128 for h in hs for x in h.tokens)
    steps = 0
    while rt.health[vi] != "healthy":
        rt.step(now=0.0)
        steps += 1
        assert steps < 12
    injs[vi].stall_forever()
    h3 = rt.submit(prompts[0], max_new_tokens=3, arrival_time=0.0)
    before = rt._m.probes.value(outcome="fail")
    _drain(pkg, rt, [h3])
    log["stall"] = (h3.state, rt._m.replica_faults.value(fault="stall"),
                    rt.health[vi], rt._m.probes.value(outcome="fail")
                    > before)
    injs[vi].clear_replica_faults()
    steps = 0
    while rt.health[vi] != "healthy":
        rt.step(now=0.0)
        steps += 1
        assert steps < 12
    log["events"] = _strip(rrec.events())

    inj = pkg.fault.FaultInjector()
    eng = pkg.mk(injector=inj)
    rrec2 = pkg.Recorder()
    rt2 = pkg.Router([eng], retry_budget=0, flight_recorder=rrec2)
    stf = rt2.submit(prompts[1], max_new_tokens=4, stream=True,
                     arrival_time=0.0)
    hf = stf.request
    inj.kill_at_step(eng._step_idx + 1)
    out = rt2.step(now=0.0)
    term = [e for e in rrec2.events()
            if e.kind == "fail" and e.attrs.get("terminal")]
    log["budget"] = (hf.state, hf in out, stf.finished, hf.output.size,
                     rt2.stats()["failed"],
                     rt2.stats()["failover_requests"], len(term),
                     term[0].attrs["retries"],
                     "failed terminally" in rt2.explain(hf.router_id))
    inj2 = pkg.fault.FaultInjector()
    eng2 = pkg.mk(injector=inj2)
    rt3 = pkg.Router([eng2], failover=False)
    h4 = rt3.submit(prompts[1], max_new_tokens=4, arrival_time=0.0)
    inj2.kill_at_step(eng2._step_idx + 1)
    rt3.step(now=0.0)
    log["switch"] = (h4.state, rt3.stats()["probes"])
    return log


def test_failover_poison_stall_and_budget(pkgs):
    """A poisoned harvest and a permanent stall fail the replica over
    (recompute path; no corrupt token reaches a stream; probes fail
    until cleared), an exhausted retry budget ends ``failed`` with the
    uniform padded output, and ``failover=False`` is the kill switch —
    each exactly as the JAX router does it."""
    t = _poison_stall_budget(pkgs["port"])
    j = _poison_stall_budget(pkgs["jax"])
    assert t["poison"] == j["poison"] == (1, 1)
    assert t["stall"] == j["stall"]
    assert t["stall"][0] == "finished" and t["stall"][1] >= 1
    assert t["stall"][2] == "unhealthy" and t["stall"][3]
    assert t["events"] == j["events"]
    assert t["budget"] == j["budget"] == (
        "failed", True, True, 4, 1, 0, 1, 0, True)
    assert t["switch"] == j["switch"] == ("failed", 0)
    tnet = pkgs["port"].net
    for p, out in zip(t["prompts"], t["outs"]):
        gen = tnet.generate(p[None], max_new_tokens=4, max_cache_len=C,
                            compute_dtype="float32")
        assert np.array_equal(out, np.asarray(gen)[0])
    _hold_greedy(pkgs["jax"].net, t["prompts"], t["outs"], j["outs"])


@pytest.mark.slow
def test_random_fault_soak(pkgs):
    """The seeded random-fault soak (``slow`` as in the JAX package: the
    combined and poison/stall tests above cover every fault class it
    draws): a seeded kill/poison/stall schedule over a 2-replica router,
    pools audited every step, faults cleared a fixed delay after arming,
    and every output equal to the port's no-fault twin; the fault
    counters equal the JAX router's."""
    res = {}
    for side in ("jax", "port"):
        pkg = pkgs[side]
        rng = np.random.default_rng(42)
        prompts = [rng.integers(0, 128, (n,)).astype(np.int32)
                   for n in (9, 7, 6, 8, 5)]
        news = [4, 3, 4, 3, 3]
        samp = pkg.SP(temperature=0.7, top_k=0, seed=11)

        def submit_all(rt):
            return [rt.submit(p, max_new_tokens=m, arrival_time=0.0,
                              **({"sampling": samp} if i == 3 else {}))
                    for i, (p, m) in enumerate(zip(prompts, news))]

        rtA = pkg.Router([pkg.mk() for _ in range(2)])
        hsA = submit_all(rtA)
        _drain(pkg, rtA, hsA)
        refs = [np.asarray(h.output) for h in hsA]
        frng = np.random.default_rng(4242)
        schedule = sorted(
            (int(frng.integers(2, 9)) + 7 * i, int(frng.integers(0, 2)),
             ("kill", "poison", "stall")[int(frng.integers(0, 3))])
            for i in range(3))
        injs = [pkg.fault.FaultInjector(), pkg.fault.FaultInjector()]
        rt = pkg.Router([pkg.mk(injector=injs[i]) for i in range(2)])
        hs = submit_all(rt)
        clears, step = [], 0
        while any(h.state not in pkg.serving.TERMINAL_STATES for h in hs):
            step += 1
            for s, vi, kind in schedule:
                if s == step:
                    injs[vi].arm_replica_fault(
                        kind, rt.engines[vi]._step_idx + 1)
                    clears.append((step + 3, vi))
            for s, vi in list(clears):
                if s == step:
                    injs[vi].clear_replica_faults()
                    clears.remove((s, vi))
            rt.step(now=0.0)
            for e in rt.engines:
                e._pool.check()
            assert step < 120, "soak did not drain"
        for i, (h, ref) in enumerate(zip(hs, refs)):
            assert h.state == "finished", (i, h.state)
            assert np.array_equal(np.asarray(h.output), ref), i
        rs = rt.stats()
        assert rs["replica_faults"] >= 1 and rs["failed"] == 0
        assert rs["recoveries_pending"] == 0
        res[side] = {k: rs[k] for k in (
            "replica_faults", "failover_requests", "probes",
            "readmissions", "migrated_blocks")}
    assert res["port"] == res["jax"]


def _copy_arenas(jeng, teng):
    for ja, ta in zip(jeng._arenas, teng._arenas):
        ta.copy_(torch.from_numpy(np.array(np.asarray(ja), copy=True)))


def _parcel_bytes(tier, key):
    return [np.array(r, copy=True).view(np.uint8) for r in
            tier.entry(key).rows]


def test_migrated_parcel_byte_equal_to_jax(pkgs):
    """The two packages' routers in lockstep, the JAX engines' arena
    bytes copied into the port's before every router step (the two
    models' float32 K/V agree to rounding only): the victim's swap
    parcel, and the copy the failover migrates into the surviving
    replica's host tier, hold the JAX parcel's bytes exactly, and the
    migrated blocks and bytes are equal."""
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32)
               for n in (9, 6, 7)]
    sides = {}
    for side in ("jax", "port"):
        pkg = pkgs[side]
        injs = [pkg.fault.FaultInjector() for _ in range(2)]
        engs = [pkg.mk(injector=injs[i]) for i in range(2)]
        rt = pkg.Router(engs)
        hs = [rt.submit(p, max_new_tokens=8, arrival_time=0.0)
              for p in prompts]
        sides[side] = (rt, engs, injs, hs, [])
        for e in engs:
            def migrate_in(*a, _e=e, _orig=e.migrate_in,
                           _seen=sides[side][4], **kw):
                # the bytes the failover handed this replica's tier
                if kw.get("parcel") is not None:
                    _seen.append(_parcel_bytes(_e._host_tier,
                                               kw["parcel"]["key"]))
                return _orig(*a, **kw)
            e.migrate_in = migrate_in

    def step():
        for je, te in zip(sides["jax"][1], sides["port"][1]):
            _copy_arenas(je, te)
        for side in ("jax", "port"):
            sides[side][0].step(now=0.0)

    for _ in range(5):
        step()
    vi = sides["jax"][3][0].engine
    assert sides["port"][3][0].engine == vi
    for side in ("jax", "port"):
        rt, engs, injs, hs, _seen = sides[side]
        assert hs[0].state == "decode"
        injs[vi].force_swap(hs[0].request_id)
        injs[vi].fail_allocs(None)
    step()
    parcels = {}
    for side in ("jax", "port"):
        rt, engs, injs, hs, _seen = sides[side]
        assert hs[0].state == "swapped"
        parcels[side] = _parcel_bytes(engs[vi]._host_tier,
                                      hs[0]._req.swap.host_key)
        injs[vi].kill_at_step(engs[vi]._step_idx + 1)
    assert [p.shape for p in parcels["port"]] == \
        [p.shape for p in parcels["jax"]]
    for a, b in zip(parcels["port"], parcels["jax"]):
        np.testing.assert_array_equal(a, b)
    step()
    for side in ("jax", "port"):
        assert sides[side][0].health[vi] == "unhealthy"
        assert len(sides[side][4]) == 1
    for a, b in zip(sides["port"][4][0], sides["jax"][4][0]):
        np.testing.assert_array_equal(a, b)
    steps = 0
    while any(h.state not in jserving.TERMINAL_STATES
              for s in sides.values() for h in s[3]):
        step()
        steps += 1
        assert steps < 150
    ts, js = sides["port"][0].stats(), sides["jax"][0].stats()
    for k in ("migrated_blocks", "migrated_bytes", "failover_requests",
              "replica_faults"):
        assert ts[k] == js[k], k
    assert ts["migrated_blocks"] > 0
    for th, jh in zip(sides["port"][3], sides["jax"][3]):
        assert th.state == jh.state == "finished"
