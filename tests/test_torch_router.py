"""The port's front-door router (``inference/router.py``) held against
the JAX package's on the traces of ``tests/test_router.py``, case for
case: affinity routing over replicas, workload policies, the router's
bounded queue, timeout and cancel, submit rollback, and the
single-replica identity contract.

Every trace runs through both packages on the same weights (the weight
bridge), each engine and router with private registries and recorders:
routing decisions and reasons, affinity counters, router flight-recorder
events (event for event, wall aside), engine counters and stream flush
boundaries are equal, and tokens equal the JAX engine's up to each
request's first non-decisive position (teacher-forced top-2 margin <=
0.01).  A multi-turn conversation's next prompt is built from the JAX
side's outputs in both packages, so the two traces see the same prompts.

The combined trace's conversations c1 and c2 each ride their own LoRA
adapter, registered in every replica's ``AdapterStore`` (each package
builds its own adapters from the same seeds): adapter affinity routes
turn 2 back to the replica holding the adapter, and the adapter rows'
margins are read from the JAX model with the adapter merged."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import lora as jlora
from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference import serving as jserving
from paddle_tpu.inference.sampling import DfaTokenMask as JaxDfa
from paddle_tpu.inference.sampling import SamplingParams as JaxSP
from paddle_tpu.models import lora as jmlora
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability.flightrec import FlightRecorder as JaxRecorder
from paddle_tpu_torch.inference import lora as tlora
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.sampling import DfaTokenMask as TorchDfa
from paddle_tpu_torch.inference.sampling import SamplingParams as TorchSP
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama_state_from_jax)
from paddle_tpu_torch.observability import FlightRecorder, MetricsRegistry

P, C, BL = 32, 48, 4
FAR = 1e12
MARGIN = 0.01


class Pkg:
    """One package's router, engine and observability classes, so a
    trace reads the same for both."""

    def __init__(self, name, net, serving, router, lora, registry,
                 recorder, sp, dfa, **extra):
        self.name, self.net = name, net
        self.serving, self.router, self.lora = serving, router, lora
        self.Registry, self.Recorder = registry, recorder
        self.SP, self.Dfa, self.extra = sp, dfa, extra

    def mk(self, *, registry=None, recorder=None, **kw):
        base = dict(num_slots=2, prompt_len=P, max_cache_len=C,
                    steps_per_call=1, block_len=BL, chunk_len=4,
                    num_blocks=16, compute_dtype="float32")
        base.update(kw)
        return self.serving.ServingEngine(
            self.net, registry=(registry if registry is not None
                                else self.Registry()),
            flight_recorder=recorder, **base, **self.extra)

    def Router(self, engines, **kw):
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
    yield {"jax": Pkg("jax", jnet, jserving, jrouter, jlora, JaxRegistry,
                      JaxRecorder, JaxSP, JaxDfa),
           "port": Pkg("port", tnet, tserving, trouter, tlora,
                       MetricsRegistry, FlightRecorder, TorchSP, TorchDfa,
                       device="cpu")}
    torch.set_num_threads(prev)


def _decisive(jnet, ids, out):
    s = np.concatenate([ids, out[:-1]])[None].astype(np.int32)
    lg = np.asarray(jnet(paddle.to_tensor(s))._value)[0]
    lg = lg[len(ids) - 1:len(ids) - 1 + len(out)]
    top2 = np.sort(lg, axis=-1)[:, -2:]
    close = np.flatnonzero(top2[:, 1] - top2[:, 0] <= MARGIN)
    return int(close[0]) if close.size else len(out)


def _assert_tokens(jnet, prompts_outs_port, prompts_outs_jax,
                   adapters=None):
    """Tokens equal up to each row's first non-decisive position, the
    margins read from the JAX model with the row's JAX adapter (if any)
    merged; at least half of all positions compared."""
    compared = total = 0
    adapters = adapters or [None] * len(prompts_outs_port)
    for (ids, tout), (_ids, jout), ad in zip(prompts_outs_port,
                                             prompts_outs_jax, adapters):
        jout = np.asarray(jout, np.int32)
        if ad is None:
            upto = _decisive(jnet, np.asarray(ids, np.int32), jout)
        else:
            with jmlora.merged_adapter(jnet, ad):
                upto = _decisive(jnet, np.asarray(ids, np.int32), jout)
        np.testing.assert_array_equal(np.asarray(tout)[:upto], jout[:upto])
        compared += upto
        total += len(jout)
    assert total and compared >= 0.5 * total, (compared, total)


def _strip(events):
    return [(e.seq, e.step, e.request, e.kind,
             tuple(sorted((k, str(v)) for k, v in e.attrs.items())))
            for e in events]


def test_router_units(pkgs):
    """Dispatch-free router surface: construction guards, policy
    resolution, submit validation, ``load_report`` (key for key and
    value for value the JAX engine's on an empty engine)."""
    t, j = pkgs["port"], pkgs["jax"]
    reg = MetricsRegistry()
    eng = t.mk(registry=reg)
    rt = t.Router([eng], registry=reg)
    ids = np.arange(6, dtype=np.int32) + 1

    rep = eng.load_report()
    jrep = j.mk().load_report()
    assert rep == jrep
    assert rep["blocks_free"] == 16 and rep["hbm_adapters"] == []
    assert rep["radix"] == {"hbm_blocks": 0, "host_blocks": 0,
                            "root_children": 0}
    assert all(type(v) in (int, str, list, dict, type(None))
               for v in rep.values())
    assert eng.prefix_match(ids) == 0

    assert trouter.ROUTER_POLICIES == jrouter.ROUTER_POLICIES
    for name in ("ROUTE_REASONS", "REPLICA_FAULTS", "FAILOVER_PATHS",
                 "PROBE_OUTCOMES", "HEALTH_STATES"):
        assert getattr(trouter, name) == getattr(jrouter, name), name
    with pytest.raises(ValueError, match="unknown router policy"):
        rt.submit(ids, policy="stream")
    with pytest.raises(ValueError, match="prefill-only"):
        rt.submit(ids, policy="embed", max_new_tokens=4)
    h = rt.submit(ids, policy="chat", arrival_time=FAR)
    assert isinstance(h, tserving.TokenStream)
    assert h.request.priority == 1
    hb = rt.submit(ids, policy="batch", arrival_time=FAR)
    assert isinstance(hb, trouter.RoutedRequest) and hb.priority == 0
    he = rt.submit(ids, policy="embed", arrival_time=FAR)
    assert he.max_new_tokens == 1
    hx = rt.submit(ids, policy="chat", stream=False, arrival_time=FAR)
    assert isinstance(hx, trouter.RoutedRequest)

    with pytest.raises(ValueError, match="prompt must be"):
        rt.submit(np.arange(P + 1, dtype=np.int32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        rt.submit(ids, max_new_tokens=0)
    with pytest.raises(ValueError, match="max_cache_len"):
        rt.submit(ids, max_new_tokens=C)
    with pytest.raises(ValueError, match="not registered"):
        rt.submit(ids, adapter="nope")
    with pytest.raises(ValueError, match="spec_decode must be"):
        rt.submit(ids, spec_decode=0)
    table = np.full((1, 128), -1, np.int32)
    table[0, 1] = 0
    with pytest.raises(ValueError, match="token-mask"):
        rt.submit(ids, spec_decode=2, sampling=t.SP(
            mask_processor=t.Dfa(table)))

    rtb = t.Router([eng], max_queue=1, registry=MetricsRegistry())
    h1 = rtb.submit(ids, arrival_time=0.0, max_queue_delay_s=0.0)
    h2 = rtb.submit(ids, arrival_time=FAR)
    assert h1.state == "timeout" and h2.state == "queued"
    assert h1 in rtb.step(now=0.0)

    other = t.mk(num_slots=1, block_len=BL + 4, num_blocks=None)
    with pytest.raises(ValueError, match="differs from replica 0"):
        t.Router([eng, other])
    with pytest.raises(ValueError, match=">= 1 engine"):
        t.Router([])

    assert hb.request_id is None and hb.engine is None
    assert not hb.routed and hb.output.size == 0
    with pytest.raises(AttributeError, match="not been routed"):
        hb.slot


def _combined(pkg, jouts=None):
    """The combined 2-replica trace: 3 conversations x 2 turns (c0
    streamed through policy 'chat', c1/c2 each on its own LoRA adapter),
    an embed request, a bounded-engine-queue spill, a router-queue shed,
    a timeout and a cancel.  ``jouts`` (the JAX run's turn outputs) build
    the next turn's prompts."""
    rng = np.random.default_rng(42)
    ads = [pkg.lora.LoraAdapter.random(pkg.net.config, f"a{j}", rank=4,
                                       seed=50 + j, scale=0.05)
           for j in range(2)]
    regs = [pkg.Registry() for _ in range(2)]
    engs = [pkg.mk(registry=reg, adapter_store=pkg.store(ads, reg))
            for reg in regs]
    rrec = pkg.Recorder()
    rt = pkg.Router(engs, affinity=True, registry=pkg.Registry(),
                    flight_recorder=rrec)
    term = pkg.serving.TERMINAL_STATES
    sys_ids = rng.integers(0, 128, (4,)).astype(np.int32)
    hist = [list(sys_ids) for _ in range(3)]
    new = 4

    def drain(handles, streams=()):
        flushes = {id(s): [] for s in streams}
        steps = 0
        while any(h.state not in term for h in handles):
            rt.step(now=0.0)
            for e in engs:
                e._pool.check()
            for s in streams:
                flushes[id(s)].append(s.read().tolist())
            steps += 1
            assert steps < 80, "trace did not drain"
        return flushes

    adapters = [None, ads[0].name, ads[1].name]
    log = {"assign": {ci: [] for ci in range(3)}, "outs": [],
           "flushes": [], "adapters": [None, ads[0], ads[1]] * 2}
    for turn in range(2):
        handles, streams = [], []
        for ci in range(3):
            user = rng.integers(0, 128, (3,)).astype(np.int32)
            hist[ci].extend(int(x) for x in user)
            ids = np.asarray(hist[ci], np.int32)
            if ci == 0:
                s = rt.submit(ids, max_new_tokens=new, policy="chat",
                              arrival_time=0.0)
                streams.append(s)
                h = s.request
            else:
                h = rt.submit(ids, max_new_tokens=new,
                              adapter=adapters[ci], arrival_time=0.0)
            handles.append(h)
        fl = drain(handles, streams)
        for ci, h in enumerate(handles):
            log["assign"][ci].append(h.engine)
            out = [int(x) for x in h.output]
            log["outs"].append((list(hist[ci]), out))
            src = out if jouts is None else jouts[turn * 3 + ci][1]
            hist[ci].extend(src)
        log["flushes"].append(fl[id(streams[0])])

    he = rt.submit(np.asarray(hist[0][:6], np.int32), policy="embed",
                   arrival_time=0.0)
    drain([he])
    assert he.state == "finished" and he.output.size == 1
    log["stats_after_turns"] = rt.stats()
    # turn-2 adapter affinity saved the second swap-in on each replica
    log["swapins"] = [r.get("serving.lora.swap_ins").value() for r in regs]
    log["engine_stats"] = [{k: e.stats()[k] for k in (
        "prefills", "prefill_chunks", "decode_steps", "block_dispatches",
        "prefix_hits", "prefix_hit_tokens", "async_syncs",
        "async_harvests", "finished")} for e in engs]

    # bounded-engine-queue spill: e0 ranks best but refuses
    filler = engs[0].submit(np.asarray(hist[2][:6], np.int32),
                            arrival_time=FAR)
    engs[0].max_queue = 1
    f1 = engs[1].submit(np.asarray(hist[2][:6], np.int32),
                        arrival_time=FAR)
    f2 = engs[1].submit(np.asarray(hist[2][:6], np.int32),
                        arrival_time=FAR)
    sp_ids = np.asarray(hist[1][:6], np.int32)
    want_aff = engs[1].prefix_match(sp_ids)
    h_sp = rt.submit(sp_ids, max_new_tokens=2, arrival_time=0.0)
    steps = 0
    while h_sp.state not in term:
        rt.step(now=0.0)
        steps += 1
        assert steps < 40
    ev_sp = [e for e in rrec.events() if e.kind == "route"][-1]
    log["spill"] = (h_sp.engine, want_aff, dict(ev_sp.attrs),
                    ev_sp.request == h_sp.router_id)
    engs[0].max_queue = None
    for e, r in ((engs[0], filler), (engs[1], f1), (engs[1], f2)):
        assert e.cancel(r.request_id)

    rt2 = pkg.Router(engs, max_queue=2, registry=pkg.Registry())
    ids6 = np.asarray(hist[1][:6], np.int32)
    lo = rt2.submit(ids6, arrival_time=FAR, priority=0)
    rt2.submit(ids6, arrival_time=FAR, priority=1)
    with pytest.raises(pkg.serving.AdmissionError):
        rt2.submit(ids6, arrival_time=FAR, priority=0)
    rt2.submit(ids6, arrival_time=FAR, priority=2)
    log["shed"] = (lo.state, lo.output.size, rt2.stats()["shed"])

    rt3 = pkg.Router(engs, registry=pkg.Registry())
    to = rt3.submit(ids6, arrival_time=0.0, max_queue_delay_s=0.0)
    out2 = rt3.step(now=1.0)
    log["timeout"] = (to.state, to in out2, to.engine,
                      rt3.stats()["timeouts"])
    ca = rt3.submit(ids6, arrival_time=FAR)
    base = rt3._m.cancelled.value(phase="router")
    log["cancel"] = (rt3.cancel(ca), ca.state, ca.engine, ca.output.size,
                     rt3._m.cancelled.value(phase="router") - base,
                     rt3.cancel(ca), rt3.cancel(10_000), rt.cancel(he))
    log["events"] = _strip(rrec.events())
    log["rt"], log["rrec"], log["engs"] = rt, rrec, engs
    return log


@pytest.fixture(scope="module")
def combined(pkgs):
    j = _combined(pkgs["jax"])
    t = _combined(pkgs["port"], jouts=j["outs"])
    return j, t


def test_router_combined_trace(pkgs, combined):
    j, t = combined
    jnet = pkgs["jax"].net
    # routing decisions, reasons and affinity counters are the JAX
    # router's; load primary, affinity a strict tie-break
    assert t["assign"] == j["assign"]
    for k in ("routed_by_reason", "prefix_affinity_tokens",
              "adapter_affinity_hits", "requests"):
        assert t["stats_after_turns"][k] == j["stats_after_turns"][k], k
    assert t["stats_after_turns"]["prefix_affinity_tokens"] > 0
    # turn 2 returns c1 and c2 to the replica holding their adapter
    assert t["stats_after_turns"]["routed_by_reason"]["adapter"] == 2
    assert t["stats_after_turns"]["adapter_affinity_hits"] == 2
    assert t["swapins"] == j["swapins"] == [1.0, 1.0]
    assert set(trouter.ROUTE_REASONS) == \
        set(t["stats_after_turns"]["routed_by_reason"])
    assert t["engine_stats"] == j["engine_stats"]
    assert sum(s["prefix_hit_tokens"] for s in t["engine_stats"]) > 0
    # c0's stream: flush boundaries equal the JAX stream's, the flushes
    # concatenate to the output, and they were incremental
    for turn in range(2):
        assert [len(f) for f in t["flushes"][turn]] == \
            [len(f) for f in j["flushes"][turn]]
        _ids, out = t["outs"][turn * 3]
        assert sum(t["flushes"][turn], []) == out
        assert sum(1 for f in t["flushes"][turn] if f) >= 2
    _assert_tokens(jnet, t["outs"], j["outs"], j["adapters"])
    # the spill landed on e1 with e1's own affinity in the event
    eng, want_aff, attrs, same = t["spill"]
    assert eng == 1 and same and attrs["engine"] == 1
    assert attrs["affinity"] == want_aff
    assert attrs["reason"] == ("prefix" if want_aff else "load")
    assert t["spill"] == j["spill"]
    assert t["shed"] == j["shed"] == ("shed", 32, 2)
    assert t["timeout"] == j["timeout"] == ("timeout", True, None, 1)
    assert t["cancel"] == j["cancel"]
    assert t["cancel"][:5] == (True, "cancelled", None, 32, 1)
    # the router's flight record is the JAX router's, event for event
    assert t["events"] == j["events"]
    routes = [e for e in t["rrec"].events() if e.kind == "route"]
    assert {e.attrs["engine"] for e in routes} == {0, 1}
    assert "routed to engine" in t["rt"].explain(routes[-1].request)
    aff = [e for e in routes if e.attrs.get("affinity")]
    assert aff and "prefix affinity" in t["rt"].explain(aff[0].request)
    assert t["rt"].explain(routes[0].request) == \
        j["rt"].explain(routes[0].request)


def _rollback(pkg):
    ids = np.arange(6, dtype=np.int32) + 1

    class ExplodingRecorder(pkg.Recorder):
        def __init__(self):
            super().__init__()
            self.armed = False

        def emit(self, kind, request, step, **attrs):
            if self.armed and kind == "submit":
                raise RuntimeError("injected recorder failure")
            super().emit(kind, request, step, **attrs)

    rec = ExplodingRecorder()
    reg = pkg.Registry()
    eng = pkg.mk()
    rt = pkg.Router([eng], max_queue=1, registry=reg, flight_recorder=rec)
    lo = rt.submit(ids, arrival_time=FAR, priority=0)
    depth0 = reg.get("serving.router.queue_depth").value()
    requests0 = reg.get("serving.router.requests").total()
    assert depth0 == 1
    rec.armed = True
    for _ in range(3):
        with pytest.raises(RuntimeError, match="injected recorder"):
            rt.submit(ids, arrival_time=FAR, priority=2)
        assert lo.state == "queued"
        assert list(rt._queue) == [lo]
        assert rt._handles == [lo]
        assert reg.get("serving.router.queue_depth").value() == depth0
        assert reg.get("serving.router.requests").total() == requests0
    rec.armed = False
    hi = rt.submit(ids, arrival_time=FAR, priority=2)
    assert lo.state == "shed" and hi.state == "queued"
    assert rt._handles == [lo, hi]
    ev = [e.kind for e in rec.events()]
    assert ev[-2:] == ["submit", "shed"]
    return _strip(rec.events()), reg.snapshot()


def test_router_submit_rollback_symmetry(pkgs):
    """A failure after the router enqueued an arrival (a raising
    recorder hook) leaves queue depth, gauges, handle list and the would-
    be shed victim as before; the victim is shed only once the arrival
    is safely enqueued.  Events and the registry equal the JAX
    router's."""
    tev, tsnap = _rollback(pkgs["port"])
    jev, jsnap = _rollback(pkgs["jax"])
    assert tev == jev
    assert tsnap == jsnap


def _single(pkg, prompts, news):
    rec1 = pkg.Recorder()
    e1 = pkg.mk(recorder=rec1)
    r1 = [e1.submit(p, max_new_tokens=m, arrival_time=0.0)
          for p, m in zip(prompts, news)]
    e1.run()
    rec2 = pkg.Recorder()
    e2 = pkg.mk(recorder=rec2)
    rt = pkg.Router([e2], affinity=False, registry=pkg.Registry())
    r2 = [rt.submit(p, max_new_tokens=m, arrival_time=0.0)
          for p, m in zip(prompts, news)]
    rt.run(wall_timeout_s=120)
    assert rt.stats()["routed_by_reason"]["round_robin"] == 3
    return e1, e2, r1, r2, rec1, rec2


def test_router_single_replica_byte_identical(pkgs):
    """A single-replica router with affinity off schedules byte-
    identically to the bare engine (same outputs, admission order,
    counters and flight-recorder events), and both equal the JAX
    package's."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32)
               for n in (7, 5, 6)]
    news = [5, 4, 4]
    prompts[2][:4] = prompts[0][:4]
    keys = ("decode_steps", "block_dispatches", "prefill_chunks",
            "prefills", "prefix_hits", "prefix_hit_tokens",
            "dispatched_tokens", "useful_tokens", "wasted_tokens",
            "async_syncs", "async_harvests", "finished")
    te1, te2, tr1, tr2, trec1, trec2 = _single(pkgs["port"], prompts, news)
    je1, je2, jr1, jr2, jrec1, jrec2 = _single(pkgs["jax"], prompts, news)
    for a, b in zip(tr1, tr2):
        assert np.array_equal(a.output, b.output)
        assert a.request_id == b.request_id
    s1, s2, js = te1.stats(), te2.stats(), je1.stats()
    for k in keys:
        assert s1[k] == s2[k] == js[k], k

    def strip(rec):
        return [(e.step, e.request, e.kind, dict(e.attrs))
                for e in rec.events()]

    assert strip(trec1) == strip(trec2) == strip(jrec1) == strip(jrec2)
    _assert_tokens(pkgs["jax"].net,
                   [(p, r.output) for p, r in zip(prompts, tr1)],
                   [(p, r.output) for p, r in zip(prompts, jr1)])
