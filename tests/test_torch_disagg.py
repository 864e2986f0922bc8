"""Disaggregated prefill/decode serving through the port, held against
the JAX package on the traces of ``tests/test_disagg.py``, case for
case: role-typed replicas, phase-aware routing and the chunk-final KV
handoff, with the "both" fleet's identity contract, the end-to-end
1-prefill + 1-decode trace, handoff composing with failover across the
loopback wire, and the arrival-aware fused window.

Each trace runs through both packages on the same weights: handoff
counters, router and engine flight-recorder stories and fused-window
sizes equal the JAX package's; the port is token-exact against its own
monolithic twin and equal to the JAX tokens up to the first
non-decisive position.  A lockstep arm (the JAX engines' arena bytes
copied into the port's before every router step and before each
handoff's gather) holds every handoff parcel byte-equal to the JAX
parcel, and without the copy each parcel's prompt rows are byte-equal
to the monolithic engine's arena rows for that request."""

import importlib.util
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import faultinject as jfault
from paddle_tpu.inference import procserve as jproc
from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference import serving as jserving
from paddle_tpu.inference import transport as jtransport
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import fleet as jfleet
from paddle_tpu.observability import flightrec as jflightrec
from paddle_tpu_torch.inference import faultinject as tfault
from paddle_tpu_torch.inference import procserve as tproc
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference import transport as ttransport
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama_state_from_jax)
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.observability import fleet as tfleet
from paddle_tpu_torch.observability import flightrec as tflightrec
from tools.serving_top import check as top_check
from tools.serving_top import render as top_render

P, C, BL = 32, 48, 4
MARGIN = 0.01
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pkg:
    def __init__(self, name, net, serving, router, fault, proc, transport,
                 fleet, flightrec, registry, **extra):
        self.name, self.net = name, net
        self.serving, self.router, self.fault = serving, router, fault
        self.proc, self.transport, self.fleet = proc, transport, fleet
        self.flightrec, self.Registry = flightrec, registry
        self.extra = extra

    def Recorder(self):
        return self.flightrec.FlightRecorder()

    def mk(self, *, registry=None, recorder=None, injector=None, **kw):
        base = dict(num_slots=2, prompt_len=P, max_cache_len=C,
                    steps_per_call=1, block_len=BL, chunk_len=4,
                    num_blocks=16, compute_dtype="float32",
                    clock=lambda: 0.0)
        base.update(kw)
        return self.serving.ServingEngine(
            self.net,
            registry=registry if registry is not None else self.Registry(),
            flight_recorder=recorder, fault_injector=injector, **base,
            **self.extra)

    def Router(self, engines, **kw):
        kw.setdefault("registry", self.Registry())
        return self.router.Router(engines, **kw)

    def wrap(self, engine, label):
        return self.transport.RemoteReplica(self.transport.LoopbackTransport(
            self.proc.EngineHost(engine, label=label),
            registry=self.Registry()))


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
    yield {"jax": Pkg("jax", jnet, jserving, jrouter, jfault, jproc,
                      jtransport, jfleet, jflightrec, JaxRegistry),
           "port": Pkg("port", tnet, tserving, trouter, tfault, tproc,
                       ttransport, tfleet, tflightrec, MetricsRegistry,
                       device="cpu")}
    torch.set_num_threads(prev)


def _decisive(jnet, ids, out):
    s = np.concatenate([ids, out[:-1]])[None].astype(np.int32)
    lg = np.asarray(jnet(paddle.to_tensor(s))._value)[0]
    lg = lg[len(ids) - 1:len(ids) - 1 + len(out)]
    top2 = np.sort(lg, axis=-1)[:, -2:]
    close = np.flatnonzero(top2[:, 1] - top2[:, 0] <= MARGIN)
    return int(close[0]) if close.size else len(out)


def _hold(jnet, prompts, touts, jouts):
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


def _story(rec):
    return [(e.kind, e.request, e.step) for e in rec.events()]


def _strip(events):
    return [(e.seq, e.step, e.request, e.kind,
             tuple(sorted((k, str(v)) for k, v in e.attrs.items())))
            for e in events]


def _drain(pkg, rt, handles, *, max_steps=200, audit=True):
    steps = 0
    while any(h.state not in pkg.serving.TERMINAL_STATES for h in handles):
        rt.step(now=0.0)
        if audit:
            for e in rt.engines:
                e._pool.check()
        steps += 1
        assert steps < max_steps, [h.state for h in handles]


def test_role_units(pkgs):
    """The closed vocabularies (the JAX package's), engine role
    validation, the decode-role door and the router's fleet-composition
    guards, with the JAX engine's messages."""
    t, j = pkgs["port"], pkgs["jax"]
    assert tserving.ENGINE_ROLES == jserving.ENGINE_ROLES
    assert tserving.HANDOFF_REASONS == jserving.HANDOFF_REASONS
    assert set(tserving.ENGINE_ROLES) == {"prefill", "decode", "both"}
    with pytest.raises(ValueError, match="role"):
        t.mk(role="embedder")
    msgs = {}
    for side, pkg in (("port", t), ("jax", j)):
        dec = pkg.mk(role="decode")
        with pytest.raises(pkg.serving.AdmissionError,
                           match="decode-role") as ei:
            dec.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=4,
                       arrival_time=0.0)
        assert dec.stats()["role"] == "decode"
        assert dec.load_report()["role"] == "decode"
        assert dec.engine_spec()["role"] == "decode"
        msgs[side] = [str(ei.value)]
        for roles, pat in ((["decode"], "prefill-capable"),
                           (["prefill"], "decode-capable")):
            with pytest.raises(ValueError, match=pat) as ei:
                pkg.Router([pkg.mk(role=r) for r in roles])
            msgs[side].append(str(ei.value))
        pkg.Router([pkg.mk(role="both")])
        pkg.Router([pkg.mk(role="prefill"), pkg.mk(role="decode")])
    assert msgs["port"] == msgs["jax"]
    reg = MetricsRegistry()
    t.mk(role="prefill", registry=reg)
    assert reg.get("serving.role").value(role="prefill") == 1


def _fleet_trace(pkg, roles, *, explicit=True):
    recs = [pkg.Recorder() for _ in roles]
    rrec = pkg.Recorder()
    engs = [pkg.mk(recorder=rec, **({"role": r} if explicit else {}))
            for r, rec in zip(roles, recs)]
    rt = pkg.Router(engs, flight_recorder=rrec)
    rng = np.random.default_rng(7)
    hs, prompts = [], []
    for i in range(5):
        ids = rng.integers(1, 100, size=6 + 2 * i).astype(np.int32)
        prompts.append(ids)
        hs.append(rt.submit(ids, max_new_tokens=4 + i, arrival_time=0.0,
                            stream=False))
    _drain(pkg, rt, hs)
    outs = [list(h.tokens) for h in sorted(hs, key=lambda h: h.router_id)]
    return rt, engs, rrec, recs, outs, prompts


def test_both_role_fleet_byte_identity(pkgs):
    """role="both" spelled out schedules byte-identically to a fleet
    that never mentions roles, and both equal the JAX fleet's stories."""
    t, j = pkgs["port"], pkgs["jax"]
    rt_a, engs_a, rrec_a, recs_a, outs_a, prompts = _fleet_trace(
        t, ["both", "both"])
    rt_b, engs_b, rrec_b, recs_b, outs_b, _ = _fleet_trace(
        t, ["both", "both"], explicit=False)
    _jrt, _je, jrrec, jrecs, jouts, _ = _fleet_trace(j, ["both", "both"])
    assert outs_a == outs_b
    assert _story(rrec_a) == _story(rrec_b) == _story(jrrec)
    for ra, rb, rj in zip(recs_a, recs_b, jrecs):
        assert _story(ra) == _story(rb) == _story(rj)
    for ea, eb in zip(engs_a, engs_b):
        sa, sb = ea.stats(), eb.stats()
        for k in ("role", "prefills", "block_dispatches", "handoffs",
                  "handoff_blocks", "handoff_bytes"):
            assert sa[k] == sb[k], k
        assert sa["handoffs"] == 0
    assert rt_a.stats()["roles"] == ["both", "both"]
    assert rt_a.stats()["handoffs_pending"] == 0
    _hold(j.net, prompts, outs_a, jouts)


def _explain_cli():
    spec = importlib.util.spec_from_file_location(
        "explain_request", os.path.join(REPO, "tools", "explain_request.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


def test_disagg_handoff_token_exact(pkgs, tmp_path, capsys):
    """1 prefill + 1 decode replica against the monolithic twin:
    token-exact, exact handoff counters, zero prefill work on the decode
    replica, the hop narrated by the router, the lone engine, the
    stitched record and the JAX package's ``explain_request`` CLI over
    the port's exported records, and ``serving_top``'s role census;
    counters and every flight record equal the JAX fleet's."""
    t, j = pkgs["port"], pkgs["jax"]
    rt_m, _em, _rm, _recm, outs_m, prompts = _fleet_trace(
        t, ["both", "both"])
    rt_d, engs_d, rrec_d, recs_d, outs_d, _ = _fleet_trace(
        t, ["prefill", "decode"])
    jrt, jengs, jrrec, jrecs, jouts, _ = _fleet_trace(
        j, ["prefill", "decode"])
    assert outs_m == outs_d
    gen = t.net.generate(prompts[0][None], max_new_tokens=4,
                         max_cache_len=C, compute_dtype="float32")
    assert np.array_equal(np.asarray(outs_d[0]), np.asarray(gen)[0])
    _hold(j.net, prompts, outs_d, jouts)

    sp, sd = engs_d[0].stats(), engs_d[1].stats()
    jsp, jsd = jengs[0].stats(), jengs[1].stats()
    assert sp["role"] == "prefill" and sd["role"] == "decode"
    assert sp["handoffs"] == sum(len(o) > 1 for o in outs_d) == 5
    assert sd["handoffs"] == 0 and sp["handoff_blocks"] > 0
    assert sp["handoff_bytes"] == \
        sp["handoff_blocks"] * BL * engs_d[0]._kv_row_bytes
    assert sd["prefills"] == 0
    for k in ("handoffs", "handoff_blocks", "handoff_bytes", "prefills",
              "prefill_chunks", "block_dispatches", "async_syncs",
              "async_harvests"):
        assert (sp[k], sd[k]) == (jsp[k], jsd[k]), k
    assert not [e for e in recs_d[1].events() if e.kind == "prefill_chunk"]
    hos = [e for e in rrec_d.events() if e.kind == "handoff"]
    assert len(hos) == 5
    assert all(e.attrs["src"] == 0 and e.attrs["engine"] == 1 for e in hos)
    assert sum(int(e.attrs["blocks"]) for e in hos) == sp["handoff_blocks"]
    assert rt_d.stats()["handoffs_pending"] == 0
    assert _strip(rrec_d.events()) == _strip(jrrec.events())
    for tr, jr in zip(recs_d, jrecs):
        assert _strip(tr.events()) == _strip(jr.events())

    rid = hos[0].request
    text = tflightrec.explain_events(rrec_d.events(), rid)
    assert ("prefilled on engine 0, handed off" in text
            and "to engine 1 at chunk-final" in text)
    eho = [e for e in recs_d[0].events() if e.kind == "handoff"][0]
    etext = tflightrec.explain_events(recs_d[0].events(), eho.request)
    assert "at chunk-final for decode elsewhere" in etext
    assert eho.attrs["reason"] == "chunk_final"
    st = tfleet.stitch_flight_records(recs_d, router=rrec_d)
    story = st.explain(rid)
    assert story.count("handed off") == 1
    assert "prefilled on engine 0" in story
    assert "to engine 1 at chunk-final" in story
    assert story == jfleet.stitch_flight_records(
        jrecs, router=jrrec).explain(rid)

    cli = _explain_cli()
    paths = []
    for i, rec in enumerate(recs_d):
        pth = str(tmp_path / f"rep{i}.json")
        rec.export(pth)
        paths.append(pth)
    rpath = str(tmp_path / "router.json")
    rrec_d.export(rpath)
    assert cli.main(paths + [str(rid), "--router", rpath]) == 0
    out = capsys.readouterr().out
    assert "prefilled on engine 0" in out
    assert "to engine 1 at chunk-final" in out
    assert cli.main(paths + [str(rid), "--router", rpath,
                             "--timeline"]) == 0
    out = capsys.readouterr().out
    assert "handoff" in out and "[on router]" in out

    snap = rt_d.fleet_snapshot()
    assert snap["roles"] == ["prefill", "decode"]
    assert top_check(snap) == []
    text = top_render(snap)
    assert "role=prefill" in text and "role=decode" in text
    assert "disagg: prefill=1 decode=1" in text
    mono_text = top_render(rt_m.fleet_snapshot())
    assert "disagg:" not in mono_text and "role=" not in mono_text


def _copy_arenas(jeng, teng):
    for ja, ta in zip(jeng._arenas, teng._arenas):
        ta.copy_(torch.from_numpy(np.array(np.asarray(ja), copy=True)))


def _disagg_lockstep(pkgs, prompts, copy):
    """Both packages' prefill/decode fleets stepped in turns over
    ``prompts`` (JAX first); with ``copy`` the JAX engines' arena bytes
    are copied into the port's before every router step, and the JAX
    prefill engine's into the port's right before each handoff gather
    (the final chunk is written inside the same step).  Returns each
    side's picked-up parcels: (request id, n_blocks, tok, lens, rows)."""
    sides = {}
    for side in ("jax", "port"):
        pkg = pkgs[side]
        engs = [pkg.mk(role=r) for r in ("prefill", "decode")]
        rt = pkg.Router(engs)
        picked = []
        take = engs[0].take_handoffs

        def take_handoffs(_take=take, _e=engs[0], _picked=picked,
                          _side=side):
            out = _take()
            for r in out:
                ent = _e._host_tier.entry(r.swap.host_key)
                if _side == "port":
                    assert not ent.resolved
                _picked.append((r.request_id, r.swap.n_blocks, r.swap.tok,
                                r.swap.lens, [np.array(x, copy=True)
                                              for x in ent.rows]))
            return out
        engs[0].take_handoffs = take_handoffs
        hs = [rt.submit(p, max_new_tokens=5, arrival_time=0.0)
              for p in prompts]
        sides[side] = (rt, engs, hs, picked)
    if copy:
        teng, jeng = sides["port"][1][0], sides["jax"][1][0]
        out = teng._handoff_out

        def handoff_out(*a, _out=out, **kw):
            _copy_arenas(jeng, teng)
            return _out(*a, **kw)
        teng._handoff_out = handoff_out
    steps = 0
    while any(h.state not in jserving.TERMINAL_STATES
              for s in sides.values() for h in s[2]):
        if copy:
            for je, te in zip(sides["jax"][1], sides["port"][1]):
                _copy_arenas(je, te)
        for side in ("jax", "port"):
            sides[side][0].step(now=0.0)
        steps += 1
        assert steps < 200
    return sides["port"][3], sides["jax"][3]


def test_handoff_parcels_byte_equal_to_jax(pkgs):
    """Every handoff parcel the port's router picks up is the JAX
    parcel: in lockstep with the JAX fleet over the same arena bytes
    (copied in, see ``_disagg_lockstep``), the same request ids, block
    counts and carries, and the same bytes in the same layout and
    dtypes.  Without the copy (each package's own float32 K/V), the
    port's parcel rows over the prompt are its monolithic engine's arena
    rows for that request, byte for byte.  The port's parcels stay lazy
    until the router's transfer reads them."""
    t = pkgs["port"]
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 100, size=n).astype(np.int32)
               for n in (7, 10, 13)]
    tp, jp = _disagg_lockstep(pkgs, prompts, copy=True)
    assert len(tp) == len(jp) == len(prompts)
    for a, b in zip(tp, jp):
        assert a[:4] == b[:4]
        for x, y in zip(a[4], b[4]):
            assert x.shape == y.shape and x.dtype == y.dtype
            np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))
    # the prompt rows of each parcel are the monolithic engine's arena
    # rows for that request (positions past the prompt are scratch)
    tp, _jp = _disagg_lockstep(pkgs, prompts, copy=False)
    mono = t.mk()
    reqs = [mono.submit(p, max_new_tokens=5, arrival_time=0.0)
            for p in prompts]
    rows = {}
    while any(r.state not in tserving.TERMINAL_STATES for r in reqs):
        mono.step(now=0.0)
        for r in reqs:
            if r.state == "decode" and r.request_id not in rows:
                ids = torch.as_tensor(r.blocks, dtype=torch.long)
                rows[r.request_id] = [a.index_select(0, ids).clone()
                                      for a in mono._arenas]
    for rid, nb, tok, lens, parcel in tp:
        assert rid in rows and lens == len(prompts[rid])
        for x, a in zip(parcel, rows[rid]):
            flat = torch.from_numpy(x).reshape((nb * BL,) + tuple(
                a.shape[2:]))
            want = a.reshape((-1,) + tuple(a.shape[2:]))
            assert torch.equal(flat[:lens], want[:lens])


def _handoff_failover(pkg, inject):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, (int(n),)).astype(np.int32)
               for n in rng.integers(6, 12, 4)]
    roles = ["prefill", "decode", "decode"]
    injs = [pkg.fault.FaultInjector() for _ in roles]
    engs = [pkg.mk(role=r, injector=i) for r, i in zip(roles, injs)]
    reps = [pkg.wrap(e, f"r{i}") for i, e in enumerate(engs)]
    assert [r.role for r in reps] == roles
    rrec = pkg.Recorder()
    rt = pkg.Router(reps, flight_recorder=rrec)
    hs = [rt.submit(p, max_new_tokens=12, arrival_time=0.0)
          for p in prompts]
    if inject:
        vi = None
        for _ in range(30):
            rt.step(now=0.0)
            vi = next((h.engine for h in hs
                       if h.engine in (1, 2) and h.state == "decode"), None)
            if vi is not None:
                break
        assert vi is not None, "no handoff landed"
        injs[vi].kill_at_step(engs[vi]._step_idx + 1)
    steps = 0
    while any(h.state not in pkg.serving.TERMINAL_STATES for h in hs):
        rt.step(now=0.0)
        steps += 1
        assert steps < 400, [h.state for h in hs]
    return dict(rt=rt, reps=reps, engs=engs, prompts=prompts,
                states=[h.state for h in hs],
                outs=[np.asarray(h.output) for h in hs],
                events=_strip(rrec.events()))


def test_handoff_then_decode_failover_loopback(pkgs):
    """Handoff composes with failover across the loopback wire: a decode
    replica killed mid-stream after requests handed off onto it recovers
    them (staged parcels migrate, the rest recompute and hand off
    again), token-exact against the no-fault twin, with the JAX fleet's
    failover story."""
    t, j = pkgs["port"], pkgs["jax"]
    ref = _handoff_failover(t, inject=False)
    got = _handoff_failover(t, inject=True)
    jgot = _handoff_failover(j, inject=True)
    assert got["states"] == ["finished"] * 4
    assert all(np.array_equal(a, b) for a, b in zip(ref["outs"],
                                                    got["outs"]))
    rs, jrs = got["rt"].stats(), jgot["rt"].stats()
    assert rs["replica_faults"] == 1
    assert rs["roles"] == ["prefill", "decode", "decode"]
    assert got["engs"][0].stats()["handoffs"] >= 4
    assert rs["failover_requests"] >= 1
    assert rs["handoffs_pending"] == 0
    assert all(len(r._host_tier.keys()) == 0 for r in got["reps"])
    for k in ("replica_faults", "failover_requests", "migrated_blocks",
              "migrated_bytes", "handoffs_pending"):
        assert rs[k] == jrs[k], k
    assert got["engs"][0].stats()["handoffs"] == \
        jgot["engs"][0].stats()["handoffs"]
    assert got["events"] == jgot["events"]
    _hold(j.net, got["prompts"], got["outs"], jgot["outs"])


def _fused_windows(pkg):
    rng = np.random.default_rng(42)
    ids1 = rng.integers(0, 128, (6,)).astype(np.int32)
    ids2 = rng.integers(0, 128, (5,)).astype(np.int32)

    def mk():
        return pkg.mk(prompt_len=8, max_cache_len=40, num_blocks=12,
                      recorder=pkg.Recorder(), clock=time.perf_counter,
                      async_dispatch=True, async_depth=3)

    def newest(e):
        return e._pend_q[-1].iters if e._pend_q else None

    log = []
    eng = mk()
    r1 = eng.submit(ids1, max_new_tokens=24, arrival_time=0.0)
    tm = 0.0
    for _ in range(6):
        eng.step(now=tm)
        tm += 1.0
    assert r1.state == "decode" and eng._step_dt == 1.0
    log.append(newest(eng))
    r2 = eng.submit(ids2, max_new_tokens=3, arrival_time=tm + 2.0)
    eng.step(now=tm)
    log.append(newest(eng))
    tm += 1.0
    eng.step(now=tm)
    log.append(newest(eng))
    tm += 1.0
    eng.step(now=tm)
    assert r2.state != "queued"
    tm += 1.0
    steps = 0
    while any(r.state not in pkg.serving.TERMINAL_STATES for r in (r1, r2)):
        eng.step(now=tm)
        tm += 1.0
        steps += 1
        assert steps < 100
    eng.run()
    eng._pool.check()
    eng_b = mk()
    rb1 = eng_b.submit(ids1, max_new_tokens=24, arrival_time=0.0)
    for _ in range(6):
        eng_b.step(now=0.0)
    assert eng_b._step_dt == 0.0
    log.append(newest(eng_b))
    eng_b.submit(ids2, max_new_tokens=3, arrival_time=2.0)
    eng_b.step(now=0.0)
    log.append(newest(eng_b))
    assert list(rb1.tokens) == list(r1.tokens)[:len(rb1.tokens)]
    return log, ids1, list(r1.tokens), _strip(eng.flight_recorder.events())


def test_arrival_aware_fused_window_shrink(pkgs):
    """A queued future arrival shrinks the fused window to close at the
    arrival step on a monotonic ``step(now=)`` clock (S=3, then 2, then
    an unfused 1) and blocks fusing outright on a constant clock; the
    window sizes and flight records are the JAX engine's, and the
    tokens its greedy ones."""
    t, j = pkgs["port"], pkgs["jax"]
    tlog, ids1, ttoks, tev = _fused_windows(t)
    jlog, _i, jtoks, jev = _fused_windows(j)
    assert tlog == jlog
    assert tlog[0] == 3 and tlog[1] == 2 and tlog[2] in (None, 1)
    assert tlog[3] == 3 and tlog[4] in (None, 1)
    assert tev == jev
    gen = t.net.generate(ids1[None], max_new_tokens=24, max_cache_len=40,
                         compute_dtype="float32")
    assert ttoks == np.asarray(gen)[0].tolist()
    _hold(j.net, [ids1], [ttoks], [jtoks])
