"""The port's fleet observability plane (``observability/fleet.py``,
``Router.fleet_snapshot()``, the time-series recorder under the router)
held against the JAX package's on the cases of
``tests/test_fleet_obs.py``, case for case.

One 2-replica kill/failover trace (force-swap one request, kill its
replica, migrate at exact bytes) runs twice through the port and once
through the JAX package, with the whole fleet plane attached.  The port
replays byte-identically; its stitched record, fleet explanation,
alerts, time series and merged registry snapshot (counters and gauges
cell for cell, histograms by count) equal the JAX package's; the JAX
package's ``serving_top`` and ``explain_request`` tools read the port's
snapshot and exported records.  The trace's two SLO rows carry the
JAX trace's tenants, ``chat`` and ``batch``, in both packages; the
merged snapshot holds every fair-share instrument the JAX fleet's
does."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import faultinject as jfault
from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference import serving as jserving
from paddle_tpu.observability import fleet as jfleet
from paddle_tpu.observability import flightrec as jflightrec
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import timeseries as jtimeseries
from paddle_tpu_torch.inference import faultinject as tfault
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama_state_from_jax)
from paddle_tpu_torch.observability import fleet as tfleet
from paddle_tpu_torch.observability import flightrec as tflightrec
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import timeseries as ttimeseries
from paddle_tpu_torch.observability.fleet import (
    ALERT_KINDS, ROUTER_LANE, SLOBurnRateMonitor, merge_registry_snapshots,
    orphan_id, stitch_flight_records)
from paddle_tpu_torch.observability.flightrec import (ENGINE_EVENT,
                                                      FlightRecorder)
from paddle_tpu_torch.observability.metrics import MetricsRegistry

P, C, BL = 32, 48, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pkg:
    def __init__(self, net, serving, router, fault, fleet, flightrec,
                 metrics, timeseries, **extra):
        self.net, self.serving, self.router = net, serving, router
        self.fault, self.fleet, self.flightrec = fault, fleet, flightrec
        self.metrics, self.timeseries, self.extra = metrics, timeseries, extra

    def mk(self, *, registry, recorder, injector):
        return self.serving.ServingEngine(
            self.net, num_slots=2, prompt_len=P, max_cache_len=C,
            steps_per_call=1, block_len=BL, chunk_len=4, num_blocks=16,
            compute_dtype="float32", registry=registry,
            flight_recorder=recorder, fault_injector=injector, **self.extra)


def _run_trace(pkg):
    rng = np.random.default_rng(77)
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32)
               for n in (10, 7, 8)]
    news = [6, 5, 4]
    regs = [pkg.metrics.MetricsRegistry() for _ in range(2)]
    recs = [pkg.flightrec.FlightRecorder() for _ in range(2)]
    injs = [pkg.fault.FaultInjector() for _ in range(2)]
    engs = [pkg.mk(registry=regs[i], recorder=recs[i], injector=injs[i])
            for i in range(2)]
    rrec = pkg.flightrec.FlightRecorder()
    rreg = pkg.metrics.MetricsRegistry()
    mon = pkg.fleet.SLOBurnRateMonitor(slo_target=0.9, window_steps=8)
    ts = pkg.timeseries.TimeSeriesRecorder(rreg, capacity=8)
    rt = pkg.router.Router(engs, affinity=True, registry=rreg,
                           flight_recorder=rrec, monitor=mon, timeseries=ts)
    hs = [rt.submit(prompts[0], max_new_tokens=news[0], arrival_time=0.0,
                    deadline_s=1e9, tenant="chat"),
          rt.submit(prompts[1], max_new_tokens=news[1], arrival_time=0.0,
                    deadline_s=1e9, tenant="batch"),
          rt.submit(prompts[2], max_new_tokens=news[2], arrival_time=0.0)]
    rt.step(now=0.0)
    assert all(h.engine is not None for h in hs)
    vi = hs[0].engine
    victim, vinj = engs[vi], injs[vi]
    for _ in range(4):
        rt.step(now=0.0)
    assert hs[0].state == "decode"
    vinj.force_swap(hs[0].request_id)
    vinj.fail_allocs(None)
    rt.step(now=0.0)
    assert hs[0].state == "swapped"
    vblocks = hs[0]._req.swap.n_blocks
    assert vblocks > 0
    vinj.kill_at_step(victim._step_idx + 1)
    rt.step(now=0.0)
    kill_step = rt._step_idx
    assert rt.health[vi] == "unhealthy"
    steps = 0
    while any(h.state not in pkg.serving.TERMINAL_STATES for h in hs):
        rt.step(now=0.0)
        for e in engs:
            e._pool.check()
        steps += 1
        assert steps < 120
    assert all(h.state == "finished" for h in hs)
    stats = rt.stats()
    snap = rt.fleet_snapshot()
    return {"rt": rt, "engs": engs, "regs": regs, "recs": recs,
            "rrec": rrec, "mon": mon, "ts": ts, "hs": hs, "vi": vi,
            "vblocks": vblocks, "kill_step": kill_step, "stats": stats,
            "snap": snap, "stitched": rt.stitched_record(),
            "outputs": [np.asarray(h.output) for h in hs]}


@pytest.fixture(scope="module")
def trace():
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
    port = Pkg(tnet, tserving, trouter, tfault, tfleet, tflightrec,
               tmetrics, ttimeseries, device="cpu")
    jax = Pkg(jnet, jserving, jrouter, jfault, jfleet, jflightrec,
              jmetrics, jtimeseries)
    out = (_run_trace(port), _run_trace(port), _run_trace(jax))
    torch.set_num_threads(prev)
    return out


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stitched_record_replay_deterministic(trace):
    """Two port runs stitch byte-identically modulo wall, equal to the
    JAX package's stitched record, losing no events, in (step, lane,
    seq) order."""
    t1, t2, j = trace
    d1 = t1["stitched"].to_dict(drop_wall=True)
    d2 = t2["stitched"].to_dict(drop_wall=True)
    dj = j["stitched"].to_dict(drop_wall=True)
    assert json.dumps(d1, sort_keys=True) == json.dumps(d2, sort_keys=True)
    assert json.dumps(d1, sort_keys=True) == json.dumps(dj, sort_keys=True)
    for a, b in zip(t1["outputs"], t2["outputs"]):
        assert np.array_equal(a, b)
    st = t1["stitched"]
    expected = len(t1["rrec"].events()) + sum(
        len(r.events()) for r in t1["recs"])
    assert len(st) == expected == d1["n_events"]
    assert st.replicas == 2 and st.dropped_total == 0

    def key(e):
        return (e.step, -1 if e.replica == ROUTER_LANE else e.replica,
                e.seq)
    assert [key(e) for e in st.events] == sorted(key(e) for e in st.events)


def test_stitched_ids_and_orphans(trace):
    t1, _t2, j = trace
    st = t1["stitched"]
    gids = st.request_ids()
    assert gids == sorted(h.router_id for h in t1["hs"])
    assert gids == j["stitched"].request_ids()
    orphans = {e.request for e in st.events if e.request <= -1000}
    assert orphans
    for e in st.events:
        if e.replica == ROUTER_LANE:
            continue
        assert e.request in gids or e.request == ENGINE_EVENT \
            or e.request in orphans
    lanes = {e.replica for e in st.timeline(t1["hs"][0].router_id)}
    assert {t1["vi"], 1 - t1["vi"], ROUTER_LANE} <= lanes


def test_fleet_explain_narrates_the_hop(trace):
    t1, t2, j = trace
    vi, vblocks = t1["vi"], t1["vblocks"]
    text = t1["stitched"].explain(t1["hs"][0].router_id)
    assert f"replica {vi} killed at step {t1['kill_step']}" in text
    assert f"migrated {vblocks} blocks to engine {1 - vi} " \
           f"at exact bytes" in text
    assert f"on engine {1 - vi}" in text and "finished at step" in text
    assert text == t2["stitched"].explain(t2["hs"][0].router_id)
    assert text == j["stitched"].explain(j["hs"][0].router_id)
    assert "no events in the stitched record" in \
        t1["stitched"].explain(99999)


def test_alert_fired_exactly_once_at_kill_step(trace):
    t1, t2, j = trace
    for t in (t1, t2):
        alerts = t["mon"].alerts()
        assert alerts == [{"kind": "replica_unhealthy",
                           "step": t["kill_step"], "engine": t["vi"]}]
        reg = t["rt"]._m.registry
        assert reg.get("serving.alerts").value(
            kind="replica_unhealthy") == 1
        evs = [e for e in t["rrec"].events() if e.kind == "alert"]
        assert len(evs) == 1 and evs[0].request == ENGINE_EVENT
        assert evs[0].step == t["kill_step"]
        assert evs[0].attrs == {"kind": "replica_unhealthy",
                                "engine": t["vi"]}
        sevs = [e for e in t["stitched"].events if e.kind == "alert"]
        assert len(sevs) == 1 and sevs[0].replica == ROUTER_LANE
    assert t1["kill_step"] == t2["kill_step"] == j["kill_step"]
    assert t1["mon"].alerts() == j["mon"].alerts()
    assert t1["mon"].burn_rates() == j["mon"].burn_rates() == \
        {"batch": 0.0, "chat": 0.0}
    b = t1["mon"].budgets()
    assert b == j["mon"].budgets()
    assert b["chat"]["missed"] == 0 and b["chat"]["consumed"] == 0.0


def _no_hist(snap):
    """A merged snapshot with histogram cells reduced to their counts
    (their sums are wall seconds)."""
    out = {}
    for name, inst in snap.items():
        if inst["type"] == "histogram":
            inst = dict(inst, values={k: v["count"] for k, v in
                                      inst["values"].items()})
        out[name] = inst
    return out


def test_fleet_snapshot_reconciles_against_replicas(trace):
    t1, _t2, j = trace
    snap, rt = t1["snap"], t1["rt"]
    assert snap["engines"] == 2
    assert snap["health"] == t1["stats"]["health"]
    merged = snap["registries"]
    for i, reg in enumerate(t1["regs"]):
        for name, inst in reg.snapshot().items():
            assert merged[name]["type"] == inst["type"], name
            assert merged[name]["labels"][0] == "replica"
            for lk, v in inst["values"].items():
                key = f"replica={i}" + ("," + lk if lk else "")
                assert merged[name]["values"][key] == v, (name, key)
    for k, v in t1["stats"].items():
        if k != "fleet":
            assert snap["router"][k] == v, k
    assert snap["router"]["migrated_blocks"] == t1["vblocks"]
    assert [r["slots_total"] for r in snap["load_reports"]] == [2, 2]
    assert snap["monitor"]["alerts_by_kind"] == {"replica_unhealthy": 1}
    assert rt._m.registry.get("serving.fleet.snapshots").total() >= 1
    # the JAX fleet's snapshot, cell for cell (histograms by count)
    jsnap = j["snap"]
    jm = _no_hist(jsnap["registries"])
    tm = _no_hist(merged)
    assert set(tm) == set(jm)
    assert any(k.startswith("serving.fairshare.") for k in tm)
    assert tm == jm
    for k in ("engines", "health", "roles", "shard_groups", "step",
              "load_reports", "router", "monitor"):
        assert snap[k] == jsnap[k], k


def test_timeseries_sampled_per_router_step(trace):
    t1, t2, j = trace
    ts = t1["ts"]
    assert len(ts) == ts.capacity == 8
    assert ts.dropped == t1["rt"]._step_idx - 8 > 0
    assert ts.steps() == list(range(t1["rt"]._step_idx - 7,
                                    t1["rt"]._step_idx + 1))
    d = json.dumps(ts.to_dict(drop_wall=True), sort_keys=True)
    assert d == json.dumps(t2["ts"].to_dict(drop_wall=True), sort_keys=True)
    assert d == json.dumps(j["ts"].to_dict(drop_wall=True), sort_keys=True)
    agg = ts.aggregates()
    assert agg["samples"] == 8 and agg["dropped"] == ts.dropped
    g = agg["instruments"]["serving.router.healthy_engines"]
    assert g["type"] == "gauge" and g["last"][""] == 1.0
    assert json.dumps(agg, sort_keys=True) == \
        json.dumps(t1["snap"]["timeseries"], sort_keys=True)


def test_perfetto_export_one_lane_per_replica(trace, tmp_path):
    t1, _t2, _j = trace
    st = t1["stitched"]
    out = str(tmp_path / "fleet.json")
    info = st.export_chrome_trace(out)
    assert info["extra_events"] == len(st)
    with open(out) as f:
        doc = json.load(f)
    evs = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    assert len(evs) == len(st)
    assert {e["pid"] for e in evs} == {0, 1, 2}
    names = {(m["pid"], m["args"]["name"]) for m in doc["traceEvents"]
             if m.get("ph") == "M" and m["name"] == "process_name"}
    assert {(0, "replica 0"), (1, "replica 1"), (2, "router")} <= names
    r0 = t1["hs"][0].router_id
    assert {e["pid"] for e in evs if e["tid"] == r0} == {0, 1, 2}


def test_serving_top_renders_and_checks(trace, tmp_path):
    """The JAX package's dashboard renders and checks the port's
    snapshot, and renders it as it renders the JAX fleet's."""
    t1, _t2, j = trace
    snap = t1["snap"]
    top = _load_tool("serving_top")
    text = top.render(snap)
    assert text == top.render(snap)
    assert "2 replicas" in text and "replica_unhealthy=1" in text
    assert f"migrated_blocks={t1['vblocks']}" in text
    assert "burn=" in text and "tenant chat" in text
    assert top.check(snap) == []
    path = str(tmp_path / "snap.json")
    with open(path, "w") as f:
        json.dump(snap, f)
    assert top.main([path, "--check"]) == 0
    assert top.main([path]) == 0
    bad = dict(snap, health=["healthy"])
    assert any("health" in p for p in top.check(bad))
    assert top.main([str(tmp_path / "missing.json"), "--check"]) == 1
    # line for line the JAX fleet's dashboard, the instrument census
    # included (the port registers the fair-share instruments too)
    assert text == top.render(j["snap"])


def test_explain_request_cli_stitches(trace, tmp_path, capsys):
    t1, _t2, _j = trace
    paths = []
    for i, rec in enumerate(t1["recs"]):
        p = str(tmp_path / f"rep{i}.json")
        rec.export(p)
        paths.append(p)
    rpath = str(tmp_path / "router.json")
    t1["rrec"].export(rpath)
    cli = _load_tool("explain_request")
    r0 = t1["hs"][0].router_id
    assert cli.main(paths + [str(r0), "--router", rpath]) == 0
    out = capsys.readouterr().out
    assert f"migrated {t1['vblocks']} blocks" in out
    assert cli.main(paths + [str(r0), "--router", rpath, "--timeline"]) == 0
    out = capsys.readouterr().out
    assert "[on replica 0]" in out and "[on replica 1]" in out \
        and "[on router]" in out
    assert cli.main(paths + ["--router", rpath]) == 0
    assert cli.main(paths + ["424242", "--router", rpath]) == 1
    assert cli.main([paths[0]]) == 0


def _stitcher_cases(fleet, recorder):
    router, r0 = recorder(), recorder()
    router.emit("route", 10, 1, engine=0, rid=3, reason="load")
    router.emit("route", 11, 5, engine=0, rid=3, reason="load")
    r0.emit("submit", 3, 1)
    r0.emit("finish", 3, 2, tokens=1)
    r0.emit("submit", 3, 5)
    r0.emit("finish", 3, 6, tokens=2)
    r0.emit("submit", 8, 7)
    st = fleet.stitch_flight_records([r0], router=router)
    alone = fleet.stitch_flight_records([r0])
    tiny = recorder(capacity=2)
    tiny.emit("submit", 1, 1)
    tiny.emit("admit", 1, 1, slot=0)
    tiny.emit("finish", 1, 2, tokens=1)
    st2 = fleet.stitch_flight_records([tiny])
    d = {"version": 1, "dropped": 2, "events": [
        {"seq": 0, "step": 1, "request": 4, "kind": "submit",
         "wall": 0.0, "attrs": {}}]}
    st3 = fleet.stitch_flight_records([d])
    return st, alone, st2, st3


def test_stitcher_units():
    st, alone, st2, st3 = _stitcher_cases(tfleet, FlightRecorder)
    assert st.request_ids() == [10, 11]
    assert [e.request for e in st.timeline(10)] == [10, 10, 10]
    assert [e.kind for e in st.timeline(11)] == ["route", "submit", "finish"]
    probe = [e for e in st.events if e.source_request == 8]
    assert probe[0].request == orphan_id(0, 8) == -(1000 + 8)
    assert orphan_id(1, 8) != orphan_id(0, 8)
    assert alone.request_ids() == [3, 8]
    assert st2.dropped == {"0": 1} and st2.dropped_total == 1
    assert "dropped 1 event" in st2.explain(1)
    assert "dropped 1 event" in st2.explain(777)
    assert st3.dropped_total == 2 and len(st3) == 1
    # the JAX stitcher gives the same records over the same events
    for a, b in zip((st, alone, st2, st3),
                    _stitcher_cases(jfleet, jflightrec.FlightRecorder)):
        assert a.to_dict(drop_wall=True) == b.to_dict(drop_wall=True)
        for rid in a.request_ids() + [777]:
            assert a.explain(rid) == b.explain(rid)


def _monitor_cases(fleet, metrics, recorder):
    reg = metrics.MetricsRegistry()
    att = reg.counter("serving.slo.attained", "t",
                      labels=("class", "tenant"))
    mis = reg.counter("serving.slo.missed", "t", labels=("class", "tenant"))
    mreg = metrics.MetricsRegistry()
    fr = recorder()
    mon = fleet.SLOBurnRateMonitor(slo_target=0.9, window_steps=4,
                                   burn_threshold=1.0, registry=mreg,
                                   flight_recorder=fr)
    log = []
    for s in range(3):
        att.inc(**{"class": "p0", "tenant": "a"})
        mon.observe(step=s, registries=[reg])
    log.append((list(mon.alerts()), mon.burn_rates()))
    for s in range(3, 6):
        mis.inc(**{"class": "p0", "tenant": "a"})
        mon.observe(step=s, registries=[reg])
    log.append((list(mon.alerts()), mon.budgets()))
    for s in range(6, 10):
        att.inc(**{"class": "p0", "tenant": "a"})
        mon.observe(step=s, registries=[reg])
    log.append(mon.burn_rates())
    for s in range(10, 12):
        mis.inc(**{"class": "p0", "tenant": "a"})
        mon.observe(step=s, registries=[reg])
    mon.observe(step=12, registries=[reg], health=["unhealthy"],
                queue_depth=5, max_queue=4)
    mon.observe(step=13, registries=[reg], health=["unhealthy"],
                queue_depth=5, max_queue=4)
    log.append(list(mon.alerts()))
    log.append(mon._tenant_totals([reg, reg]) == mon._tenant_totals([reg]))
    log.append(len([e for e in fr.events() if e.kind == "alert"]))
    log.append(mon.summary())
    log.append(mreg.snapshot())
    return log


def test_monitor_units():
    """Latching, burn math, budget exhaustion and re-arming over
    synthetic counters; every alert, burn rate, budget, summary and the
    monitor's registry equal the JAX monitor's."""
    assert ALERT_KINDS == jfleet.ALERT_KINDS == (
        "burn_rate", "budget_exhausted", "replica_unhealthy",
        "queue_saturation")
    with pytest.raises(ValueError, match="slo_target"):
        SLOBurnRateMonitor(slo_target=1.0)
    with pytest.raises(ValueError, match="window_steps"):
        SLOBurnRateMonitor(window_steps=1)
    t = _monitor_cases(tfleet, tmetrics, FlightRecorder)
    j = _monitor_cases(jfleet, jmetrics, jflightrec.FlightRecorder)
    assert t == j
    assert t[0] == ([], {"a": 0.0})
    alerts, budgets = t[1]
    assert len([a for a in alerts if a["kind"] == "burn_rate"]) == 1
    ex = [a for a in alerts if a["kind"] == "budget_exhausted"]
    assert ex == [{"kind": "budget_exhausted", "step": 3, "tenant": "a",
                   "missed": 1, "total": 4}]
    assert budgets["a"]["consumed"] > 1.0
    assert t[2]["a"] == 0.0
    kinds = [a["kind"] for a in t[3]]
    assert kinds.count("burn_rate") == 2
    assert kinds.count("queue_saturation") == 1
    assert kinds.count("replica_unhealthy") == 1
    assert t[4] is True and t[5] == len(t[3])
    assert t[6]["alerts_by_kind"]["burn_rate"] == 2
    assert t[7]["serving.fleet.monitor_steps"]["values"][""] == 14


def test_merge_registry_snapshots_units():
    snaps = {}
    for side, metrics, fleet in (("port", tmetrics, tfleet),
                                 ("jax", jmetrics, jfleet)):
        reg0, reg1 = metrics.MetricsRegistry(), metrics.MetricsRegistry()
        for i, reg in enumerate((reg0, reg1)):
            reg.counter("m.ticks", "t", labels=("k",)).inc(10 + i, k="x")
            reg.gauge("m.depth", "t").set(3 + i)
        merged = fleet.merge_registry_snapshots([reg0.snapshot(),
                                                 reg1.snapshot()])
        m2 = fleet.merge_registry_snapshots([("0+1", reg0.snapshot())])
        snaps[side] = (merged, m2)
        regX = metrics.MetricsRegistry()
        regX.gauge("m.ticks", "t", labels=("k",))
        with pytest.raises(ValueError, match="homogeneous"):
            fleet.merge_registry_snapshots([reg0.snapshot(),
                                            regX.snapshot()])
    merged, m2 = snaps["port"]
    assert snaps["port"] == snaps["jax"]
    assert merged["m.ticks"]["labels"] == ["replica", "k"]
    assert merged["m.ticks"]["values"] == {"replica=0,k=x": 10,
                                           "replica=1,k=x": 11}
    assert merged["m.depth"]["values"] == {"replica=0": 3, "replica=1": 4}
    assert merged["m.depth"]["hwm"] == {"replica=0": 3, "replica=1": 4}
    assert m2["m.ticks"]["values"] == {"replica=0+1,k=x": 10}
    assert merge_registry_snapshots is tfleet.merge_registry_snapshots
    assert stitch_flight_records is tfleet.stitch_flight_records
    assert MetricsRegistry is tmetrics.MetricsRegistry
