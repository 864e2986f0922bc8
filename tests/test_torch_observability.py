"""The port's observability layer (``paddle_tpu_torch.observability``)
held against the JAX package's: the same operation sequence on a
reference ``MetricsRegistry`` and the port's gives equal snapshots, JSON,
Prometheus text and ``diff_snapshots``; span names round-trip hostile
values exactly as the reference encodes them; the disabled registry,
recorder and spans are no-ops; the time-series ring overflows alike;
and the port's engine, driven under ``torch.profiler.profile()`` on the
CPU, records ``serving.decode_block`` and ``serving.prefill`` ranges
whose attrs parse back to the dispatches they timed, which
``merge_chrome_traces`` stitches beside the host tracer's spans.

No wall-clock assertion runs here: the enabled-against-disabled
overhead is measured on the card (``chip_smoke.py``, phase 3g)."""

import itertools
import json
import time

import numpy as np
import pytest
import torch

from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import spans as jspans
from paddle_tpu.observability import timeseries as jtimeseries
from paddle_tpu_torch import runtime as trt
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config
from paddle_tpu_torch.observability import FlightRecorder, MetricsRegistry
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import spans as tspans
from paddle_tpu_torch.observability import timeseries as ttimeseries

HOSTILE = ["%", ";", "=", "%3B", "%3D", "%25", "a=b;c=d", "100%;done=1",
           ";;==%%", "k=v", "%3D%3B", "trailing;", "=lead", "%%25",
           "a%3Bb;c", "a,b=c", "line\nbreak", 'quo"te', "back\\slash"]


# ---------------------------------------------------------------------------
# the registry: one operation sequence through both packages
# ---------------------------------------------------------------------------

def _seq_basic(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("t.tokens", "tokens emitted")
    g = reg.gauge("t.depth", "queue depth")
    h = reg.histogram("t.lat", "latency", buckets=(0.1, 1.0))
    c.inc(12)
    c.inc(0.5)
    g.set(4)
    g.add(-1)
    g.set(2)
    for v in (0.05, 0.1, 0.5, 7.0, 1.0):
        h.observe(v)
    return reg


def _seq_labels(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("t.route", "route", labels=("decision", "reason"))
    c.inc(3, decision="xla", reason="vmem_budget")
    c.inc(decision="pallas", reason="ok")
    e = reg.counter("t.err", labels=("kind",))
    for v in HOSTILE:
        e.inc(kind=v)
    g = reg.gauge("t.host_blocks", labels=("reason",))
    g.set(5, reason="preempt")
    g.set(1, reason="preempt")
    g.set(0, reason="cache")
    h = reg.histogram("t.trial", labels=("kernel",), buckets=(0.1, 1.0))
    h.observe(0.5, kernel="rms_norm")
    h.observe(0.05, kernel="paged,decode")
    return reg


def _seq_edges(mod):
    reg = mod.MetricsRegistry()
    reg.histogram("t.empty", buckets=(1.0,))         # never observed
    one = reg.histogram("t.one", buckets=(0.25,))
    for v in (0.0, 0.25, 0.3, 1e9):
        one.observe(v)
    reg.counter("t.zero")                              # registered only
    d = reg.histogram("t.default")                     # DEFAULT_BUCKETS
    for i in range(40):
        d.observe(i * 0.003)
    reg.gauge("t.neg").set(-3.5)
    return reg


def _seq_disabled(mod):
    reg = mod.MetricsRegistry(enabled=False)
    c = reg.counter("t.c")
    g = reg.gauge("t.g", labels=("x",))
    h = reg.histogram("t.h", buckets=(0.5,))
    c.inc(5)
    g.set(9, x="a")
    h.observe(1.0)
    reg.enable()
    c.inc(2)
    h.observe(0.25)
    reg.disable()
    c.inc(100)
    return reg


SEQS = {"basic": _seq_basic, "labels": _seq_labels, "edges": _seq_edges,
        "disabled": _seq_disabled}


@pytest.mark.parametrize("name", sorted(SEQS))
def test_registry_exports_equal_reference(name):
    """Snapshot, JSON and Prometheus text byte-equal to the JAX
    package's for the same sequence of operations."""
    j, t = SEQS[name](jmetrics), SEQS[name](tmetrics)
    assert t.snapshot() == j.snapshot()
    assert t.to_json(indent=1) == j.to_json(indent=1)
    assert t.to_prometheus_text() == j.to_prometheus_text()
    assert t.names() == j.names()


def test_diff_snapshots_equal_reference():
    """``diff_snapshots`` over the same windows (moved and unmoved
    cells, a fresh registry after a reset) equals the reference's."""
    outs = []
    for mod in (jmetrics, tmetrics):
        reg = _seq_labels(mod)
        b0 = reg.snapshot()
        reg.counter("t.route", labels=("decision", "reason")).inc(
            2, decision="xla", reason="other")
        reg.gauge("t.host_blocks", labels=("reason",)).set(
            7, reason="cache")
        reg.histogram("t.trial", labels=("kernel",),
                      buckets=(0.1, 1.0)).observe(0.7, kernel="rms_norm")
        b1 = reg.snapshot()
        fresh = _seq_basic(mod).snapshot()
        outs.append((mod.diff_snapshots(b0, b1),
                     mod.diff_snapshots(b1, b1),
                     mod.diff_snapshots(b1, fresh),
                     mod.diff_snapshots({}, b0)))
    assert outs[0] == outs[1]
    assert outs[1][1] == {}


def test_registration_rules_as_reference():
    """The same registrations are refused with the same messages."""
    def attempts(mod):
        reg = mod.MetricsRegistry()
        reg.counter("t.route", labels=("a",))
        reg.histogram("t.lat", buckets=(0.1, 1.0))
        msgs = []
        for fn in (lambda: reg.counter("t.route", labels=("b",)),
                   lambda: reg.gauge("t.route"),
                   lambda: reg.counter("Bad-Name"),
                   lambda: reg.histogram("t.lat", buckets=(0.5,)),
                   lambda: reg.counter("t.x").inc(-1),
                   lambda: reg.get("t.route").inc(b=1)):
            with pytest.raises(ValueError) as ei:
                fn()
            msgs.append(str(ei.value))
        assert reg.counter("t.route", labels=("a",)) is reg.get("t.route")
        return msgs
    assert attempts(tmetrics) == attempts(jmetrics)


def test_default_registry_is_process_wide():
    assert tmetrics.get_registry() is tmetrics.get_registry()
    assert isinstance(tmetrics.get_registry(), MetricsRegistry)
    assert tmetrics.get_registry() is not jmetrics.get_registry()


# ---------------------------------------------------------------------------
# spans and the host tracer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", HOSTILE)
def test_span_names_roundtrip_hostile_values_as_reference(value):
    attrs = {"v": value, "w": f"x{value}y{value}", "n": 3}
    enc = tspans.format_span_name("t.span", attrs)
    assert enc == jspans.format_span_name("t.span", attrs)
    assert tspans.parse_span_name(enc) == jspans.parse_span_name(enc)
    name, got = tspans.parse_span_name(enc)
    assert name == "t.span"
    assert got == {k: str(v) for k, v in attrs.items()}


def test_spans_record_on_the_host_tracer_and_merge(tmp_path):
    """Spans and instants land on the host tracer only while it is
    enabled; ``merge_chrome_traces`` decodes their attrs into Perfetto
    args beside a torch profiler export (file or directory form), with
    the reference's summary keys."""
    trt.HostTracer.clear()
    with tspans.span("t.off", a=1):
        tspans.instant("t.off_instant", b=2)
    assert trt.HostTracer.events() == []
    trt.HostTracer.enable()
    try:
        with tspans.span("t.outer", request=3, url="a=1;b=2"):
            with tspans.span("t.inner", k="v"):
                pass
            tspans.instant("t.mark", slot=1)
        tspans.bump_trace_generation()
        host = trt.HostTracer.events()
    finally:
        trt.HostTracer.disable()
        trt.HostTracer.clear()
    assert [e[0] for e in host] == [0, 1, 0]       # inner, mark, outer
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tspans.span("t.ranged", steps=2, active=5):
            torch.ones(4).add_(1)
    dev_file = str(tmp_path / "torch_trace.json")
    prof.export_chrome_trace(dev_file)
    out = str(tmp_path / "merged.json")
    info = tspans.merge_chrome_traces(out, host=host,
                                      device_trace_dir=dev_file)
    assert set(info) == {"host_events", "device_events",
                         "device_processes", "extra_events", "path"}
    assert info["host_events"] == 3 and info["device_events"] > 0
    with open(out) as f:
        evs = json.load(f)["traceEvents"]
    outer = [e for e in evs if e["name"] == "t.outer"]
    assert outer[0]["args"] == {"request": "3", "url": "a=1;b=2"}
    assert outer[0]["pid"] == 0 and outer[0]["ph"] == "X"
    ranged = [e for e in evs if e["name"] == "t.ranged"
              and e.get("cat") == "user_annotation"]
    assert len(ranged) == 1 and ranged[0]["pid"] >= 1000
    assert ranged[0]["args"]["steps"] == "2"
    assert ranged[0]["args"]["active"] == "5"
    # the directory form of a torch export reads the same events
    d = tmp_path / "dir"
    d.mkdir()
    import shutil
    shutil.copy(dev_file, str(d / "w.pt.trace.json"))
    info2 = tspans.merge_chrome_traces(str(tmp_path / "m2.json"),
                                       host=host,
                                       device_trace_dir=str(d))
    assert info2["device_events"] == info["device_events"]
    assert info2["device_processes"] == info["device_processes"]
    # host-only (and a directory without captures) is still valid JSON
    info3 = tspans.merge_chrome_traces(str(tmp_path / "m3.json"),
                                       host=host,
                                       device_trace_dir=str(tmp_path / "no"))
    assert info3["device_events"] == 0


def test_disabled_span_opens_no_profiler_range():
    """Outside a profiler the span dispatches no ``record_function``:
    a profiler started afterwards sees only its own ranges."""
    with tspans.span("t.before", a=1):
        pass
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tspans.span("t.inside", a=2):
            pass
    names = [e.name for e in prof.events()]
    assert "t.inside;a=2" in names
    assert not any(n.startswith("t.before") for n in names)


def test_disabled_recorder_is_noop_and_matches_reference_contract():
    rec = FlightRecorder(enabled=False)
    rec.emit("not_a_kind", 0, 0)            # disabled: not even validated
    rec.emit("finish", 0, 0, tokens=1)
    assert rec.events() == [] and rec.dropped == 0
    rec.enable()
    with pytest.raises(ValueError, match="unknown flight-recorder"):
        rec.emit("not_a_kind", 0, 0)
    rec.emit("finish", 0, 3, tokens=5)
    assert [(e.kind, e.step, e.attrs) for e in rec.events()] == \
        [("finish", 3, {"tokens": 5})]


# ---------------------------------------------------------------------------
# the time-series ring
# ---------------------------------------------------------------------------

def _drive_timeseries(reg_mod, ts_mod, clock):
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("t.tokens")
    g = reg.gauge("t.depth")
    h = reg.histogram("t.lat", buckets=(0.1, 1.0))
    ts = ts_mod.TimeSeriesRecorder(reg, capacity=4, clock=clock)
    g.set(100)
    for step in range(10):
        c.inc(3)
        g.set(step)
        h.observe(0.05 if step % 2 else 0.5)
        ts.sample(step)
    return ts


def test_timeseries_ring_overflow_equal_reference():
    wall_j, wall_t = itertools.count(1000), itertools.count(1000)
    tj = _drive_timeseries(jmetrics, jtimeseries,
                           lambda: float(next(wall_j)))
    tt = _drive_timeseries(tmetrics, ttimeseries,
                           lambda: float(next(wall_t)))
    assert len(tt) == 4 and tt.dropped == 6
    assert tt.steps() == tj.steps() == [6, 7, 8, 9]
    assert tt.to_dict() == tj.to_dict()
    assert tt.aggregates() == tj.aggregates()
    assert tt.rates("t.tokens") == tj.rates("t.tokens")
    # a second replay on another clock: equal modulo the wall stamps
    tt2 = _drive_timeseries(tmetrics, ttimeseries, time.perf_counter)
    assert json.dumps(tt2.to_dict(drop_wall=True), sort_keys=True) == \
        json.dumps(tt.to_dict(drop_wall=True), sort_keys=True)


# ---------------------------------------------------------------------------
# the engine under the torch profiler, on the CPU
# ---------------------------------------------------------------------------

P, C = 6, 32
SPECS = [(4, 4), (3, 3), (5, 2)]


@pytest.fixture(scope="module")
def profiled():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    net = LlamaForCausalLM(tiny_llama_config(), device="cpu", seed=3)
    reg = MetricsRegistry()
    eng = ServingEngine(net, num_slots=2, prompt_len=P, max_cache_len=C,
                        steps_per_call=1, compute_dtype="float32",
                        device="cpu", registry=reg)
    rng = np.random.default_rng(7)
    from torch.profiler import ProfilerActivity, profile
    trt.HostTracer.clear()
    trt.HostTracer.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            reqs = [eng.submit(
                rng.integers(0, 256, (n,)).astype(np.int32),
                max_new_tokens=m) for n, m in SPECS]
            eng.run()
        host = trt.HostTracer.events()
    finally:
        trt.HostTracer.disable()
        trt.HostTracer.clear()
    yield dict(eng=eng, reg=reg, reqs=reqs, prof=prof, host=host,
               stats=eng.stats())
    torch.set_num_threads(prev)


def _ranges(prof, name):
    return [tspans.parse_span_name(e.name)[1] for e in prof.events()
            if tspans.parse_span_name(e.name)[0] == name]


def test_engine_profiler_ranges_carry_attrs(profiled):
    """Under ``torch.profiler.profile()`` every decode dispatch and every
    prefill chunk is one ``record_function`` range whose parsed attrs are
    the dispatch's: one ``serving.decode_block`` per block dispatch with
    ``steps``/``active`` summing to the decode steps and busy slot-steps,
    one ``serving.prefill`` per chunk naming its request and start."""
    st, prof = profiled["stats"], profiled["prof"]
    blocks = _ranges(prof, "serving.decode_block")
    assert len(blocks) == st["block_dispatches"] > 0
    assert sum(int(a["steps"]) for a in blocks) == st["decode_steps"]
    assert sum(int(a["steps"]) * int(a["active"]) for a in blocks) \
        == st["busy_slot_steps"]
    pre = _ranges(prof, "serving.prefill")
    assert len(pre) == st["prefill_chunks"] == len(SPECS)
    assert sorted(int(a["request"]) for a in pre) == \
        [r.request_id for r in profiled["reqs"]]
    assert all(a["start"] == "0" for a in pre)


def test_engine_host_spans_recorded(profiled):
    names = [tspans.parse_span_name(e[5])[0] for e in profiled["host"]]
    for expected in ("serving.request.queued", "serving.request.admit",
                     "serving.prefill", "serving.decode_block",
                     "serving.request.finish"):
        assert expected in names, expected
    assert names.count("serving.decode_block") == \
        profiled["stats"]["block_dispatches"]


def test_engine_stats_equal_registry(profiled):
    """``stats()`` is read out of the registry: with a private registry
    the per-engine deltas are the raw instrument values, and the
    Prometheus export carries the engine's instruments."""
    s, reg = profiled["stats"], profiled["reg"]
    for key, inst in (("decode_steps", "serving.decode_steps"),
                      ("busy_slot_steps", "serving.busy_slot_steps"),
                      ("block_dispatches", "serving.block_dispatches"),
                      ("prefills", "serving.prefills"),
                      ("finished", "serving.requests_finished"),
                      ("kv_bytes_swept", "serving.kv.bytes_swept"),
                      ("weight_bytes_swept", "serving.weights.bytes_swept"),
                      ("useful_tokens", "serving.goodput.useful_tokens"),
                      ("dispatched_tokens",
                       "serving.goodput.dispatched_tokens")):
        assert s[key] == reg.get(inst).total(), key
    assert s["peak_queue"] == reg.get("serving.queue_depth").hwm()
    assert s["useful_tokens"] + s["wasted_tokens"] == \
        s["dispatched_tokens"]
    assert s["host_seconds"] == reg.get(
        "serving.step.host_seconds").summary()["sum"]
    assert s["dispatch_seconds"] == reg.get(
        "serving.step.dispatch_seconds").summary()["sum"]
    assert reg.get("serving.request_latency_seconds") \
        .summary()["count"] == len(SPECS)
    assert reg.get("serving.tpot_seconds").summary()["count"] == len(SPECS)
    assert reg.get("serving.queue_depth").value() == 0
    assert reg.get("serving.slot_occupancy").value() == 0
    text = reg.to_prometheus_text()
    assert "serving_slots_total 2" in text
    assert 'serving_kv_quant_dtype{dtype="float32"} 1' in text
    assert f"serving_prefills {len(SPECS)}" in text


def test_engine_instrument_names_and_help_equal_reference(profiled):
    """Every instrument the port's engine registers exists in the JAX
    engine's registry under the same type, labels, help and buckets."""
    import paddle_tpu as paddle
    from paddle_tpu import models as jmodels
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    paddle.seed(1)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jreg = jmetrics.MetricsRegistry()
    JaxEngine(jnet, num_slots=2, prompt_len=P, max_cache_len=C,
              compute_dtype="float32", registry=jreg)
    treg = MetricsRegistry()
    ServingEngine(LlamaForCausalLM(tiny_llama_config(), device="cpu"),
                  num_slots=2, prompt_len=P, max_cache_len=C,
                  compute_dtype="float32", device="cpu", registry=treg)
    missing = sorted(set(treg.names()) - set(jreg.names()))
    assert missing == []
    only_ref = sorted(set(jreg.names()) - set(treg.names()))
    assert all(n.startswith("serving.fairshare.") for n in only_ref), \
        only_ref
    for name in treg.names():
        t, j = treg.get(name), jreg.get(name)
        assert (type(t).__name__, t.label_names, t.help) == \
            (type(j).__name__, j.label_names, j.help), name
        if hasattr(t, "bounds"):
            assert t.bounds == j.bounds, name
