"""The port's wire transport and process replicas
(``inference/transport.py``, ``inference/procserve.py``) held against
the JAX package's on the cases of ``tests/test_transport.py``, case for
case, plus the mixed fleet: one package's router driving the other
package's replica over the loopback wire.

- The frame codec is the JAX package's byte for byte: every frame kind,
  a migration parcel's planes, and a bfloat16 plane (the port's
  ``uint16`` bits go out under the JAX package's ``"<V2"`` dtype string
  and come back as bits named ``"bfloat16"``).
- Loopback replicas schedule byte-identically to bare engines (outputs,
  routing, flight-recorder events modulo the transport tag, engine
  counters, stream flush boundaries), and as the JAX package's do.
- Two runs of one trace move identical frames, and the port's frames
  equal the JAX package's, frame for frame (header, canonical JSON
  payload and planes), on a trace whose tokens are decisive.
- Failover across the wire migrates the staged parcel token-exactly;
  ``crash_reset`` and the probe loop readmit a remote replica; the
  fleet snapshot dedupes a shared registry by its stable key.
- Mixed fleets, in both directions: a failover migrates a swap parcel
  across packages and a prefill replica of one package hands a parcel to
  a decode replica of the other; the parcel's bytes are equal on both
  sides of the wire and the tokens equal the single-package fleet's up
  to the first non-decisive position.

The real-socket kill-and-recover test stays ``slow`` as in the JAX
package (it spawns two child processes, on the CPU here)."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import faultinject as jfault
from paddle_tpu.inference import lora as jlora
from paddle_tpu.inference import procserve as jproc
from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference import serving as jserving
from paddle_tpu.inference import transport as jtransport
from paddle_tpu.inference.sampling import SamplingParams as JaxSP
from paddle_tpu.models import lora as jmlora
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability.flightrec import FlightRecorder as JaxRecorder
from paddle_tpu_torch.inference import faultinject as tfault
from paddle_tpu_torch.inference import lora as tlora
from paddle_tpu_torch.inference import procserve as tproc
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference import transport as ttransport
from paddle_tpu_torch.inference.sampling import DfaTokenMask
from paddle_tpu_torch.inference.sampling import SamplingParams as TorchSP
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama_state_from_jax)
from paddle_tpu_torch.observability import FlightRecorder, MetricsRegistry
from paddle_tpu_torch.observability.fleet import SLOBurnRateMonitor
from tools.serving_top import check as top_check
from tools.serving_top import render as top_render

P, C, BL = 32, 48, 4
FAR = 1e12
MARGIN = 0.01


class Pkg:
    def __init__(self, name, net, serving, router, fault, proc, transport,
                 registry, recorder, sp, **extra):
        self.name, self.net = name, net
        self.serving, self.router, self.fault = serving, router, fault
        self.proc, self.transport = proc, transport
        self.Registry, self.Recorder, self.SP = registry, recorder, sp
        self.extra = extra

    def mk(self, *, registry=None, recorder=None, **kw):
        # clock pinned to 0.0: first-token and finish times come off the
        # engine clock, and the identity checks compare whole stats
        return self.serving.ServingEngine(
            self.net, num_slots=2, prompt_len=P, max_cache_len=C,
            steps_per_call=1, block_len=BL, chunk_len=4, num_blocks=16,
            compute_dtype="float32", clock=lambda: 0.0,
            registry=registry if registry is not None else self.Registry(),
            flight_recorder=recorder, **kw, **self.extra)

    def Router(self, engines, **kw):
        kw.setdefault("registry", self.Registry())
        return self.router.Router(engines, **kw)

    def store(self, adapters, registry):
        lora = tlora if self.name == "port" else jlora
        s = lora.AdapterStore(self.net, slots=2, max_rank=4,
                              dtype="float32", registry=registry,
                              **self.extra)
        for ad in adapters:
            s.register(ad)
        return s

    def adapters(self):
        lora = tlora if self.name == "port" else jlora
        return [lora.LoraAdapter.random(self.net.config, f"a{j}", rank=4,
                                        seed=50 + j, scale=0.05)
                for j in range(2)]

    def wrap(self, engine, label="replica"):
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
                      jtransport, JaxRegistry, JaxRecorder, JaxSP),
           "port": Pkg("port", tnet, tserving, trouter, tfault, tproc,
                       ttransport, MetricsRegistry, FlightRecorder, TorchSP,
                       device="cpu")}
    torch.set_num_threads(prev)


def _decisive(jnet, ids, out):
    s = np.concatenate([ids, out[:-1]])[None].astype(np.int32)
    lg = np.asarray(jnet(paddle.to_tensor(s))._value)[0]
    lg = lg[len(ids) - 1:len(ids) - 1 + len(out)]
    top2 = np.sort(lg, axis=-1)[:, -2:]
    close = np.flatnonzero(top2[:, 1] - top2[:, 0] <= MARGIN)
    return int(close[0]) if close.size else len(out)


def _hold(jnet, prompts, touts, jouts, adapters=None):
    """Tokens equal the JAX tokens up to each request's first non-decisive
    position (read with the row's JAX adapter, if any, merged); at least
    half of all positions are compared."""
    compared = total = 0
    adapters = adapters or [None] * len(prompts)
    for ids, tout, jout, ad in zip(prompts, touts, jouts, adapters):
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


def _strip(events, drop=()):
    return [(e.seq, e.step, e.request, e.kind,
             tuple(sorted((k, str(v)) for k, v in e.attrs.items()
                          if k not in drop)))
            for e in events]


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def test_frame_roundtrip_every_kind():
    """Every frame kind round-trips byte-exactly, re-encoding is a
    bijection on the codec's image, and the bytes are the JAX codec's."""
    assert ttransport.FRAME_KINDS == jtransport.FRAME_KINDS
    assert ttransport.WIRE_VERSION == jtransport.WIRE_VERSION == 1
    assert ttransport._MAGIC == jtransport._MAGIC == b"PTWF"
    assert ttransport._HEADER.format == jtransport._HEADER.format
    assert ttransport._PLANE.format == jtransport._PLANE.format
    payload = {"b": 1, "a": [1, 2.5, None, "x"], "z": {"k": True}}
    for i, kind in enumerate(ttransport.FRAME_KINDS):
        buf = ttransport.encode_frame(kind, i, payload)
        assert buf == jtransport.encode_frame(kind, i, payload)
        k2, seq2, obj2, planes2, n = ttransport.decode_frame(buf)
        assert (k2, seq2, obj2, planes2, n) == (kind, i, payload, [],
                                                len(buf))
        assert ttransport.encode_frame(k2, seq2, obj2) == buf
    k2, _s, obj2, _p, _n = ttransport.decode_frame(
        ttransport.encode_frame("probe", 0))
    assert k2 == "probe" and obj2 is None


def test_frame_roundtrip_migration_parcel():
    """A migration parcel (int8 codes + f32 scales, and a float64 plane)
    rides as raw planes and comes back byte-exact, in the JAX codec's
    bytes; a bfloat16 parcel's ``uint16`` bits go out as the JAX
    package's ``ml_dtypes`` bf16 plane does, byte for byte, and come back
    as ``uint16`` bits named ``"bfloat16"``."""
    rng = np.random.default_rng(7)
    codes = rng.integers(-128, 128, (5, 2, 4, 8), np.int8)
    scales = rng.standard_normal((5, 2, 4, 1)).astype(np.float32)
    big = rng.standard_normal((3, 16)).astype(np.float64)
    meta = {"n_blocks": 5, "tok": 11, "lens": 9, "phase": "decode",
            "pf_pos": 0, "n_planes": 3}
    buf = ttransport.encode_frame("migrate_in", 3, {"parcel": meta},
                                  (codes, scales, big))
    assert buf == jtransport.encode_frame("migrate_in", 3,
                                          {"parcel": meta},
                                          (codes, scales, big))
    kind, seq, obj, planes, _n = ttransport.decode_frame(buf)
    assert kind == "migrate_in" and seq == 3 and obj == {"parcel": meta}
    for src, got in zip((codes, scales, big), planes):
        assert got.dtype == src.dtype and got.shape == src.shape
        assert got.tobytes() == src.tobytes()
    assert ttransport.encode_frame(kind, seq, obj, tuple(planes)) == buf
    rows, dtypes = ttransport.rows_from_planes(planes)
    assert dtypes == ("int8", "float32", "float64")

    import ml_dtypes
    bits = rng.integers(0, 1 << 16, (3, 4, 8), dtype=np.uint16)
    jrows = bits.view(ml_dtypes.bfloat16)
    tbuf = ttransport.encode_frame(
        "stepped", 0, {"parcels": []},
        ttransport.wire_planes([bits, scales], ("bfloat16", "float32")))
    jbuf = jtransport.encode_frame("stepped", 0, {"parcels": []},
                                   (jrows, scales))
    assert tbuf == jbuf
    _k, _s, _o, planes, _n = ttransport.decode_frame(jbuf)
    rows, dtypes = ttransport.rows_from_planes(planes)
    assert dtypes == ("bfloat16", "float32")
    assert rows[0].dtype == np.uint16 and np.array_equal(rows[0], bits)
    assert np.array_equal(rows[1], scales)
    # the bits reach a bf16 arena unchanged
    from paddle_tpu_torch.inference.prefixcache import parcel_tensor
    arena = torch.zeros((4, 4, 8), dtype=torch.bfloat16)
    t = parcel_tensor(rows[0], "bfloat16", arena)
    assert torch.equal(t.view(torch.int16),
                       torch.from_numpy(bits.view(np.int16)))


def test_frame_typed_errors():
    buf = ttransport.encode_frame("step", 9, {"now": 0.0})
    for cut in range(len(buf)):
        with pytest.raises(ttransport.FrameTruncatedError):
            ttransport.decode_frame(buf[:cut])
    pbuf = ttransport.encode_frame("stepped", 0, {"parcels": []},
                                   (np.arange(8, dtype=np.int8),))
    with pytest.raises(ttransport.FrameTruncatedError):
        ttransport.decode_frame(pbuf[:-1])
    with pytest.raises(ttransport.FrameCorruptError):
        ttransport.decode_frame(b"XXXX" + buf[4:])
    bad_kind = bytearray(buf)
    bad_kind[6] = 250
    with pytest.raises(ttransport.FrameCorruptError):
        ttransport.decode_frame(bytes(bad_kind))
    bad_ver = bytearray(buf)
    bad_ver[4:6] = (ttransport.WIRE_VERSION + 1).to_bytes(2, "big")
    with pytest.raises(ttransport.FrameVersionError):
        ttransport.decode_frame(bytes(bad_ver))
    with pytest.raises(ttransport.TransportError,
                       match="unknown frame kind"):
        ttransport.encode_frame("bogus", 0)
    # the JAX codec reads the port's frames and the port's the JAX's
    assert jtransport.decode_frame(pbuf)[:3] == \
        ttransport.decode_frame(pbuf)[:3]


def test_wire_error_and_sampling_codecs():
    e = tserving.AdmissionError("full", queue_depth=3, max_queue=3)
    wire = json.loads(json.dumps(ttransport.err_to_wire(e)))
    assert wire == jtransport.err_to_wire(
        jserving.AdmissionError("full", queue_depth=3, max_queue=3))
    with pytest.raises(tserving.AdmissionError) as ei:
        ttransport.raise_from_wire(wire)
    assert ei.value.queue_depth == 3 and ei.value.max_queue == 3
    with pytest.raises(tserving.ReplicaKilledError):
        ttransport.raise_from_wire(ttransport.err_to_wire(
            tserving.ReplicaKilledError("boom")))
    with pytest.raises(ttransport.TransportError, match="SomethingElse"):
        ttransport.raise_from_wire({"name": "SomethingElse", "msg": "?"})
    sp = TorchSP(temperature=0.7, top_k=5, top_p=0.9,
                 repetition_penalty=1.1, seed=42)
    w = ttransport.sampling_to_wire(sp)
    assert w == jtransport.sampling_to_wire(JaxSP(
        temperature=0.7, top_k=5, top_p=0.9, repetition_penalty=1.1,
        seed=42))
    sp2 = ttransport.sampling_from_wire(json.loads(json.dumps(w)))
    assert (sp2.temperature, sp2.top_k, sp2.top_p, sp2.repetition_penalty,
            sp2.seed) == (0.7, 5, 0.9, 1.1, 42)
    assert ttransport.sampling_to_wire(None) is None
    table = np.full((1, 8), -1, np.int32)
    table[0, 1] = 0
    with pytest.raises(ttransport.TransportError, match="mask_processor"):
        ttransport.sampling_to_wire(TorchSP(
            mask_processor=DfaTokenMask(table)))


# ---------------------------------------------------------------------------
# loopback byte identity
# ---------------------------------------------------------------------------

def _combined_trace(pkg, *, wrap, jouts=None):
    """The 2-replica conversation trace (3 conversations x 2 turns, c0
    streamed 'chat', c1/c2 on their own LoRA adapters, then an embed
    request) against bare or loopback-wrapped engines."""
    rng = np.random.default_rng(42)
    ads = pkg.adapters()
    regs = [pkg.Registry() for _ in range(2)]
    engs = [pkg.mk(registry=reg, adapter_store=pkg.store(ads, reg))
            for reg in regs]
    replicas = ([pkg.wrap(e, f"r{i}") for i, e in enumerate(engs)]
                if wrap else engs)
    rrec = pkg.Recorder()
    rt = pkg.Router(replicas, affinity=True, flight_recorder=rrec)
    term = pkg.serving.TERMINAL_STATES
    sys_ids = rng.integers(0, 128, (4,)).astype(np.int32)
    hist = [list(sys_ids) for _ in range(3)]
    adapters = [None, ads[0].name, ads[1].name]
    with pytest.raises(ValueError, match="not registered"):
        rt.submit(sys_ids, adapter="nope")

    def drain(handles, streams=()):
        flushes = {id(s): [] for s in streams}
        steps = 0
        while any(h.state not in term for h in handles):
            rt.step(now=0.0)
            for e in engs:
                e._pool.check()
            for s in streams:
                c = s.read()
                if c.size:
                    flushes[id(s)].append(c.tolist())
            steps += 1
            assert steps < 80
        return flushes

    assign = {ci: [] for ci in range(3)}
    outs, c0_flushes = [], []
    for turn in range(2):
        handles, streams = [], []
        for ci in range(3):
            user = rng.integers(0, 128, (3,)).astype(np.int32)
            hist[ci].extend(int(x) for x in user)
            ids = np.asarray(hist[ci], np.int32)
            if ci == 0:
                s = rt.submit(ids, max_new_tokens=4, policy="chat",
                              arrival_time=0.0)
                streams.append(s)
                h = s.request
            else:
                h = rt.submit(ids, max_new_tokens=4, adapter=adapters[ci],
                              arrival_time=0.0)
            handles.append(h)
        fl = drain(handles, streams)
        for ci, h in enumerate(handles):
            assign[ci].append(h.engine)
            out = [int(x) for x in h.output]
            outs.append((list(hist[ci]), out))
            hist[ci].extend(out if jouts is None
                            else jouts[turn * 3 + ci][1])
        c0_flushes.append(fl[id(streams[0])])
    he = rt.submit(np.asarray(hist[0][:6], np.int32), policy="embed",
                   arrival_time=0.0)
    drain([he])
    assert he.state == "finished" and he.output.size == 1
    return {
        "assign": assign, "adapters": [None, ads[0], ads[1]] * 2,
        "swapins": [r.get("serving.lora.swap_ins").value() for r in regs],
        "adapter_hits": rt.stats()["adapter_affinity_hits"],
        "routed_by_reason": rt.stats()["routed_by_reason"],
        "outs": outs, "c0_flushes": c0_flushes,
        "events": _strip(rrec.events(), drop=("transport",)),
        "n_route_events": sum(1 for e in rrec.events()
                              if e.kind == "route"),
        "engine_stats": [e.stats() for e in engs],
        "transport_attrs": sorted({str(e.attrs.get("transport"))
                                   for e in rrec.events()
                                   if e.kind == "route"}),
    }


def test_loopback_byte_identity(pkgs):
    """A router over loopback proxies schedules byte-identically to the
    bare router (same assignments, reasons, outputs, flush boundaries,
    events modulo the transport tag, full engine stats), and both equal
    the JAX package's loopback run."""
    t, j = pkgs["port"], pkgs["jax"]
    jloop = _combined_trace(j, wrap=True)
    bare = _combined_trace(t, wrap=False, jouts=jloop["outs"])
    loop = _combined_trace(t, wrap=True, jouts=jloop["outs"])
    for k in ("assign", "routed_by_reason", "outs", "c0_flushes",
              "events", "n_route_events", "engine_stats", "swapins",
              "adapter_hits"):
        assert bare[k] == loop[k], k
    assert loop["swapins"] == jloop["swapins"] == [1.0, 1.0]
    assert loop["adapter_hits"] == jloop["adapter_hits"] == 2
    assert loop["n_route_events"] == 7
    assert bare["transport_attrs"] == ["None"]
    assert loop["transport_attrs"] == ["loopback"]
    for k in ("assign", "routed_by_reason", "events", "n_route_events",
              "transport_attrs"):
        assert loop[k] == jloop[k], k
    assert [[len(f) for f in fl] for fl in loop["c0_flushes"]] == \
        [[len(f) for f in fl] for fl in jloop["c0_flushes"]]
    keys = ("prefills", "prefill_chunks", "decode_steps", "block_dispatches",
            "prefix_hits", "prefix_hit_tokens", "async_syncs",
            "async_harvests", "finished", "dispatched_tokens")
    assert [{k: s[k] for k in keys} for s in loop["engine_stats"]] == \
        [{k: s[k] for k in keys} for s in jloop["engine_stats"]]
    _hold(j.net, [p for p, _o in loop["outs"]],
          [o for _p, o in loop["outs"]], [o for _p, o in jloop["outs"]],
          jloop["adapters"])


# ---------------------------------------------------------------------------
# the RemoteReplica engine surface
# ---------------------------------------------------------------------------

def test_remote_replica_surface(pkgs):
    """The proxy's engine surface against the same engine bare:
    handshake geometry, greedy and seeded-sampled submit (with
    ``samp_base`` mirrored back), ``prefix_match``, ``load_report``,
    cancel, typed error relay, the observability shims and the transport
    counters."""
    t = pkgs["port"]
    eng = t.mk(recorder=FlightRecorder())
    rep = t.wrap(eng, "solo")
    spec = eng.engine_spec()
    assert (rep.prompt_len, rep.max_cache_len, rep.block_len,
            rep.num_blocks, rep.num_slots) == (
        spec["prompt_len"], spec["max_cache_len"], spec["block_len"],
        spec["num_blocks"], spec["num_slots"])
    assert rep.kv_cache_dtype == spec["kv_cache_dtype"]
    assert rep._kv_row_bytes == spec["kv_row_bytes"]
    assert rep.cfg.pad_token_id == spec["pad_token_id"]
    assert rep._adapters is None and rep.role == "both"
    for n, m in ((1, 1), (6, 4), (31, 17)):
        assert rep._blocks_needed(n, m) == eng._blocks_needed(n, m)
    assert rep.load_report() == eng.load_report()

    ids = np.arange(6, dtype=np.int32) + 1
    assert rep.prefix_match(ids) == eng.prefix_match(ids) == 0
    h = rep.submit(ids, max_new_tokens=5, arrival_time=0.0)
    assert h.state == "queued" and h.samp_base is None
    for _ in range(60):
        done = rep.step(now=0.0)
        if done:
            break
    assert h.state == "finished" and done == [h]
    ref = eng.submit(ids, max_new_tokens=5, arrival_time=0.0)
    eng.run()
    assert np.array_equal(h.output, ref.output)
    assert h.ttft == ref.ttft == 0.0 and h.latency == ref.latency

    sp = TorchSP(temperature=0.8, top_k=8, seed=11)
    hs = rep.submit(ids, max_new_tokens=5, arrival_time=0.0, sampling=sp)
    assert hs.samp_base is not None and hs.samp_base.dtype == np.uint32
    for _ in range(60):
        if rep.step(now=0.0):
            break
    rs = eng.submit(ids, max_new_tokens=5, arrival_time=0.0, sampling=sp)
    eng.run()
    assert np.array_equal(hs.output, rs.output)
    assert np.array_equal(hs.samp_base, np.asarray(rs.samp_base))

    hq = rep.submit(ids, max_new_tokens=5, arrival_time=FAR)
    assert rep.cancel(hq.request_id) is True
    assert rep.cancel(10_000) is False
    with pytest.raises(ValueError, match="max_new_tokens"):
        rep.submit(ids, max_new_tokens=0)
    table = np.full((1, 128), -1, np.int32)
    table[0, 1] = 0
    with pytest.raises(ttransport.TransportError, match="mask_processor"):
        rep.submit(ids, sampling=TorchSP(mask_processor=DfaTokenMask(table)))

    snap = rep.metrics_registry.snapshot()
    assert snap == eng.metrics_registry.snapshot()
    assert rep.metrics_registry.dedupe_key == rep.metrics_registry.dedupe_key
    inst = rep.metrics_registry.get("serving.queue_depth")
    assert inst is not None and inst._snap()["type"] == "gauge"
    fr = rep.flight_recorder
    assert fr["n_events"] == len(eng.flight_recorder.events())
    assert fr["events"][0]["kind"] == "submit"
    assert rep.ping() is True
    st = rep.transport_stats()
    assert st["kind"] == "loopback" and st["label"] == "solo"
    assert st["frames"]["submit"] == 4 and st["frames"]["hello"] == 1
    assert st["bytes_out"] > 0 and st["bytes_in"] > 0
    assert st["staged_parcels"] == 0
    tsnap = rep._t._m.registry.snapshot()
    assert tsnap["serving.transport.frames"]["values"]["kind=submit"] == 4.0
    assert tsnap["serving.transport.bytes_out"]["values"][""] == \
        float(st["bytes_out"])
    assert tsnap["serving.transport.rpc_seconds"]["values"][""][
        "count"] > 0


class _Recording:
    """A host wrapper that keeps every request and reply frame."""

    def __init__(self, host):
        self.host, self.frames = host, []

    def handle(self, buf):
        out = self.host.handle(buf)
        self.frames.append((buf, out))
        return out


def _frame_trace(pkg, ids):
    host = _Recording(pkg.proc.EngineHost(pkg.mk(), label="r0"))
    rep = pkg.transport.RemoteReplica(pkg.transport.LoopbackTransport(
        host, registry=pkg.Registry()))
    h = rep.submit(ids, max_new_tokens=4, arrival_time=0.0)
    for _ in range(60):
        if rep.step(now=0.0):
            break
    assert h.state == "finished"
    rep.load_report()
    return rep.transport_stats(), host.frames, h.output


def _decoded(frames, codec):
    out = []
    for req, rep in frames:
        for buf in (req, rep):
            kind, seq, obj, planes, _n = codec.decode_frame(buf)
            if kind == "welcome":
                obj = {k: v for k, v in obj.items() if k != "registry_key"}
            out.append((buf[:codec._HEADER.size] if kind != "welcome"
                        else kind, seq, json.dumps(obj, sort_keys=True),
                        [p.tobytes() for p in planes]))
    return out


def test_transport_stats_deterministic(pkgs):
    """Two identical loopback traces move identical frames (counts by
    kind and byte totals), and the port's frames are the JAX package's,
    frame for frame: header bytes, canonical JSON payload and planes
    (the welcome's process-local registry key aside).  The prompt's
    four greedy tokens are all decisive (top-2 margins >= 0.24), so the
    two packages' token deltas are the same bytes."""
    t, j = pkgs["port"], pkgs["jax"]
    ids = np.arange(7, dtype=np.int32) + 6
    a, fa, out = _frame_trace(t, ids)
    b, fb, _ = _frame_trace(t, ids)
    assert a == b
    assert [x for x, _ in fa] == [x for x, _ in fb]
    ja, jf, jout = _frame_trace(j, ids)
    assert _decisive(j.net, ids, np.asarray(jout)) == 4
    assert np.array_equal(out, jout)
    assert a["frames"] == ja["frames"]
    assert _decoded(fa, ttransport) == _decoded(jf, jtransport)
    # every frame but the welcome is the JAX frame byte for byte
    diff = [i for i, (x, y) in enumerate(zip(fa, jf)) if x != y]
    assert diff == [0]


# ---------------------------------------------------------------------------
# failover across the wire
# ---------------------------------------------------------------------------

def _loopback_failover(pkg, inject):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, (int(n),)).astype(np.int32)
               for n in rng.integers(6, 12, 4)]
    injs = [pkg.fault.FaultInjector() for _ in range(2)]
    engs = [pkg.mk(fault_injector=i) for i in injs]
    reps = [pkg.wrap(e, f"r{i}") for i, e in enumerate(engs)]
    rrec = pkg.Recorder()
    rt = pkg.Router(reps, flight_recorder=rrec)
    hs = [rt.submit(p, max_new_tokens=16, arrival_time=0.0)
          for p in prompts]
    rt.step(now=0.0)
    vblocks = staged = 0
    if inject:
        for _ in range(2):
            rt.step(now=0.0)
        vi = hs[0].engine
        injs[vi].force_swap(hs[0].request_id)
        injs[vi].fail_allocs(None)
        rt.step(now=0.0)
        assert hs[0].state == "swapped"
        staged = reps[vi].transport_stats()["staged_parcels"]
        vblocks = hs[0]._req.swap.n_blocks
        assert reps[vi]._host_tier.entry(
            hs[0]._req.swap.host_key).n_blocks == vblocks
        injs[vi].kill_at_step(engs[vi]._step_idx + 1)
    steps = 0
    while any(h.state not in pkg.serving.TERMINAL_STATES for h in hs):
        rt.step(now=0.0)
        steps += 1
        assert steps < 400
    return dict(rt=rt, reps=reps, prompts=prompts, vblocks=vblocks,
                staged=staged, states=[h.state for h in hs],
                outs=[np.asarray(h.output) for h in hs],
                events=_strip(rrec.events()),
                fails=[e for e in rrec.events() if e.kind == "fail"])


def test_loopback_failover_migration_token_exact(pkgs):
    """Force-swap ships the parcel into the proxy's local staging tier,
    the replica is killed (the typed error relays through an error
    frame), and the router migrates the staged parcel and recomputes the
    rest: token-exact against the no-fault run, migrated blocks exact,
    fail events tagged with the transport — the JAX fleet's story."""
    t, j = pkgs["port"], pkgs["jax"]
    ref = _loopback_failover(t, inject=False)
    got = _loopback_failover(t, inject=True)
    jgot = _loopback_failover(j, inject=True)
    assert got["states"] == ["finished"] * 4
    assert all(np.array_equal(a, b) for a, b in zip(ref["outs"],
                                                    got["outs"]))
    rs = got["rt"].stats()
    assert rs["replica_faults"] == 1 and got["staged"] == 1
    assert got["vblocks"] > 0 and rs["migrated_blocks"] == got["vblocks"]
    assert rs["migrated_bytes"] == \
        got["vblocks"] * BL * got["reps"][0]._kv_row_bytes
    assert all(r.transport_stats()["staged_parcels"] == 0
               for r in got["reps"])
    assert all(len(r._host_tier.keys()) == 0 for r in got["reps"])
    assert got["fails"] and all(e.attrs["transport"] == "loopback"
                                for e in got["fails"])
    jrs = jgot["rt"].stats()
    for k in ("replica_faults", "failover_requests", "migrated_blocks",
              "migrated_bytes"):
        assert rs[k] == jrs[k], k
    assert got["events"] == jgot["events"]
    _hold(j.net, got["prompts"], got["outs"], jgot["outs"])


def test_remote_crash_reset_and_probe_recovery(pkgs):
    """``crash_reset`` over the wire strips the replica and the probe
    loop readmits it after the injector's restart."""
    t = pkgs["port"]
    inj = tfault.FaultInjector()
    eng = t.mk(fault_injector=inj)
    rep = t.wrap(eng)
    rt = t.Router([rep, t.wrap(t.mk())], probe_interval=2)
    ids = np.arange(6, dtype=np.int32) + 1
    h = rt.submit(ids, max_new_tokens=4, arrival_time=0.0)
    rt.step(now=0.0)
    inj.kill_at_step(eng._step_idx + 1)
    steps = 0
    while h.state not in tserving.TERMINAL_STATES:
        rt.step(now=0.0)
        steps += 1
        assert steps < 100
    assert h.state == "finished"
    assert rt.health[0] == "unhealthy" and not rep._reqs
    assert eng.load_report()["queue_depth"] == 0
    inj.clear_replica_faults()
    for _ in range(20):
        rt.step(now=0.0)
        if rt.health[0] != "unhealthy":
            break
    assert rt.health[0] in ("probation", "healthy")


# ---------------------------------------------------------------------------
# the fleet snapshot and the SLO monitor
# ---------------------------------------------------------------------------

def test_fleet_snapshot_dedupe_and_serving_top(pkgs, tmp_path):
    """Two replicas sharing one registry merge it once, keyed by the
    stable ``dedupe_key`` (each fetch is a fresh dict); the JSON dump
    passes ``serving_top --check`` and renders; remote flight records
    stitch."""
    t = pkgs["port"]
    shared = MetricsRegistry()
    engs = [t.mk(registry=shared) for _ in range(2)]
    reps = [t.wrap(e, f"r{i}") for i, e in enumerate(engs)]
    assert reps[0].metrics_registry is not reps[1].metrics_registry
    assert reps[0].metrics_registry.dedupe_key == \
        reps[1].metrics_registry.dedupe_key
    rt = t.Router(reps)
    ids = np.arange(6, dtype=np.int32) + 1
    h = rt.submit(ids, max_new_tokens=4, arrival_time=0.0)
    steps = 0
    while h.state not in tserving.TERMINAL_STATES:
        rt.step(now=0.0)
        steps += 1
        assert steps < 60
    snap = rt.fleet_snapshot()
    sub = snap["registries"]["serving.requests_finished"]
    assert list(sub["values"]) == ["replica=0+1"]
    assert sub["values"]["replica=0+1"] == \
        shared.get("serving.requests_finished").value() == 1.0
    assert len(snap["transport"]) == 2
    assert all(x["kind"] == "loopback" for x in snap["transport"])
    assert snap["shard_groups"] == ["single", "single"]
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(snap))
    rt2 = json.loads(path.read_text())
    assert top_check(rt2) == []
    assert "transport=loopback" in top_render(rt2)
    bad = dict(rt2)
    bad["transport"] = rt2["transport"][:1]
    assert any("transport has 1 entries" in p for p in top_check(bad))
    bad2 = dict(rt2)
    bad2["transport"] = [{"frames": {}}, None]
    assert any("lacks a transport kind" in p for p in top_check(bad2))

    engs2 = [t.mk(recorder=FlightRecorder()) for _ in range(2)]
    reps2 = [t.wrap(e, f"s{i}") for i, e in enumerate(engs2)]
    rt3 = t.Router(reps2, flight_recorder=FlightRecorder())
    h2 = rt3.submit(ids, max_new_tokens=3, arrival_time=0.0)
    while h2.state not in tserving.TERMINAL_STATES:
        rt3.step(now=0.0)
    st = rt3.stitched_record()
    assert len(st) > 0 and h2.router_id in st.request_ids()
    assert "routed to engine" in st.explain(h2.router_id)


def test_slo_monitor_dedupes_by_key():
    """The monitor's tenant-budget sum dedupes shared registries by the
    stable key too."""
    reg = MetricsRegistry()
    att = reg.counter("serving.slo.attained", "t", labels=("tenant", "cls"))
    att.inc(10, tenant="t0", cls="latency")
    mon = SLOBurnRateMonitor(slo_target=0.9, window_steps=8)

    class _Shim:
        def __init__(self, reg):
            self.dedupe_key = reg.dedupe_key
            self._r = reg

        def get(self, name):
            return self._r.get(name)

    assert mon._tenant_totals([_Shim(reg), _Shim(reg)]) == {"t0": [10, 0]}
    assert mon._tenant_totals([reg, reg]) == {"t0": [10, 0]}


# ---------------------------------------------------------------------------
# process supervision
# ---------------------------------------------------------------------------

def test_engine_process_dryrun():
    """The supervisor's launch and restart surface without a process:
    commands recorded verbatim (the port's child entry point), restart
    bumps the generation, and the generation-0 fault schedule does not
    survive a respawn."""
    ep = tproc.EngineProcess(
        "r0", "paddle_tpu_torch.inference.procserve:tiny_llama_engine",
        {"seed": 7, "fault_spec": {"exit_at_step": 8}},
        ("127.0.0.1", 1), dryrun=True)
    assert ep.alive() is False and ep.address() is None
    assert ep.gen == 0 and len(ep.commands) == 1
    cmd = ep.commands[0]
    assert cmd[1] == "-c" and "paddle_tpu_torch.inference.procserve" in cmd[2]
    assert cmd[cmd.index("--label") + 1] == "r0"
    assert cmd[cmd.index("--gen") + 1] == "0"
    kw0 = json.loads(cmd[cmd.index("--kwargs") + 1])
    assert kw0 == {"seed": 7, "fault_spec": {"exit_at_step": 8}}
    ep.restart()
    assert ep.gen == 1 and len(ep.commands) == 2
    cmd1 = ep.commands[1]
    assert cmd1[cmd1.index("--gen") + 1] == "1"
    assert json.loads(cmd1[cmd1.index("--kwargs") + 1]) == {"seed": 7}
    ep.kill()


def test_tcp_store_lite():
    addr, closer = tproc.TCPStoreLite.serve()
    try:
        store = tproc.TCPStoreLite(addr)
        assert store.get("replica/r0/0") is None
        store.set("replica/r0/0", "127.0.0.1:5000")
        assert store.wait("replica/r0/0") == "127.0.0.1:5000"
        with pytest.raises(TimeoutError):
            store.wait("missing", timeout_s=0.2)
        # the JAX package's client speaks to the port's store
        assert jproc.TCPStoreLite(addr).get("replica/r0/0") == \
            "127.0.0.1:5000"
    finally:
        closer()


@pytest.mark.slow
def test_socket_kill_and_recover_token_exact():
    """Two ``EngineProcess`` children (the port's tiny engine on the CPU)
    behind ``SocketTransport`` proxies; the victim arms ``exit_at_step``
    and ``os._exit``s mid-decode, the parent sees only a dead socket and
    the failover recovers token-exactly against an in-process reference
    built from the same factory; the supervisor respawns the child."""
    rng = np.random.default_rng(29)
    prompts = [rng.integers(1, 128, (int(n),)).astype(np.int32)
               for n in rng.integers(6, 12, 4)]
    new = 8
    engs = [tproc.tiny_llama_engine(device="cpu") for _ in range(2)]
    rt0 = trouter.Router(engs, registry=MetricsRegistry())
    hs0 = [rt0.submit(p, max_new_tokens=new, arrival_time=0.0)
           for p in prompts]
    for _ in range(400):
        rt0.step(now=0.0)
        if all(h.state in tserving.TERMINAL_STATES for h in hs0):
            break
    ref = [np.asarray(h.output) for h in hs0]
    store_addr, closer = tproc.TCPStoreLite.serve()
    procs, reps = [], []
    try:
        fault = {"force_swap_rid": 0, "force_swap_step": 6,
                 "park_allocs": True, "exit_at_step": 8}
        for i in range(2):
            kw = {"device": "cpu"}
            if i == 0:
                kw["fault_spec"] = fault
            procs.append(tproc.EngineProcess(
                f"kr{i}",
                "paddle_tpu_torch.inference.procserve:tiny_llama_engine",
                kw, store_addr))
        reps = [ttransport.RemoteReplica(ttransport.SocketTransport(
            p, registry=MetricsRegistry(), rpc_timeout_s=300.0))
            for p in procs]
        rt = trouter.Router(reps, registry=MetricsRegistry())
        hs = [rt.submit(p, max_new_tokens=new, arrival_time=0.0)
              for p in prompts]
        vblocks = 0
        for _ in range(400):
            rt.step(now=0.0)
            for h in hs:
                if h.state == "swapped" and h._req.swap is not None:
                    vblocks = h._req.swap.n_blocks
            if all(h.state in tserving.TERMINAL_STATES for h in hs):
                break
        assert all(h.state == "finished" for h in hs)
        outs = [np.asarray(h.output) for h in hs]
        assert all(np.array_equal(a, b) for a, b in zip(ref, outs))
        rs = rt.stats()
        assert rs["replica_faults"] == 1
        assert vblocks > 0 and rs["migrated_blocks"] == vblocks
        assert procs[0].gen == 1
        assert issubclass(ttransport.TransportDeadError,
                          tserving.ReplicaKilledError)
    finally:
        for r in reps:
            r._t.close()
        for p in procs:
            p.kill()
        closer()


# ---------------------------------------------------------------------------
# mixed fleets: one package's router over the other package's replica
# ---------------------------------------------------------------------------

def _received(engine):
    """Wrap ``engine.migrate_in`` to keep a copy of the bytes of every
    parcel the engine is handed."""
    seen = []
    orig_in = engine.migrate_in

    def migrate_in(*a, **kw):
        if kw.get("parcel") is not None:
            ent = engine._host_tier.entry(kw["parcel"]["key"])
            seen.append([np.array(r, copy=True).view(np.uint8)
                         for r in ent.rows])
        return orig_in(*a, **kw)
    engine.migrate_in = migrate_in
    return seen


def _mixed(pkgs, router_side, scenario):
    """One mixed fleet: ``router_side``'s router over one engine of its
    own package and one replica of the other package behind that
    package's ``EngineHost`` and the router package's proxy.  Scenario
    ``"failover"``: the remote replica holds a force-swapped request and
    is killed, so its staged parcel migrates onto the local engine;
    ``"disagg"``: the local engine prefills and the remote one decodes.
    Returns the outputs, the parcels each side saw and the stats."""
    own, other = pkgs[router_side], pkgs["port" if router_side == "jax"
                                         else "jax"]
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 128, (int(n),)).astype(np.int32)
               for n in (9, 7, 11)]
    if scenario == "failover":
        inj = other.fault.FaultInjector()
        local = own.mk()
        remote_eng = other.mk(fault_injector=inj)
    else:
        local = own.mk(role="prefill")
        remote_eng = other.mk(role="decode")
    host = other.proc.EngineHost(remote_eng, label="x")
    rep = own.transport.RemoteReplica(own.transport.LoopbackTransport(
        host, registry=own.Registry()))
    local_in = _received(local)
    remote_in = _received(remote_eng)
    staged = []
    put = rep._host_tier.put

    def staging_put(rows, n, reason, *a):
        staged.append([np.array(r, copy=True).view(np.uint8) for r in rows])
        return put(rows, n, reason, *a)
    rep._host_tier.put = staging_put
    rt = own.Router([local, rep], affinity=False)
    hs = [rt.submit(p, max_new_tokens=10, arrival_time=0.0)
          for p in prompts]
    parcel = None
    if scenario == "failover":
        for _ in range(40):
            rt.step(now=0.0)
            victim = next((h for h in hs if h.engine == 1
                           and h.state == "decode"), None)
            if victim is not None and len(victim.tokens) >= 2:
                break
        assert victim is not None
        inj.force_swap(victim.request_id)
        inj.fail_allocs(None)
        rt.step(now=0.0)
        assert victim.state == "swapped"
        parcel = list(staged)
        inj.kill_at_step(remote_eng._step_idx + 1)
    steps = 0
    while any(h.state not in own.serving.TERMINAL_STATES for h in hs):
        rt.step(now=0.0)
        steps += 1
        assert steps < 300, [h.state for h in hs]
    return dict(prompts=prompts, outs=[np.asarray(h.output) for h in hs],
                states=[h.state for h in hs], staged=staged, parcel=parcel,
                local_in=local_in, remote_in=remote_in,
                stats=rt.stats(), local=local, remote=remote_eng)


def _single_package(pkg, prompts, roles):
    engs = [pkg.mk(**({"role": r} if r else {})) for r in roles]
    rt = pkg.Router(engs, affinity=False)
    hs = [rt.submit(p, max_new_tokens=10, arrival_time=0.0)
          for p in prompts]
    steps = 0
    while any(h.state not in pkg.serving.TERMINAL_STATES for h in hs):
        rt.step(now=0.0)
        steps += 1
        assert steps < 300
    return [np.asarray(h.output) for h in hs]


@pytest.mark.parametrize("router_side", ["jax", "port"])
def test_mixed_fleet_failover_migrates_across_packages(pkgs, router_side):
    """A failover migrates a swap parcel across packages: the remote
    replica (the other package) ships its parcel in a ``stepped`` reply,
    the proxy stages it, the router moves it onto the local engine (the
    router's package), and the bytes the local engine resumes from are
    the bytes the remote engine gathered.  Every request finishes with
    the single-package fleet's tokens up to the first non-decisive
    position."""
    got = _mixed(pkgs, router_side, "failover")
    assert got["states"] == ["finished"] * 3
    assert got["stats"]["replica_faults"] == 1
    assert got["stats"]["migrated_blocks"] > 0
    assert len(got["parcel"]) == 1 and len(got["local_in"]) == 1
    for a, b in zip(got["parcel"][0], got["local_in"][0]):
        np.testing.assert_array_equal(a, b)
    ref = _single_package(pkgs["jax"], got["prompts"], [None, None])
    _hold(pkgs["jax"].net, got["prompts"], got["outs"], ref)


@pytest.mark.parametrize("router_side", ["jax", "port"])
def test_mixed_fleet_handoff_across_packages(pkgs, router_side):
    """A prefill replica of the router's package hands every request's
    parcel to a decode replica of the other package over the wire: the
    bytes the remote engine resumes from are the bytes the local engine
    gathered (``migrate_in`` planes), and the tokens are the single-
    package fleet's up to the first non-decisive position."""
    got = _mixed(pkgs, router_side, "disagg")
    assert got["states"] == ["finished"] * 3
    assert got["local"].stats()["handoffs"] == 3
    assert got["remote"].stats()["prefills"] == 0
    assert len(got["remote_in"]) == len(got["staged"]) == 3
    for a, b in zip(got["staged"], got["remote_in"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    ref = _single_package(pkgs["jax"], got["prompts"],
                          ["prefill", "decode"])
    _hold(pkgs["jax"].net, got["prompts"], got["outs"], ref)
