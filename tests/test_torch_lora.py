"""Multi-tenant batched LoRA serving and fair-share admission of the port
(``inference/lora.py``, ``models/lora.py`` and the engine's adapter and
tenant paths) held against the JAX package on the cases of
``tests/test_lora.py``, case for case.

Both packages build their own adapters from ``LoraAdapter.random`` with
the same seeds (no numpy buffer is shared between them) over the same
tiny model (the weight bridge, float32).  The store's semantics, the
subset-target slot overwrite and the engine's guards give the same
slots, instrument values and errors as the JAX store.  The combined LoRA
trace (two concurrent adapters, a base row in the same dispatches, a
demotion and swap-in, engine-slot reuse with a changed adapter, a spec
row) runs through both engines: the port's tokens equal the JAX
engine's and its own merged-weights oracle exactly, its arena rows are
byte-equal to the JAX store's, and its ``serving.lora.*`` and
``serving.fairshare.*`` instruments, stats keys and flight records equal
the JAX engine's.  The fair-share starvation and weights traces admit in
the JAX engine's order, which is the hand-computed deficit-WRR order.
Then the int8-KV compose (``slow``, as the reference marks it) and one
engine holding int8 weights, LoRA, ``async_depth=2`` and a spec row
drafted by a ``ModelDrafter`` over the target."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import lora as jlora
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import lora as jmlora
from paddle_tpu.observability.flightrec import FlightRecorder as JaxRecorder
from paddle_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.inference import lora as tlora
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.speculative import ModelDrafter
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)
from paddle_tpu_torch.models import lora as tmlora
from paddle_tpu_torch.observability import FlightRecorder, MetricsRegistry

P, C = 6, 32


class Pkg:
    """One package's model, LoRA and serving modules, so one trace
    function serves both."""

    def __init__(self, name, net, lora, serving, registry, recorder,
                 **dev):
        self.name, self.net, self.cfg = name, net, net.config
        self.lora, self.serving = lora, serving
        self.Registry, self.Recorder, self.dev = registry, recorder, dev

    def adapter(self, name, rank, seed=0, scale=0.1, **kw):
        return self.lora.LoraAdapter.random(self.cfg, name, rank=rank,
                                            seed=seed, scale=scale, **kw)

    def store(self, **kw):
        kw.setdefault("registry", self.Registry())
        return self.lora.AdapterStore(self.net, **kw, **self.dev)

    def engine(self, **kw):
        kw.setdefault("registry", self.Registry())
        return self.serving.ServingEngine(self.net, **kw, **self.dev)


@pytest.fixture(scope="module")
def pkgs():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(2024)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    yield {"jax": Pkg("jax", jnet, jlora, jserving, JaxRegistry,
                      JaxRecorder),
           "port": Pkg("port", tnet, tlora, tserving, MetricsRegistry,
                       FlightRecorder, device="cpu")}
    torch.set_num_threads(prev)


def _pad(ids):
    padded = np.zeros((P,), np.int32)
    padded[:ids.size] = ids
    return padded


def _oracle(net, adapter, ids, seq_len, max_new):
    """The port's per-request merged-weights greedy ``generate()``: the
    'run alone with its adapter' oracle (the base model without one)."""
    t = torch.from_numpy(_pad(ids)[None, :])

    def gen():
        return np.asarray(net.generate(
            t, seq_lens=np.array([seq_len]), max_new_tokens=max_new,
            max_cache_len=C, compute_dtype="float32"))[0]

    if adapter is None:
        return gen()
    with tmlora.merged_adapter(net, adapter):
        return gen()


def _err(fn):
    try:
        fn()
    except Exception as e:       # noqa: BLE001 - the error IS the result
        return type(e).__name__, str(e)
    return None


def _strip(events):
    return [(e.seq, e.step, e.request, e.kind,
             tuple(sorted((k, str(v)) for k, v in e.attrs.items()
                          if k != "wall")))
            for e in events]


def _instruments(reg, *prefixes):
    snap = reg.snapshot()
    return {k: v for k, v in snap.items() if k.startswith(prefixes)}


def _rows(store, slots):
    """Every target's (A, B) arena rows of ``slots`` as raw bytes."""
    out = {}
    for t in tmlora.LORA_TARGETS:
        for s in slots:
            a, b = store.arena_row(t, s)
            out[(t, s)] = (np.asarray(a).tobytes(), np.asarray(b).tobytes())
    return out


# -- models/lora.py: the delta and the merge --

def test_lora_math_matches_jax(pkgs):
    """``gather_lora`` + ``lora_delta`` + ``maybe_lora`` and
    ``merged_weight_delta`` on the same numpy inputs as the JAX functions
    (float32); ``attn_lora_dims`` equal; ``merged_adapter`` adds ``(A @
    B).T`` in place and restores every weight bit for bit in the same
    storage."""
    import jax.numpy as jnp
    t = pkgs["port"]
    assert tmlora.LORA_TARGETS == jmlora.LORA_TARGETS
    assert tmlora.attn_lora_dims(t.cfg) == \
        jmlora.attn_lora_dims(pkgs["jax"].cfg)
    rng = np.random.default_rng(0)
    L, d_in, r, d_out, B, S = 2, 8, 3, 5, 3, 4
    a = rng.normal(size=(4, L, d_in, r)).astype(np.float32)
    b = rng.normal(size=(4, L, r, d_out)).astype(np.float32)
    a[-1] = 0.0
    b[-1] = 0.0
    x = rng.normal(size=(B, S, d_in)).astype(np.float32)
    ids = np.array([2, 3, 0], np.int32)          # row 1 is the null row
    jg = jmlora.gather_lora({"ids": jnp.asarray(ids),
                             "a": {"q_proj": jnp.asarray(a)},
                             "b": {"q_proj": jnp.asarray(b)}})
    tg = tmlora.gather_lora({"ids": torch.from_numpy(ids.copy()),
                             "a": {"q_proj": torch.from_numpy(a.copy())},
                             "b": {"q_proj": torch.from_numpy(b.copy())}})
    for layer in range(L):
        with jmlora.lora_context(jg):
            jd = np.asarray(jmlora.lora_delta("q_proj", layer,
                                              jnp.asarray(x)))
        with tmlora.lora_context(tg):
            td = tmlora.lora_delta("q_proj", layer,
                                   torch.from_numpy(x.copy())).numpy()
            out = torch.ones(B, S, d_out)
            assert tmlora.lora_delta("k_proj", layer, out) is None
            np.testing.assert_allclose(
                tmlora.maybe_lora(out, torch.from_numpy(x.copy()),
                                  "q_proj", layer).numpy(), 1.0 + td)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
        assert (td[1] == 0).all()                # the null row: + 0.0
    assert tmlora.lora_delta("q_proj", 0, torch.zeros(1, 1, d_in)) is None
    np.testing.assert_array_equal(
        tmlora.merged_weight_delta(a[0, 0], b[0, 0]),
        jmlora.merged_weight_delta(a[0, 0], b[0, 0]))

    net = t.net
    ad = t.adapter("m", rank=2, seed=4, scale=0.3, targets=("q_proj",
                                                            "o_proj"))
    before = {n: (p.data_ptr(), p.detach().clone())
              for n, p in net.named_parameters()}
    with tmlora.merged_adapter(net, ad):
        q = net.attn_projections()[1]["q_proj"].weight
        want = before["llama.layers.1.self_attn.q_proj.weight"][1] + \
            (torch.from_numpy(ad.weights["q_proj"][0][1])
             @ torch.from_numpy(ad.weights["q_proj"][1][1])).t()
        torch.testing.assert_close(q, want, rtol=0, atol=0)
        # the same delta as the reference's numpy merged_weight_delta, to
        # float32 rounding
        np.testing.assert_allclose(
            (q - before["llama.layers.1.self_attn.q_proj.weight"][1])
            .detach().numpy().T, jmlora.merged_weight_delta(
                ad.weights["q_proj"][0][1], ad.weights["q_proj"][1][1]),
            rtol=1e-5, atol=1e-6)
        k = net.attn_projections()[0]["k_proj"].weight
        assert torch.equal(k, before["llama.layers.0.self_attn.k_proj."
                                     "weight"][1])
    for n, p in net.named_parameters():
        assert p.data_ptr() == before[n][0], n
        assert torch.equal(p, before[n][1]), n


# -- AdapterStore units --

def _store_semantics(pkg):
    """The reference's store case, asserted, with the observable log (the
    slots, instrument values, arena bytes and errors) returned."""
    reg = pkg.Registry()
    store = pkg.store(slots=2, max_rank=4, dtype="float32", registry=reg)
    a = pkg.adapter("a", rank=3, seed=1, scale=0.2)
    b = pkg.adapter("b", rank=2, seed=2, scale=0.2)
    c = pkg.adapter("c", rank=4, seed=3, scale=0.2)
    for ad in (a, b, c):
        store.register(ad)
    store.check()
    log = {"registered": (reg.get("serving.lora.hbm_adapters").value(),
                          reg.get("serving.lora.host_adapters").value())}
    assert log["registered"] == (0, 3)

    bad = pkg.adapter("bad", rank=2)
    bad.weights["q_proj"] = (bad.weights["q_proj"][0][:, :-1, :],
                             bad.weights["q_proj"][1])
    log["errors"] = [
        _err(lambda: store.register(pkg.adapter("a", rank=1))),
        _err(lambda: store.register(pkg.adapter("big", rank=9))),
        _err(lambda: store.register(bad)),
        _err(lambda: store.register(pkg.lora.LoraAdapter(
            name="odd", rank=1, weights={"mlp_gate": bad.weights[
                "q_proj"]}))),
        _err(lambda: store.acquire("never_registered"))]
    kinds = [e[0] for e in log["errors"]]
    assert kinds == ["ValueError"] * 4 + ["KeyError"]
    assert "already registered" in log["errors"][0][1]
    assert "rank" in log["errors"][1][1]
    assert "shapes" in log["errors"][2][1]
    assert "unknown projection" in log["errors"][3][1]

    sa = store.acquire("a")
    sb = store.acquire("b")
    assert sorted((sa, sb)) == [0, 1]
    assert store.acquire("c") is None
    log["acquired"] = (sa, sb, reg.get("serving.lora.swap_ins").value(),
                       reg.get("serving.lora.swap_in_bytes").value())
    assert log["acquired"][2] == 2 and log["acquired"][3] > 0
    store.check()

    store.release("a")
    assert store.resident("a")
    sc = store.acquire("c")
    assert sc == sa and not store.resident("a")
    log["demoted"] = (sc, reg.get("serving.lora.host_adapters").value(),
                      store.hbm_resident())
    assert log["demoted"][1] == 1
    store.check()

    store.release("b")
    sa2 = store.acquire("a")
    st = store.state("a")
    for t in tmlora.LORA_TARGETS:
        a_dev, b_dev = store.arena_row(t, sa2)
        np.testing.assert_array_equal(a_dev, st.rows[t][0])
        np.testing.assert_array_equal(b_dev, st.rows[t][1])
        assert (np.asarray(a_dev)[:, :, a.rank:] == 0).all()
        assert (np.asarray(b_dev)[:, a.rank:, :] == 0).all()
    log["rows"] = _rows(store, range(store.slots + 1))
    store.release("a")
    log["double_release"] = _err(lambda: store.release("a"))
    assert log["double_release"][0] == "RuntimeError"
    assert "below pin count" in log["double_release"][1]
    assert reg.get("serving.lora.hbm_adapters").hwm() == 2
    store.check()
    log["instruments"] = _instruments(reg, "serving.lora.")
    log["names"] = (store.names(), store.hbm_resident(), sa2)
    return log


def test_adapter_store_semantics(pkgs):
    """Registration validation, free-list/LRU/pin residency, demotion and
    byte-identical swap-in, gauges and counters on a private registry and
    the audit: the port's store is the JAX store, slot for slot, error for
    error, byte for byte."""
    j = _store_semantics(pkgs["jax"])
    t = _store_semantics(pkgs["port"])
    for k in j:
        assert t[k] == j[k], k


def _subset_overwrite(pkg):
    store = pkg.store(slots=1, max_rank=3, dtype="float32")
    full = pkg.adapter("full", rank=2, seed=5, scale=0.3)
    q_only = pkg.adapter("q_only", rank=2, seed=6, scale=0.3,
                         targets=("q_proj",))
    store.register(full)
    store.register(q_only)
    slot = store.acquire("full")
    store.release("full")
    slot2 = store.acquire("q_only")      # demotes 'full', same slot
    assert slot2 == slot
    a_dev, _b = store.arena_row("q_proj", slot2)
    assert np.abs(np.asarray(a_dev)).sum() > 0
    for t in ("k_proj", "v_proj", "o_proj"):
        a_dev, b_dev = store.arena_row(t, slot2)
        assert (np.asarray(a_dev) == 0).all() and \
            (np.asarray(b_dev) == 0).all(), t
    store.check()
    return _rows(store, [slot2])


def test_subset_target_adapter_overwrites_whole_slot(pkgs):
    """A subset-target adapter overwrites the slot's whole row set: the
    demoted full-target occupant's rows read zero, byte-equal to the JAX
    store's."""
    assert _subset_overwrite(pkgs["port"]) == \
        _subset_overwrite(pkgs["jax"])


def _guards(pkg):
    eng = pkg.engine(num_slots=1, prompt_len=P, max_cache_len=8,
                     compute_dtype="float32")
    store = pkg.store(slots=1, max_rank=2, dtype="float32")
    eng2 = pkg.engine(num_slots=1, prompt_len=P, max_cache_len=8,
                      compute_dtype="float32", adapter_store=store)
    return [
        _err(lambda: eng.submit(np.zeros((4,), np.int32),
                                max_new_tokens=2, adapter="a")),
        _err(lambda: eng2.submit(np.zeros((4,), np.int32),
                                 max_new_tokens=2, adapter="ghost")),
        _err(lambda: pkg.engine(num_slots=1, prompt_len=P, max_cache_len=8,
                                compute_dtype="bfloat16",
                                adapter_store=store)),
        _err(lambda: pkg.engine(num_slots=1, prompt_len=P, max_cache_len=8,
                                compute_dtype="float32",
                                tenant_weights={"t": 0.0})),
        _err(lambda: eng2.migrate_in(np.zeros((4,), np.int32),
                                     max_new_tokens=2, adapter="ghost"))]


def test_engine_adapter_guards(pkgs):
    """submit(adapter=) without a store and with an unregistered name, a
    store/engine dtype mismatch, a non-positive tenant weight and
    migrate_in of an adapter this replica does not hold: the JAX engine's
    errors, message for message.  The dtype guard fires before the model
    is touched; a store on another device is refused."""
    t = _guards(pkgs["port"])
    assert t == _guards(pkgs["jax"])
    assert [e[0] for e in t] == ["ValueError"] * 5
    for e, word in zip(t, ("adapter_store", "not registered",
                           "compute_dtype", "tenant_weights",
                           "replica-homogeneous")):
        assert word in e[1], (word, e)
    assert next(pkgs["port"].net.parameters()).dtype == torch.float32
    store = tlora.AdapterStore(pkgs["port"].net, slots=1, max_rank=2,
                               dtype="float32", device="cpu",
                               registry=MetricsRegistry())
    store.device = torch.device("meta")
    with pytest.raises(ValueError, match="live on"):
        pkgs["port"].engine(num_slots=1, prompt_len=P, max_cache_len=8,
                            compute_dtype="float32", adapter_store=store)


# -- the module-scoped combined LoRA trace --

SPECS = [
    # (prompt_seed, seq_len, max_new, adapter, spec_k)
    (10, 4, 6, "a", None),     # K=2 batched: a + b decode together
    (11, 5, 6, "b", None),
    (12, 4, 6, None, None),    # base rides the SAME lora dispatches
    (13, 3, 5, "c", None),     # store full -> adapter swap (demote)
    (14, 4, 5, "a", None),     # 'a' swaps BACK in (byte-identical)
    (15, 6, 6, "b", 2),        # spec-decode verify over an adapter
]


def _lora_trace(pkg):
    reg, fr = pkg.Registry(), pkg.Recorder()
    store = pkg.store(slots=2, max_rank=4, dtype="float32", registry=reg)
    adapters = {n: pkg.adapter(n, rank=3, seed=s, scale=0.2)
                for n, s in (("a", 7), ("b", 8), ("c", 9))}
    for ad in adapters.values():
        store.register(ad)
    eng = pkg.engine(num_slots=2, prompt_len=P, max_cache_len=C,
                     steps_per_call=3, compute_dtype="float32",
                     adapter_store=store, registry=reg, flight_recorder=fr)
    reqs = []
    for seed, n, m, aname, spec_k in SPECS:
        ids = np.random.default_rng(seed).integers(
            0, pkg.cfg.vocab_size, (n,)).astype(np.int32)
        reqs.append((ids, n, m, aname, eng.submit(
            ids, max_new_tokens=m, adapter=aname, spec_decode=spec_k,
            tenant=None if aname is None else f"tenant_{aname}")))
    done = eng.run()
    assert len(done) == len(SPECS)
    return {"reg": reg, "fr": fr, "store": store, "adapters": adapters,
            "eng": eng, "reqs": reqs}


@pytest.fixture(scope="module")
def lora_trace(pkgs):
    return {"jax": _lora_trace(pkgs["jax"]),
            "port": _lora_trace(pkgs["port"])}


STAT_KEYS = ("tenant_served_tokens", "fair_reorders", "lora_dispatches",
             "adapters_resident", "finished", "prefills", "prefill_chunks",
             "decode_steps", "block_dispatches", "spec_verify_steps",
             "spec_draft_tokens", "spec_accepted_tokens", "useful_tokens",
             "wasted_tokens", "dispatched_tokens", "async_syncs",
             "async_harvests")


def test_batched_lora_token_exact_vs_merged(pkgs, lora_trace):
    """Every request's batched gathered output is token for token its own
    merged-weights ``generate()`` on the port (K=2 concurrent adapters,
    the base row in the same dispatches, the adapter that crossed the
    host tier, the slot reuse with a changed adapter id, the spec row),
    and the JAX engine's output of the same request."""
    net = pkgs["port"].net
    t, j = lora_trace["port"], lora_trace["jax"]
    for (ids, n, m, aname, req), (*_x, jreq) in zip(t["reqs"], j["reqs"]):
        want = _oracle(net, t["adapters"].get(aname), ids, n, m)
        np.testing.assert_array_equal(
            req.output, want,
            err_msg=f"request {req.request_id} (adapter={aname})")
        np.testing.assert_array_equal(req.output, np.asarray(jreq.output))


def test_lora_trace_store_and_instruments(lora_trace):
    """The trace exercised the paged store: K=2 peak residency, >= 4
    swap-ins, every lora dispatch counted, per-tenant goodput
    conservation and a clean audit after the drain; and the port's
    arena rows, ``serving.lora.*`` / ``serving.fairshare.*`` instruments,
    stats keys, flight records and ``explain()`` equal the JAX
    engine's."""
    t, j = lora_trace["port"], lora_trace["jax"]
    reg, store, eng = t["reg"], t["store"], t["eng"]
    s = eng.stats()
    assert reg.get("serving.lora.hbm_adapters").hwm() == 2
    assert reg.get("serving.lora.swap_ins").value() >= 4
    assert reg.get("serving.lora.swap_in_bytes").value() > 0
    assert reg.get("serving.lora.gathers").value() == \
        s["lora_dispatches"] > 0
    store.check()
    assert all(store.state(n).pins == 0 for n in store.names())
    g_u = reg.get("serving.goodput.useful_tokens")
    g_w = reg.get("serving.goodput.wasted_tokens")
    g_d = reg.get("serving.goodput.dispatched_tokens")
    for ten in ("tenant_a", "tenant_b", "tenant_c", "default"):
        w = sum(g_w.value(reason=r, tenant=ten)
                for r in ("spec_reject", "recompute_preempt",
                          "recompute_cache", "pad"))
        assert g_u.value(tenant=ten) + w == g_d.value(tenant=ten) > 0
    assert s["useful_tokens"] + s["wasted_tokens"] \
        == s["dispatched_tokens"]
    admits = {e.request: e for e in t["fr"].events() if e.kind == "admit"}
    a_req = next(r for *_x, an, r in t["reqs"] if an == "a")
    assert admits[a_req.request_id].attrs.get("adapter") == "a"
    text = eng.explain(a_req.request_id)
    assert "adapter a" in text and "tenant tenant_a" in text

    # against the JAX engine: arena bytes, instruments, stats, records
    assert _rows(store, range(store.slots + 1)) == \
        _rows(j["store"], range(store.slots + 1))
    prefixes = ("serving.lora.", "serving.fairshare.")
    assert _instruments(reg, *prefixes) == _instruments(j["reg"], *prefixes)
    js = j["eng"].stats()
    for k in STAT_KEYS:
        assert s[k] == js[k], (k, s[k], js[k])
    assert _strip(t["fr"].events()) == _strip(j["fr"].events())
    for *_x, req in t["reqs"]:
        assert eng.explain(req.request_id) == \
            j["eng"].explain(req.request_id)
    assert eng.load_report()["hbm_adapters"] == \
        j["eng"].load_report()["hbm_adapters"] == store.hbm_resident()
    assert eng.engine_spec() == j["eng"].engine_spec()
    assert eng.engine_spec()["adapters"] == ["a", "b", "c"]
    # the decode programs: keyed (steps, flags, lora_on) in both packages
    # (every decode dispatch of this trace carries an adapter row)
    keys = sorted(eng._blocks)
    assert keys == sorted((k[0], tuple(bool(f) for f in k[1]), k[2])
                          for k in j["eng"]._blocks)
    assert {k[2] for k in keys} == {True}


# -- fair-share admission (deficit-weighted round-robin) --

def _starvation_arm(pkg, tenants, n_steps, seed, weights=None):
    """One fixed-step run of the two-tenant starvation trace: a 1-slot
    engine, every request submitted at t=0, the admission order read back
    from the flight recorder."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, pkg.cfg.vocab_size, (4,)).astype(np.int32)
               for _ in range(9)]
    fr = pkg.Recorder()
    eng = pkg.engine(num_slots=1, prompt_len=4, max_cache_len=16,
                     steps_per_call=1, compute_dtype="float32",
                     flight_recorder=fr, tenant_weights=weights)
    reqs = [eng.submit(prompts[i], max_new_tokens=3, tenant=t)
            for i, t in enumerate(tenants)]
    for _ in range(n_steps):
        eng.step()
    admits = [e.request for e in fr.events() if e.kind == "admit"]
    fin = {}
    for i, t in enumerate(tenants):
        if reqs[i].state == "finished":
            fin[t] = fin.get(t, 0) + 1
    return admits, fin, eng.stats(), fr


FAIR_KEYS = ("tenant_served_tokens", "fair_reorders", "finished",
             "prefills", "decode_steps", "block_dispatches")


def test_fair_share_starvation_trace(pkgs):
    """Under a bursty tenant's overload (6 requests at t=0) against a
    steady tenant (3 at t=0), the port admits in the JAX engine's order,
    the hand-computed alternation, twice; the steady tenant finishes more
    than under FIFO; a single-tenant trace stays FIFO with no reorder;
    the admit events carry tenant and deficit as the JAX engine's do."""
    burst = ["A"] * 6 + ["B"] * 3
    n = 14
    out = {}
    for name, pkg in pkgs.items():
        fifo = _starvation_arm(pkg, ["default"] * 9, n, seed=3)
        fair = _starvation_arm(pkg, burst, n, seed=3)
        fair2 = _starvation_arm(pkg, burst, n, seed=3)
        out[name] = (fifo, fair, fair2)
    (fifo_admits, fifo_fin, fifo_stats, _), \
        (fair_admits, fair_fin, fair_stats, fair_fr), \
        (fair2_admits, _f2, _s2, _) = out["port"]
    assert fifo_admits == sorted(fifo_admits)
    assert fifo_stats["fair_reorders"] == 0
    want_order = [0, 6, 1, 7, 2, 8, 3, 4, 5]
    assert fair_admits == want_order[:len(fair_admits)]
    assert fair_admits == fair2_admits
    assert fair_stats["fair_reorders"] == 3
    assert fair_fin.get("B", 0) > fifo_fin.get("B", 0)
    assert fair_fin.get("B", 0) >= 2
    assert fair_stats["tenant_served_tokens"]["A"] > \
        fair_stats["tenant_served_tokens"]["B"] > 0
    b_admit = next(e for e in fair_fr.events()
                   if e.kind == "admit" and e.request == 6)
    assert b_admit.attrs["tenant"] == "B"
    assert b_admit.attrs["deficit"] > 0
    text = fair_fr.explain(6)
    assert "tenant B" in text and "deficit" in text
    for arm_t, arm_j in zip(out["port"], out["jax"]):
        assert arm_t[0] == arm_j[0]                     # admission order
        assert arm_t[1] == arm_j[1]                     # finishes by tenant
        for k in FAIR_KEYS:
            assert arm_t[2][k] == arm_j[2][k], k
        assert _strip(arm_t[3].events()) == _strip(arm_j[3].events())


def test_fair_share_weights(pkgs):
    """tenant_weights scale the fair share: at weight 2 the bursty tenant
    keeps a 2:1 admission ratio, the deterministic prefix 0, 6, 1, 2, 7,
    3, 4, 8, 5 in both packages, with equal deficit gauges."""
    burst = ["A"] * 6 + ["B"] * 3
    want = [0, 6, 1, 2, 7, 3, 4, 8, 5]
    got = {}
    for name, pkg in pkgs.items():
        admits, _fin, stats, fr = _starvation_arm(
            pkg, burst, 18, seed=4, weights={"A": 2.0, "B": 1.0})
        assert admits == want[:len(admits)]
        got[name] = (admits, {k: stats[k] for k in FAIR_KEYS},
                     _strip(fr.events()))
    assert len(got["port"][0]) == len(want)
    assert got["port"] == got["jax"]


# -- compositions --

@pytest.mark.slow
def test_lora_int8_kv_compose(pkgs):
    """LoRA composes with the int8 KV cache: each request alone on the
    int8 engine reproduces its batched row exactly (row independence),
    and the int8 stream tracks the float LoRA stream closely."""
    pkg = pkgs["port"]
    store = pkg.store(slots=2, max_rank=4, dtype="float32")
    for n, s in (("a", 7), ("b", 8)):
        store.register(pkg.adapter(n, rank=3, seed=s, scale=0.2))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, pkg.cfg.vocab_size, (5,)).astype(np.int32)
               for _ in range(3)]

    def run(kv_dtype, batch):
        eng = pkg.engine(num_slots=2, prompt_len=P, max_cache_len=C,
                         steps_per_call=2, compute_dtype="float32",
                         kv_cache_dtype=kv_dtype, adapter_store=store)
        reqs = [eng.submit(ids, max_new_tokens=5, adapter=aname)
                for ids, aname in batch]
        eng.run()
        return [r.output for r in reqs]

    batch = [(prompts[0], "a"), (prompts[1], "b"), (prompts[2], None)]
    int8_batched = run("int8", batch)
    for i, (ids, aname) in enumerate(batch):
        np.testing.assert_array_equal(int8_batched[i],
                                      run("int8", [(ids, aname)])[0])
    f32 = run("float32", batch)
    agree = np.mean([np.mean(a == b) for a, b in zip(int8_batched, f32)])
    assert agree >= 0.9


def test_weight_quant_composes_spec_lora_async(pkgs):
    """One engine holding every serving feature at once: int8 weights,
    dispatch-ahead depth 2, a LoRA row, a spec row and a plain row.  The
    drafter is a ``ModelDrafter`` over the target (the n-gram drafter
    drafts little on a random tiny model), so the spec row really
    verifies and accepts.  Every request finishes with its exact budget;
    the verify, gather and weight-sweep counters advance; the spec row's
    tokens equal the same engine's non-spec run of that request."""
    pkg = pkgs["port"]
    cfg = pkg.cfg

    def run(spec_k):
        reg = MetricsRegistry()
        store = pkg.store(slots=2, max_rank=4, dtype="float32",
                          registry=reg)
        store.register(pkg.adapter("a", rank=2, seed=3, scale=0.2))
        drafter = ModelDrafter(pkg.net, max_context=P + 12,
                               compute_dtype="float32")
        eng = pkg.engine(num_slots=2, prompt_len=P, max_cache_len=C,
                         steps_per_call=1, block_len=4, chunk_len=4,
                         compute_dtype="float32", weight_dtype="int8",
                         adapter_store=store, async_depth=2,
                         drafter=drafter, registry=reg)
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, cfg.vocab_size, (5,)).astype(np.int32)
                   for _ in range(3)]
        reqs = [eng.submit(prompts[0], max_new_tokens=8, arrival_time=0.0,
                           adapter="a"),
                eng.submit(prompts[1], max_new_tokens=8, arrival_time=0.0,
                           spec_decode=spec_k, adapter="a"),
                eng.submit(prompts[2], max_new_tokens=8, arrival_time=0.0)]
        done = eng.run(max_iters=200)
        assert {r.request_id for r in done} == \
            {r.request_id for r in reqs}
        for r in reqs:
            assert r.state == "finished" and len(r.output) == 8
        store.check()
        return reqs, reg, eng.stats()

    reqs, reg, st = run(2)
    assert reg.get("serving.spec.verify_steps").value() > 0
    assert st["spec_accepted_tokens"] > 0
    assert reg.get("serving.lora.gathers").value() > 0
    assert reg.get("serving.weights.bytes_swept").value() > 0
    assert reg.get("serving.weights.quant_dtype").value(dtype="int8") == 1
    plain, _reg, _st = run(None)
    for r, p in zip(reqs, plain):
        np.testing.assert_array_equal(r.output, p.output)
