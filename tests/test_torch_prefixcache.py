"""The port's tiered radix prefix cache held against the JAX package.

- Units (no model): one sequence of operations runs on both copies of
  ``HostTier`` and of ``RadixPrefixCache`` over a ``BlockPool`` (the
  sequences of the JAX package's ``tests/test_prefixcache.py`` unit
  tests), and every observation — keys, evictions, spans,
  ``root_stats()``, ``audit()``, ``check()`` verdicts — is equal.  The
  row conversion keeps exact bytes: float32 and int8 as they are,
  bfloat16 as the ``uint16`` view of its bits (equal to a JAX bfloat16
  array's bits), and a parcel of the wrong dtype or row shape raises.
- Engines (radix mode; the JAX engine with ``async_dispatch=False``):
  the multi-turn trace of the JAX package's acceptance test (two
  conversations x three turns over a 1-slot engine with an 8-block pool,
  so turn N's blocks are demoted to host RAM while the other
  conversation runs and promoted back on the next turn) through both
  engines in lockstep on a step clock, in float32, with an int8 KV
  cache, and (two turns) in bfloat16.  Before every step the JAX
  engine's arena bytes are copied into the port's, so a parcel the
  port demotes holds the same source bytes as the JAX engine's: after
  every step the tiers hold the same keys, reasons, block counts and
  pins, every parcel's rows are byte-equal to the JAX parcel's (int8
  codes and f32 scales; bf16 by bit view), and every integer counter
  of ``stats()`` is equal.  Tokens are equal up to each request's first
  non-decisive position (teacher-forced top-2 margin <= 0.01).
- The port alone, without the copy: the radix engine's tokens equal the
  digest engine's on the same trace, and it serves host-tier hits and
  runs fewer prefill chunks.
- Cache-aware admission order (resident prefix first, priority above
  residency, FIFO when cold) is the JAX engine's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference.prefixcache import HostTier as JaxHostTier
from paddle_tpu.inference.prefixcache import \
    RadixPrefixCache as JaxRadixPrefixCache
from paddle_tpu.inference.serving import BlockPool as JaxBlockPool
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.observability.metrics import MetricsRegistry
from paddle_tpu_torch.observability import (
    MetricsRegistry as TorchRegistry)
from paddle_tpu_torch.inference import (BlockPool, HostTier,
                                        RadixPrefixCache, ServingEngine)
from paddle_tpu_torch.inference.prefixcache import device_rows, host_rows
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)

P, C, BLK, CHUNK, NB = 16, 24, 2, 4, 8
MARGIN = 0.01


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def _fake_rows(block):
    return [np.full((1, 2, 2), block, np.float32)]


def _host_tier_script(tier_cls):
    """The JAX package's HostTier unit sequence; returns what it saw."""
    seen, evicted = [], []
    tier = tier_cls(cache_capacity_blocks=2, evict_cb=evicted.append)
    k1 = tier.put(_fake_rows(1), 1, "cache")
    k2 = tier.put(_fake_rows(2), 1, "cache")
    seen.append((tier.blocks("cache"), tier.blocks("preempt")))
    kp = tier.put([np.zeros((3, 2, 2), np.float32)], 3, "preempt")
    seen.append((kp, tier.blocks("preempt"), tier.blocks()))
    k3 = tier.put(_fake_rows(3), 1, "cache")
    seen.append((k3, list(evicted), tier.entry(k1) is None,
                 tier.blocks("cache")))
    tier.pin(k2)
    k4 = tier.put(_fake_rows(4), 1, "cache")
    seen.append((k4, list(evicted)))
    tier.pin(k4)
    seen.append((tier.put(_fake_rows(5), 1, "cache"), tier.would_accept(1)))
    tier.unpin(k4)
    seen.append(tier.would_accept(1))
    tier.unpin(k2)
    tier.touch(k2)
    seen.append(tier.put(_fake_rows(6), 1, "cache"))
    seen.append((tier.entry(k4) is None, tier.entry(k2) is not None))
    tier.drop(k2)
    tier.unpin(k2)
    seen.append((tier.audit(), tier.keys(), tier.keys("cache"),
                 tier.keys("preempt")))
    with pytest.raises(ValueError, match="reason"):
        tier.put(_fake_rows(7), 1, "wat")
    seen.append(tier.put([np.zeros((9, 2, 2))], 9, "cache"))
    dest = tier_cls(cache_capacity_blocks=None)
    seen.append((tier.transfer(kp, dest), tier.entry(kp) is None,
                 dest.blocks("preempt"), dest.audit()))
    return seen, dest


def test_host_tier_matches_jax():
    jseen, _ = _host_tier_script(JaxHostTier)
    tseen, dest = _host_tier_script(HostTier)
    assert tseen == jseen
    # the port's parcels carry what their bits decode to, across a
    # transfer too; a dtype list that does not cover the stacks is caught
    tier = HostTier(cache_capacity_blocks=4)
    rows = [np.zeros((2, 2, 2), np.uint16), np.zeros((2, 2, 2), np.int8)]
    key = tier.put(rows, 2, "preempt", ("bfloat16", "int8"))
    new = tier.transfer(key, dest)
    assert dest.entry(new).dtypes == ("bfloat16", "int8")
    assert dest.audit() == []
    dest.entry(new).dtypes = ("bfloat16",)
    assert any("dtypes" in e for e in dest.audit())


def _radix_script(pool_cls, tier_cls, tree_cls):
    """The JAX package's radix-tree unit sequence (insert, split, token
    match, demote, promote, holes, audit); returns what it saw."""
    seen = []
    L = 2
    pool = pool_cls(num_blocks=8, block_len=L)
    tier = tier_cls(cache_capacity_blocks=8)
    tree = tree_cls(L, pool, tier)
    tier.evict_cb = tree.drop_host
    pool.audit_hooks.append(lambda: tree.audit(pool))

    def look(ids):
        m, span = tree.match(np.asarray(ids, np.int32))
        seen.append((m, list(span), tree.root_stats(), pool.available(),
                     pool.cached(), tree.audit(pool)))
        return m, span

    ids_a = np.array([5, 6, 7, 8, 9, 10], np.int32)
    blocks_a = pool.alloc(3)
    tree.insert(ids_a, blocks_a, 3)
    seen.append(pool.check())
    look(ids_a)
    look([5, 6, 7, 99])
    ids_b = np.array([5, 6, 42, 43], np.int32)
    blocks_b = pool.alloc(2)
    tree.insert(ids_b, blocks_b, 2)
    look(ids_b)
    look(ids_a)
    (fresh,) = pool.alloc(1)
    for b in blocks_a:
        pool.unpin(b)

    def _demote_all(blks):
        for b in blks:
            tree.demote(b, _fake_rows(b))
    pool.reclaim_cb = _demote_all
    grabbed = pool.alloc(3)
    seen.append((grabbed, pool.check()))
    _m, span = look(ids_a)
    tree.promote(span[0][1], fresh)
    seen.append((pool.check(), tier.blocks("cache")))
    look(ids_a)
    for b in [fresh] + grabbed:
        pool.unpin(b)
    seen.append(pool.alloc(5))
    _m, span = look(ids_a)
    first_host = next(ref for kind, ref in span if kind == "host")
    tree.drop_host(first_host)
    tier.drop(first_host)
    look(ids_a)
    seen.append((pool.check(), tree.n_hbm(), tree.n_host()))
    bid = next(iter(tree._hbm))
    pool._free.append(bid)
    with pytest.raises(RuntimeError, match="tree-referenced"):
        pool.check()
    pool._free.pop()
    tree._host[9999] = (tree.root, 0)
    with pytest.raises(RuntimeError, match="radix"):
        pool.check()
    del tree._host[9999]
    seen.append(pool.check())
    return seen


def test_radix_tree_matches_jax():
    jseen = _radix_script(JaxBlockPool, JaxHostTier, JaxRadixPrefixCache)
    tseen = _radix_script(BlockPool, HostTier, RadixPrefixCache)
    assert tseen == jseen


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_host_rows_keep_exact_bytes(dtype):
    """Arena rows -> host parcel -> arena rows is bit-exact; a bf16 stack
    travels as the uint16 view of its bits, equal to a JAX bfloat16
    array's bits, and a JAX bfloat16 parcel scatters back as the same
    bits."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((3, 2, 8)).astype(np.float32)
    if dtype == "int8":
        t = torch.from_numpy(np.clip(base * 40, -127, 127).astype(np.int8))
    else:
        t = torch.from_numpy(base.copy()).to(getattr(torch, dtype))
    arena = torch.zeros((5, 2, 8), dtype=t.dtype)
    rows, name = host_rows(t)
    assert name == dtype and rows.shape == (3, 2, 8)
    back = device_rows(rows, name, arena)
    assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))
    if dtype == "bfloat16":
        assert rows.dtype == np.uint16
        jrows = np.asarray(jnp.asarray(base, jnp.bfloat16))
        np.testing.assert_array_equal(rows, jrows.view(np.uint16))
        from_jax = device_rows(jrows, "bfloat16", arena)
        assert torch.equal(from_jax.view(torch.int16), t.view(torch.int16))
    else:
        assert rows.dtype == np.dtype(dtype)
    with pytest.raises(ValueError, match="decode to"):
        device_rows(rows, "float16", arena)
    with pytest.raises(ValueError, match="row shape"):
        device_rows(rows, name, torch.zeros((5, 2, 4), dtype=t.dtype))
    if dtype != "bfloat16":
        with pytest.raises(ValueError, match="arena holds"):
            device_rows(rows.astype(np.float64), name, arena)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

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
    yield jnet, tnet, arrays
    torch.set_num_threads(prev)


def _kw(compute="float32", kv=None, **extra):
    return dict(num_slots=1, prompt_len=P, max_cache_len=C, steps_per_call=1,
                block_len=BLK, chunk_len=CHUNK, num_blocks=NB,
                compute_dtype=compute, kv_cache_dtype=kv, **extra)


def _copy_arenas(jeng, teng):
    """The JAX engine's arena bytes into the port engine's arenas."""
    for ja, ta in zip(jeng._arenas, teng._arenas):
        a = np.asarray(ja)
        if ta.dtype == torch.bfloat16:
            ta.view(torch.int16).copy_(torch.from_numpy(
                np.array(a.view(np.int16), copy=True)))
        else:
            ta.copy_(torch.from_numpy(np.array(a, copy=True)))


def _tier_state(eng):
    return sorted((k, e.reason, e.n_blocks, e.pins)
                  for k, e in eng._host_tier._entries.items())


def _assert_parcels_equal(jeng, teng):
    for k in jeng._host_tier.keys():
        je, te = jeng._host_tier.entry(k), teng._host_tier.entry(k)
        assert len(te.rows) == len(je.rows) == len(te.dtypes)
        for jr, tr, dt in zip(je.rows, te.rows, te.dtypes):
            jr = np.asarray(jr)
            assert dt == str(jr.dtype) and tr.shape == jr.shape
            if dt == "bfloat16":
                assert tr.dtype == np.uint16
                np.testing.assert_array_equal(tr, jr.view(np.uint16))
            else:
                assert tr.dtype == jr.dtype
                np.testing.assert_array_equal(tr.view(np.uint8),
                                              jr.view(np.uint8))


def _int_stats(eng):
    return {k: v for k, v in eng.stats().items() if type(v) is int}


def _multiturn(jnet, tnet, compute, kv, turns):
    """Both engines over the multi-turn trace in lockstep: the JAX
    engine's outputs extend the histories, the same prompts go to both,
    the JAX arenas are copied into the port's before every step, and
    tiers, parcels, pools and counters are compared after every step."""
    rng = np.random.default_rng(3)
    vocab = tiny_llama_config().vocab_size
    sys_ids = rng.integers(0, vocab, (4,)).astype(np.int32)
    tclock, jclock = StepClock(), StepClock()
    teng = ServingEngine(tnet, device="cpu", async_dispatch=False,
                         registry=TorchRegistry(), clock=tclock,
                         **_kw(compute, kv))
    jeng = JaxEngine(jnet, async_dispatch=False, registry=MetricsRegistry(),
                     clock=jclock, **_kw(compute, kv))
    assert teng.prefix_cache_mode == jeng.prefix_cache_mode == "radix"
    hist = [list(sys_ids), list(sys_ids)]
    served = []
    n_parcels = 0
    for _turn in range(turns):
        reqs = []
        for ci in range(2):
            user = rng.integers(0, vocab, (2,)).astype(np.int32)
            hist[ci].extend(int(x) for x in user)
            ids = np.asarray(hist[ci], np.int32)
            reqs.append((ci, ids, jeng.submit(ids, max_new_tokens=2),
                         teng.submit(ids.copy(), max_new_tokens=2)))
        steps = 0
        while jeng._queue or jeng._swapped or \
                any(s is not None for s in jeng._slots):
            _copy_arenas(jeng, teng)
            jeng.step(jclock.now)
            teng.step(tclock.now)
            jclock.now += 1.0
            tclock.now += 1.0
            jeng._pool.check()
            teng._pool.check()
            assert _tier_state(teng) == _tier_state(jeng)
            _assert_parcels_equal(jeng, teng)
            n_parcels = max(n_parcels, len(jeng._host_tier.keys()))
            assert _int_stats(teng) == {
                k: v for k, v in _int_stats(jeng).items()
                if k in _int_stats(teng)}
            steps += 1
            assert steps < 200
        assert not (teng._queue or any(s is not None for s in teng._slots))
        for ci, ids, jr, tr in reqs:
            assert jr.state == tr.state == "finished"
            hist[ci].extend(int(x) for x in jr.output)
            served.append((ids, jr, tr))
    assert n_parcels > 0
    return jeng, teng, served


def _margins(jnet, served):
    out = []
    for ids, jr, _tr in served:
        s = np.concatenate([ids, jr.output[:-1]])[None]
        lg = np.asarray(jnet(paddle.to_tensor(s))._value)[0]
        lg = lg[len(ids) - 1:len(ids) - 1 + len(jr.output)]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        out.append(top2[:, 1] - top2[:, 0])
    return out


@pytest.fixture(scope="module")
def lockstep(bridged):
    jnet, tnet, _ = bridged
    return {kv or "float32": _multiturn(jnet, tnet, "float32", kv, 3)
            for kv in (None, "int8")}


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_multiturn_radix_matches_jax(bridged, lockstep, kv):
    """Counters equal (the host tier really demoted and promoted), and
    tokens equal up to each request's first non-decisive position."""
    jnet = bridged[0]
    jeng, teng, served = lockstep[kv]
    ts, js = teng.stats(), jeng.stats()
    shared = sorted(k for k in ts if k in js and type(ts[k]) is int)
    assert {"prefix_hit_tokens", "prefix_host_hits", "host_swapin_blocks",
            "prefix_partial_hits", "swap_blocks_out", "swap_bytes_in",
            "host_cache_blocks", "prefill_chunks"} <= set(shared)
    for key in shared:
        assert ts[key] == js[key], (key, ts[key], js[key])
    assert ts["prefix_host_hits"] >= 1 and ts["host_swapin_blocks"] >= 1
    assert ts["swap_bytes_out"] == ts["swap_blocks_out"] * BLK * \
        teng._kv_row_bytes
    assert ts["blocks_in_use"] == 0 and ts["swap_host_blocks"] == 0
    compared = total = 0
    for (ids, jr, tr), margin in zip(served, _margins(jnet, served)):
        total += len(margin)
        close = np.flatnonzero(margin <= MARGIN)
        upto = int(close[0]) if close.size else len(margin)
        np.testing.assert_array_equal(tr.output[:upto], jr.output[:upto])
        compared += upto
        assert teng.prefix_match(ids) == jeng.prefix_match(ids)
    assert compared >= 0.8 * total, (compared, total)


def test_multiturn_radix_bf16_parcels_match_jax(bridged):
    """Two turns in bfloat16: every parcel's uint16 bits equal the JAX
    parcel's bfloat16 bits, and the counters are equal."""
    jnet, tnet, arrays = bridged
    # a private bf16 copy of the port model: the engine casts in place
    net16 = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    net16.load_state_dict(llama_state_from_jax(arrays))
    jeng, teng, _served = _multiturn(jnet, net16, "bfloat16", None, 2)
    assert teng._arenas[0].dtype == torch.bfloat16
    assert teng.stats()["swap_blocks_out"] > 0
    assert teng.stats()["swap_blocks_out"] == jeng.stats()["swap_blocks_out"]


def test_radix_tokens_equal_digest_engine(bridged, lockstep):
    """The port alone: on the lockstep trace's prompts, a radix engine
    (no arena copy) gives the digest engine's tokens, serves host-tier
    hits and runs fewer prefill chunks."""
    _jnet, tnet, _ = bridged
    served = lockstep["float32"][2]
    outs, stats = {}, {}
    for mode in ("radix", "digest"):
        eng = ServingEngine(tnet, device="cpu", prefix_cache_mode=mode,
                            **_kw())
        got = []
        for turn in range(0, len(served), 2):
            pair = [eng.submit(ids, max_new_tokens=2)
                    for ids, _j, _t in served[turn:turn + 2]]
            eng.run()
            eng._pool.check()
            got += [r.output for r in pair]
        outs[mode], stats[mode] = got, eng.stats()
    for a, b in zip(outs["radix"], outs["digest"]):
        np.testing.assert_array_equal(a, b)
    assert stats["radix"]["prefix_host_hits"] >= 1
    assert stats["radix"]["prefix_hit_tokens"] > \
        stats["digest"]["prefix_hit_tokens"]
    assert stats["radix"]["prefill_chunks"] < \
        stats["digest"]["prefill_chunks"]


def _admission_order(eng_cls, net, extra):
    """The JAX package's cache-aware admission sequence; returns the
    prefill order of each round, as request ids."""
    rng = np.random.default_rng(7)
    vocab = tiny_llama_config().vocab_size
    shared = rng.integers(0, vocab, (4,)).astype(np.int32)
    eng = eng_cls(net, num_slots=4, prompt_len=P, max_cache_len=C,
                  steps_per_call=1, block_len=2, chunk_len=4,
                  compute_dtype="float32", **extra)
    eng.submit(shared, max_new_tokens=1)
    eng.run(max_iters=100)
    cold = [rng.integers(0, vocab, (6,)).astype(np.int32) for _ in range(3)]
    sharer = np.concatenate([shared,
                             rng.integers(0, vocab, (2,)).astype(np.int32)])
    rounds = []
    for subs in ([(cold[0], 0), (cold[1], 0), (sharer, 0)],
                 [(cold[2], 1), (sharer, 0)]):
        reqs = [eng.submit(ids, max_new_tokens=1, priority=p)
                for ids, p in subs]
        eng._admit(eng._clock(), [])
        rounds.append([r.request_id for r in eng._prefilling])
        for r in reqs:
            assert eng.cancel(r.request_id)
        eng._prefilling.clear()
        assert eng._pool.check()
    eng2 = eng_cls(net, num_slots=3, prompt_len=P, max_cache_len=C,
                   block_len=2, compute_dtype="float32", **extra)
    [eng2.submit(ids, max_new_tokens=1) for ids in cold]
    eng2._admit(eng2._clock(), [])
    rounds.append([r.request_id for r in eng2._prefilling])
    return rounds, eng.stats()["cancelled"]


def test_cache_aware_admission_order_matches_jax(bridged):
    jnet, tnet, _ = bridged
    jrounds, jc = _admission_order(
        JaxEngine, jnet, dict(async_dispatch=False,
                              registry=MetricsRegistry()))
    trounds, tc = _admission_order(ServingEngine, tnet,
                                   dict(device="cpu", async_dispatch=False))
    assert trounds == jrounds and tc == jc == 5
    # the resident sharer (id 3) admits ahead of earlier cold requests;
    # priority dominates residency (the cold priority-1 id 4 before the
    # sharer id 5); an all-cold trace stays FIFO
    assert trounds == [[3, 1, 2], [4, 5], [0, 1, 2]]
