"""The speculative slice's kernel modules and host pieces held against the
JAX package on the CPU.

The same numpy inputs go through the JAX function and the port's
counterpart.  On the CPU the port's wrappers run their plain versions;
the JAX side runs its Pallas kernels in interpret mode (as its own tests
do) and its gather-based XLA path.

- ``decode_attention_paged_multi`` (the K-wide verify attention) against
  ``_decode_attention_pallas_paged_multi`` and ``_paged_multi_xla`` over
  C in {1, 3, 5}, G in {1, 4} and L in {4, 8, 16}, with lens at a block
  edge, the last query at the last slot of the table, and a row outside
  spec mode (all-trash table, lens past the table); its int8 twin against
  ``_decode_attention_pallas_paged_multi_q``.  float32 ``atol 1e-5``
  (the same fp32 math in another order).
- the dense ``decode_attention`` against ``_decode_attention_pallas`` and
  ``_decode_attention_xla``, odd S included, ``atol 1e-5``.
- ``paged_verify_scatter`` and ``paged_verify_scatter_q`` bit-equal,
  trash columns and the table-edge clamp included; the dense cache
  helpers bit-equal.
- ``NGramDrafter.propose`` and ``accept_drafts`` equal on seeded random
  contexts, EOS inside accepted drafts included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference import speculative as jspec
from paddle_tpu.models import generation as jgen
from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops import decode_attention as tda

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _multi_case(seed, cq, g, blk_len, hkv=2, d=64, mb=4):
    """Three rows over a packed arena (the Pallas kernel's layout): row 0's
    first query sits on the last slot of block 0 (its later queries cross
    into block 1), row 1's last query on the last slot of its table, row
    2 is outside spec mode (all-trash table, lens past the table).  The
    arena is random everywhere, so every slot past a query's frontier is
    finite garbage."""
    rng = np.random.default_rng(seed)
    b = 3
    lens = np.array([blk_len - 1, mb * blk_len - cq, mb * blk_len + 3],
                    np.int32)
    nb = 2 * mb + 2
    shape = jda.paged_arena_shape(nb + 1, hkv, blk_len, d)
    ka = rng.standard_normal(shape).astype(np.float32)
    va = rng.standard_normal(shape).astype(np.float32)
    perm = rng.permutation(nb)
    tables = np.full((b, mb), nb, np.int32)
    tables[0, :2] = perm[:2]
    tables[1] = perm[2:2 + mb]
    q = rng.standard_normal((b, cq, hkv * g, d)).astype(np.float32)
    return q, ka, va, tables, lens


@pytest.mark.parametrize("blk_len", [4, 8, 16])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("cq", [1, 3, 5])
def test_paged_multi_matches_pallas_and_xla(cq, g, blk_len):
    q, ka, va, tables, lens = _multi_case(cq * 100 + g * 10 + blk_len, cq, g,
                                          blk_len)
    b, _, hq, d = q.shape
    hkv = hq // g
    out = tda.decode_attention_paged_multi(_t(q), _t(ka), _t(va), _t(tables),
                                           _t(lens))
    assert out.shape == q.shape and out.dtype == torch.float32
    ref = jda._decode_attention_pallas_paged_multi(
        jnp.asarray(q.reshape(b, cq, hkv, g, d)), jnp.asarray(ka),
        jnp.asarray(va), jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(q.shape),
                               atol=ATOL, rtol=0)
    xla = jda._paged_multi_xla(jnp.asarray(q), jnp.asarray(ka),
                               jnp.asarray(va), jnp.asarray(tables),
                               jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("cq", [1, 5])
def test_paged_multi_int8_matches_pallas(cq, g):
    q, ka, va, tables, lens = _multi_case(7 + cq + g, cq, g, 8)
    b, _, hq, d = q.shape
    hkv = hq // g
    planes = []
    for a in (ka, va):
        f = a.reshape(a.shape[0], a.shape[1], hkv, d)
        codes, sc = jgen.quantize_kv_heads(jnp.asarray(f))
        planes.append((np.asarray(codes).reshape(a.shape), np.asarray(sc)))
    (kc, ks), (vc, vs) = planes
    out = tda.decode_attention_paged_multi(
        _t(q), _t(kc), _t(vc), _t(tables), _t(lens),
        kv_scales=(_t(ks), _t(vs)))
    ref = jda._decode_attention_pallas_paged_multi_q(
        jnp.asarray(q.reshape(b, cq, hkv, g, d)), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(q.shape),
                               atol=ATOL, rtol=0)
    xla = jda.decode_attention_paged_multi(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(lens),
        kv_scales=(jnp.asarray(ks), jnp.asarray(vs)))
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATOL,
                               rtol=0)


def test_paged_multi_ignores_everything_past_each_frontier():
    """Setting every slot past a row's last query frontier to 1e6 leaves
    the output bit-identical, and a query's output does not depend on
    the width it rides in (column c of a C=5 call equals the C=c+1
    call's last column)."""
    cq, g, blk_len = 5, 4, 8
    q, ka, va, tables, lens = _multi_case(3, cq, g, blk_len)
    out = tda.decode_attention_paged_multi(_t(q[:2]), _t(ka), _t(va),
                                           _t(tables[:2]), _t(lens[:2]))
    ka2, va2 = ka.copy(), va.copy()
    used = set()
    for i in range(2):
        for s in range(int(lens[i]) + cq):
            used.add((int(tables[i, min(s // blk_len, 3)]), s % blk_len))
    for blk in range(ka.shape[0]):
        for off in range(blk_len):
            if (blk, off) not in used:
                ka2[blk, off] = 1e6
                va2[blk, off] = 1e6
    out2 = tda.decode_attention_paged_multi(_t(q[:2]), _t(ka2), _t(va2),
                                            _t(tables[:2]), _t(lens[:2]))
    assert torch.equal(out, out2)
    narrow = tda.decode_attention_paged_multi(
        _t(q[:2, :3]), _t(ka), _t(va), _t(tables[:2]), _t(lens[:2]))
    np.testing.assert_allclose(narrow.numpy(), out[:, :3].numpy(), atol=ATOL,
                               rtol=0)


def test_paged_prefix_attention_is_the_multi_plain_version():
    q, ka, va, tables, lens = _multi_case(5, 3, 4, 8)
    a = tda.paged_prefix_attention(_t(q), _t(ka), _t(va), _t(tables),
                                   _t(lens))
    b = tda.decode_attention_paged_multi_plain(_t(q), _t(ka), _t(va),
                                               _t(tables), _t(lens))
    assert torch.equal(a, b)


@pytest.mark.parametrize("s", [16, 13])
@pytest.mark.parametrize("g", [1, 4])
def test_dense_decode_matches_pallas_and_xla(s, g):
    rng = np.random.default_rng(s * 10 + g)
    b, hkv, d = 3, 2, 64
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    shape = jda.cache_shape(b, hkv, s, d)
    assert shape == tda.cache_shape(b, hkv, s, d) == (b, s, hkv * d)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    lens = np.array([0, s // 2, s - 1], np.int32)
    out = tda.decode_attention(_t(q), _t(kc), _t(vc), _t(lens))
    assert out.shape == (b, hkv * g * d)
    ref = jda._decode_attention_pallas(
        jnp.asarray(q.reshape(b, hkv, g, d)), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(lens), chunk=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(b, -1),
                               atol=ATOL, rtol=0)
    xla = jda._decode_attention_xla(jnp.asarray(q.reshape(b, hkv, g, d)),
                                    jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(xla).reshape(b, -1),
                               atol=ATOL, rtol=0)


def test_dense_decode_unpacked_matches_jax_entry_point():
    """The tiny model's geometry (H_kv=2, D=16: the unpacked [B, S, H, D]
    cache) through both packages' public ``decode_attention``."""
    rng = np.random.default_rng(4)
    b, hkv, g, d, s = 2, 2, 2, 16, 11
    shape = tda.cache_shape(b, hkv, s, d)
    assert shape == jda.cache_shape(b, hkv, s, d) == (b, s, hkv, d)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    lens = np.array([4, 10], np.int32)
    out = tda.decode_attention(_t(q), _t(kc), _t(vc), _t(lens))
    ref = jda.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_wrappers_take_plain_versions_on_cpu_and_refuse_other_devices():
    q, ka, va, tables, lens = _multi_case(6, 3, 4, 8)
    before = (tda.KERNEL_MULTI.launches, tda.KERNEL_MULTI_INT8.launches,
              tda.KERNEL_DENSE.launches)
    tda.decode_attention_paged_multi(_t(q), _t(ka), _t(va), _t(tables),
                                     _t(lens))
    kc = torch.randn(3, 16, 128, generator=torch.Generator().manual_seed(0))
    tda.decode_attention(_t(q[:, 0]), kc, kc, _t(lens.clip(0, 15)))
    assert (tda.KERNEL_MULTI.launches, tda.KERNEL_MULTI_INT8.launches,
            tda.KERNEL_DENSE.launches) == before
    meta = torch.empty(q.shape, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tda.decode_attention_paged_multi(meta, _t(ka), _t(va), _t(tables),
                                         _t(lens))
    with pytest.raises(ValueError, match="unsupported device"):
        tda.decode_attention(meta[:, 0], kc, kc, _t(lens))


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_verify_scatter_bit_exact(int8):
    """Row 0 writes 3 valid columns across a block edge, row 1 writes 3 of
    4 columns with its span past the table (the clamp sends position
    mb*L to the last block's offset 0), row 2 is outside spec mode
    (n_valid 0); trash-routed columns land in the trash row, which is
    left out of the comparison (duplicate writes may pick any writer)."""
    rng = np.random.default_rng(9 + int8)
    b, c, hkv, d, blk_len, mb, nb = 3, 4, 2, 16, 4, 3, 8
    shape = jda.paged_arena_shape(nb + 1, hkv, blk_len, d)
    tables = np.array([[1, 4, 8], [2, 5, 7], [8, 8, 8]], np.int32)
    lens = np.array([2, mb * blk_len - 2, 5], np.int32)
    n_valid = np.array([3, 3, 0], np.int32)
    new = rng.standard_normal((b, c, hkv, d)).astype(np.float32)
    if int8:
        arena = np.zeros(shape, np.int8)
        scales = np.zeros(jda.paged_scale_shape(nb + 1, hkv, blk_len),
                          np.float32)
        ja, js = jgen.paged_verify_scatter_q(
            jnp.asarray(arena), jnp.asarray(scales), jnp.asarray(tables),
            jnp.asarray(lens), jnp.asarray(n_valid), jnp.asarray(new))
        ta, ts = tgen.paged_verify_scatter_q(
            _t(arena), _t(scales), _t(tables), _t(lens), _t(n_valid),
            _t(new))
        np.testing.assert_array_equal(ts.numpy()[:nb], np.asarray(js)[:nb])
    else:
        arena = rng.standard_normal(shape).astype(np.float32)
        ja = jgen.paged_verify_scatter(
            jnp.asarray(arena), jnp.asarray(tables), jnp.asarray(lens),
            jnp.asarray(n_valid), jnp.asarray(new))
        ta = tgen.paged_verify_scatter(_t(arena), _t(tables), _t(lens),
                                       _t(n_valid), _t(new))
    np.testing.assert_array_equal(ta.numpy()[:nb], np.asarray(ja)[:nb])
    # the clamped column landed in the last table block at offset 0
    tb, to = tgen._paged_verify_route(ta, _t(tables), _t(lens), _t(n_valid),
                                      c)
    assert (int(tb[1, 2]), int(to[1, 2])) == (7, 0)
    assert (tb[2] == nb).all() and (tb[1, 3:] == nb).all()


def test_dense_cache_helpers_bit_exact():
    rng = np.random.default_rng(12)
    nl, b, s, hkv, d = 2, 2, 9, 2, 16
    jk = jgen.init_kv_cache(nl, b, s, hkv, d, jnp.float32)
    tk = tgen.init_kv_cache(nl, b, s, hkv, d, torch.float32, "cpu")
    assert [tuple(a.shape) for e in tk for a in e] == \
        [tuple(a.shape) for e in jk for a in e]
    plane = rng.standard_normal((b, 5, hkv, d)).astype(np.float32)
    jc = jgen.cache_prefill_write(jk[0][0], jnp.asarray(plane))
    tc = tgen.cache_prefill_write(tk[0][0], _t(plane))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    row = rng.standard_normal((b, hkv, d)).astype(np.float32)
    lens = np.array([5, 8], np.int32)
    jc = jgen.cache_scatter(jc, jnp.asarray(lens), jnp.asarray(row))
    tc = tgen.cache_scatter(tc, _t(lens), _t(row))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _contexts(seed, n=60):
    """Seeded random contexts over a small vocabulary (so n-grams recur),
    with repeated runs, constant runs and short contexts mixed in."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(1, 40))
        vocab = int(rng.integers(2, 12))
        ctx = rng.integers(0, vocab, (length,)).astype(np.int32)
        if i % 5 == 0:
            ctx = np.tile(ctx[:4], 6)
        if i % 7 == 0:
            ctx = np.full((length,), 3, np.int32)
        out.append(ctx)
    return out


@pytest.mark.parametrize("ngram", [(3, 1), (2, 2), (4, 1)])
def test_ngram_drafter_equals_jax(ngram):
    jd = jspec.NGramDrafter(*ngram)
    td = tspec.NGramDrafter(*ngram)
    for ctx in _contexts(sum(ngram)):
        for k in (0, 1, 3, 6):
            got, want = td.propose(ctx, k), jd.propose(ctx, k)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="min_ngram"):
        tspec.NGramDrafter(max_ngram=1, min_ngram=2)


def test_accept_drafts_equals_jax():
    rng = np.random.default_rng(21)
    for _ in range(300):
        k = int(rng.integers(0, 6))
        greedy = rng.integers(0, 4, (k + 1,)).astype(np.int32)
        drafts = greedy[:k].copy()
        cut = int(rng.integers(0, k + 1))
        if cut < k:
            drafts[cut] = (drafts[cut] + 1) % 4         # first mismatch
        for eos in (None, 2):
            got = tspec.accept_drafts(greedy, drafts, eos)
            assert got == jspec.accept_drafts(greedy, drafts, eos)
    # EOS inside the accepted drafts stops acceptance there
    assert tspec.accept_drafts([5, 2, 7], [5, 2], eos_token_id=2) == \
        ([5, 2], 2)
