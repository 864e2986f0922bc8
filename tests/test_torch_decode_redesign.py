"""The contracts that the port's one-token decode kernels rest on, held on
the CPU: the paged decode (``csrc/paged_decode_attention.cu``) and the
dense decode (``csrc/decode_attention.cu``) are the split-K template of
``csrc/decode_split.cuh``, the paged one at C = 1 of the verify kernel.

- The split plans are functions of the cache geometry alone: the paged
  decode takes ``verify_split_plan(max_blocks, L)``, the dense decode
  ``decode_split_plan(S, chunk)``; neither sees the batch, so a row's
  split boundaries, and so its output bits, do not depend on the batch.
- Split-K merged as the kernels merge it (per split: running max,
  denominator, unnormalized accumulator over the split's blocks, P in
  q's dtype; the merge weights a row's splits by exp(m_s - max m) and
  reads only the splits its walk reaches), in float32, is the plain
  version and the JAX package's Pallas kernel in interpret mode
  (``_decode_attention_pallas_paged``, ``_decode_attention_pallas``):
  ``atol 1e-5`` (the same fp32 math in another order).  Cases: ragged
  lens with frontiers mid-block, lens 0, an all-trash row with lens past
  its table, S not a multiple of the 16-slot chunk, lens past S.
- The emulated split-K gives a row the same bits at B=1 and inside a
  batch.
- The int8 one-token decode is the verify kernel's int8 path at C = 1:
  the same split-K emulation, each block dequantized as code x scale in
  fp32 rounded to q's dtype, against its plain version and
  ``_paged_kernel_q`` in interpret mode; its wrapper hands the kernel the
  verify plan at C = 1.
- The operand checks refuse what the template cannot take: head dims
  outside {32, 64, 128, 256} (the int8 kernel's too), more than 512
  threads a CTA.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu_torch.ops import decode_attention as tda

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


# ---- the split plans ----

@pytest.mark.parametrize("s", [516, 512, 37, 16, 1, 4096])
def test_decode_split_plan_depends_on_cache_length_only(s):
    cps, n_splits = tda.decode_split_plan(s, 16)
    assert cps == 4                      # 64-slot splits of 16-slot chunks
    n_chunks = -(-s // 16)
    assert (n_splits - 1) * cps < n_chunks <= n_splits * cps
    for b in (1, 8):
        part = tda.split_partials(b, 8, n_splits, 4, 128, "cpu")
        assert part.shape == (b, 8, n_splits, 4, 128 + 4)
        assert part.dtype == torch.float32
    # 8-slot chunks: 8 chunks, still 64 slots, a split
    n8 = -(-s // 8)
    assert tda.decode_split_plan(s, 8) == (8, -(-n8 // 8))


@pytest.mark.parametrize("max_blocks,blk_len", [(128, 16), (64, 16),
                                                (5, 8)])
def test_one_token_paged_plan_is_the_verify_plan_at_c1(max_blocks, blk_len):
    """The one-token paged decode walks the verify kernel's splits: the
    plan depends on the table width and L, never on C or the batch."""
    bps, n_splits = tda.verify_split_plan(max_blocks, blk_len)
    assert bps == 128 // blk_len
    for b in (1, 8):
        part = tda.verify_partials(b, 1, 8, 4, 128, max_blocks, blk_len,
                                   "cpu")
        assert part.shape == (b, 8, n_splits, 4, 128 + 4)


# ---- split-K as the kernels run it ----

def _split_merge(q, kv_block, first, n_blocks, blk_len, per_split):
    """The split and merge kernels in plain torch over the whole batch at
    once: ``kv_block(j)`` gives block j of every row as ([B, L, Hkv, D]
    K, V) with slots a row does not own zero-filled, ``first`` [B] the
    frontier of each row's query, ``n_blocks`` [B] the blocks each row
    walks, ``per_split`` blocks a split.  q: [B, Hq, D]; returns
    [B, Hq * D]."""
    b, hq, d = q.shape
    n_splits = -(-int(n_blocks.max()) // per_split)
    parts = []
    for s in range(n_splits):
        js = range(s * per_split, (s + 1) * per_split)
        k = torch.cat([kv_block(j)[0] for j in js], 1)   # [B, n, Hkv, D]
        v = torch.cat([kv_block(j)[1] for j in js], 1)
        hkv = k.shape[2]
        qq = q.reshape(b, hkv, hq // hkv, 1, d)
        kk = k.permute(0, 2, 1, 3)[:, :, None]             # [B,Hkv,1,n,D]
        vv = v.permute(0, 2, 1, 3)[:, :, None]
        logits = (qq * kk).sum(-1) / math.sqrt(d)          # [B,Hkv,G,n]
        slot = s * per_split * blk_len + torch.arange(k.shape[1])
        walked = (torch.tensor(list(js))[None, :] < n_blocks[:, None]) \
            .repeat_interleave(blk_len, 1)                  # [B, n]
        keep = walked & (slot[None, :] <= first[:, None])
        logits = logits.masked_fill(~keep[:, None, None, :], float("-inf"))
        m = logits.amax(-1)
        p = torch.where(torch.isinf(m)[..., None], torch.zeros_like(logits),
                        torch.exp(logits - m[..., None]))
        acc = (p.to(q.dtype)[..., None] * vv).sum(-2)      # [B,Hkv,G,D]
        parts.append((m, p.sum(-1), acc,
                      s * per_split < n_blocks))            # row reaches s
    mx = torch.stack([torch.where(r[:, None, None], m, -math.inf)
                      for m, _, _, r in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc, reach in parts:
        w = torch.where(torch.isinf(m) | ~reach[:, None, None],
                        torch.zeros_like(m), torch.exp(m - mx))
        num = num + w[..., None] * acc
        den = den + w * l
    return (num / den[..., None]).to(q.dtype).reshape(b, hq * d)


def _paged_split_merge(q, k_arena, v_arena, tables, lens, kv_scales=None):
    """The one-token paged kernel: block j of row b is arena row
    tables[b, j] clamped into the arena, a row walks min(lens / L + 1,
    max_blocks) blocks in splits of ``verify_split_plan``.  An int8 cache
    (``kv_scales`` given) stages each block dequantized as the kernel's
    int8 path does: code x scale in fp32, rounded to q's dtype."""
    blk_len, mb = k_arena.shape[1], tables.shape[1]
    d = q.shape[-1]
    hkv = k_arena[0, 0].numel() // d
    bps, _ = tda.verify_split_plan(mb, blk_len)
    lens = lens.long()
    n_blocks = torch.clamp(lens // blk_len + 1, max=mb)

    def staged(arena, scales, rows):
        blk = arena[rows].reshape(-1, blk_len, hkv, d)
        if scales is None:
            return blk
        return (blk.float() * scales[rows][..., None]).to(q.dtype)

    def kv_block(j):
        if j >= mb:
            z = torch.zeros(q.shape[0], blk_len, hkv, d, dtype=q.dtype)
            return z, z
        rows = tables[:, j].long().clamp(0, k_arena.shape[0] - 1)
        ks, vs = kv_scales if kv_scales is not None else (None, None)
        return staged(k_arena, ks, rows), staged(v_arena, vs, rows)

    return _split_merge(q, kv_block, lens, n_blocks, blk_len, bps)


def _dense_split_merge(q, k_cache, v_cache, lens):
    """The dense kernel: block j of row b is the chunk of slots 16 j ..
    16 j + 15 of its cache, slots >= S zero-filled; the frontier is
    min(lens, S - 1); splits of ``decode_split_plan(S)`` chunks."""
    b, s = k_cache.shape[:2]
    d = q.shape[-1]
    hkv = k_cache[0, 0].numel() // d
    chunk = 16
    cps, _ = tda.decode_split_plan(s, chunk)
    first = torch.clamp(lens.long(), max=s - 1)
    kc = k_cache.reshape(b, s, hkv, d)
    vc = v_cache.reshape(b, s, hkv, d)
    pad = -(-s // (chunk * cps)) * chunk * cps - s
    z = torch.zeros(b, pad, hkv, d, dtype=q.dtype)
    kc, vc = torch.cat([kc, z], 1), torch.cat([vc, z], 1)

    def kv_block(j):
        sl = slice(j * chunk, (j + 1) * chunk)
        return kc[:, sl], vc[:, sl]

    return _split_merge(q, kv_block, first, first // chunk + 1, chunk, cps)


def _paged_case(seed, g, blk_len, hkv=2, d=64, mb=6):
    """Five rows over a packed arena with a random (finite) trash row:
    ragged lens with frontiers mid-block, one at a block's last slot,
    lens 0, the full table, and a vacant row (all-trash table, lens past
    the table)."""
    rng = np.random.default_rng(seed)
    lens = np.array([3 * blk_len + 5, blk_len - 1, 0, mb * blk_len - 1,
                     mb * blk_len + 7], np.int32)
    need = [min(n // blk_len + 1, mb) for n in lens[:4]]
    nb = sum(need) + 2
    perm = rng.permutation(nb)
    tables = np.full((5, mb), nb, np.int32)
    used = 0
    for i, k in enumerate(need):
        tables[i, :k] = perm[used:used + k]
        used += k
    shape = jda.paged_arena_shape(nb + 1, hkv, blk_len, d)
    ka = rng.standard_normal(shape).astype(np.float32)
    va = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((5, hkv * g, d)).astype(np.float32)
    return q, ka, va, tables, lens


@pytest.mark.parametrize("g,blk_len", [(4, 16), (1, 16), (4, 8)])
def test_paged_split_merge_matches_plain_and_pallas(g, blk_len):
    q, ka, va, tables, lens = _paged_case(g * 100 + blk_len, g, blk_len)
    b, hq, d = q.shape
    got = _paged_split_merge(_t(q), _t(ka), _t(va), _t(tables), _t(lens))
    plain = tda.decode_attention_paged(_t(q), _t(ka), _t(va), _t(tables),
                                       _t(lens))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                               rtol=0)
    hkv = ka.shape[2] // d
    ref = jda._decode_attention_pallas_paged(
        jnp.asarray(q.reshape(b, hkv, g, d)), jnp.asarray(ka),
        jnp.asarray(va), jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(b, -1),
                               atol=ATOL, rtol=0)
    assert torch.isfinite(got).all()


def _int8_paged_case(seed, g, blk_len, hkv=2, d=64, mb=6):
    """``_paged_case``'s rows and tables over an int8 cache: the float
    arenas quantized per entry per kv head (``quantize_kv_heads``), the
    trash row included."""
    from paddle_tpu_torch.models.generation import quantize_kv_heads
    q, ka, va, tables, lens = _paged_case(seed, g, blk_len, hkv, d, mb)
    planes = []
    for a in (ka, va):
        codes, sc = quantize_kv_heads(_t(a).reshape(a.shape[0], blk_len,
                                                    hkv, d))
        planes.append((codes.reshape(a.shape).numpy(), sc.numpy()))
    (kc, ks), (vc, vs) = planes
    return q, kc, vc, ks, vs, tables, lens


@pytest.mark.parametrize("g,blk_len", [(4, 16), (1, 16), (4, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_paged_split_merge_matches_plain_and_pallas(g, blk_len, dtype):
    """The int8 one-token decode on the template: the K-wide verify's int8
    path at C = 1, split-K over the verify plan, against its plain version
    (float32 ``atol 1e-5``; bfloat16 one ulp plus ``atol 2^-5`` of the
    row's RMS, as ``chip_smoke.DECODE_INT8_TOL``: P is rounded to bf16
    against the split's running max, the plain version rounds the
    normalized P) and against ``_paged_kernel_q`` in interpret mode."""
    q, kc, vc, ks, vs, tables, lens = _int8_paged_case(g * 10 + blk_len, g,
                                                       blk_len)
    b, hq, d = q.shape
    qt = _t(q).to(dtype)
    scales = (_t(ks), _t(vs))
    got = _paged_split_merge(qt, _t(kc), _t(vc), _t(tables), _t(lens),
                             scales)
    plain = tda.decode_attention_paged(qt, _t(kc), _t(vc), _t(tables),
                                       _t(lens), kv_scales=scales)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    g32, p32 = got.float().numpy(), plain.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(g32, p32, atol=ATOL, rtol=0)
    else:
        rms = np.sqrt((p32.reshape(b, hq, d) ** 2).mean(-1, keepdims=True))
        err = np.abs(g32 - p32).reshape(b, hq, d)
        assert np.all(err <= 2.0 ** -5 * rms
                      + 2.0 ** -7 * np.abs(p32.reshape(b, hq, d)))
    hkv = kc.shape[2] // d
    ref = jda._decode_attention_pallas_paged_q(
        jnp.asarray(q.reshape(b, hkv, g, d)), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(tables), jnp.asarray(lens))
    if dtype == torch.float32:
        np.testing.assert_allclose(g32, np.asarray(ref).reshape(b, -1),
                                   atol=ATOL, rtol=1e-5)


def test_int8_paged_split_merge_row_bits_do_not_depend_on_batch():
    q, kc, vc, ks, vs, tables, lens = _int8_paged_case(3, 4, 16)
    scales = (_t(ks), _t(vs))
    full = _paged_split_merge(_t(q), _t(kc), _t(vc), _t(tables), _t(lens),
                              scales)
    for i in range(q.shape[0]):
        row = _paged_split_merge(_t(q[i:i + 1]), _t(kc), _t(vc),
                                 _t(tables[i:i + 1]), _t(lens[i:i + 1]),
                                 scales)
        assert torch.equal(row[0], full[i])


@pytest.mark.parametrize("int8", [False, True])
def test_one_token_wrappers_launch_the_verify_plan_at_c1(monkeypatch, int8):
    """What the CUDA wrapper of the one-token paged decode hands its
    kernel, float or int8 cache: the verify kernel's split plan and a
    scratch of its partials at C = 1 (run on CPU tensors with the launch
    captured)."""
    q, kc, vc, ks, vs, tables, lens = _int8_paged_case(4, 4, 16)
    if int8:
        args, scales, kern = (_t(kc), _t(vc)), (_t(ks), _t(vs)), \
            tda.KERNEL_INT8
    else:
        _, ka, va, _, _ = _paged_case(4, 4, 16)
        args, scales, kern = (_t(ka), _t(va)), None, tda.KERNEL
    seen = []
    monkeypatch.setattr(kern, "launch", lambda *a: seen.append(a))
    monkeypatch.setattr(tda._build, "stream_ptr",
                        lambda t: ctypes.c_void_p(None))
    out = tda._decode_attention_paged_cuda(_t(q), *args, _t(tables),
                                           _t(lens), scales)
    assert out.shape == (5, q.shape[1] * q.shape[2]) and len(seen) == 1
    n_ptr = 9 if int8 else 7
    part = seen[0][n_ptr - 1]
    b, hkv, g, d, blk_len, mb, num_rows, bps, n_splits = \
        seen[0][n_ptr:n_ptr + 9]
    assert (bps, n_splits) == tda.verify_split_plan(mb, blk_len)
    assert (b, hkv, g, d, blk_len, mb) == (5, 2, 4, 64, 16, 6)
    assert part.value is not None and num_rows == args[0].shape[0]


@pytest.mark.parametrize("s,g", [(37, 4), (64, 1), (100, 4)])
def test_dense_split_merge_matches_plain_and_pallas(s, g):
    """S not a multiple of the 16-slot chunk (37, 100) and a multiple
    (64); lens 0, mid-chunk, the last slot and past S (clamped)."""
    rng = np.random.default_rng(s * 10 + g)
    b, hkv, d = 4, 2, 64
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    shape = tda.cache_shape(b, hkv, s, d)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    lens = np.array([0, s // 2 + 3, s - 1, s + 20], np.int32)
    got = _dense_split_merge(_t(q), _t(kc), _t(vc), _t(lens))
    plain = tda.decode_attention(_t(q), _t(kc), _t(vc), _t(lens))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                               rtol=0)
    ref = jda._decode_attention_pallas(
        jnp.asarray(q.reshape(b, hkv, g, d)), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(b, -1),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("walk", ["paged", "dense"])
def test_split_merge_row_bits_do_not_depend_on_batch(walk):
    if walk == "paged":
        q, ka, va, tables, lens = _paged_case(5, 4, 16)
        full = _paged_split_merge(_t(q), _t(ka), _t(va), _t(tables),
                                  _t(lens))

        def row(i):
            return _paged_split_merge(_t(q[i:i + 1]), _t(ka), _t(va),
                                      _t(tables[i:i + 1]), _t(lens[i:i + 1]))
    else:
        rng = np.random.default_rng(9)
        s, b = 100, 4
        q = rng.standard_normal((b, 8, 64)).astype(np.float32)
        kc = rng.standard_normal((b, s, 128)).astype(np.float32)
        vc = rng.standard_normal((b, s, 128)).astype(np.float32)
        lens = np.array([99, 0, 40, 300], np.int32)
        full = _dense_split_merge(_t(q), _t(kc), _t(vc), _t(lens))

        def row(i):
            sl = slice(i, i + 1)
            return _dense_split_merge(_t(q[sl]), _t(kc[sl]), _t(vc[sl]),
                                      _t(lens[sl]))
    for i in range(q.shape[0]):
        assert torch.equal(row(i)[0], full[i])


# ---- what the template cannot take ----

def _paged_operands(d, g=2, hkv=2, blk_len=4, dtype=torch.float32):
    q = torch.zeros(2, hkv * g, d, dtype=dtype)
    ka = torch.zeros(7, blk_len, hkv * d, dtype=dtype)
    return (q, ka, torch.zeros_like(ka), torch.zeros(2, 3, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32))


def _dense_operands(d, g=2, hkv=2, s=20, dtype=torch.float32):
    q = torch.zeros(2, hkv * g, d, dtype=dtype)
    kc = torch.zeros(2, s, hkv * d, dtype=dtype)
    return q, kc, torch.zeros_like(kc), torch.zeros(2, dtype=torch.int32)


@pytest.mark.parametrize("d", [16, 48, 80, 512])
def test_split_checks_refuse_head_dims_outside_the_template(d):
    with pytest.raises(ValueError, match="head_dim in"):
        tda._check_operands(*_paged_operands(d))
    with pytest.raises(ValueError, match="head_dim in"):
        tda._check_dense(*_dense_operands(d))
    # the int8 one-token kernel is the template's too (before, D % 16)
    args = _paged_operands(d)
    codes = [a.to(torch.int8) for a in args[1:3]]
    sc = tuple(torch.zeros(7, 4, 2) for _ in range(2))
    with pytest.raises(ValueError, match="head_dim in"):
        tda._check_operands(args[0], *codes, *args[3:], kv_scales=sc)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_split_checks_take_the_template_head_dims(d):
    assert tda._check_operands(*_paged_operands(d)) == (2, 4, d, 2, 2)
    assert tda._check_dense(*_dense_operands(d)) == (2, 4, d, 2, 2)
    bf = _paged_operands(d, g=16, blk_len=16, dtype=torch.bfloat16)
    assert tda._check_operands(*bf) == (2, 32, d, 2, 16)


def test_split_checks_refuse_too_many_threads():
    """float32 runs D/16 lanes per query row: G=64 at D=256 would need
    1024 threads; bfloat16 two warps per 16 rows: G=144 needs 640."""
    with pytest.raises(ValueError, match="threads"):
        tda._check_dense(*_dense_operands(256, g=64))
    with pytest.raises(ValueError, match="threads"):
        tda._check_operands(*_paged_operands(128, g=144,
                                             dtype=torch.bfloat16))
    assert tda._check_dense(*_dense_operands(256, g=32))[4] == 32
