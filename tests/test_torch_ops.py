"""The port's kernel modules held against the JAX package on the CPU.

The same numpy inputs go through the JAX function and the port's
counterpart.  On the CPU the port's wrappers run their plain versions;
the JAX side runs its Pallas kernels in interpret mode (as its own tests
do) or its gather-based XLA path.  Tolerances: float32 ``atol 1e-4`` for
attention (sums in a different order), ``1e-5`` for RMSNorm, and one
bfloat16 ULP for RMSNorm in bfloat16 (both round one fp32 result).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import generation as jgen
from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu.ops.pallas import rms_norm as jrn
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import rms_norm as trn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _within_one_bf16_ulp(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30)))
                                    - 7), 0.0)
    return bool(np.all(np.abs(a - b) <= ulp))


@pytest.mark.parametrize("n,d", [(16, 128), (32, 256)])
def test_rms_norm_matches_pallas_kernel(n, d):
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    ref = np.asarray(jrn._rms_fwd_impl(jnp.asarray(x), jnp.asarray(w), 1e-5))
    out = trn.rms_norm(_t(x), _t(w), 1e-5).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    refb = jrn._rms_fwd_impl(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16), 1e-5)
    outb = trn.rms_norm(_t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16),
                        1e-5)
    assert outb.dtype == torch.bfloat16
    assert _within_one_bf16_ulp(outb.float().numpy(),
                                np.asarray(refb).astype(np.float32))


def test_rms_norm_plain_is_the_wrapper_on_cpu():
    x = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(0))
    w = torch.rand(64, generator=torch.Generator().manual_seed(1))
    assert torch.equal(trn.rms_norm(x, w, 1e-6),
                       trn.rms_norm_plain(x, w, 1e-6))
    assert trn.KERNEL.launches == 0


def _paged_case(seed, b, hkv, g, blk_len, nb, mb, d, lens):
    """Random q and arenas (trash row included) with per-row tables:
    each row owns ceil((lens+1)/L) distinct blocks, the rest of its
    table points at the trash row ``nb``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    shape = jda.paged_arena_shape(nb + 1, hkv, blk_len, d)
    ka = rng.standard_normal(shape).astype(np.float32)
    va = rng.standard_normal(shape).astype(np.float32)
    perm = rng.permutation(nb)
    tables = np.full((b, mb), nb, np.int32)
    used = 0
    for i, ln in enumerate(lens):
        k = min(ln // blk_len + 1, mb)
        tables[i, :k] = perm[used:used + k]
        used += k
    return q, ka, va, tables, np.asarray(lens, np.int32)


# (b, hkv, g, L, nb, mb, d, lens): the geometry of the JAX kernel tests,
# the 8B head geometry (Hkv=8, G=4, D=128, L=16), and the tiny model's
# unpacked [NB+1, L, H, D] arena (which the Pallas kernel does not take)
_GEOMS = {
    "pallas_small": (3, 2, 2, 8, 12, 4, 64, [5, 17, 30]),
    "llama8b_heads": (2, 8, 4, 16, 10, 4, 128, [9, 47]),
    "tiny_unpacked": (3, 2, 2, 4, 12, 4, 16, [2, 7, 14]),
}


@pytest.mark.parametrize("geom", ["pallas_small", "llama8b_heads"])
def test_paged_decode_matches_pallas_kernel(geom):
    b, hkv, g, blk_len, nb, mb, d, lens = _GEOMS[geom]
    q, ka, va, tables, lens = _paged_case(1, b, hkv, g, blk_len, nb, mb, d,
                                          lens)
    ref = jda._decode_attention_pallas_paged(
        jnp.asarray(q.reshape(b, hkv, g, d)), jnp.asarray(ka),
        jnp.asarray(va), jnp.asarray(tables), jnp.asarray(lens))
    out = tda.decode_attention_paged(_t(q), _t(ka), _t(va), _t(tables),
                                     _t(lens))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref).reshape(b, -1),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("geom", sorted(_GEOMS))
def test_paged_decode_matches_gather_path(geom):
    b, hkv, g, blk_len, nb, mb, d, lens = _GEOMS[geom]
    q, ka, va, tables, lens = _paged_case(2, b, hkv, g, blk_len, nb, mb, d,
                                          lens)
    ref = jda.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
        jnp.asarray(tables), jnp.asarray(lens))
    out = tda.decode_attention_paged(_t(q), _t(ka), _t(va), _t(tables),
                                     _t(lens))
    assert out.shape == (b, hkv * g * d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_paged_decode_ignores_garbage_beyond_lens():
    b, hkv, g, blk_len, nb, mb, d, lens = _GEOMS["llama8b_heads"]
    q, ka, va, tables, lens = _paged_case(3, b, hkv, g, blk_len, nb, mb, d,
                                          lens)
    out1 = tda.decode_attention_paged(_t(q), _t(ka), _t(va), _t(tables),
                                      _t(lens))
    ka2, va2 = ka.copy(), va.copy()
    for i, ln in enumerate(lens):
        for s in range(ln + 1, mb * blk_len):
            blk = tables[i, s // blk_len]
            ka2[blk, s % blk_len] = 1e6
            va2[blk, s % blk_len] = -1e6
    ka2[nb] = 1e6          # the trash row too
    va2[nb] = -1e6
    out2 = tda.decode_attention_paged(_t(q), _t(ka2), _t(va2), _t(tables),
                                      _t(lens))
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())


@pytest.mark.parametrize("geom", ["tiny_unpacked", "llama8b_heads"])
def test_paged_prefix_attention_matches_jax(geom):
    b, hkv, g, blk_len, nb, mb, d, _ = _GEOMS[geom]
    c = 5
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, c, hkv * g, d)).astype(np.float32)
    shape = jda.paged_arena_shape(nb + 1, hkv, blk_len, d)
    ka = rng.standard_normal(shape).astype(np.float32)
    va = rng.standard_normal(shape).astype(np.float32)
    tables = rng.permutation(nb)[:mb].astype(np.int32)[None, :]
    start = np.asarray([blk_len + 1], np.int32)     # mid-block chunk start
    ref = jda.paged_prefix_attention(jnp.asarray(q), jnp.asarray(ka),
                                     jnp.asarray(va), jnp.asarray(tables),
                                     jnp.asarray(start))
    out = tda.paged_prefix_attention(_t(q), _t(ka), _t(va), _t(tables),
                                     _t(start))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("geom", ["tiny_unpacked", "llama8b_heads"])
def test_paged_scatters_bit_equal(geom):
    """Decode and chunk scatters land the same bytes at the same arena
    coordinates, trash routing included (vacant rows and pad positions
    write the trash row; duplicates avoided so the result is defined)."""
    _b, hkv, _g, blk_len, nb, mb, d, _ = _GEOMS[geom]
    rng = np.random.default_rng(5)
    shape = jda.paged_arena_shape(nb + 1, hkv, blk_len, d)
    arena = rng.standard_normal(shape).astype(np.float32)
    # decode: rows 0-1 live, rows 2-3 vacant (all-trash tables, distinct
    # offsets), row 1's lens past its table span (clamped column)
    tables = np.full((4, mb), nb, np.int32)
    tables[0] = [3, 7, 1, 9]
    tables[1] = [2, 0, 5, 4]
    lens = np.asarray([blk_len + 2, mb * blk_len + 1, 0, 1], np.int32)
    new = rng.standard_normal((4, hkv, d)).astype(np.float32)
    ref = jgen.paged_cache_scatter(jnp.asarray(arena), jnp.asarray(tables),
                                   jnp.asarray(lens), jnp.asarray(new))
    out = tgen.paged_cache_scatter(_t(arena.copy()), _t(tables), _t(lens),
                                   _t(new))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # chunk: 6 positions from a mid-block start, the last 2 past n_valid
    c, start, n_valid = 6, blk_len - 1, blk_len + 3
    chunk = rng.standard_normal((c, hkv, d)).astype(np.float32)
    ref = jgen.paged_chunk_scatter(jnp.asarray(arena),
                                   jnp.asarray(tables[:1]),
                                   jnp.asarray(start, jnp.int32),
                                   jnp.asarray(n_valid, jnp.int32),
                                   jnp.asarray(chunk))
    out = tgen.paged_chunk_scatter(_t(arena.copy()), _t(tables[:1]), start,
                                   n_valid, _t(chunk))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert not np.array_equal(np.asarray(ref)[nb], arena[nb])


def _rms_bad(case):
    x = torch.zeros(4, 64)
    w = torch.ones(64)
    if case == "int_x":
        return x.int(), w.int(), TypeError
    if case == "mixed_dtype":
        return x, w.to(torch.bfloat16), TypeError
    if case == "weight_shape":
        return x, torch.ones(32), ValueError
    if case == "width_not_8":
        return torch.zeros(4, 12), torch.ones(12), ValueError
    if case == "non_contiguous":
        return torch.zeros(64, 4).t(), w, ValueError
    if case == "misaligned":
        return torch.zeros(4 * 64 + 1)[1:].view(4, 64), w, ValueError
    return x, w, None


@pytest.mark.parametrize("case", ["ok", "int_x", "mixed_dtype",
                                  "weight_shape", "width_not_8",
                                  "non_contiguous", "misaligned"])
def test_rms_norm_kernel_operand_checks(case):
    """What the CUDA wrapper refuses before any launch (the checks are
    device-independent, so they run here on CPU tensors)."""
    x, w, exc = _rms_bad(case)
    if exc is None:
        assert trn._check_operands(x, w) == 4
        return
    with pytest.raises(exc):
        trn._check_operands(x, w)


def _decode_bad(case):
    b, hkv, g, blk_len, nb, mb, d = 2, 2, 2, 4, 6, 3, 32
    q = torch.zeros(b, hkv * g, d)
    ka = torch.zeros(nb + 1, blk_len, hkv * d)
    va = torch.zeros_like(ka)
    tables = torch.zeros(b, mb, dtype=torch.int32)
    lens = torch.zeros(b, dtype=torch.int32)
    bad = {
        "f64_q": (q.double(), ka, va, tables, lens, TypeError),
        "mixed_dtype": (q, ka.to(torch.bfloat16), va, tables, lens,
                        TypeError),
        "int64_tables": (q, ka, va, tables.long(), lens, TypeError),
        "lens_shape": (q, ka, va, tables, lens[:1], ValueError),
        "head_dim_not_8": (torch.zeros(b, hkv * g, 12),
                           torch.zeros(nb + 1, blk_len, hkv * 12),
                           torch.zeros(nb + 1, blk_len, hkv * 12), tables,
                           lens, ValueError),
        "heads_not_grouped": (torch.zeros(b, 3, d), ka, va, tables, lens,
                              ValueError),
        "non_contiguous": (q, ka, va.transpose(0, 1).contiguous()
                           .transpose(0, 1), tables, lens, ValueError),
        # float32, L=64, D=256: a 3-stage ring of 393216 bytes
        "smem": (torch.zeros(1, 4, 256), torch.zeros(3, 64, 256),
                 torch.zeros(3, 64, 256), torch.zeros(1, 1,
                                                      dtype=torch.int32),
                 torch.zeros(1, dtype=torch.int32), ValueError),
    }
    if case == "ok":
        return q, ka, va, tables, lens, None
    return bad[case]


@pytest.mark.parametrize("case", ["ok", "f64_q", "mixed_dtype",
                                  "int64_tables", "lens_shape",
                                  "head_dim_not_8", "heads_not_grouped",
                                  "non_contiguous", "smem"])
def test_paged_decode_kernel_operand_checks(case):
    *args, exc = _decode_bad(case)
    if exc is None:
        assert tda._check_operands(*args) == (2, 4, 32, 2, 2)
        return
    with pytest.raises(exc):
        tda._check_operands(*args)
