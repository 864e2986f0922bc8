"""The contracts that the port's quantized matmul on the tensor cores
(``csrc/quantized_matmul.cu``, bf16 x) rests on, held on the CPU.

- The split plan (``tc_split_plan``) is a function of K and bits alone:
  the code rows (K, or K/2 packed int4 rows) in mma steps of 16, cut into
  at most 8 pieces, each one mma chain, summed in order 0..P-1.
- A plain-torch mirror of that plan (each piece's partial in fp32, the
  pieces added in order, then the fp32 epilogue) is the JAX package's
  Pallas kernels in interpret mode, int8 and int4, with and without bias
  and with each act, within ``chip_smoke.QMM_TOL`` (float32 ``atol 1e-4,
  rtol 1e-5``; bf16 ``atol 1e-4`` plus one ulp, ``rtol 2^-7``).  Under
  the mirror a row's bits are the same at M = 1, 8, 40 and 256.
- The kernel's register dequantization is exact: the words ldmatrix.trans
  hands a lane pair two k rows of one column in bytes 0 and 2 (and, shifted
  by 8, of the next column), the int8 form (0x4300 | c & 0x7f) + (0xC300 |
  c & 0x80) and the int4 form (0x4300 | v ^ 8) - 136, read as bf16, give
  every code.
- The wrapper hands the kernel the plan: pieces and rows a piece and no
  scratch for bf16 x; K slices and an fp32 scratch for float32 x.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import quantized_matmul as jqmm
from paddle_tpu_torch.ops import quantized_matmul as tqmm
from paddle_tpu_torch.quantization import observers as tobs

# chip_smoke.QMM_TOL: (atol, rtol)
QMM_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-4, 2.0 ** -7)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _case(seed, m, k, n, bits):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    scales = tobs.absmax_to_scales(_t(np.abs(w).max(axis=0)), bits)
    codes = tobs.quantize_channelwise(_t(w), scales, bits)
    if bits == 4:
        codes = tqmm.pack_int4(codes)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, codes.numpy(), scales.numpy(), bias


def _mirror(x, codes, scales, bias=None, act=None, bits=8):
    """The kernel's arithmetic in plain torch: piece p of
    ``tc_split_plan`` covers code rows [p * per, (p + 1) * per) (int4: k
    in those rows and K/2 + those rows); its partial is the exact sum of
    the piece's products (float64: a bf16 x times a code has at most 16
    significant bits, so the sum is exact and any order gives it), rounded
    to fp32 (the one rounding of its mma chain's order that a mirror
    cannot copy); the pieces are added in fp32 in order 0..P-1; then the
    product with the scale and the sum with the bias, each rounded on its
    own, the act and the cast."""
    m, k = x.shape
    rows = k // 2 if bits == 4 else k
    full = tqmm.unpack_int4(codes) if bits == 4 else codes
    pieces, per = tqmm.tc_split_plan(k, bits)
    xd, wd = x.double(), full.double()
    acc = None
    for p in range(pieces):
        r = torch.arange(p * per, min((p + 1) * per, rows))
        ks = torch.cat([r, r + rows]) if bits == 4 else r
        part = (xd[:, ks] @ wd[ks]).float()
        acc = part if acc is None else acc + part
    acc = acc * scales.float()[None, :]
    if bias is not None:
        acc = acc + bias.float()[None, :]
    return tqmm._apply_act(acc, act).to(x.dtype)


EPILOGUES = [(False, None), (True, None), (True, "silu"), (False, "relu"),
             (True, "gelu")]


@pytest.mark.parametrize("k", [2048, 1056])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("with_bias,act", EPILOGUES)
def test_split_mirror_matches_pallas_kernel(k, dtype, bits, with_bias, act):
    """Ragged M = 13, N = 128; K = 2048 (int8: 8 pieces of 256 rows;
    int4: 4 of 256 packed rows) and K = 1056 (int8: a short last piece)."""
    x, codes, scales, bias = _case(k + bits, 13, k, 128, bits)
    b = bias if with_bias else None
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jqmm.quantized_matmul(
        jnp.asarray(x, jdt), jnp.asarray(codes), jnp.asarray(scales),
        bias=None if b is None else jnp.asarray(b), act=act, bits=bits)
    xt = _t(x).to(dtype)
    got = _mirror(xt, _t(codes), _t(scales), None if b is None else _t(b),
                  act, bits)
    assert got.dtype == dtype and got.shape == (13, 128)
    atol, rtol = QMM_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=atol, rtol=rtol)
    # and the plain version the kernel is held to on the card
    plain = tqmm.quantized_matmul(xt, _t(codes), _t(scales),
                                  bias=None if b is None else _t(b),
                                  act=act, bits=bits)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("bits", [8, 4])
def test_split_mirror_row_bits_do_not_depend_on_m(bits):
    """bf16 x at the 8B width K = 4096: the first rows of x at M = 1, 8,
    40 and 256, each launch's rows equal to the same rows of the next."""
    x, codes, scales, bias = _case(40 + bits, 256, 4096, 64, bits)
    xt = _t(x).to(torch.bfloat16)
    outs = {m: _mirror(xt[:m], _t(codes), _t(scales), _t(bias), "silu", bits)
            for m in (1, 8, 40, 256)}
    for small, big in ((1, 8), (8, 40), (40, 256)):
        assert torch.equal(outs[small], outs[big][:small])


@pytest.mark.parametrize("k", [4096, 14336, 1056, 1024, 256, 96, 32])
@pytest.mark.parametrize("bits", [8, 4])
def test_split_plan_depends_on_k_and_bits_alone(k, bits):
    pieces, per = tqmm.tc_split_plan(k, bits)
    rows = k // 2 if bits == 4 else k
    assert 1 <= pieces <= 8 and per % 16 == 0
    assert (pieces - 1) * per < rows <= pieces * per   # no empty piece
    # no more pieces than one for each 16 steps of 16 rows (rounded up)
    assert pieces <= max(1, -(-rows // 256))
    assert tqmm.tc_split_plan(k, bits) == (pieces, per)


def test_split_plan_at_the_8b_projections():
    assert tqmm.tc_split_plan(4096, 8) == (8, 512)
    assert tqmm.tc_split_plan(4096, 4) == (8, 256)
    assert tqmm.tc_split_plan(14336, 8) == (8, 1792)
    assert tqmm.tc_split_plan(14336, 4) == (8, 896)


# ---- the kernel's register dequantization ----

def _bf16(h):
    """A 16-bit pattern read as bf16, as a float."""
    return float(np.array([h << 16], np.uint32).view(np.float32)[0])


def _deq8(r):
    """``deq8``: the int8 codes in bytes 0 and 2 of r, low half first."""
    a, b = (r & 0x007F007F) | 0x43004300, (r & 0x00800080) | 0xC300C300
    return [_bf16((a >> s) & 0xFFFF) + _bf16((b >> s) & 0xFFFF)
            for s in (0, 16)]


def _deq4(r):
    """``deq4``: the int4 codes in the low nibbles of bytes 0 and 2."""
    a = (r & 0x000F000F) ^ 0x43084308
    return [_bf16((a >> s) & 0xFFFF) + _bf16(0xC308) for s in (0, 16)]


def test_register_dequant_is_exact_for_every_code():
    for c in range(-128, 128):
        byte = c & 0xFF
        # every value in between is an integer of at most 9 bits: exact in
        # bf16, so the bf16x2 add rounds nothing
        assert _deq8(byte | (byte << 16)) == [c, c]
    for v in range(16):
        code = (v ^ 8) - 8
        assert _deq4(v | (v << 16)) == [code, code]


def test_ldmatrix_trans_word_gives_two_columns_of_two_k_rows():
    """ldmatrix.trans of a code tile viewed as 16-bit elements hands a
    lane the word (k 2t, n 2g), (2t, 2g+1), (2t+1, 2g), (2t+1, 2g+1) (byte
    0 first): the even bytes are the A register of column 2g (k 2t in the
    low half), the bytes shifted by 8 that of column 2g + 1; int4 takes
    the low nibbles (k = i) and, shifted by 4 more, the high ones (k = K/2
    + i)."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        tile = rng.integers(-128, 128, (2, 2))        # [k 2t..2t+1][n pair]
        b = [int(v) & 0xFF for v in (tile[0, 0], tile[0, 1], tile[1, 0],
                                     tile[1, 1])]
        r = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
        for p in (0, 1):
            assert _deq8(r >> (8 * p)) == [tile[0, p], tile[1, p]]
            lo = [((int(v) & 0xF) ^ 8) - 8 for v in tile[:, p]]
            hi = [(((int(v) >> 4) & 0xF) ^ 8) - 8 for v in tile[:, p]]
            assert _deq4(r >> (8 * p)) == lo
            assert _deq4(r >> (8 * p + 4)) == hi


# ---- what the wrapper hands the kernel ----

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits", [8, 4])
def test_wrapper_passes_the_plan(monkeypatch, dtype, bits):
    x, codes, scales, _ = _case(3, 40, 1024, 256, bits)
    seen = []
    monkeypatch.setattr(tqmm.KERNEL, "launch", lambda *a: seen.append(a))
    monkeypatch.setattr(tqmm._build, "stream_ptr",
                        lambda t: ctypes.c_void_p(None))
    y = tqmm._qmm_cuda(_t(x).to(dtype), _t(codes), _t(scales), dtype, None,
                       None, bits)
    assert y.shape == (40, 256) and y.dtype == dtype and len(seen) == 1
    part, m, k, n, b_, act, split, piece_rows, tile, dt = seen[0][5:15]
    assert (m, k, n, b_, act) == (40, 1024, 256, bits, 0)
    if dtype == torch.bfloat16:
        assert (split, piece_rows) == tqmm.tc_split_plan(1024, bits)
        mt, ng, wn, wm = tqmm.tc_tile(40, 256, split)
        assert tile == tqmm._tile_code((mt, ng, wn, wm)) and mt == 5
        assert part.value is None and dt == 1
    else:
        assert (split, piece_rows, tile) == (tqmm._num_slices(1024, bits),
                                             0, 0)
        assert part.value is not None and dt == 0


@pytest.mark.parametrize("n,k,bits,ok", [(128, 1024, 8, True),
                                         (120, 1024, 8, False),
                                         (128, 1032, 8, False),
                                         (128, 1040, 4, False),
                                         (128, 1056, 4, True)])
def test_tensor_core_route_refuses_what_its_tiles_cannot_take(n, k, bits, ok):
    """bf16 x needs N % 16 == 0 and K % 16 == 0 (int4: K % 32 == 0); the
    float32 route keeps N % 8 == 0 and any K (even for int4)."""
    x = torch.zeros(4, k, dtype=torch.bfloat16)
    rows = k // 2 if bits == 4 else k
    codes = torch.zeros(rows, n, dtype=torch.int8)
    sc = torch.ones(n)
    args = (codes, sc, torch.bfloat16, None, None, bits)
    if ok:
        assert tqmm._check_operands(x, *args) == (4, k, n)
    else:
        with pytest.raises(ValueError, match="tensor-core"):
            tqmm._check_operands(x, *args)
    assert tqmm._check_operands(x.float(), codes, sc, torch.float32, None,
                                None, bits) == (4, k, n)
