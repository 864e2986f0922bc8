"""The port's quantization pieces held against the JAX package on the CPU.

The same numpy inputs go through the JAX function and the port's
counterpart.  Bit-exact: the absmax quant rule (``absmax_to_scales``,
``quantize_channelwise``, the per-channel observer), int4 packing,
``quantize_kv_heads``, the ``_q`` scatters and the weight-quant plan on
bridged weights.  Within a tolerance (float32 sums in another order):
int8 paged decode attention against the interpret-mode Pallas kernel
(``atol 1e-5, rtol 1e-5``), chunk-prefill attention over an int8 cache
against the JAX function (``atol 1e-5, rtol 1e-5``), and the quantized
matmul against the interpret-mode Pallas kernels (``rtol 1e-5`` plus
``atol 1e-4``: outputs of size ~1 summed over K = 256 fp32 products) and
its x-gradient against ``jax.grad`` (the same).  On the CPU every
wrapper runs its plain version, so no kernel launches here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.inference.llm import build_weight_quant_plan as j_plan
from paddle_tpu.models import generation as jgen
from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu.ops.pallas import quantized_matmul as jqmm
from paddle_tpu.quantization import observers as jobs
from paddle_tpu_torch.inference.llm import build_weight_quant_plan as t_plan
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import quantized_matmul as tqmm
from paddle_tpu_torch.quantization import observers as tobs

QMM_ATOL, QMM_RTOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(torch_out, jax_out):
    np.testing.assert_array_equal(torch_out.numpy(), np.asarray(jax_out))


# -- the quant rule -----------------------------------------------------------

@pytest.mark.parametrize("bits,axis", [(8, -1), (4, -1), (8, 0)])
def test_quant_rule_bit_exact(bits, axis):
    rng = np.random.default_rng(bits + 10 * (axis % 2))
    w = (0.05 * rng.standard_normal((96, 40))).astype(np.float32)
    w[:, 3] = 0.0                      # an all-zero channel hits the floor
    if axis == 0:
        w[5] = 0.0
    red = tuple(i for i in range(2) if i != axis % 2)
    absmax = np.abs(w).max(axis=red)
    js = jobs.absmax_to_scales(jnp.asarray(absmax), bits)
    ts = tobs.absmax_to_scales(_t(absmax), bits)
    _eq(ts, js)
    _eq(tobs.quantize_channelwise(_t(w), ts, bits, axis),
        jobs.quantize_channelwise(jnp.asarray(w), js, bits, axis))
    jo = jobs.PerChannelAbsmaxObserver(quant_axis=axis, bit_length=bits)
    to = tobs.PerChannelAbsmaxObserver(quant_axis=axis, bit_length=bits)
    for part in (w, 1.5 * w[::-1].copy()):
        jo.observe(Tensor(jnp.asarray(part)))
        to.observe(_t(part))
    _eq(to.scales(), jo.scales()._value)
    # composing the rule with the floored observer output is idempotent
    _eq(tobs.absmax_to_scales(to.scales(), bits),
        jobs.absmax_to_scales(jo.scales()._value, bits))


def test_int4_packing_bit_exact():
    rng = np.random.default_rng(3)
    codes = rng.integers(-8, 8, (64, 24)).astype(np.int8)
    packed = tqmm.pack_int4(_t(codes))
    assert packed.shape == (32, 24) and packed.dtype == torch.int8
    _eq(packed, jqmm.pack_int4(jnp.asarray(codes)))
    _eq(tqmm.unpack_int4(packed), jqmm.unpack_int4(jnp.asarray(packed.numpy())))
    np.testing.assert_array_equal(tqmm.unpack_int4(packed).numpy(), codes)
    with pytest.raises(ValueError, match="even"):
        tqmm.pack_int4(_t(codes[:63]))


def test_quantize_kv_heads_bit_exact():
    rng = np.random.default_rng(4)
    kv = rng.standard_normal((5, 7, 2, 16)).astype(np.float32)
    kv[1, 2, 0] = 0.0                  # zero plane: floored scale, codes 0
    kv[3] *= 1e3
    jc, js = jgen.quantize_kv_heads(jnp.asarray(kv))
    tc, ts = tgen.quantize_kv_heads(_t(kv))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    _eq(tc, jc)
    _eq(ts, js)


def test_int8_arena_layout():
    arenas = tgen.init_paged_kv_arena(2, 6, 4, 2, 16, torch.int8, "cpu")
    jarenas = jgen.init_paged_kv_arena(2, 6, 4, 2, 16, jnp.int8)
    assert len(arenas) == 2
    for t, j in zip(arenas[0], jarenas[0]):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == j.dtype.name
        assert not t.any()
    assert tda.paged_scale_shape(7, 2, 4) == jda.paged_scale_shape(7, 2, 4)


@pytest.mark.parametrize("packed", [True, False])
def test_q_scatters_bit_exact(packed):
    """A decode append (vacant rows write the trash row at distinct
    offsets; one row's lens past its table span) and a chunk with a pad
    tail land the same codes and scales as the JAX scatters."""
    hkv, d, blk_len, nb, mb = 2, 64 if packed else 16, 4, 10, 4
    rng = np.random.default_rng(5)
    shape = jda.paged_arena_shape(nb + 1, hkv, blk_len, d)
    assert len(shape) == (3 if packed else 4)
    arena = rng.integers(-127, 128, shape).astype(np.int8)
    scales = rng.random((nb + 1, blk_len, hkv)).astype(np.float32)
    tables = np.full((4, mb), nb, np.int32)
    tables[0] = [3, 7, 1, 9]
    tables[1] = [2, 0, 5, 4]
    lens = np.asarray([blk_len + 2, mb * blk_len + 1, 0, 1], np.int32)
    new = rng.standard_normal((4, hkv, d)).astype(np.float32)
    ja, js = jgen.paged_cache_scatter_q(
        jnp.asarray(arena), jnp.asarray(scales), jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(new))
    ta, ts = tgen.paged_cache_scatter_q(_t(arena.copy()), _t(scales.copy()),
                                        _t(tables), _t(lens), _t(new))
    _eq(ta, ja)
    _eq(ts, js)
    # chunk of 6 from a mid-block start, the last 2 past n_valid (trash)
    c, start, n_valid = 6, blk_len - 1, blk_len + 3
    chunk = rng.standard_normal((c, hkv, d)).astype(np.float32)
    ja, js = jgen.paged_chunk_scatter_q(
        jnp.asarray(arena), jnp.asarray(scales), jnp.asarray(tables[:1]),
        jnp.asarray(start, jnp.int32), jnp.asarray(n_valid, jnp.int32),
        jnp.asarray(chunk))
    ta, ts = tgen.paged_chunk_scatter_q(_t(arena.copy()), _t(scales.copy()),
                                        _t(tables[:1]), start, n_valid,
                                        _t(chunk))
    _eq(ta, ja)
    _eq(ts, js)
    assert not np.array_equal(np.asarray(js)[nb], scales[nb])


# -- int8 paged attention -----------------------------------------------------

def _int8_case(seed, b, hkv, g, blk_len, nb, mb, d):
    """Random float arenas quantized into codes and scales (the engine's
    at-rest form), q and per-row tables of distinct blocks."""
    rng = np.random.default_rng(seed)
    kf = rng.standard_normal((nb + 1, blk_len, hkv, d)).astype(np.float32)
    vf = rng.standard_normal((nb + 1, blk_len, hkv, d)).astype(np.float32)
    kc, ks = (t.numpy() for t in tgen.quantize_kv_heads(_t(kf)))
    vc, vs = (t.numpy() for t in tgen.quantize_kv_heads(_t(vf)))
    w = hkv * d
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    tables = rng.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32)
    return (q, kc.reshape(nb + 1, blk_len, w), vc.reshape(nb + 1, blk_len, w),
            ks, vs, tables)


def test_int8_paged_decode_matches_pallas_kernel():
    """The case of the JAX package's int8 kernel test (b=3, hkv=2, g=2,
    L=8, d=64, lens [5, 17, 30]): the port's plain version against
    ``_decode_attention_pallas_paged_q`` in interpret mode and against
    the JAX gather path."""
    b, hkv, g, blk_len, nb, mb, d = 3, 2, 2, 8, 12, 4, 64
    q, kc, vc, ks, vs, tables = _int8_case(23, b, hkv, g, blk_len, nb, mb, d)
    lens = np.asarray([5, 17, 30], np.int32)
    ref = jda._decode_attention_pallas_paged_q(
        jnp.asarray(q.reshape(b, hkv, g, d)), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(tables), jnp.asarray(lens))
    out = tda.decode_attention_paged(_t(q), _t(kc), _t(vc), _t(tables),
                                     _t(lens), kv_scales=(_t(ks), _t(vs)))
    assert out.shape == (b, hkv * g * d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(b, -1),
                               atol=1e-5, rtol=1e-5)
    ref2 = jda.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(lens),
        kv_scales=(jnp.asarray(ks), jnp.asarray(vs)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref2), atol=1e-5,
                               rtol=1e-5)
    assert tda.KERNEL_INT8.launches == 0


def test_int8_paged_decode_ignores_everything_beyond_lens():
    """Codes and scales past each row's last slot do not reach the
    output."""
    b, hkv, g, blk_len, nb, mb, d = 3, 2, 2, 8, 12, 4, 64
    q, kc, vc, ks, vs, tables = _int8_case(7, b, hkv, g, blk_len, nb, mb, d)
    lens = np.asarray([5, 17, 30], np.int32)
    out1 = tda.decode_attention_paged(_t(q), _t(kc), _t(vc), _t(tables),
                                      _t(lens), kv_scales=(_t(ks), _t(vs)))
    kc2, vc2, ks2, vs2 = kc.copy(), vc.copy(), ks.copy(), vs.copy()
    for i, ln in enumerate(lens):
        for s in range(ln + 1, mb * blk_len):
            blk = tables[i, s // blk_len]
            kc2[blk, s % blk_len] = 127
            vc2[blk, s % blk_len] = -127
            ks2[blk, s % blk_len] = 1e6
            vs2[blk, s % blk_len] = 1e6
    out2 = tda.decode_attention_paged(_t(q), _t(kc2), _t(vc2), _t(tables),
                                      _t(lens), kv_scales=(_t(ks2), _t(vs2)))
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())


def test_int8_paged_decode_bf16_rounds_dequant_to_q_dtype():
    """In bf16 the dequantized K/V are rounded to q's dtype before the
    dots (``paged_dequant_view``): the result equals the float path over
    the bf16 dequantized arenas."""
    b, hkv, g, blk_len, nb, mb, d = 2, 2, 2, 8, 12, 4, 64
    q, kc, vc, ks, vs, tables = _int8_case(9, b, hkv, g, blk_len, nb, mb, d)
    lens = _t(np.asarray([9, 30], np.int32))
    qb = _t(q).to(torch.bfloat16)
    out = tda.decode_attention_paged(qb, _t(kc), _t(vc), _t(tables), lens,
                                     kv_scales=(_t(ks), _t(vs)))
    w = hkv * d
    kd = (_t(kc).float().reshape(nb + 1, blk_len, hkv, d)
          * _t(ks)[..., None]).to(torch.bfloat16).reshape(nb + 1, blk_len, w)
    vd = (_t(vc).float().reshape(nb + 1, blk_len, hkv, d)
          * _t(vs)[..., None]).to(torch.bfloat16).reshape(nb + 1, blk_len, w)
    want = tda.decode_attention_paged(qb, kd, vd, _t(tables), lens)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want)


def test_paged_dequant_view_refuses_a_float_arena():
    with pytest.raises(TypeError, match="int8 code arena"):
        tda.paged_dequant_view(torch.zeros(3, 4, 32), torch.zeros(3, 4, 2),
                               torch.zeros(1, 2, dtype=torch.int32),
                               torch.float32)


@pytest.mark.parametrize("geom", ["packed", "unpacked"])
def test_int8_paged_prefix_attention_matches_jax(geom):
    hkv, g, blk_len, nb, mb, d = (8, 4, 16, 10, 4, 128) if geom == "packed" \
        else (2, 2, 4, 12, 4, 16)
    c = 5
    rng = np.random.default_rng(11)
    kf = rng.standard_normal((nb + 1, blk_len, hkv, d)).astype(np.float32)
    vf = rng.standard_normal((nb + 1, blk_len, hkv, d)).astype(np.float32)
    shape = jda.paged_arena_shape(nb + 1, hkv, blk_len, d)
    kc, ks = (t.numpy() for t in tgen.quantize_kv_heads(_t(kf)))
    vc, vs = (t.numpy() for t in tgen.quantize_kv_heads(_t(vf)))
    kc, vc = kc.reshape(shape), vc.reshape(shape)
    q = rng.standard_normal((1, c, hkv * g, d)).astype(np.float32)
    tables = rng.permutation(nb)[:mb].astype(np.int32)[None, :]
    start = np.asarray([blk_len + 1], np.int32)
    ref = jda.paged_prefix_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(start),
        kv_scales=(jnp.asarray(ks), jnp.asarray(vs)))
    out = tda.paged_prefix_attention(_t(q), _t(kc), _t(vc), _t(tables),
                                     _t(start), kv_scales=(_t(ks), _t(vs)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def _int8_decode_bad(case):
    b, hkv, g, blk_len, nb, mb, d = 2, 2, 2, 4, 6, 3, 32
    q = torch.zeros(b, hkv * g, d)
    kc = torch.zeros(nb + 1, blk_len, hkv * d, dtype=torch.int8)
    vc = torch.zeros_like(kc)
    sc = (torch.zeros(nb + 1, blk_len, hkv), torch.zeros(nb + 1, blk_len, hkv))
    tables = torch.zeros(b, mb, dtype=torch.int32)
    lens = torch.zeros(b, dtype=torch.int32)
    bad = {
        "float_codes": (q, kc.float(), vc.float(), tables, lens, sc,
                        TypeError),
        "bf16_scales": (q, kc, vc, tables, lens,
                        (sc[0].to(torch.bfloat16), sc[1]), ValueError),
        "scale_shape": (q, kc, vc, tables, lens,
                        (sc[0][:, :, :1], sc[1]), ValueError),
        "head_dim_not_16": (torch.zeros(b, hkv * g, 8),
                            torch.zeros(nb + 1, blk_len, hkv * 8,
                                        dtype=torch.int8),
                            torch.zeros(nb + 1, blk_len, hkv * 8,
                                        dtype=torch.int8),
                            tables, lens, sc, ValueError),
        "non_contiguous_scales": (q, kc, vc, tables, lens,
                                  (sc[0].transpose(0, 1).contiguous()
                                   .transpose(0, 1), sc[1]), ValueError),
    }
    if case == "ok":
        return q, kc, vc, tables, lens, sc, None
    return bad[case]


@pytest.mark.parametrize("case", ["ok", "float_codes", "bf16_scales",
                                  "scale_shape", "head_dim_not_16",
                                  "non_contiguous_scales"])
def test_int8_paged_decode_kernel_operand_checks(case):
    """What the int8 CUDA wrapper refuses before any launch (the checks
    are device-independent, so they run here on CPU tensors)."""
    *args, sc, exc = _int8_decode_bad(case)
    if exc is None:
        assert tda._check_operands(*args, kv_scales=sc) == (2, 4, 32, 2, 2)
        return
    with pytest.raises(exc):
        tda._check_operands(*args, kv_scales=sc)


# -- quantized matmul ---------------------------------------------------------

def _qmm_case(seed, m, k, n, bits):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    scales = tobs.absmax_to_scales(_t(np.abs(w).max(axis=0)), bits)
    codes = tobs.quantize_channelwise(_t(w), scales, bits)
    if bits == 4:
        codes = tqmm.pack_int4(codes)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, codes.numpy(), scales.numpy(), bias


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("epilogue", ["none", "bias", "bias_silu"])
def test_quantized_matmul_matches_pallas_kernel(bits, epilogue):
    """Ragged M = 13 (the Pallas kernel pads it to its block), K = 256,
    N = 384."""
    x, codes, scales, bias = _qmm_case(bits, 13, 256, 384, bits)
    b = bias if epilogue != "none" else None
    act = "silu" if epilogue == "bias_silu" else None
    ref = jqmm.quantized_matmul(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales),
        bias=None if b is None else jnp.asarray(b), act=act, bits=bits)
    out = tqmm.quantized_matmul(_t(x), _t(codes), _t(scales),
                                bias=None if b is None else _t(b), act=act,
                                bits=bits)
    assert out.shape == (13, 384) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=QMM_ATOL,
                               rtol=QMM_RTOL)
    # the reference's XLA path and dequant view agree with the port's too
    np.testing.assert_allclose(
        tqmm.dequant_view(_t(codes), _t(scales), bits).numpy(),
        np.asarray(jqmm.dequant_view(jnp.asarray(codes), jnp.asarray(scales),
                                     bits=bits)), atol=0, rtol=0)
    if act is None:
        np.testing.assert_allclose(
            tqmm.routed_quantized_matmul(
                _t(x), _t(codes), _t(scales), bits=bits,
                bias=None if b is None else _t(b)).numpy(),
            np.asarray(jqmm.dequant_matmul_xla(
                jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales),
                bits=bits, bias=None if b is None else jnp.asarray(b))),
            atol=QMM_ATOL, rtol=QMM_RTOL)
    assert tqmm.KERNEL.launches == 0


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_bf16_within_one_ulp(bits):
    """bf16 x: both sides sum exact fp32 products and round once."""
    x, codes, scales, _ = _qmm_case(20 + bits, 9, 128, 256, bits)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jqmm.quantized_matmul(xb, jnp.asarray(codes),
                                           jnp.asarray(scales), bits=bits))
    out = tqmm.quantized_matmul(_t(x).to(torch.bfloat16), _t(codes),
                                _t(scales), bits=bits)
    assert out.dtype == torch.bfloat16
    a, r = out.float().numpy(), ref.astype(np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 1e-30))) - 7)
    assert np.all(np.abs(a - r) <= ulp)


def test_quantized_matmul_int8_x_gradient_matches_jax_grad():
    x, codes, scales, _ = _qmm_case(31, 6, 256, 128, 8)
    g = np.random.default_rng(32).standard_normal((6, 128)).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jqmm.quantized_matmul(
        a, jnp.asarray(codes), jnp.asarray(scales)) * jnp.asarray(g)))(
            jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y = tqmm.quantized_matmul(xt, _t(codes), _t(scales))
    (tg,) = torch.autograd.grad((y * _t(g)).sum(), xt)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=QMM_ATOL,
                               rtol=QMM_RTOL)


@pytest.mark.parametrize("form", ["int4", "bias", "act"])
def test_quantized_matmul_inference_forms_refuse_grad(form):
    bits = 4 if form == "int4" else 8
    x, codes, scales, bias = _qmm_case(33, 4, 128, 128, bits)
    kw = {"bias": _t(bias)} if form == "bias" else \
        ({"act": "relu"} if form == "act" else {})
    xt = _t(x).requires_grad_()
    with pytest.raises(RuntimeError, match="differentiable"):
        tqmm.quantized_matmul(xt, _t(codes), _t(scales), bits=bits, **kw)
    with torch.no_grad():
        tqmm.quantized_matmul(xt, _t(codes), _t(scales), bits=bits, **kw)


def _qmm_bad(case):
    x = torch.zeros(4, 256)
    codes = torch.zeros(256, 128, dtype=torch.int8)
    sc = torch.ones(128)
    bad = {
        "f64_x": (x.double(), codes, sc, torch.float64, None, None, 8,
                  TypeError),
        "out_dtype": (x, codes, sc, torch.bfloat16, None, None, 8,
                      TypeError),
        "float_codes": (x, codes.float(), sc, torch.float32, None, None, 8,
                        TypeError),
        "k_mismatch": (x, codes[:128], sc, torch.float32, None, None, 8,
                       ValueError),
        "n_not_8": (x, codes[:, :100], torch.ones(100), torch.float32, None,
                    None, 8, ValueError),
        "scale_dtype": (x, codes, sc.double(), torch.float32, None, None, 8,
                        ValueError),
        "bias_shape": (x, codes, sc, torch.float32, torch.ones(64), None, 8,
                       ValueError),
        "act": (x, codes, sc, torch.float32, None, "tanh", 8, ValueError),
        "bits": (x, codes, sc, torch.float32, None, None, 2, ValueError),
        "non_contiguous": (torch.zeros(256, 4).t(), codes, sc, torch.float32,
                           None, None, 8, ValueError),
        "misaligned": (torch.zeros(4 * 256 + 1)[1:].view(4, 256), codes, sc,
                       torch.float32, None, None, 8, ValueError),
    }
    if case == "ok":
        return x, codes, sc, torch.float32, None, None, 8, None
    if case == "ok_int4":
        return x, codes[:128], sc, torch.float32, None, "silu", 4, None
    return bad[case]


@pytest.mark.parametrize("case", ["ok", "ok_int4", "f64_x", "out_dtype",
                                  "float_codes", "k_mismatch", "n_not_8",
                                  "scale_dtype", "bias_shape", "act", "bits",
                                  "non_contiguous", "misaligned"])
def test_quantized_matmul_kernel_operand_checks(case):
    *args, exc = _qmm_bad(case)
    if exc is None:
        assert tqmm._check_operands(*args) == (4, 256, 128)
        return
    with pytest.raises(exc):
        tqmm._check_operands(*args)


def test_kernel_slices_depend_on_k_alone():
    """The kernel's K split (and so each element's summation order) is a
    function of K and bits only: the same for every M.  bf16 x (the tensor
    cores): pieces of ``tc_split_plan``, one cluster CTA each; float32 x:
    slices of 256 code rows."""
    assert tqmm.tc_split_plan(4096, 8) == (8, 512)
    assert tqmm.tc_split_plan(4096, 4) == (8, 256)
    assert tqmm.tc_split_plan(14336, 8) == (8, 1792)
    assert tqmm.tc_split_plan(96, 8) == (1, 96)
    assert tqmm._num_slices(4096, 8) == tqmm._num_slices(4096, 4) == 16
    assert tqmm._num_slices(14336, 8) == 56
    assert tqmm._num_slices(100, 8) == 1


# -- the weight-quant plan ----------------------------------------------------

@pytest.fixture(scope="module")
def bridged():
    paddle.seed(77)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.eval()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays))
    return jnet, tnet


@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_weight_quant_plan_bit_exact_to_jax(bridged, wd):
    jnet, tnet = bridged
    jp, tp = j_plan(jnet, wd), t_plan(tnet, wd)
    assert tp.bits == jp.bits and tp.dtype == jp.dtype
    assert len(tp.entries) == len(jp.entries) == \
        7 * tiny_llama_config().num_hidden_layers
    for (tli, tt, tpos, tc, ts), (jli, jt, jpos, jc, js) in zip(tp.entries,
                                                                jp.entries):
        assert (tli, tt, tpos) == (jli, jt, jpos)
        assert tc.dtype == torch.int8 and tc.is_contiguous()
        _eq(tc, jc)
        _eq(ts, js)
    assert tp.bytes_swept() == jp.bytes_swept()
    assert tp.param_positions == jp.param_positions
