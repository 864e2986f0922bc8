"""The kernels of the port's flag-selected training routes held against
the JAX package on the CPU: the two-pass flash-attention backward
(``flash_onepass_bwd=False``) and the fused AdamW update
(``use_fused_adamw_kernel``), with the stochastic rounding of bf16
moments.

On the CPU the JAX model never takes Pallas flash (``pallas_enabled``
needs a TPU) and its ``TrainStep`` never takes the fused route, so the
JAX functions are called directly, their Pallas kernels in interpret
mode; the port's wrappers run their plain versions for CPU tensors.
Tolerances, each with its reason:
- two-pass flash gradients, float32: ``atol 2e-4, rtol 1e-3``, the JAX
  package's own bound for its kernel against XLA
  (``test_pallas_kernels.py:59``);
- the same in bfloat16: one bf16 ulp (``rtol 2**-7``) plus ``2**-6`` of
  the gradient's largest entry.  Both sides round P and dS to bf16 at
  the same places, but from fp32 scores summed in different orders, so
  a product term may round the other way; the reference also sums the
  GQA group's dK, dV in bf16 where the port sums in fp32;
- fused AdamW, float32 parameters and moments: ``rtol 1e-6`` plus
  ``2**-20`` of the tensor's largest entry.  The same fp32 operations in
  the same order, but XLA on the CPU contracts ``b1*m + (1-b1)*g`` into
  one FMA (one rounding fewer), so where the sum cancels, the two differ
  by an ulp of the operands rather than of the result, and XLA's ``exp``
  may differ in the last bit of a bias correction;
- fused AdamW, bf16 outputs: within one bf16 ulp of the JAX value (a
  last-bit difference of the fp32 result may round the other way);
- the stochastic rounding rule given JAX's own noise tile: bit-exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.jit import train_step as jts
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import fused_optimizer as jfo
import paddle_tpu_torch
from paddle_tpu_torch.jit import train_step as tts
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_optimizer as tfo


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def twopass():
    """Both packages on the two-pass flash backward, restored after."""
    paddle.set_flags({"FLAGS_flash_onepass_bwd": False})
    paddle_tpu_torch.set_flags({"FLAGS_flash_onepass_bwd": False})
    yield
    paddle.set_flags({"FLAGS_flash_onepass_bwd": True})
    paddle_tpu_torch.set_flags({"FLAGS_flash_onepass_bwd": True})


def _t(a, grad=False):
    """A torch tensor that owns a copy of ``a``.  The JAX side may read a
    numpy input through a zero-copy alias, after the call returns (its
    dispatch is asynchronous); a tensor sharing ``a``'s memory would let
    the port's in-place update (AdamW's p, m, v) race with that read."""
    return torch.from_numpy(np.array(a, order="C", copy=True)) \
        .requires_grad_(grad)


def _bf16_np(a):
    """float32 numpy values rounded to bf16 (exactly representable)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# ---- two-pass flash backward ----

@pytest.mark.parametrize("causal,hq,hk,dtype", [
    (False, 2, 2, "float32"), (True, 2, 2, "float32"),
    (True, 4, 2, "float32"), (False, 4, 1, "float32"),
    (True, 4, 2, "bfloat16"), (False, 2, 2, "bfloat16")])
def test_twopass_gradients_match_dq_and_dkv_kernels(twopass, causal, hq,
                                                    hk, dtype):
    """jax.grad of ``flash_attention`` with ``flash_onepass_bwd`` off
    runs ``_dq_kernel`` and ``_dkv_kernel`` in interpret mode; the port's
    backward runs ``_dq_plain`` and ``_dkv_plain`` through the same
    route."""
    rng = np.random.default_rng(21 + hq + hk)
    b, s, d = 1, 256, 64
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, hq, d), (b, s, hk, d), (b, s, hk, d)))
    c = rng.standard_normal(q.shape).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v, c = (_bf16_np(a) for a in (q, k, v, c))
    jdt = getattr(jnp, dtype)

    def loss(a, b_, c_):
        o = jfa.flash_attention(a, b_, c_, causal=causal)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(c))

    jg = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (_t(a).to(tdt).requires_grad_() for a in (q, k, v))
    calls = []
    real_dq, real_dkv = tfa._dq, tfa._dkv
    try:
        tfa._dq = lambda *a: calls.append("dq") or real_dq(*a)
        tfa._dkv = lambda *a: calls.append("dkv") or real_dkv(*a)
        out = tfa.flash_attention(tq, tk, tv, causal=causal)
        (out.float() * _t(c)).sum().backward()
    finally:
        tfa._dq, tfa._dkv = real_dq, real_dkv
    assert calls == ["dq", "dkv"]
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert got.dtype == tdt
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, atol=2e-4,
                                       rtol=1e-3)
        else:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       atol=2.0 ** -6 * np.abs(want).max(),
                                       rtol=2.0 ** -7)
    assert tfa.KERNEL_DQ.launches == tfa.KERNEL_DKV.launches == 0


def test_twopass_and_onepass_plain_cores_agree():
    """On the CPU both routes compute the same function: the one-pass
    plain core is the dQ and dK/dV plain versions together, bit for
    bit (its dK and dV per KV head, each GQA group summed in the compute
    dtype, as both kernels return them in bfloat16), and the two routes'
    gradients are equal."""
    rng = np.random.default_rng(31)
    q, k, v, do = (_t(rng.standard_normal(shape).astype(np.float32))
                   for shape in ((2, 70, 4, 16), (2, 70, 2, 16),
                                 (2, 70, 2, 16), (2, 70, 4, 16)))
    o, lse = tfa.flash_attention_fwd(q, k, v, True)
    outs = []
    for onepass in (True, False):
        paddle_tpu_torch.set_flags({"FLAGS_flash_onepass_bwd": onepass})
        try:
            outs.append(tfa.flash_attention_bwd(q, k, v, o, lse, do, True))
        finally:
            paddle_tpu_torch.set_flags({"FLAGS_flash_onepass_bwd": True})
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)
    delta = (do * o).sum(-1).permute(0, 2, 1).contiguous()
    dq = tfa._dq_plain(q, k, v, do, lse, delta, True)
    dk, dv = tfa._dkv_plain(q, k, v, do, lse, delta, True)
    assert dq.shape == (2, 70, 4, 16) and dk.shape == dv.shape == \
        (2, 70, 2, 16)
    core = tfa._bwd_core_plain(q, k, v, do, lse, delta, True)
    assert torch.equal(core[0], dq)
    for a, b_ in zip(core[1:], (dk, dv)):
        assert torch.equal(a, b_)


# ---- fused AdamW ----

def _adamw_inputs(seed, shape, p_dtype, m_dtype):
    rng = np.random.default_rng(seed)
    p = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    g = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    m = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    v = ((rng.standard_normal(shape) * 1e-2) ** 2).astype(np.float32)
    out = []
    for a, dt in ((p, p_dtype), (g, p_dtype), (m, m_dtype), (v, m_dtype)):
        out.append(_bf16_np(a) if dt == "bfloat16" else a)
    return out


def _ulp_bf16(x):
    """One bf16 ulp at each |x| (the spacing of bf16 numbers there)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("shape", [(16, 256), (37, 5), (1000,)])
@pytest.mark.parametrize("p_dtype,m_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_fused_adamw_matches_pallas_kernel(shape, p_dtype, m_dtype):
    """``fused_adamw_update`` without a seed against the interpret-mode
    ``_adamw_kernel`` (the 2-D native form for the tileable shape, the
    flat form for the others), round-to-nearest moment stores on both
    sides."""
    p, g, m, v = _adamw_inputs(41, shape, p_dtype, m_dtype)
    hp = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1)
    jp, jm, jv = jfo.fused_adamw_update(
        *(jnp.asarray(a).astype(getattr(jnp, dt)) for a, dt in
          ((p, p_dtype), (g, p_dtype), (m, m_dtype), (v, m_dtype))),
        3e-3, 5, **hp)
    tp, tg, tm, tv = (_t(a).to(getattr(torch, dt)) for a, dt in
                      ((p, p_dtype), (g, p_dtype), (m, m_dtype),
                       (v, m_dtype)))
    out = tfo.fused_adamw_update(tp, tg, tm, tv, 3e-3, 5, **hp)
    assert out[0] is tp and out[1] is tm and out[2] is tv
    assert tfo.KERNEL.launches == 0
    for got, want, dt in ((tp, jp, p_dtype), (tm, jm, m_dtype),
                          (tv, jv, m_dtype)):
        assert got.dtype == getattr(torch, dt)
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        if dt == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=2.0 ** -20 * np.abs(want).max())
        else:
            assert np.all(np.abs(got - want) <= _ulp_bf16(want))


def test_fused_adamw_zero_betas():
    """beta1 = beta2 = 0 is legal (bias correction exactly 1), as
    ``test_pallas_kernels.py:147`` checks for the Pallas kernel."""
    p, g, m, v = _adamw_inputs(43, (8, 128), "float32", "float32")
    hp = dict(beta1=0.0, beta2=0.0, epsilon=1e-8, weight_decay=0.0)
    jp, jm, jv = jfo.fused_adamw_update(*(jnp.asarray(a) for a in
                                          (p, g, m, v)), 1e-2, 3, **hp)
    tp, tm, tv = _t(p), _t(m), _t(v)
    tfo.fused_adamw_update(tp, _t(g), tm, tv, 1e-2, 3, **hp)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=2.0 ** -20 * np.abs(p).max())
    assert np.array_equal(tm.numpy(), g) and np.array_equal(tv.numpy(), g * g)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=0)


def test_fused_adamw_seed_rounds_bf16_moments_stochastically():
    """With a seed, bf16 moments are stored by stochastic rounding from
    the per-element hash: reproducible from the seed, different for
    another seed, and each value one of the two bf16 neighbours of the
    fp32 result (the seedless round-to-nearest store)."""
    p, g, m, v = _adamw_inputs(47, (64, 96), "bfloat16", "bfloat16")

    def run(seed):
        ts = [_t(a).to(torch.bfloat16) for a in (p, g, m, v)]
        tfo.fused_adamw_update(ts[0], ts[1], ts[2], ts[3], 1e-3, 2,
                               seed=seed)
        return ts[0], ts[2], ts[3]

    a, b_, rn = run(7), run(7), run(None)
    other = run(8)
    for x, y in zip(a, b_):
        assert torch.equal(x, y)
    assert torch.equal(a[0], rn[0])          # p: round to nearest always
    assert not torch.equal(a[1], other[1])
    for got, near in ((a[1], rn[1]), (a[2], rn[2])):
        ulp = torch.from_numpy(_ulp_bf16(near.float().numpy()))
        assert ((got.float() - near.float()).abs() <= ulp).all()
        assert not torch.equal(got, near)



@pytest.mark.parametrize("m_dtype", ["float32", "bfloat16"])
def test_fused_adamw_shared_scalars_give_the_same_update(m_dtype):
    """``scalars=adamw_scalars(...)``, made once and shared by the
    parameters of a step, gives the same bits as the scalars made from
    ``lr`` and ``step`` inside the call."""
    p, g, m, v = _adamw_inputs(53, (24, 40), "bfloat16", m_dtype)
    hp = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1)
    sc = tfo.adamw_scalars(2e-3, 4, hp["beta1"], hp["beta2"], "cpu")
    outs = []
    for kw in (dict(), dict(scalars=sc)):
        ts = [_t(a).to(getattr(torch, dt)).clone() for a, dt in
              ((p, "bfloat16"), (g, "bfloat16"), (m, m_dtype), (v, m_dtype))]
        tfo.fused_adamw_update(ts[0], ts[1], ts[2], ts[3], 2e-3, 4, seed=9,
                               **hp, **kw)
        outs.append((ts[0], ts[2], ts[3]))
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


# ---- stochastic rounding ----

def _jax_tile(key, n):
    """The noise tile ``_stochastic_round_bf16`` draws (:130-137)."""
    kd = jax.random.key_data(key).astype(jnp.uint32).reshape(-1)
    seed = jnp.tile(kd, 2)[:4] if kd.size < 4 else kd[:4]
    _, tile = jax.lax.rng_bit_generator(seed, (n,), dtype=jnp.uint32)
    return np.asarray(tile).astype(np.int64)


@pytest.mark.parametrize("shape", [(3, 257), (1000,), ()])
def test_rounding_rule_returns_jax_bits_given_jax_noise(shape):
    rng = np.random.default_rng(51)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    key = jax.random.key(5)
    want = np.asarray(jts._stochastic_round_bf16(jnp.asarray(x), key)
                      .astype(jnp.float32))
    tile = _jax_tile(key, x.reshape(-1).shape[-1] if x.ndim == 0
                     else x.shape[-1])
    # a 0-d x meets its one-element tile as a [1] array, as there
    xt = _t(x).reshape(1) if x.ndim == 0 else _t(x)
    got = tfo.stochastic_round_bf16(xt, torch.from_numpy(tile)) \
        .reshape(x.shape)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert np.array_equal(got.float().numpy().view(np.uint32),
                          want.view(np.uint32))


def _unbiased_two_neighbours(r):
    vals = np.unique(r)
    assert len(vals) == 2, vals          # straddles the two neighbours
    np.testing.assert_allclose(r.mean(), 1.0 + 1e-3, rtol=3e-4)


def test_tile_form_unbiased_and_column_correlated():
    """The unfused store: one trailing-row tile per store (the
    reference's test_stochastic_round_unbiased, same margins), the same
    noise for every row of a column."""
    x = torch.full((20000,), 1.0 + 1e-3)
    r = tts._stochastic_round_bf16(x, 12345).float().numpy()
    _unbiased_two_neighbours(r)
    assert len(np.unique(x.to(torch.bfloat16).float().numpy())) == 1
    x2 = torch.full((6, 4000), 1.0 + 1e-3)
    r2 = tts._stochastic_round_bf16(x2, 99).float()
    assert torch.equal(r2, r2[:1].expand_as(r2))


def test_element_form_unbiased():
    """The kernel's store: noise per element from ``(seed, 2 i)``."""
    n = 20000
    x = torch.full((n,), 1.0 + 1e-3)
    noise = tfo.noise_bits(777, torch.arange(n, dtype=torch.int64) * 2)
    _unbiased_two_neighbours(tfo.stochastic_round_bf16(x, noise)
                             .float().numpy())


def _noise_reference(seed, c):
    """The hash in Python integers, 32-bit arithmetic."""
    def mix(x):
        x &= 0xFFFFFFFF
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)
    k = mix(seed)
    return mix(mix(c ^ k) + k)


def test_noise_is_a_function_of_seed_and_index():
    counters = torch.tensor([0, 1, 2, 77, 2 ** 31 - 1, 2 ** 32 - 1],
                            dtype=torch.int64)
    for seed in (0, 1, 0xDEADBEEF):
        got = tfo.noise_bits(seed, counters).tolist()
        assert got == [_noise_reference(seed, int(c)) for c in counters]
    full = tfo.noise_bits(3, torch.arange(5000, dtype=torch.int64))
    part = tfo.noise_bits(3, torch.arange(1000, 1100, dtype=torch.int64))
    assert torch.equal(full[1000:1100], part)
    assert tfo.noise_bits(3, counters).max() < 2 ** 32
    assert len(set(full.tolist())) > 4990          # no short cycle
    assert tfo.seed_of(2 ** 64 - 1) == 2 ** 32 - 1
