"""The port's threefry PRNG (``paddle_tpu_torch/inference/threefry.py``)
against JAX's on the CPU: keys, ``fold_in``, ``split``, 32-bit random
bits and uniforms bit for bit; Gumbel noise within 2 ulp of max(|g|, 1)
(each of its two logs within 1 ulp of XLA's on the same input); the
per-row categorical of the serving sampler equal to the vmapped
``jax.random.categorical`` wherever the top two perturbed scores are
more than 1e-5 apart.  The port implements the partitionable threefry
rule only, so the flag that selects it is asserted here: a JAX whose
default changed would fail this file instead of drawing other streams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import threefry
from paddle_tpu_torch.inference.sampling import categorical_rows

V_SERVE = 128256          # the Llama-3 vocabulary


def _ordered(a: np.ndarray) -> np.ndarray:
    """float32 bits as integers ordered like the floats (ulp distance)."""
    i = a.view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _key(seed):
    return threefry.as_key(threefry.prng_key(seed))


def test_jax_uses_the_partitionable_rule():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1, 2 ** 32 + 5,
                                  2 ** 63 - 1, -2 ** 63, 2 ** 64, -2 ** 63 - 1])
def test_prng_key_equals_jax(seed):
    try:
        want = np.asarray(jax.random.PRNGKey(seed))
    except Exception as e:          # noqa: BLE001 - compared by type
        with pytest.raises(type(e)):
            threefry.prng_key(seed)
        return
    got = threefry.prng_key(seed)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1])
def test_fold_in_equals_jax(seed):
    k = jax.random.PRNGKey(seed)
    data = np.arange(4096)
    kt = _key(seed)
    for lane in (0, 1):
        want = np.asarray(jax.vmap(lambda d: jax.random.fold_in(
            jax.random.fold_in(k, d), lane))(jnp.asarray(data)))
        got = threefry.fold_in(threefry.fold_in(
            kt.expand(data.size, 2), torch.from_numpy(data.copy())), lane)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a Python int and a scalar key
    np.testing.assert_array_equal(
        threefry.fold_in(kt, 7).numpy(),
        np.asarray(jax.random.fold_in(k, 7)).astype(np.int64))


@pytest.mark.parametrize("num", [2, 3, 8])
def test_split_equals_jax(num):
    k = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.split(k, num))
    got = threefry.split(_key(11), num)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # batched keys split row by row
    keys = jax.random.split(k, 3)
    want = np.asarray(jax.vmap(lambda kk: jax.random.split(kk, num))(keys))
    got = threefry.split(threefry.as_key(np.asarray(keys)), num)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", [(V_SERVE,), (3, V_SERVE), (1001,),
                                   (5, 77), ()])
def test_random_bits_equal_jax(shape):
    k = jax.random.PRNGKey(42)
    want = np.asarray(jax.random.bits(k, shape, dtype=jnp.uint32))
    got = threefry.random_bits(_key(42), shape)
    assert tuple(got.shape) == tuple(shape)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_random_bits_per_row_keys_equal_vmapped_jax():
    keys = jax.random.split(jax.random.PRNGKey(5), 8)
    want = np.asarray(jax.vmap(lambda kk: jax.random.bits(
        kk, (999,), dtype=jnp.uint32))(keys))
    got = threefry.random_bits(threefry.as_key(np.asarray(keys)), (999,))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape,lo,hi", [((3, 1001), 0.0, 1.0),
                                         ((8, V_SERVE), 0.0, 1.0),
                                         ((513,), float(np.finfo(
                                             np.float32).tiny), 1.0),
                                         ((), 0.0, 1.0)])
def test_uniform_bit_equal_jax(shape, lo, hi):
    k = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
    got = threefry.uniform(_key(9), shape, lo, hi).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_gumbel_within_2_ulp_of_jax():
    """-log(-log(u)) on the same bit-equal u: each log is within 1 ulp of
    XLA's on the same input, so the noise is within 2 ulp of max(|g|, 1)
    (near g = 0 the outer log's relative error is unbounded in ulps of g
    itself)."""
    k = jax.random.PRNGKey(42)
    shape = (8, V_SERVE)
    tiny = float(np.finfo(np.float32).tiny)
    u = np.asarray(jax.random.uniform(k, shape, minval=tiny))
    inner_j = np.asarray(-jnp.log(jnp.asarray(u)))
    inner_t = (-torch.log(torch.from_numpy(np.array(u, copy=True)))).numpy()
    assert np.abs(_ordered(inner_j) - _ordered(inner_t)).max() <= 1
    outer_t = (-torch.log(torch.from_numpy(
        np.array(inner_j, copy=True)))).numpy()
    want = np.asarray(jax.random.gumbel(k, shape))
    assert np.abs(_ordered(want) - _ordered(outer_t)).max() <= 1
    got = threefry.gumbel(_key(42), shape).numpy()
    spacing = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= 2 * spacing).all()


@pytest.mark.parametrize("v", [256, 1001, V_SERVE])
def test_categorical_rows_equal_vmapped_jax(v):
    rows = 64 if v < V_SERVE else 8
    keys = jax.random.split(jax.random.PRNGKey(3), rows)
    lg = (np.random.default_rng(v).standard_normal((rows, v)) * 2.0
          ).astype(np.float32)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                       jnp.asarray(lg)))
    got = categorical_rows(torch.from_numpy(lg.copy()),
                           threefry.as_key(np.asarray(keys))).numpy()
    assert got.dtype == np.int32
    g = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(kk, (v,)))(keys))
    top2 = np.sort(g + lg, axis=-1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 1e-5
    print(f"categorical_rows V={v}: {int(decisive.sum())} of {rows} rows "
          f"compared")
    assert decisive.sum() >= rows - 1
    np.testing.assert_array_equal(got[decisive], want[decisive])


def test_categorical_one_key_over_a_batch_equals_jax():
    """``generate()``'s draw: one key over a whole [B, V] batch."""
    k = jax.random.PRNGKey(17)
    lg = np.random.default_rng(1).standard_normal((4, 300)).astype(
        np.float32)
    want = np.asarray(jax.random.categorical(k, jnp.asarray(lg)))
    got = threefry.categorical(_key(17), torch.from_numpy(lg.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
