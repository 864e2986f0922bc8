"""``clip_grad_norm_`` of the port held against the reference on the CPU,
for every ``norm_type`` over float32, bf16 and mixed (bf16 + float32)
gradients: two parameters of shapes (64, 48) and (300,), gradients ``3 *
standard_normal`` from ``default_rng(1)``, ``max_norm=1.0``.

The inf-norm takes its max and scale in the gradients' result dtype, as
JAX's promotion does: total, dtype and every clipped gradient bit-equal.
A p-norm sums fp32 powers in each package's own summation order, so its
total may differ by a few float32 ulps (rtol 2e-6); the clipped
gradients are then within rtol 2e-6 of their largest element in float32,
and within one ulp of their dtype in bf16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn.clip import clip_grad_norm_ as j_clip
from paddle_tpu_torch.nn import clip_grad_norm_

SHAPES = ((64, 48), (300,))
RTOL = 2e-6


def _grads():
    rng = np.random.default_rng(1)
    return [3 * rng.standard_normal(s).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("bfloat16", "float32")])
@pytest.mark.parametrize("norm_type", [float("inf"), 2.0, 1.0, 3.0])
def test_clip_grad_norm_matches_reference(dtypes, norm_type):
    tps, jps = [], []
    for g, dt in zip(_grads(), dtypes):
        p = torch.nn.Parameter(torch.zeros(g.shape, dtype=getattr(torch, dt)))
        p.grad = torch.from_numpy(g.copy()).to(getattr(torch, dt))
        tps.append(p)
        jp = paddle.to_tensor(np.zeros(g.shape, np.float32)).astype(dt)
        jp._grad = paddle.to_tensor(g.copy()).astype(dt)
        jps.append(jp)
    total = clip_grad_norm_(tps, 1.0, norm_type=norm_type)
    j_total = j_clip(jps, 1.0, norm_type=norm_type)._value
    assert str(total.dtype).replace("torch.", "") == str(j_total.dtype)
    got_t = float(total.float())
    want_t = float(np.asarray(j_total.astype(jnp.float32)))
    for p, jp in zip(tps, jps):
        got = p.grad.float().numpy()
        want = np.asarray(jp._grad._value.astype(jnp.float32))
        assert p.grad.dtype == getattr(torch, str(jp._grad._value.dtype))
        if norm_type == float("inf"):
            np.testing.assert_array_equal(got, want)
        elif p.grad.dtype == torch.bfloat16:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=RTOL * np.abs(want).max())
    if norm_type == float("inf"):
        assert got_t == want_t
    else:
        np.testing.assert_allclose(got_t, want_t, rtol=RTOL)
