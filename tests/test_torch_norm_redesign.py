"""The contracts that the port's RoPE (``csrc/rope.cu``) and RMSNorm
(``csrc/rms_norm.cu``) kernels rest on, held on the CPU.

- ``rope_plan`` (a function of B, S, H, D and the dtype) covers every
  (b, s, h, i) exactly once: D = 64 and 128 on the vector route, D = 6 on
  the element route, S not a multiple of the positions a CTA takes, one
  and several rows (b) a thread walks.  The vector route is taken exactly where
  (D/2) % (16 bytes of the dtype) == 0, and the wrapper hands the kernel
  the plan.
- ``apply_rope`` equals the JAX ``apply_rope`` (its Pallas kernel in
  interpret mode), forward and ``jax.grad``, at D = 128 and D = 6,
  float32 ``atol 1e-6`` (the same fp32 products and sums; only the
  compilers' rounding order differs).
- ``rms_norm_plan`` is a function of d and the dtype alone.  A float32
  mirror of the kernel's reduction order under the plan (each lane's fma
  chains, the tree over a vector's elements, the butterfly over lanes,
  the warps' sums in order) equals ``rms_norm_plain`` and the JAX
  ``_rms_fwd_impl`` in interpret mode within float32 ``atol 1e-6`` (the
  same sum of squares, in another order; rsqrt rounded once).
- ``rms_norm`` without autograd (grad disabled, or nothing requiring a
  gradient) returns what the autograd path returns, and the gradients
  under grad are ``rms_norm_bwd``'s.
"""

import ctypes
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import rms_norm as jrn
from paddle_tpu.ops.pallas import rope as jrp
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import rms_norm as trn
from paddle_tpu_torch.ops import rope as trp

DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _tables(s, d, base=500000.0):
    inv = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float32) / d))
    freqs = np.outer(np.arange(s, dtype=np.float32), inv)
    return (np.cos(freqs)[None, :, None, :].astype(np.float32),
            np.sin(freqs)[None, :, None, :].astype(np.float32))


# ---- RoPE: the plan ----

def _rope_cover(plan, b, s, h, d):
    """How many times the kernel's threads touch each element of x [B, S,
    H, D] under ``plan``: every thread of the grid, as rope.cu maps it
    (position from grid x and block z, head from grid y and block y, pair
    groups from block x; each thread walks the B rows)."""
    half = d // 2
    seen = np.zeros((b, s, h, d), np.int32)
    gx, gy = plan.grid
    for bx in range(gx):
        for tz in range(plan.sy):
            si = bx * plan.sy + tz
            if si >= s:
                continue
            for by in range(gy):
                for ty in range(plan.hb):
                    hi = by * plan.hb + ty
                    if hi >= h:
                        continue
                    for tx in range(plan.px):
                        for i in range(tx * plan.vec, half,
                                       plan.px * plan.vec):
                            for j in range(i, i + plan.vec):
                                seen[:, si, hi, j] += 1
                                seen[:, si, hi, half + j] += 1
    return seen


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,d", [(2, 37, 3, 64), (1, 5, 32, 128),
                                     (10, 9, 8, 64), (3, 13, 2, 6),
                                     (2, 70, 1, 6)])
def test_rope_plan_covers_every_element_once(dtype, b, s, h, d):
    plan = trp.rope_plan(b, s, h, d, dtype)
    assert plan.px * plan.hb * plan.sy <= 256 and plan.sy <= 64
    assert plan.grid == (-(-s // plan.sy), -(-h // plan.hb))
    seen = _rope_cover(plan, b, s, h, d)
    assert seen.min() == 1 and seen.max() == 1


def test_rope_plan_at_the_main_shapes():
    """The training q and k and the 8B drafter's prefill: 256 threads a
    CTA, every head of a position in one CTA; S = 37 leaves a tail
    CTA."""
    q = trp.rope_plan(8, 2048, 32, 64, torch.bfloat16)
    assert (q.vec, q.px, q.hb, q.sy, q.grid) == (8, 4, 32, 2, (1024, 1))
    k = trp.rope_plan(8, 2048, 8, 64, torch.bfloat16)
    assert (k.vec, k.px, k.hb, k.sy, k.grid) == (8, 4, 8, 8, (256, 1))
    p = trp.rope_plan(1, 512, 32, 128, torch.bfloat16)
    assert (p.vec, p.px, p.hb, p.sy, p.grid) == (8, 8, 32, 1, (512, 1))
    assert 37 % trp.rope_plan(2, 37, 3, 64, torch.bfloat16).sy != 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_vector_route_exactly_where_half_d_divides(dtype):
    v = 16 // dtype.itemsize
    for d in range(2, 260, 2):
        plan = trp.rope_plan(2, 3, 4, d, dtype)
        assert (plan.vec > 1) == ((d // 2) % v == 0)
        assert plan.vec in (1, v)
        assert trp.rope_plan(2, 3, 4, d, dtype, aligned=False).vec == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128, 6])
def test_rope_wrapper_hands_the_kernel_its_plan(monkeypatch, dtype, d):
    b, s, h = 3, 17, 4
    x = torch.zeros(b, s, h, d, dtype=dtype)
    cos, sin = (_t(a) for a in _tables(s, d))
    seen = []
    monkeypatch.setattr(trp.KERNEL, "launch", lambda *a: seen.append(a))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: ctypes.c_void_p(None))
    y = trp._rope_cuda(x, cos, sin, -1.0)
    assert y.shape == x.shape and y.dtype == dtype and len(seen) == 1
    args = seen[0]
    assert args[4:10] == (b, s, h, d, -1.0, trp._DTYPES[dtype])
    plan = trp.rope_plan(b, s, h, d, dtype)
    assert args[10:14] == (plan.vec, plan.px, plan.hb, plan.sy)
    assert (plan.vec > 1) == ((d // 2) % (16 // dtype.itemsize) == 0)


# ---- RoPE: against the JAX package ----

@pytest.mark.parametrize("b,s,h,d", [(2, 12, 3, 128), (2, 16, 4, 6)])
def test_rope_matches_pallas_kernel_forward_and_grad(b, s, h, d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    c = rng.standard_normal((b, s, h, d)).astype(np.float32)
    cos, sin = _tables(s, d)
    jy = jrp.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    jg = jax.grad(lambda a: jnp.sum(jrp.apply_rope(
        a, jnp.asarray(cos), jnp.asarray(sin)) * jnp.asarray(c)))(
            jnp.asarray(x))
    tx = _t(x, grad=True)
    ty = trp.apply_rope(tx, _t(cos), _t(sin))
    (ty * _t(c)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=0)
    assert trp.KERNEL.launches == 0


# ---- RMSNorm: the plan ----

def test_rms_norm_plan_is_a_function_of_d_and_dtype():
    assert list(inspect.signature(trn.rms_norm_plan).parameters) == [
        "d", "dtype"]
    assert trn.rms_norm_plan(2048, torch.bfloat16) == (4, 2, 8)
    assert trn.rms_norm_plan(4096, torch.bfloat16) == (8, 2, 8)
    assert trn.rms_norm_plan(4096, torch.float32) == (16, 2, 4)
    for dtype in DTYPES:
        v = 16 // dtype.itemsize
        for d in list(range(8, 4200, 8)) + [8192, 65536 // dtype.itemsize]:
            plan = trn.rms_norm_plan(d, dtype)
            assert plan.vec == v
            assert 1 <= plan.warps <= 16 and 1 <= plan.vecs <= 8
            assert plan.warps * 32 * plan.vecs >= d // v
            if plan.warps < 16:     # the fewest warps at 2 vectors a lane
                assert plan.vecs <= 2 and (plan.warps - 1) * 64 < d // v
            else:                   # then the fewest vectors a lane
                assert (plan.vecs - 1) * 512 < d // v


def _mirror(x, w, eps, plan):
    """float32 rows normalised in the kernel's order under ``plan``: lane
    (q, l) owns vectors (k * warps + q) * 32 + l; per element position j
    an fma chain over k (the fma's one rounding taken in float64), the
    chains added in a pairwise tree over j, the xor butterfly over the 32
    lanes, the warps' sums in order; then x * rsqrt(mean + eps) * w."""
    n, d = x.shape
    v, warps, vecs = plan.vec, plan.warps, plan.vecs
    nvec = d // v
    xv = torch.zeros(n, warps * 32 * vecs, v, dtype=torch.float32)
    xv[:, :nvec] = x.reshape(n, nvec, v)
    k = torch.arange(vecs)[:, None, None]
    q = torch.arange(warps)[None, :, None]
    lane = torch.arange(32)[None, None, :]
    g = xv[:, (k * warps + q) * 32 + lane]           # [n, K, W, 32, V]
    acc = torch.zeros(n, warps, 32, v, dtype=torch.float32)
    for kk in range(vecs):
        f = g[:, kk].double()
        acc = (f * f + acc.double()).float()
    st = 1
    while st < v:
        acc = acc.clone()
        acc[..., 0::2 * st] = acc[..., 0::2 * st] + acc[..., st::2 * st]
        st *= 2
    ss = acc[..., 0]                                  # [n, W, 32]
    for o in (16, 8, 4, 2, 1):
        ss = ss + ss[..., torch.arange(32) ^ o]
    tot = torch.zeros(n, dtype=torch.float32)
    for p in range(warps):
        tot = tot + ss[:, p, 0]
    r = torch.rsqrt(tot / torch.tensor(float(d)) + eps)
    return x * r[:, None] * w


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d", [(5, 64), (3, 2048), (4, 4096), (2, 4104)])
def test_rms_norm_reduction_order_mirror(dtype, n, d):
    """The mirror follows the plan of ``dtype`` (the order the kernel
    takes for that dtype) on float32 values."""
    rng = np.random.default_rng(n * d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    got = _mirror(_t(x), _t(w), 1e-5, trn.rms_norm_plan(d, dtype))
    np.testing.assert_allclose(got.numpy(),
                               trn.rms_norm_plain(_t(x), _t(w), 1e-5).numpy(),
                               atol=1e-6, rtol=0)
    ref = np.asarray(jrn._rms_fwd_impl(jnp.asarray(x), jnp.asarray(w), 1e-5))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_wrapper_hands_the_kernel_its_plan(monkeypatch, dtype):
    x = torch.zeros(3, 5, 4096, dtype=dtype)
    w = torch.ones(4096, dtype=dtype)
    seen = []
    monkeypatch.setattr(trn.KERNEL, "launch", lambda *a: seen.append(a))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: ctypes.c_void_p(None))
    y = trn._rms_norm_cuda(x, w, 1e-5)
    assert y.shape == x.shape and len(seen) == 1
    plan = trn.rms_norm_plan(4096, dtype)
    assert seen[0][3:9] == (15, 4096, 1e-5, trn._DTYPES[dtype], plan.warps,
                            plan.vecs)


def test_rms_norm_refuses_rows_wider_than_the_kernel_holds():
    for dtype, d in ((torch.bfloat16, 32768 + 8), (torch.float32, 16392)):
        with pytest.raises(ValueError, match="16-byte vectors"):
            trn._check_operands(torch.zeros(2, d, dtype=dtype),
                                torch.ones(d, dtype=dtype))
    assert trn._check_operands(torch.zeros(2, 16384),
                               torch.ones(16384)) == 2


def test_stream_ptr_refuses_another_device(monkeypatch):
    """The current stream comes from torch at every call; a tensor on
    another device than the current one is refused."""
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 4096 + dev, raising=False)

    class OnDevice:
        def __init__(self, index):
            self.index = index
            self.device = f"cuda:{index}"

        def get_device(self):
            return self.index

    assert _build.stream_ptr(OnDevice(0)) == 4096
    with pytest.raises(ValueError, match="current CUDA device is 0"):
        _build.stream_ptr(OnDevice(1))


# ---- RMSNorm: the host path ----

@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_no_grad_path_equals_autograd_path(monkeypatch, dtype):
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((4, 6, 64)).astype(np.float32)).to(dtype)
    w = _t((1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)).to(
        dtype)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    with_grad = trn.rms_norm(xg, wg, 1e-5)
    assert with_grad.grad_fn is not None
    assert "rms_norm" in type(with_grad.grad_fn).__name__
    # every call goes through the dispatcher op; its CPU body runs the
    # module's ``rms_norm_plain``, looked up when the op runs
    ran = []
    fwd = trn.rms_norm_plain
    monkeypatch.setattr(trn, "rms_norm_plain",
                        lambda *a: ran.append(1) or fwd(*a))
    plain = trn.rms_norm(x, w, 1e-5)                # nothing requires grad
    with torch.no_grad():
        nograd = trn.rms_norm(xg, wg, 1e-5)         # grad disabled
    assert ran == [1, 1]
    assert plain.grad_fn is None and nograd.grad_fn is None
    assert torch.equal(plain, with_grad.detach())
    assert torch.equal(nograd, with_grad.detach())
    assert trn.rms_norm(xg, wg, 1e-5).grad_fn is not None
    assert ran == [1, 1, 1]


def test_rms_norm_gradients_under_grad_are_rms_norm_bwd():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((3, 5, 64)).astype(np.float32)
    tx, tw = _t(x, grad=True), _t(w, grad=True)
    (trn.rms_norm(tx, tw, 1e-5) * _t(g)).sum().backward()
    dx, dw = trn.rms_norm_bwd(_t(x), _t(w), _t(g), 1e-5)
    assert torch.equal(tx.grad, dx) and torch.equal(tw.grad, dw)
    assert trn.KERNEL.launches == 0
