"""The slice test of the tensor facade: phase 8c's decoder
(``chip_smoke.tensor_decoder_class``, written against the top-level
tensor API only) at a tiny width in float32 on the CPU, held against the
same code run on the JAX package's facade with the weights carried
through numpy: the loss and every gradient within 1e-5 of the largest.
Also: the smoke's numpy copy of the sweep's input rules
(``chip_smoke.sweep_inputs``) equals the reference sweep's inputs, op for
op, so the card's sweep (8c (e)) runs the CPU sweep's cases."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden=64, heads=4, kv_heads=2, ffn=96, layers=2, eps=1e-5,
            rope_base=500000.0, std=0.05)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tensor_api", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    prev = tdevice._layer_device
    pt.set_device("cpu")
    yield
    tdevice._layer_device = prev


def _build(P):
    c = TINY
    return SMOKE.tensor_decoder_class(P)(
        c["hidden"], c["heads"], c["kv_heads"], c["ffn"], c["layers"],
        c["eps"], c["rope_base"], "float32", c["std"])


def _carry(jm, tm):
    """The JAX twin takes the port model's weights, through numpy."""
    for jl, tl in zip(jm.layers, tm.layers):
        for k in jl:
            jl[k] = paddle.to_tensor(tl[k].numpy(), stop_gradient=False)
    jm.norm = paddle.to_tensor(tm.norm.numpy(), stop_gradient=False)


def _run(P, model, x_np):
    x = P.to_tensor(x_np.copy(), stop_gradient=False)
    loss = model.loss(model.forward(x))
    loss.backward()
    grads = [np.asarray(p.grad._value) if hasattr(p.grad, "_value")
             else p.grad.numpy() for p in model.parameters()]
    xg = x.grad
    grads.append(np.asarray(xg._value) if hasattr(xg, "_value")
                 else xg.numpy())
    return float(loss), grads


def test_tensor_api_decoder_matches_jax():
    pt.seed(3)
    tm = _build(pt)
    assert all(isinstance(p, pt.Tensor) and not p.stop_gradient
               for p in tm.parameters())
    paddle.seed(3)
    jm = _build(paddle)
    _carry(jm, tm)
    x = np.random.default_rng(4).standard_normal(
        (2, 8, TINY["hidden"])).astype(np.float32)
    jl, jg = _run(paddle, jm, x)
    tl, tg = _run(pt, tm, x)
    assert abs(tl - jl) <= 1e-5 * max(abs(jl), 1e-30), (tl, jl)
    assert len(jg) == len(tg) == 8 * TINY["layers"] + 2
    for i, (w, g) in enumerate(zip(jg, tg)):
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= 1e-5 * scale, (i, err, scale)


def test_tensor_api_decoder_pylayer_and_grad():
    """The SwiGLU PyLayer's hand-written backward equals autograd through
    the same facade ops, and ``grad(loss, [x])`` equals the ``.grad``
    route, on the port."""
    Swi = SMOKE.tensor_decoder_class(pt).SwiGLU
    rng = np.random.default_rng(6)
    g = pt.to_tensor(rng.standard_normal((3, 8)).astype(np.float32),
                     stop_gradient=False)
    u = pt.to_tensor(rng.standard_normal((3, 8)).astype(np.float32),
                     stop_gradient=False)
    w = pt.to_tensor(rng.standard_normal((3, 8)).astype(np.float32))
    (Swi.apply(g, u) * w).sum().backward()
    g2, u2 = g.detach().clone(), u.detach().clone()
    g2.stop_gradient = u2.stop_gradient = False
    ((g2 * (1.0 / (1.0 + pt.exp(-g2)))) * u2 * w).sum().backward()
    np.testing.assert_allclose(g.grad.numpy(), g2.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(u.grad.numpy(), u2.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    pt.seed(5)
    tm = _build(pt)
    x = pt.to_tensor(np.ones((1, 4, TINY["hidden"]), np.float32),
                     stop_gradient=False)
    tm.loss(tm.forward(x)).backward()
    (gx,) = pt.grad(tm.loss(tm.forward(x)), [x])
    np.testing.assert_allclose(gx.numpy(), x.grad.numpy(), rtol=1e-6,
                               atol=1e-7)


def _faulty_flash_bwd(fault):
    """``ops.flash_attention._bwd_core_onepass`` with one planted fault
    in (dQ, dK, dV)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    core = fa._bwd_core_onepass

    def bad(*args):
        dq, dk, dv = core(*args)
        if fault == "dq sign flipped":
            dq = -dq
        elif fault == "dq zero":
            dq = torch.zeros_like(dq)
        elif fault == "dk scaled by 1.001":
            dk = dk * 1.001
        return dq, dk, dv

    return bad


@pytest.mark.parametrize("fault", [None, "dq sign flipped", "dq zero",
                                   "dk scaled by 1.001"])
def test_card_vs_cpu_check_catches_a_faulty_backward(fault, monkeypatch):
    """8c (d)'s check (``tensor_api_grads`` on each side, then
    ``hold_by_own_largest``) rehearsed on the CPU at 1 layer, float32,
    with the "card" side's flash backward faulty: each fault fails the
    check at its limit, and a clean run passes it."""
    from paddle_tpu_torch.ops import flash_attention as fa
    c = TINY
    pt.seed(11)
    host = SMOKE.tensor_decoder_class(pt)(
        c["hidden"], c["heads"], c["kv_heads"], c["ffn"], 1, c["eps"],
        c["rope_base"], "float32", c["std"])
    card = SMOKE.copy_decoder_to(pt, host, "cpu")
    xh = pt.randn([1, 16, c["hidden"]])
    want = SMOKE.tensor_api_grads(pt, host, xh, "cpu")
    if fault is not None:
        monkeypatch.setattr(fa, "_bwd_core_onepass", _faulty_flash_bwd(fault))
    got = SMOKE.tensor_api_grads(pt, card, xh, "cpu")
    # the gradients are small, as at the card's width: a limit that is
    # absolute at scale 1 could not see these faults
    assert max(float(w.abs().max()) for w in want[1:]) < 1.0
    if fault is None:
        err, _ = SMOKE.hold_by_own_largest(torch, "8c (d)", got, want,
                                           SMOKE.TENSOR_API_REL)
        assert err <= 1e-6
    else:
        with pytest.raises(AssertionError, match="of its largest entry"):
            SMOKE.hold_by_own_largest(torch, "8c (d)", got, want,
                                      SMOKE.TENSOR_API_REL)


def test_smoke_sweep_inputs_are_the_references():
    """``chip_smoke.sweep_inputs`` (numpy only) builds, for every op of
    the sweep, the inputs the reference sweep builds: same structure,
    dtypes and values."""
    import test_op_sweep as ref_sweep
    from paddle_tpu.core.tensor import Tensor as JTensor
    from paddle_tpu.ops.registry import registry as jregistry
    from paddle_tpu.ops.registry import resolve as jresolve
    from paddle_tpu_torch.ops.registry import registry_by_name, resolve

    def same(a, b, op):
        if isinstance(a, JTensor):
            assert isinstance(b, pt.Tensor), op
            w = np.asarray(a._value)
            assert b.numpy().dtype == w.dtype or (
                w.dtype.name == "bfloat16"), op
            np.testing.assert_array_equal(b.numpy(), w, err_msg=op)
        elif isinstance(a, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b), op
            for x, y in zip(a, b):
                same(x, y, op)
        elif isinstance(a, dict):
            assert a.keys() == b.keys(), op
            for k in a:
                same(a[k], b[k], op)
        else:
            assert a == b, op

    tspecs = registry_by_name()
    n = 0
    for spec in jregistry():
        if spec.op in SMOKE.SWEEP_SKIP:
            continue
        want = ref_sweep._auto_inputs(spec, jresolve(spec))
        got = SMOKE.sweep_inputs(
            spec.op, resolve(tspecs[spec.op]),
            lambda a: pt.to_tensor(a, place="cpu"), pt.nn.functional)
        same(tuple(want), tuple(got), spec.op)
        n += 1
    assert n == 384
