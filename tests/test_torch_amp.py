"""AMP of the port held against the JAX package's on the CPU: the dtype
every op of a tiny Llama forward computes in under O1 and O2, the O1
and O2 logits, ``decorate``, AMP in ``TrainStep`` and through a
recomputed layer, ``GradScaler``'s sequence with an inf step, the
debugging helpers and ``FLAGS_low_precision_op_list``.

Tolerances, each with its reason: the per-op dtypes and the scaler's
history are compared exactly; logits under O1/O2 within ``atol 0.05``
(bf16 products: a bf16 ulp near the logits' magnitude of about 3 is
2^-6, and a few such roundings differ between XLA's and torch's bf16
kernels); O1 train-step losses within ``rtol 2e-3`` (bf16 logits feed a
bf16 log-softmax on both sides); the scaler's parameters within ``atol
1e-6`` (float32 SGD).
"""

from importlib import import_module

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.amp import debugging as jdebug
from paddle_tpu.core import dispatch as jdispatch
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
import paddle_tpu_torch
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.amp import debugging as tdebug
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)
from paddle_tpu_torch.optimizer import SGD, AdamW

# the module (the package re-exports its function under the same name)
tcast = import_module("paddle_tpu_torch.amp.auto_cast")
PORT_OPS = {"embedding", "rms_norm", "linear", "llama_rope", "sdpa", "add",
            "swiglu", "cross_entropy"}
_JDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "float16": torch.float16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def nets():
    paddle.seed(17)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    arrays = {n: np.array(p._value, copy=True)
              for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays), strict=True)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, (2, 16)).astype(np.int32)
    return jnet, tnet, arrays, tokens


def _jax_op_trace(fn):
    """(op name, floating input dtypes after the AMP cast) of every op the
    JAX package dispatches inside ``fn``."""
    log = []
    orig = jdispatch._dispatch_impl

    def rec(op_name, impl, tensor_args, *a, **k):
        d = jdispatch._amp_cast_hook(op_name)
        dts = []
        for t in tensor_args:
            dt = getattr(t, "dtype", None)
            if dt is not None and jnp.issubdtype(dt, jnp.floating):
                dts.append(_JDT[str(jnp.dtype(d if d is not None else dt))])
        log.append((op_name, tuple(dts)))
        return orig(op_name, impl, tensor_args, *a, **k)

    jdispatch._dispatch_impl = rec
    try:
        fn()
    finally:
        jdispatch._dispatch_impl = orig
    return [e for e in log if e[0] in PORT_OPS]


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_per_op_dtypes_match_jax(nets, level):
    jnet, tnet, _, tokens = nets

    def jrun():
        with paddle.amp.auto_cast(level=level):
            jnet(paddle.to_tensor(tokens), labels=paddle.to_tensor(tokens))

    want = _jax_op_trace(jrun)
    with tcast._trace_ops() as got, tamp.auto_cast(level=level):
        tnet(torch.from_numpy(tokens), labels=torch.from_numpy(tokens))
    assert got == want
    assert len(got) == 1 + tiny_llama_config().num_hidden_layers * 14 + 3


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_logits_match_jax(nets, level):
    jnet, tnet, _, tokens = nets
    with paddle.amp.auto_cast(level=level):
        want = jnet(paddle.to_tensor(tokens))
    with tamp.auto_cast(level=level):
        got = tnet(torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want._value, np.float32),
                               atol=0.05, rtol=0)


def test_decorate_o2_matches_jax(nets):
    _, _, arrays, tokens = nets
    paddle.seed(17)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays), strict=True)
    jopt = paddle.optimizer.AdamW(1e-3, parameters=jnet.parameters())
    t_opt = AdamW(1e-3, parameters=tnet.parameters())
    jnet, jopt = paddle.amp.decorate(jnet, jopt, level="O2")
    params = list(tnet.parameters())
    tnet2, t_opt2 = tamp.decorate(tnet, t_opt, level="O2")
    assert tnet2 is tnet and t_opt2 is t_opt and t_opt._multi_precision
    assert jopt._multi_precision
    assert all(p.dtype == torch.bfloat16 for p in tnet.parameters())
    assert all(a is b for a, b in zip(params, t_opt._parameter_list))
    with paddle.amp.auto_cast(level="O2"):
        want = jnet(paddle.to_tensor(tokens))
    with tamp.auto_cast(level="O2"):
        got = tnet(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want._value, np.float32),
                               atol=0.05, rtol=0)
    assert tamp.decorate(tnet, level="O1") is tnet


def test_custom_lists_and_hook(nets):
    with tamp.auto_cast(level="O1", custom_black_list={"linear"},
                        custom_white_list={"swiglu"}):
        assert tcast._amp_hook("linear") is None
        assert tcast._amp_hook("swiglu") == torch.bfloat16
        assert tcast._amp_hook("add") is None
    with tamp.auto_cast(level="O2", dtype="float16"):
        assert tcast._amp_hook("add") == torch.float16
        assert tcast._amp_hook("softmax") == torch.float32
    assert tcast._amp_hook("linear") is None
    assert tamp.white_list() == paddle.amp.white_list()
    assert tamp.black_list() == paddle.amp.black_list()


def test_o1_train_step_matches_jax(nets):
    _, _, arrays, tokens = nets
    paddle.seed(17)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config(
        recompute=True))
    jnet.train()
    tnet = LlamaForCausalLM(tiny_llama_config(recompute=True), device="cpu",
                            init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays), strict=True)
    tnet.train()

    def jloss(net, t):
        with paddle.amp.auto_cast(level="O1"):
            return net(t, labels=t)[0]

    def tloss(net, t):
        with tamp.auto_cast(level="O1"):
            return net(t, labels=t)[0]

    jstep = JTrainStep(jnet, jloss, paddle.optimizer.AdamW(
        1e-3, parameters=jnet.parameters(), multi_precision=True))
    tstep = TrainStep(tnet, tloss, AdamW(1e-3, parameters=tnet.parameters(),
                                         multi_precision=True))
    jl = [float(jstep(paddle.to_tensor(tokens))) for _ in range(3)]
    tl = [float(tstep(tokens)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert tl[-1] < tl[0]


def test_recompute_replays_the_amp_state(nets):
    """The backward's run of a recomputed layer (outside ``auto_cast``)
    computes in the first forward's dtypes: gradients equal those of the
    same forward without recompute, bit for bit."""
    _, _, arrays, tokens = nets
    grads = []
    for recompute in (True, False):
        tnet = LlamaForCausalLM(tiny_llama_config(recompute=recompute),
                                device="cpu", init=False)
        tnet.load_state_dict(llama_state_from_jax(arrays), strict=True)
        tnet.train()
        with tamp.auto_cast(level="O1"):
            loss, _ = tnet(torch.from_numpy(tokens),
                           labels=torch.from_numpy(tokens))
        grads.append(torch.autograd.grad(loss, list(tnet.parameters())))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ---- GradScaler ----

def _scaler_run(side):
    rng = np.random.default_rng(9)
    init = rng.standard_normal((3, 4)).astype(np.float32)
    gs = [rng.standard_normal((3, 4)).astype(np.float32) * 512
          for _ in range(7)]
    gs[2][1, 1] = np.inf
    gs[5][0, 0] = np.nan
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1, incr_ratio=2.0, decr_ratio=0.5)
    hist = []
    if side == "j":
        p = paddle.nn.Parameter(np.array(init, copy=True))
        opt = paddle.optimizer.SGD(0.1, parameters=[p])
        scaler = paddle.amp.GradScaler(**kw)
        for g in gs:
            p._grad = paddle.to_tensor(np.array(g, copy=True))
            scaler.step(opt)
            found = scaler._found_inf
            scaler.update()
            hist.append((float(scaler.get_loss_scaling()), found,
                         dict(scaler.state_dict())))
        return np.asarray(p._value), hist
    p = torch.nn.Parameter(torch.tensor(init))
    opt = SGD(0.1, parameters=[p])
    scaler = tamp.GradScaler(**kw)
    for g in gs:
        p.grad = torch.tensor(g)
        scaler.step(opt)
        found = scaler._found_inf
        scaler.update()
        hist.append((float(scaler.get_loss_scaling()), found,
                     dict(scaler.state_dict())))
    return p.detach().numpy(), hist


def test_grad_scaler_sequence_matches_jax():
    jp, jh = _scaler_run("j")
    tp, th = _scaler_run("t")
    assert th == jh
    assert [found for _, found, _ in th].count(True) == 2
    np.testing.assert_allclose(tp, jp, atol=1e-6, rtol=0)


def test_grad_scaler_scale_minimize_and_state():
    p = torch.nn.Parameter(torch.ones(3))
    opt = SGD(0.5, parameters=[p])
    scaler = tamp.GradScaler(init_loss_scaling=8.0)
    jscaler = paddle.amp.GradScaler(init_loss_scaling=8.0)
    loss = (p * torch.tensor([1.0, 2.0, 3.0])).sum()
    scaled = scaler.scale(loss)
    assert float(scaled) == 8.0 * 6.0
    scaler.minimize(opt, scaled)
    assert torch.allclose(p.detach(), torch.tensor([0.5, 0.0, -0.5]))
    assert scaler.state_dict() == dict(jscaler.state_dict(),
                                       incr_count=1)
    off = tamp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()
    scaler.load_state_dict({"scale": 4.0, "incr_count": 3})
    assert float(scaler.get_loss_scaling()) == 4.0
    assert scaler.state_dict()["incr_count"] == 3


# ---- debugging and the flag ----

def test_check_numerics_and_debug_mode_match_jax():
    good = np.array([1.0, 2.0], np.float32)
    bad = np.array([1.0, np.nan, np.inf, np.inf], np.float32)
    jn, ji = jdebug.check_numerics(paddle.to_tensor(good), "op", "x")
    tn, ti = tdebug.check_numerics(torch.from_numpy(good), "op", "x")
    assert (int(tn), int(ti)) == (int(jn._value), int(ji._value)) == (0, 0)
    with pytest.raises(FloatingPointError) as want:
        jdebug.check_numerics(paddle.to_tensor(bad), "op", "x")
    with pytest.raises(FloatingPointError) as got:
        tdebug.check_numerics(torch.from_numpy(bad), "op", "x")
    assert str(got.value) == str(want.value)
    for k in ("CHECK_NAN_INF_AND_ABORT", "CHECK_NAN_INF", "CHECK_ALL"):
        assert getattr(tdebug.DebugMode, k) == getattr(jdebug.DebugMode, k)
    with tdebug.collect_operator_stats():
        pass
    tdebug.disable_tensor_checker()
    # the checker's flag selects the eager NaN/Inf scan, not ported yet
    with pytest.raises(NotImplementedError, match="check_nan_inf"):
        tdebug.enable_tensor_checker()


def test_low_precision_op_list_flag_takes_any_value():
    old = paddle_tpu_torch.get_flags("FLAGS_low_precision_op_list")
    try:
        paddle_tpu_torch.set_flags({"FLAGS_low_precision_op_list": 1})
        assert paddle_tpu_torch.get_flags("FLAGS_low_precision_op_list") == \
            {"FLAGS_low_precision_op_list": 1}
    finally:
        paddle_tpu_torch.set_flags(old)
