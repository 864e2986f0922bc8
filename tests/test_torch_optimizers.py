"""The port's eager optimizers held against the JAX package's on the CPU:
every optimizer's ``step()`` for 4 steps on the same parameters and
gradients, parameter groups, ``optimize_attr``, ``L1Decay``/``L2Decay``,
``apply_decay_param_fun``, ``lr_ratio``, clips, an LR schedule, master
weights, ``LBFGS.step(closure)``, ``state_dict``/``set_state_dict`` and
the optimizer-state bridge (``models.convert``).

Tolerance: ``atol 1e-6, rtol 1e-6`` on float32 parameters and
accumulators (the same float32 operations; XLA and torch may round a
fused chain or a reduction in another order); bf16 parameters under
master weights: the fp32 masters within that bound, the bf16 parameters
within one bf16 ulp of them (a master on a rounding boundary may round
either way).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu import nn as jnn
from paddle_tpu.regularizer import L1Decay as JL1, L2Decay as JL2
import paddle_tpu_torch
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models.convert import LINEAR_NAMES
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     optimizer_state_from_jax,
                                     optimizer_state_to_jax, tiny_llama_config)
from paddle_tpu_torch.regularizer import L1Decay as TL1, L2Decay as TL2

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = [(4, 3), (5,), (2, 2, 3)]
NAMES = ["w", "b", "k"]
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]


def _pair(dtype="float32"):
    """The same parameters on both sides (named, for
    ``apply_decay_param_fun``)."""
    arrs = _arrays(0)
    jps = [jnn.Parameter(np.array(a, copy=True), name=n)
           for a, n in zip(arrs, NAMES)]
    tps = [torch.nn.Parameter(torch.tensor(a)) for a in arrs]
    if dtype == "bfloat16":
        for p in jps:
            p._value = p._value.astype("bfloat16")
        tps = [torch.nn.Parameter(p.detach().to(torch.bfloat16))
               for p in tps]
    return jps, tps


def _set_grads(jps, tps, step, scale=1.0):
    for jp, tp, g in zip(jps, tps, _arrays(100 + step, scale)):
        jp._grad = paddle.to_tensor(np.array(g, copy=True)).astype(
            jp._value.dtype)
        tp.grad = torch.tensor(g).to(tp.dtype)


def _params_close(jps, tps, tol=TOL):
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().float().numpy(),
                                   np.asarray(jp._value, np.float32), **tol)


def _state_close(jopt, topt_):
    js, ts = jopt.state_dict(), topt_.state_dict()
    assert set(js) == set(ts)
    for k, v in js.items():
        if k == "LR_Scheduler":
            assert ts[k] == v
            continue
        np.testing.assert_allclose(ts[k].float().numpy(),
                                   np.asarray(v._value, np.float32), **TOL,
                                   err_msg=k)


# (class name, keyword arguments built per side: each value may be a
# callable taking "j" or "t")
CASES = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "sgd_l2": ("SGD", dict(learning_rate=0.1, weight_decay=0.01)),
    "momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9)),
    "nesterov": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  use_nesterov=True)),
    "adam": ("Adam", dict(learning_rate=0.01)),
    "adam_l2": ("Adam", dict(learning_rate=0.01, weight_decay=0.02)),
    "adamw": ("AdamW", dict(learning_rate=0.01, weight_decay=0.05)),
    "adamw_decay_fun": ("AdamW", dict(
        learning_rate=0.01, weight_decay=0.05,
        apply_decay_param_fun=lambda n: n != "b")),
    "adamw_lr_ratio": ("AdamW", dict(learning_rate=0.01,
                                     lr_ratio=lambda p: 0.5)),
    "adamax": ("Adamax", dict(learning_rate=0.01, beta2=0.99)),
    "lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.02,
                          exclude_from_weight_decay_fn=lambda p: p.ndim == 1)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, momentum=0.5)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, centered=True)),
    "adagrad": ("Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    "momentum_l1": ("Momentum", dict(learning_rate=0.05,
                                     weight_decay=lambda s: (
                                         JL1 if s == "j" else TL1)(0.01))),
    "adam_l2decay": ("Adam", dict(learning_rate=0.01,
                                  weight_decay=lambda s: (
                                      JL2 if s == "j" else TL2)(0.02))),
    "adamw_l2decay": ("AdamW", dict(learning_rate=0.01,
                                    weight_decay=lambda s: (
                                        JL2 if s == "j" else TL2)(0.02))),
    "adamw_global_clip": ("AdamW", dict(
        learning_rate=0.01, grad_clip=lambda s: (
            jnn if s == "j" else tnn).ClipGradByGlobalNorm(0.5))),
    "sgd_norm_clip": ("SGD", dict(
        learning_rate=0.1, grad_clip=lambda s: (
            jnn if s == "j" else tnn).ClipGradByNorm(0.3))),
    "momentum_value_clip": ("Momentum", dict(
        learning_rate=0.05, grad_clip=lambda s: (
            jnn if s == "j" else tnn).ClipGradByValue(0.2))),
}


def _kw(kw, side):
    return {k: (v(side) if callable(v) and k in ("weight_decay",
                                                  "grad_clip") else v)
            for k, v in kw.items()}


def _make(cls, kw, jps, tps):
    """Both optimizers; the port's gets ``(name, param)`` pairs, which
    name its parameters as the JAX side's are named."""
    return (getattr(paddle.optimizer, cls)(parameters=jps, **_kw(kw, "j")),
            getattr(topt, cls)(parameters=list(zip(NAMES, tps)),
                               **_kw(kw, "t")))


@pytest.mark.parametrize("case", list(CASES))
def test_eager_step_matches_jax(case):
    cls, kw = CASES[case]
    jps, tps = _pair()
    jopt, t_opt = _make(cls, kw, jps, tps)
    for s in range(STEPS):
        _set_grads(jps, tps, s, scale=3.0 if "clip" in case else 1.0)
        jopt.step()
        t_opt.step()
        _params_close(jps, tps)
    _state_close(jopt, t_opt)


def test_param_groups_and_optimize_attr_match_jax():
    jps, tps = _pair()
    jps[2].optimize_attr["learning_rate"] = 0.3
    tps[2].optimize_attr = {"learning_rate": 0.3}

    def groups(ps, l1):
        return [{"params": [ps[0]], "learning_rate": 0.5,
                 "weight_decay": 0.0},
                {"params": [ps[1]], "weight_decay": l1(0.01)},
                {"params": [ps[2]], "weight_decay": 0.02}]

    jopt = paddle.optimizer.Adam(0.01, parameters=groups(jps, JL1),
                                 weight_decay=0.05)
    t_opt = topt.Adam(0.01, parameters=groups(tps, TL1), weight_decay=0.05)
    for s in range(STEPS):
        _set_grads(jps, tps, s)
        jopt.step()
        t_opt.step()
    _params_close(jps, tps)
    _state_close(jopt, t_opt)


def test_lr_schedule_and_clear_grad_match_jax():
    jps, tps = _pair()
    js = paddle.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    ts = topt.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    jopt = paddle.optimizer.Momentum(js, parameters=jps)
    t_opt = topt.Momentum(ts, parameters=tps)
    for s in range(STEPS):
        _set_grads(jps, tps, s)
        jopt.step()
        t_opt.step()
        js.step()
        ts.step()
        t_opt.clear_grad()
        assert all(p.grad is None for p in tps)
    _params_close(jps, tps)
    _state_close(jopt, t_opt)


@pytest.mark.parametrize("cls", ["SGD", "Momentum", "AdamW"])
def test_master_weights_match_jax(cls):
    jps, tps = _pair("bfloat16")
    kw = dict(learning_rate=0.05, multi_precision=True)
    jopt, t_opt = _make(cls, kw, jps, tps)
    for s in range(STEPS):
        _set_grads(jps, tps, s)
        jopt.step()
        t_opt.step()
    _state_close(jopt, t_opt)
    assert all(p.dtype == torch.bfloat16 for p in tps)
    _params_close(jps, tps, dict(atol=0, rtol=2 ** -7))
    assert set(k for k in t_opt.state_dict() if k.startswith("master_")) \
        == {"master_0", "master_1", "master_2"}


def test_lbfgs_closure_matches_jax():
    jps, tps = _pair()
    targets = _arrays(7)

    def closure_for(ps, side):
        def closure():
            if side == "j":
                for p in ps:
                    p.clear_grad()
                loss = sum((((p - paddle.to_tensor(t)) ** 2) * (i + 1.0))
                           .sum() for i, (p, t) in enumerate(zip(ps,
                                                                 targets)))
            else:
                for p in ps:
                    p.grad = None
                loss = sum((((p - torch.tensor(t)) ** 2) * (i + 1.0)).sum()
                           for i, (p, t) in enumerate(zip(ps, targets)))
            loss.backward()
            return loss
        return closure

    jopt = paddle.optimizer.LBFGS(learning_rate=0.1, parameters=jps)
    t_opt = topt.LBFGS(learning_rate=0.1, parameters=tps)
    for _ in range(STEPS):
        jl = jopt.step(closure_for(jps, "j"))
        tl = t_opt.step(closure_for(tps, "t"))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _params_close(jps, tps, dict(atol=1e-5, rtol=1e-5))
    assert len(t_opt._s_hist) == len(jopt._s_hist) > 0


def test_state_dict_from_jax_resumes_equal():
    jps, tps = _pair()
    sched = dict(learning_rate=0.01, weight_decay=0.05)
    jopt = paddle.optimizer.AdamW(parameters=jps, **sched)
    for s in range(2):
        _set_grads(jps, tps, s)
        jopt.step()
    # the port starts from the JAX side's parameters and optimizer state
    with torch.no_grad():
        for jp, tp in zip(jps, tps):
            tp.copy_(torch.from_numpy(np.array(jp._value, copy=True)))
    jstate = {k: np.asarray(v._value) for k, v in jopt.state_dict().items()}
    t_opt = topt.AdamW(parameters=tps, **sched)
    t_opt.set_state_dict(optimizer_state_from_jax(jstate, NAMES))
    for s in range(2, 4):
        _set_grads(jps, tps, s)
        jopt.step()
        t_opt.step()
    _params_close(jps, tps)
    _state_close(jopt, t_opt)


def _as_port(name, arr):
    """A JAX array of parameter ``name`` in the port's layout."""
    arr = np.asarray(arr)
    parts = name.split(".")
    return arr.T if parts[-1] == "weight" and parts[-2] in LINEAR_NAMES \
        else arr


def _llama_grads(jnet, tnet, seed):
    """Random gradients for every parameter: JAX layout on the JAX side,
    the port's ([out, in] Linear) on the port's.  (The JAX model's eager
    tape does not reach the MLP's gate and up projections, whose outputs
    it re-wraps for the remat tags, so gradients are set, not
    computed.)"""
    rng = np.random.default_rng(seed)
    tparams = dict(tnet.named_parameters())
    for name, p in jnet.named_parameters():
        g = rng.standard_normal(p._value.shape).astype(np.float32)
        p._grad = paddle.to_tensor(np.array(g, copy=True))
        tp = tparams[name]
        tp.grad = torch.from_numpy(np.ascontiguousarray(_as_port(name, g)))


@pytest.fixture(scope="module")
def llama_pair():
    """The tiny Llama on both sides after one eager AdamW step from the
    same weights and gradients."""
    paddle.seed(5)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    arrays = {n: np.array(p._value, copy=True)
              for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays), strict=True)
    jopt = paddle.optimizer.AdamW(0.01, parameters=jnet.parameters())
    t_opt = topt.AdamW(0.01, parameters=tnet.parameters())
    _llama_grads(jnet, tnet, 0)
    jopt.step()
    t_opt.step()
    return dict(jnet=jnet, tnet=tnet, jopt=jopt, topt=t_opt)


def test_optimizer_state_bridge_both_ways(llama_pair):
    jnames = [n for n, _ in llama_pair["jnet"].named_parameters()]
    tnames = [n for n, _ in llama_pair["tnet"].named_parameters()]
    jstate = {k: np.asarray(v._value)
              for k, v in llama_pair["jopt"].state_dict().items()}
    tstate = llama_pair["topt"].state_dict()
    # JAX -> port: the keys of the port's own state dict, its layouts,
    # and values within the eager step's tolerance of the port's own
    bridged = optimizer_state_from_jax(jstate, jnames, tnames)
    assert set(bridged) == set(tstate)
    for k, v in tstate.items():
        assert bridged[k].shape == v.shape, k
        np.testing.assert_allclose(bridged[k].numpy(), v.numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    # and back, exactly
    back = optimizer_state_to_jax(bridged, tnames, jnames)
    assert set(back) == set(jstate)
    for k, v in jstate.items():
        assert np.array_equal(back[k], v), k
    # port -> JAX loads into a JAX optimizer
    jopt2 = paddle.optimizer.AdamW(
        0.01, parameters=llama_pair["jnet"].parameters())
    jopt2.set_state_dict(optimizer_state_to_jax(tstate, tnames, jnames))
    for k, v in jopt2.state_dict().items():
        np.testing.assert_allclose(np.asarray(v._value), jstate[k],
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def test_eager_llama_step_resumes_from_a_bridged_state(llama_pair):
    """A fresh port optimizer given the JAX state takes the same next
    step as the JAX optimizer."""
    jnet, tnet = llama_pair["jnet"], llama_pair["tnet"]
    jnames = [n for n, _ in jnet.named_parameters()]
    tnames = [n for n, _ in tnet.named_parameters()]
    arrays = {n: np.array(p._value, copy=True)
              for n, p in jnet.named_parameters()}
    tnet2 = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet2.load_state_dict(llama_state_from_jax(arrays), strict=True)
    t_opt = topt.AdamW(0.01, parameters=tnet2.parameters())
    t_opt.set_state_dict(optimizer_state_from_jax(
        {k: np.asarray(v._value)
         for k, v in llama_pair["jopt"].state_dict().items()},
        jnames, tnames))
    _llama_grads(jnet, tnet2, 1)
    llama_pair["jopt"].step()
    t_opt.step()
    tparams = dict(tnet2.named_parameters())
    for name, p in jnet.named_parameters():
        np.testing.assert_allclose(tparams[name].detach().numpy(),
                                   _as_port(name, p._value), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert paddle_tpu_torch.optimizer.AdamW is topt.AdamW
