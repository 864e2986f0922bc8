"""The rest of the port's single-device pretraining held against the JAX
package on the CPU: SGD, Momentum, Adam and AdamW (with the
``adamw_rsqrt_update`` form and the fused route), gradient merge,
``run_steps`` and LR schedulers through ``TrainStep``, on the same
weights carried over by the weight bridge; plus the flag registry, the
key generator and bf16 moments.

``tiny_llama_config()`` in ``.train()``, float32.  Tolerances, as
``test_torch_train.py`` states them with their reasons: per-call losses
within ``rtol 1e-5``; final parameters within ``atol 1e-5``; optimizer
state (moments, velocity) within ``rtol 1e-4`` plus ``1e-5`` of the
tensor's largest entry.  One exception for parameters: Adam divides the
gradient by its own RMS, so where a gradient is within a few eps of
zero its update depends on the last bits of the gradient, which the two
packages sum in different orders; at most 1 in 1000 entries of a tensor
may pass ``1e-5``, and none may pass ``lr`` (a step of the wrong sign
would); the state of those entries follows them, so at most 1 in 1000
entries of a state tensor may pass its limit, and none may pass
``1e-3`` of the tensor's largest entry.  The fused route's bias
correction ``1 - exp(t log beta)`` differs from the JAX step's ``1 -
beta**t`` in the last bits only, well inside these limits.  LR schedulers are host
arithmetic copied from the JAX package: their values are held equal.
"""

import contextlib
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
from paddle_tpu.optimizer import lr as jlr
import paddle_tpu_torch
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import generator as tgen
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit import train_step as tts
from paddle_tpu_torch.models import (LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     llama_state_from_jax, tiny_llama_config)
from paddle_tpu_torch.models.convert import LINEAR_NAMES
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer import lr as tlr

LR = 3e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _flags(**kw):
    """The same flags on both packages, restored after."""
    names = {f"FLAGS_{k}": v for k, v in kw.items()}
    old_j = paddle.get_flags(list(names))
    old_t = paddle_tpu_torch.get_flags(list(names))
    paddle.set_flags(names)
    paddle_tpu_torch.set_flags(names)
    try:
        yield
    finally:
        paddle.set_flags(old_j)
        paddle_tpu_torch.set_flags(old_t)


def _batch(seed=3, b=2, s=32):
    rng = np.random.default_rng(seed)
    vocab = tiny_llama_config().vocab_size
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :4] = -100
    return tokens, labels


def _as_port(name, arr):
    arr = np.asarray(arr)
    parts = name.split(".")
    if parts[-1] == "weight" and parts[-2] in LINEAR_NAMES:
        return arr.T
    return arr


def _pair(seed=2024):
    """The JAX model and the port model on the same weights."""
    paddle.seed(seed)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    jnet.train()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays), strict=True)
    tnet.train()
    return jnet, tnet


def _optimizers(case, jnet, tnet):
    """(JAX optimizer, port optimizer, schedulers) for a case."""
    jp, tp = jnet.parameters(), tnet.parameters()
    if case in ("sgd",):
        return (paddle.optimizer.SGD(LR, parameters=jp, weight_decay=0.01),
                topt.SGD(LR, parameters=tp, weight_decay=0.01), ())
    if case.startswith("momentum"):
        nest = case == "momentum_nesterov"
        return (paddle.optimizer.Momentum(LR, 0.9, parameters=jp,
                                          use_nesterov=nest,
                                          weight_decay=0.01),
                topt.Momentum(LR, 0.9, parameters=tp, use_nesterov=nest,
                              weight_decay=0.01), ())
    if case == "adam":
        return (paddle.optimizer.Adam(
                    LR, parameters=jp, weight_decay=0.01,
                    grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
                    multi_precision=True),
                topt.Adam(LR, parameters=tp, weight_decay=0.01,
                          grad_clip=ClipGradByGlobalNorm(1.0),
                          multi_precision=True), ())
    if case == "scheduler":
        js = jlr.LinearWarmup(jlr.CosineAnnealingDecay(LR, T_max=5), 2,
                              LR / 10, LR)
        ts = tlr.LinearWarmup(tlr.CosineAnnealingDecay(LR, T_max=5), 2,
                              LR / 10, LR)
        return (paddle.optimizer.AdamW(js, parameters=jp, weight_decay=0.01,
                                       multi_precision=True),
                topt.AdamW(ts, parameters=tp, weight_decay=0.01,
                           multi_precision=True), (js, ts))
    return (paddle.optimizer.AdamW(
                LR, parameters=jp, weight_decay=0.01,
                grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
                multi_precision=True),
            topt.AdamW(LR, parameters=tp, weight_decay=0.01,
                       grad_clip=ClipGradByGlobalNorm(1.0),
                       multi_precision=True), ())


CASES = ["sgd", "momentum", "momentum_nesterov", "adam", "adamw_rsqrt",
         "adamw_fused", "merge_avg", "merge_sum", "run_steps", "scheduler"]


def _run_case(case):
    jnet, tnet = _pair()
    jopt, topt_, scheds = _optimizers(case, jnet, tnet)
    kw = {}
    if case.startswith("merge"):
        kw = dict(accumulate_steps=2, accumulate_avg=case == "merge_avg")
    jcrit = jmodels.LlamaPretrainingCriterion(jnet.config)
    tcrit = LlamaPretrainingCriterion(tnet.config)
    jstep = JTrainStep(jnet, lambda net, t, l: jcrit(net(t), l), jopt, **kw)
    tstep = TrainStep(tnet, lambda net, t, l: tcrit(net(t), l), topt_, **kw)
    flag_kw = {"adamw_rsqrt": dict(adamw_rsqrt_update=True),
               "adamw_fused": dict(use_fused_adamw_kernel=True)}.get(case, {})
    fused_calls = []
    real_fused = tts.fused_adamw_update
    jl, tl = [], []
    try:
        tts.fused_adamw_update = \
            lambda *a, **k: fused_calls.append(1) or real_fused(*a, **k)
        with _flags(**flag_kw):
            if case == "run_steps":
                tokens, labels = _batch()
                jl.append(float(jstep.run_steps(paddle.to_tensor(tokens),
                                                paddle.to_tensor(labels),
                                                steps=3)))
                tl.append(float(tstep.run_steps(tokens, labels, steps=3)))
            for i in range(4 if case.startswith(("merge", "sched")) else 3):
                tokens, labels = _batch(3 + i % 2)
                jl.append(float(jstep(paddle.to_tensor(tokens),
                                      paddle.to_tensor(labels))))
                tl.append(float(tstep(tokens, labels)))
                for s in scheds:
                    s.step()
    finally:
        tts.fused_adamw_update = real_fused
    return dict(jnet=jnet, tnet=tnet, jstep=jstep, tstep=tstep, jl=jl,
                tl=tl, fused_calls=len(fused_calls))


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_jax(case):
    r = _run_case(case)
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=1e-5, atol=0)
    n_params = len(list(r["tnet"].parameters()))
    updates = {"merge_avg": 2, "merge_sum": 2, "run_steps": 6,
               "scheduler": 4}.get(case, 3)
    assert r["fused_calls"] == (n_params * updates
                                if case == "adamw_fused" else 0)
    tparams = dict(r["tnet"].named_parameters())
    tindex = {n: i for i, n in enumerate(tparams)}
    jstate, tstate = r["jstep"]._state, r["tstep"]._state
    for i, (name, p) in enumerate(r["jnet"].named_parameters()):
        j = tindex[name]
        diff = np.abs(tparams[name].detach().numpy()
                      - _as_port(name, p._value))
        assert diff.max() <= LR and (diff > 1e-5).mean() <= 1e-3, \
            (case, name, diff.max(), int((diff > 1e-5).sum()))
        for key, val in jstate[i].items():
            got = tstate[j][key]
            if key == "t":
                assert float(got) == float(val) == updates
                continue
            want = _as_port(name, val)
            assert got.dtype == torch.float32
            top = np.abs(want).max()
            diff = np.abs(got.numpy() - want)
            past = diff > 1e-4 * np.abs(want) + 1e-5 * top
            assert diff.max() <= 1e-3 * top and past.mean() <= 1e-3, \
                (case, name, key, diff.max(), int(past.sum()))
    if case.startswith("merge"):
        # calls 1 and 2 see the same parameters, as do calls 3 and 4
        assert r["tl"][0] != r["tl"][2]
        gm = r["tstep"]._gm_state
        assert gm["count"] == 4 and all(float(a.abs().max()) == 0.0
                                        for a in gm["acc"])


def test_sgd_and_momentum_ignore_weight_decay():
    """As in the JAX step: the same run with and without weight_decay
    gives the same parameters."""
    out = []
    for wd in (None, 0.5):
        tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", seed=5)
        step = TrainStep(tnet, lambda net, t, l: net(t, labels=l)[0],
                         topt.Momentum(LR, parameters=tnet.parameters(),
                                       weight_decay=wd))
        tokens, labels = _batch()
        step(tokens, labels)
        out.append([p.detach().clone() for p in tnet.parameters()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ---- LR schedulers ----

def _schedulers(mod):
    return {
        "NoamDecay": lambda: mod.NoamDecay(64, 4, learning_rate=2.0),
        "ExponentialDecay": lambda: mod.ExponentialDecay(0.5, 0.9),
        "NaturalExpDecay": lambda: mod.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lambda: mod.InverseTimeDecay(0.5, 0.2),
        "PolynomialDecay": lambda: mod.PolynomialDecay(0.5, 5, cycle=True),
        "LinearWarmup": lambda: mod.LinearWarmup(
            mod.CosineAnnealingDecay(0.5, 6), 3, 0.0, 0.5),
        "StepDecay": lambda: mod.StepDecay(0.5, 3, 0.5),
        "MultiStepDecay": lambda: mod.MultiStepDecay(0.5, [2, 5, 9]),
        "LambdaDecay": lambda: mod.LambdaDecay(0.5, lambda e: 0.9 ** e),
        "MultiplicativeDecay": lambda: mod.MultiplicativeDecay(
            0.5, lambda e: 0.95),
        "CosineAnnealingDecay": lambda: mod.CosineAnnealingDecay(0.5, 7, 0.01),
        "CosineAnnealingWarmRestarts": lambda: mod.CosineAnnealingWarmRestarts(
            0.5, 3, T_mult=2),
        "ReduceOnPlateau": lambda: mod.ReduceOnPlateau(0.5, patience=1),
        "PiecewiseDecay": lambda: mod.PiecewiseDecay([3, 6], [0.5, 0.1,
                                                              0.01]),
        "LinearLR": lambda: mod.LinearLR(0.5, 8),
        "OneCycleLR": lambda: mod.OneCycleLR(0.5, 12),
        "CyclicLR": lambda: mod.CyclicLR(0.1, 0.5, 3),
    }


@pytest.mark.parametrize("name", sorted(_schedulers(tlr)))
def test_lr_scheduler_values_equal_jax(name):
    js, ts = _schedulers(jlr)[name](), _schedulers(tlr)[name]()
    metrics = [5.0, 4.0, 4.0, 4.0, 3.9, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5,
               4.5, 4.5]
    jv, tv = [js()], [ts()]
    for m in metrics:
        if name == "ReduceOnPlateau":
            js.step(m)
            ts.step(torch.tensor(m))
        else:
            js.step()
            ts.step()
        jv.append(js())
        tv.append(ts())
    assert tv == jv
    assert len(set(tv)) > 1
    assert set(tlr.__all__) == set(jlr.__all__)


def test_optimizer_lr_from_a_scheduler():
    sched = tlr.StepDecay(0.5, 2, 0.1)
    opt = topt.AdamW(sched)
    assert opt.get_lr() == 0.5
    sched.step()
    sched.step()
    assert math.isclose(opt.get_lr(), 0.05)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    plain = topt.SGD(0.25)
    plain.set_lr(0.125)
    assert plain.get_lr() == 0.125
    assert isinstance(opt, topt.Adam)


# ---- bf16 moments ----

def test_moment_dtypes_follow_multi_precision():
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu",
                            dtype="bfloat16", seed=3)
    tokens, labels = _batch()
    for opt_cls, mp, want in ((topt.AdamW, False, torch.bfloat16),
                              (topt.Adam, False, torch.bfloat16),
                              (topt.AdamW, True, torch.float32)):
        step = TrainStep(tnet, lambda net, t, l: net(t, labels=l)[0],
                         opt_cls(1e-3, parameters=tnet.parameters(),
                                 multi_precision=mp))
        step(tokens, labels)
        for s in step._state:
            assert s["m"].dtype == s["v"].dtype == want
            assert s["t"].dtype == torch.float32 and float(s["t"]) == 1.0
    step = TrainStep(tnet, lambda net, t, l: net(t, labels=l)[0],
                     topt.Momentum(1e-3, parameters=tnet.parameters()))
    step(tokens, labels)
    assert all(s["velocity"].dtype == torch.bfloat16 for s in step._state)


def test_fp16_params_keep_fp32_moments():
    """fp16's 5-bit exponent overflows v: multi_precision=False keeps
    fp32 moments for fp16 parameters (``test_bf16_moments.py:27``), and
    the fused route leaves them to the unfused update."""
    torch.manual_seed(0)
    net = torch.nn.Linear(8, 8).to(torch.float16)
    with _flags(use_fused_adamw_kernel=True):
        step = TrainStep(net, lambda n, x: n(x).float().sum(),
                         topt.AdamW(1e-3, parameters=net.parameters()))
        float(step(np.ones((2, 8), np.float16)))
    for s in step._state:
        assert s["m"].dtype == s["v"].dtype == torch.float32
    assert not tts._fused_adam_eligible(net.weight, step._state[0])
    assert torch.isfinite(net.weight).all()


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_moments_converge_like_fp32(fused):
    """bf16 parameters; the bf16-moment run (stochastic rounding by the
    tile, or by the fused update's per-element noise) reaches a loss
    close to the fp32-moment run on the same stream, with the margins of
    ``test_bf16_moments.py:49``."""
    losses = {}
    rng = np.random.default_rng(0)
    ids = rng.integers(0, tiny_llama_config().vocab_size,
                       (4, 32)).astype(np.int32)
    with _flags(use_fused_adamw_kernel=fused):
        for mp in (True, False):
            paddle_tpu_torch.seed(0)
            tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu",
                                    dtype="bfloat16", seed=0)
            tnet.train()
            step = TrainStep(tnet, lambda net, t, l: net(t, labels=l)[0],
                             topt.AdamW(2e-3, parameters=tnet.parameters(),
                                        multi_precision=mp))
            for _ in range(30):
                last = float(step(ids, ids))
            want = torch.float32 if mp else torch.bfloat16
            assert step._state[2]["m"].dtype == want
            losses[mp] = last
    assert losses[True] < 2.0, losses
    assert losses[False] < losses[True] * 1.35 + 0.2, losses


def test_bf16_moment_noise_follows_the_generator():
    """The same global seed gives the same stochastically rounded
    moments; another seed gives others."""
    def run(seed):
        paddle_tpu_torch.seed(seed)
        tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu",
                                dtype="bfloat16", seed=1)
        step = TrainStep(tnet, lambda net, t, l: net(t, labels=l)[0],
                         topt.AdamW(1e-3, parameters=tnet.parameters()))
        tokens, labels = _batch()
        step(tokens, labels)
        step(tokens, labels)
        return [s["v"].clone() for s in step._state]

    a, b, c = run(4), run(4), run(5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


# ---- the fused route's gate ----

@pytest.mark.parametrize("opt_name,flags,taken", [
    ("AdamW", dict(use_fused_adamw_kernel=True), True),
    ("AdamW", dict(use_fused_adamw_kernel=False), False),
    ("AdamW", dict(use_fused_adamw_kernel=True, adamw_rsqrt_update=True),
     False),
    ("Adam", dict(use_fused_adamw_kernel=True), False),
    ("Momentum", dict(use_fused_adamw_kernel=True), False)])
def test_fused_route_taken_only_when_its_gate_holds(opt_name, flags, taken):
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", seed=7)
    opt = getattr(topt, opt_name)(1e-3, parameters=tnet.parameters())
    step = TrainStep(tnet, lambda net, t, l: net(t, labels=l)[0], opt)
    calls = []
    real = tts.fused_adamw_update
    try:
        tts.fused_adamw_update = lambda *a, **k: calls.append(
            k.get("seed")) or real(*a, **k)
        with _flags(**flags):
            assert tts._fused_adam_ok(step._update_fn, step._hypers) == taken
            step(*_batch())
    finally:
        tts.fused_adamw_update = real
    assert len(calls) == (len(step._params) if taken else 0)
    assert all(seed is None for seed in calls)     # fp32 moments: no SR



def test_fused_route_makes_its_scalars_once_per_update():
    """The fused route makes (lr, bc1, bc2) once per update and shares
    them and the step count across the parameters."""
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", seed=7)
    opt = topt.AdamW(1e-3, parameters=tnet.parameters())
    step = TrainStep(tnet, lambda net, t, l: net(t, labels=l)[0], opt)
    made = []
    real = tts.adamw_scalars
    try:
        tts.adamw_scalars = lambda *a, **k: made.append(1) or real(*a, **k)
        with _flags(use_fused_adamw_kernel=True):
            step(*_batch())
            step(*_batch())
    finally:
        tts.adamw_scalars = real
    assert len(made) == 2
    assert all(float(s["t"]) == 2.0 for s in step._state)


def test_fused_per_parameter_gate():
    p32 = torch.zeros(4, 3)
    s = {"m": torch.zeros(4, 3), "v": torch.zeros(4, 3)}
    assert tts._fused_adam_eligible(p32, s)
    assert tts._fused_adam_eligible(p32.bfloat16(), {
        "m": torch.zeros(4, 3, dtype=torch.bfloat16)})
    assert not tts._fused_adam_eligible(p32.half(), s)
    assert not tts._fused_adam_eligible(p32.double(), s)
    assert not tts._fused_adam_eligible(p32, {})
    assert not tts._fused_adam_eligible(p32, {"m": torch.zeros(
        4, 3, dtype=torch.float16)})
    assert tts._fused_adam_eligible(torch.zeros(7), {"m": torch.zeros(7)})


# ---- flags and keys ----

def test_set_and_get_flags_round_trip():
    assert paddle_tpu_torch.get_flags("adamw_rsqrt_update") == \
        {"FLAGS_adamw_rsqrt_update": False}
    with _flags(adamw_rsqrt_update=True, flash_onepass_bwd=False,
                use_fused_adamw_kernel=True):
        assert paddle_tpu_torch.get_flags(
            ["FLAGS_adamw_rsqrt_update", "flash_onepass_bwd",
             "use_fused_adamw_kernel"]) == {
            "FLAGS_adamw_rsqrt_update": True,
            "FLAGS_flash_onepass_bwd": False,
            "FLAGS_use_fused_adamw_kernel": True}
        assert tflags.flag("flash_onepass_bwd") is False
    assert tflags.flag("flash_onepass_bwd") is True
    # every flag of the JAX package, with its default
    jdefs = {k: v["default"] for k, v in
             __import__("paddle_tpu.core.flags", fromlist=["_DEFS"])
             ._DEFS.items()}
    assert {k: v["default"] for k, v in tflags._DEFS.items()} == jdefs


def test_unknown_and_unported_flags_raise():
    with pytest.raises(KeyError, match="no_such_flag"):
        paddle_tpu_torch.set_flags({"FLAGS_no_such_flag": 1})
    with pytest.raises(tflags.NotFoundError):
        paddle_tpu_torch.get_flags(["adamw_rsqrt_update", "no_such_flag"])
    # one refused entry leaves the others unset
    with pytest.raises(NotImplementedError, match="FLAGS_benchmark"):
        paddle_tpu_torch.set_flags({"FLAGS_adamw_rsqrt_update": True,
                                    "FLAGS_benchmark": True})
    assert tflags.flag("adamw_rsqrt_update") is False
    # an unported flag at its default is accepted
    paddle_tpu_torch.set_flags({"FLAGS_use_decode_attention_kernel": True,
                                "default_dtype": "float32"})


def test_environment_override(monkeypatch):
    monkeypatch.setenv("FLAGS_ptt_probe_flag", "true")
    monkeypatch.setenv("FLAGS_benchmark", "1")
    saved = tflags._FLAGS["benchmark"], dict(tflags._DEFS["benchmark"])
    try:
        tflags.define_flag("ptt_probe_flag", False)
        assert tflags.flag("ptt_probe_flag") is True
        with pytest.raises(NotImplementedError, match="environment"):
            tflags.define_flag("benchmark", False)
    finally:
        tflags._FLAGS.pop("ptt_probe_flag", None)
        tflags._DEFS.pop("ptt_probe_flag", None)
        tflags._FLAGS["benchmark"], tflags._DEFS["benchmark"] = saved


def test_generator_keys():
    g = tgen.Generator(11)
    keys = [g.next_key() for _ in range(4)]
    assert len(set(keys)) == 4 and all(0 <= k < 2 ** 64 for k in keys)
    assert g.get_state() == (11, 4)
    g.set_state((11, 1))
    assert g.next_key() == keys[1]
    assert tgen.Generator(11).next_key() == keys[0] != \
        tgen.Generator(12).next_key()
    k = keys[0]
    assert tgen.fold_in(k, 1) != tgen.fold_in(k, 2) != k
    a, b = tgen.split(k)
    assert len({a, b, k, tgen.fold_in(k, 0)}) == 4
    assert tgen.split(k, 3)[:2] == (a, b)
    paddle_tpu_torch.seed(9)
    first = tgen.next_key()
    paddle_tpu_torch.seed(9)
    assert tgen.default_generator().next_key() == first
    assert tgen.get_rng_state() == [(9, 1)]
