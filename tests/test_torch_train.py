"""The port's Llama pretrain step held against the JAX package's on the
CPU, on the same weights carried over by the weight bridge.

``tiny_llama_config(recompute=True)`` in ``.train()``: every decoder
layer runs under full recompute on both sides.  Tolerances, each with
its reason (float32 throughout; both sides sum in float32 in different
orders):
- the training-mode loss: ``atol 1e-5``;
- three ``TrainStep`` calls (AdamW, ``weight_decay=0.01``, global-norm
  clip 1.0): per-step losses within ``rtol 1e-5``; final parameters
  within ``atol 1e-5``.  Adam's first steps move each parameter by about
  ``lr * sign(g)``, so a gradient whose sign the two summation orders
  disagree on would move one parameter by up to ``2 * lr`` per step; the
  check shows no such element at this size.  The moments are compared
  relative to their own size, since v (about ``1e-3 * g**2`` after
  clipping) is far below any fixed atol: ``rtol 1e-4`` (gradients
  summed in different orders, squared in v) plus ``atol`` of ``1e-5``
  times the tensor's largest entry for the entries near zero, where a
  sum that cancels keeps the absolute error of its terms.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     llama_state_from_jax, tiny_llama_config)
from paddle_tpu_torch.models.convert import LINEAR_NAMES
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW, Optimizer

LR = 3e-3
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_net(seed=2024):
    paddle.seed(seed)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config(recompute=True))
    jnet.train()
    return jnet


def _port_net(arrays, recompute=True):
    tnet = LlamaForCausalLM(tiny_llama_config(recompute=recompute),
                            device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays), strict=True)
    tnet.train()
    return tnet


def _batch(seed=3, b=2, s=32):
    rng = np.random.default_rng(seed)
    vocab = tiny_llama_config().vocab_size
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :4] = -100                       # a few ignored positions
    return tokens, labels


def _as_port(name, arr):
    """A JAX parameter's array in the port's layout ([out, in] Linear)."""
    arr = np.asarray(arr)
    parts = name.split(".")
    if parts[-1] == "weight" and parts[-2] in LINEAR_NAMES:
        return arr.T
    return arr


@pytest.fixture(scope="module")
def trained():
    """Both sides after STEPS train steps on the same batch."""
    jnet = _jax_net()
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = _port_net(arrays)
    tokens, labels = _batch()

    jcrit = jmodels.LlamaPretrainingCriterion(jnet.config)
    jopt = paddle.optimizer.AdamW(
        learning_rate=LR, parameters=jnet.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), multi_precision=True)
    jstep = JTrainStep(jnet, lambda net, t, l: jcrit(net(t), l), jopt)
    tcrit = LlamaPretrainingCriterion(tnet.config)
    topt = AdamW(learning_rate=LR, parameters=tnet.parameters(),
                 weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0),
                 multi_precision=True)
    tstep = TrainStep(tnet, lambda net, t, l: tcrit(net(t), l), topt)
    jl, tl = [], []
    for _ in range(STEPS):
        jl.append(float(jstep(paddle.to_tensor(tokens),
                              paddle.to_tensor(labels))))
        tl.append(float(tstep(tokens, labels)))
    return dict(jnet=jnet, jstep=jstep, tnet=tnet, tstep=tstep, jl=jl, tl=tl)


def test_training_loss_matches_jax():
    jnet = _jax_net(7)
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet = _port_net(arrays)
    tokens, labels = _batch(8)
    want = jmodels.LlamaPretrainingCriterion(jnet.config)(
        jnet(paddle.to_tensor(tokens)), paddle.to_tensor(labels))
    loss, logits = tnet(torch.from_numpy(tokens),
                        labels=torch.from_numpy(labels))
    assert logits.shape == (2, 32, tiny_llama_config().vocab_size)
    np.testing.assert_allclose(float(loss.detach()), float(want), atol=1e-5,
                               rtol=0)
    crit = LlamaPretrainingCriterion(tnet.config)
    assert float(crit(tnet(torch.from_numpy(tokens)),
                      torch.from_numpy(labels)).detach()) == \
        float(loss.detach())


def test_train_step_losses_match_jax(trained):
    np.testing.assert_allclose(trained["tl"], trained["jl"], rtol=1e-5,
                               atol=0)
    assert trained["tl"][-1] < trained["tl"][0]


@pytest.mark.parametrize("what", ["param", "m", "v"])
def test_train_step_parameters_and_moments_match_jax(trained, what):
    tparams = dict(trained["tnet"].named_parameters())
    tindex = {n: i for i, n in enumerate(tparams)}
    jstate = trained["jstep"]._state
    tstate = trained["tstep"]._state
    for i, (name, p) in enumerate(trained["jnet"].named_parameters()):
        j = tindex[name]
        if what == "param":
            np.testing.assert_allclose(tparams[name].detach().numpy(),
                                       _as_port(name, p._value), atol=1e-5,
                                       rtol=0, err_msg=name)
            assert float(tstate[j]["t"]) == float(jstate[i]["t"]) == STEPS
            continue
        want = _as_port(name, jstate[i][what])
        got = tstate[j][what]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"{name} {what}")


def test_recompute_on_and_off_give_identical_gradients():
    jnet = _jax_net(11)
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tokens, labels = (torch.from_numpy(a) for a in _batch(12))
    grads = []
    for recompute in (True, False):
        tnet = _port_net(arrays, recompute=recompute)
        loss, _ = tnet(tokens, labels=labels)
        grads.append(torch.autograd.grad(loss, list(tnet.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _step_for(opt_cls=AdamW, **kw):
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    opt = opt_cls(learning_rate=1e-3, parameters=tnet.parameters())
    return TrainStep(tnet, lambda net, t, l: net(t, labels=l)[0], opt, **kw)


@pytest.mark.parametrize("case", [
    "mesh", "base_optimizer", "lr_ratio", "lr_scheduler", "eager_step",
    "fused_linear_loss", "recompute_policy", "tensor_parallel",
    "tie_word_embeddings", "attention_cache", "recompute_named_policy"])
def test_unported_keywords_raise(case):
    from paddle_tpu_torch.distributed import recompute
    with pytest.raises(NotImplementedError):
        if case == "mesh":
            _step_for(mesh=object())
        elif case == "base_optimizer":
            _step_for(Optimizer)
        elif case == "lr_ratio":
            AdamW(lr_ratio=lambda p: 1.0)
        elif case == "lr_scheduler":
            AdamW(learning_rate=object())
        elif case == "eager_step":
            AdamW().step()
        elif case == "attention_cache":
            tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu")
            tnet.llama.layers[0].self_attn(torch.zeros(1, 2, 64),
                                           cache=(None, None))
        elif case == "recompute_named_policy":
            recompute(lambda x: x, torch.zeros(1), policy="save_attn")
        else:
            value = {"recompute_policy": "dots"}.get(case, True)
            LlamaConfig(**{case: value})


def test_bf16_moments_ok_with_multi_precision_and_unknown_policy_errors():
    from paddle_tpu_torch.distributed import recompute
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu",
                            dtype="bfloat16")
    step = TrainStep(tnet, lambda net, t: net(t).float().mean(),
                     AdamW(parameters=tnet.parameters(),
                           multi_precision=True))
    step(np.zeros((1, 4), np.int32))
    assert step._state[0]["m"].dtype == torch.float32
    assert next(tnet.parameters()).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown policy"):
        recompute(lambda x: x, torch.zeros(1), policy="no_such_policy")
    with pytest.raises(ValueError, match="accumulate_steps"):
        _step_for(accumulate_steps=0)
