"""The port's GPT pretrain step held against the JAX package's on the CPU,
on the JAX model's weights carried by the weight bridge, and the
optimizer-state bridge over GPT's parameter names.

Three ``TrainStep`` calls of AdamW (``weight_decay=0.01``, global-norm
clip 1.0) on one batch, in two arms: every dropout 0 (the attention is
the flash route's plain version here) and the configured dropouts (0.1:
the embedding, attention-probability, residual and MLP masks, drawn from
each step's pushed key in the reference's trace order, so the masks are
the same bits on both sides).  Tolerances as ``test_torch_train.py``
(float32; both sides sum in different orders): losses ``rtol 1e-5``,
parameters ``atol 1e-5``, moments ``rtol 1e-4`` plus ``atol`` of
``1e-5`` times the tensor's largest entry.  One slice is held to Adam's
step size instead: the key third of ``qkv_proj.bias``.  Its gradient is
zero in exact arithmetic (adding one vector to every key shifts a
query's scores by one constant, which the softmax cancels), so both
sides' gradients there are float32 rounding noise whose sign the two
summation orders pick independently, and Adam moves each element by
about ``lr`` per step in that sign: ``atol 2 * lr * steps``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
import paddle_tpu_torch
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_state_from_jax,
                                     optimizer_state_from_jax,
                                     optimizer_state_to_jax, tiny_gpt_config)
from paddle_tpu_torch.models.convert import LINEAR_NAMES
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

LR = 3e-3
STEPS = 3
ARMS = {"no_dropout": dict(hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0),
        "dropout": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _as_port(name, arr):
    arr = np.asarray(arr)
    parts = name.split(".")
    if parts[-1] == "weight" and parts[-2] in LINEAR_NAMES:
        return arr.T
    return arr


def _pair(seed, **kw):
    paddle.seed(seed)
    jnet = jmodels.GPTForCausalLM(jmodels.tiny_gpt_config(**kw))
    arrays = {n: np.array(p._value, copy=True)
              for n, p in jnet.named_parameters()}
    tnet = GPTForCausalLM(tiny_gpt_config(**kw), device="cpu", init=False)
    tnet.load_state_dict(gpt_state_from_jax(arrays), strict=True)
    jnet.train()
    tnet.train()
    return jnet, tnet


def _batch(seed=3, b=2, s=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    labels = rng.integers(0, 256, (b, s)).astype(np.int32)
    labels[0, :4] = -100
    return tokens, labels


@pytest.fixture(scope="module", params=list(ARMS))
def trained(request):
    jnet, tnet = _pair(2024, **ARMS[request.param])
    tokens, labels = _batch()
    jopt = paddle.optimizer.AdamW(
        learning_rate=LR, parameters=jnet.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), multi_precision=True)
    jstep = JTrainStep(jnet, lambda net, t, l: net(t, labels=l)[0], jopt)
    topt = AdamW(learning_rate=LR, parameters=tnet.parameters(),
                 weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0),
                 multi_precision=True)
    tstep = TrainStep(tnet, lambda net, t, l: net(t, labels=l)[0], topt)
    paddle.seed(9)
    paddle_tpu_torch.seed(9)
    jl, tl = [], []
    for _ in range(STEPS):
        jl.append(float(jstep(paddle.to_tensor(tokens),
                              paddle.to_tensor(labels))))
        tl.append(float(tstep(tokens, labels)))
    return dict(arm=request.param, jnet=jnet, jstep=jstep, tnet=tnet,
                tstep=tstep, jl=jl, tl=tl)


def test_gpt_train_step_losses_match_jax(trained):
    np.testing.assert_allclose(trained["tl"], trained["jl"], rtol=1e-5,
                               atol=0)
    assert trained["tl"][-1] < trained["tl"][0]


@pytest.mark.parametrize("what", ["param", "m", "v"])
def test_gpt_train_step_parameters_and_moments_match_jax(trained, what):
    tparams = dict(trained["tnet"].named_parameters())
    tindex = {n: i for i, n in enumerate(tparams)}
    jstate = trained["jstep"]._state
    tstate = trained["tstep"]._state
    for i, (name, p) in enumerate(trained["jnet"].named_parameters()):
        j = tindex[name]
        if what == "param":
            got = tparams[name].detach().numpy()
            want = _as_port(name, p._value)
            if name.endswith("qkv_proj.bias"):
                h = got.shape[0] // 3
                np.testing.assert_allclose(got[h:2 * h], want[h:2 * h],
                                           atol=2 * LR * STEPS, rtol=0,
                                           err_msg=f"{name} (keys)")
                got = np.concatenate([got[:h], got[2 * h:]])
                want = np.concatenate([want[:h], want[2 * h:]])
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=name)
            continue
        want = _as_port(name, jstate[i][what])
        np.testing.assert_allclose(tstate[j][what].numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"{name} {what}")


def test_gpt_dropout_arm_draws_masks():
    """The dropout arm's loss is not the no-dropout arm's (the masks are
    live) and is the same on a second run from the same seed."""
    tokens, labels = (torch.from_numpy(a) for a in _batch())
    losses = []
    for arm in ("no_dropout", "dropout", "dropout"):
        _jnet, tnet = _pair(2024, **ARMS[arm])
        paddle_tpu_torch.seed(4)
        losses.append(float(tnet(tokens, labels=labels.long())[0].detach()))
    assert losses[1] != losses[0] and losses[1] == losses[2]


def test_gpt_optimizer_state_bridge_round_trips():
    """One eager AdamW step on each side from the same weights and
    gradients; the JAX state bridged to the port is the port's own
    (within the step's tolerance) and bridges back bit for bit."""
    jnet, tnet = _pair(5)
    rng = np.random.default_rng(0)
    tparams = dict(tnet.named_parameters())
    for name, p in jnet.named_parameters():
        g = rng.standard_normal(p._value.shape).astype(np.float32)
        p._grad = paddle.to_tensor(np.array(g, copy=True))
        tparams[name].grad = torch.from_numpy(
            np.ascontiguousarray(_as_port(name, g)))
    jopt = paddle.optimizer.AdamW(0.01, parameters=jnet.parameters())
    topt = AdamW(0.01, parameters=tnet.parameters())
    jopt.step()
    topt.step()
    jnames = [n for n, _ in jnet.named_parameters()]
    tnames = list(tparams)
    jstate = {k: np.asarray(v._value) for k, v in jopt.state_dict().items()}
    tstate = topt.state_dict()
    bridged = optimizer_state_from_jax(jstate, jnames, tnames)
    assert set(bridged) == set(tstate)
    for k, v in tstate.items():
        assert bridged[k].shape == v.shape, k
        np.testing.assert_allclose(bridged[k].numpy(), v.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    back = optimizer_state_to_jax(bridged, tnames, jnames)
    assert set(back) == set(jstate)
    for k, v in jstate.items():
        assert np.array_equal(back[k], v), k
