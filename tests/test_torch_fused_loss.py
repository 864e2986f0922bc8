"""``fused_linear_cross_entropy`` and the Llama ``fused_linear_loss``
config of the port held against the JAX package on the CPU.

Tolerances, each with its reason (float32 throughout): the loss, dH and
dW within ``atol 1e-5`` (chunk sums and the log-sum-exp in other
orders); three ``TrainStep`` calls with ``fused_linear_loss=True``:
losses within ``rtol 1e-5`` and parameters within ``atol 1e-5``, the
bound of ``test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.incubate.nn.functional import \
    fused_linear_cross_entropy as jfused
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
from paddle_tpu_torch.incubate.nn.functional import \
    fused_linear_cross_entropy as tfused
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_state_from_jax,
                                     tiny_llama_config)
from paddle_tpu_torch.models.convert import LINEAR_NAMES
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import AdamW

LR = 3e-3
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(n, h, v, n_ignored, seed):
    rng = np.random.default_rng(seed)
    hid = rng.standard_normal((n, h)).astype(np.float32)
    w = (rng.standard_normal((h, v)) * 0.3).astype(np.float32)
    lab = rng.integers(0, v, n).astype(np.int32)
    lab[rng.permutation(n)[:n_ignored]] = -100
    return hid, w, lab


def _jax_value_and_grads(hid, w, lab, chunk):
    def f(h, ww):
        return jfused(JTensor(h), JTensor(ww), JTensor(jnp.asarray(lab)),
                      chunk=chunk)._value
    val, (gh, gw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(hid), jnp.asarray(w))
    return float(val), np.asarray(gh), np.asarray(gw)


@pytest.mark.parametrize("n,chunk,n_ignored", [
    (37, 8, 3), (64, 16, 0), (5, 1024, 1), (33, 32, 33), (20, 7, 19)],
    ids=["ragged", "whole", "one-chunk", "all-ignored", "one-valid"])
def test_fused_linear_cross_entropy_matches_jax(n, chunk, n_ignored):
    hid, w, lab = _case(n, 16, 50, n_ignored, seed=n + chunk)
    want, gh, gw = _jax_value_and_grads(hid, w, lab, chunk)
    th = torch.tensor(hid, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss = tfused(th, tw, torch.from_numpy(lab.copy()), chunk=chunk)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(th.grad.numpy(), gh, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), gw, atol=1e-5, rtol=0)


def test_fused_equals_lm_head_plus_cross_entropy():
    hid, w, lab = _case(40, 16, 50, 4, seed=5)
    th = torch.tensor(hid, requires_grad=True)
    a = tfused(th, torch.from_numpy(w), torch.from_numpy(lab.copy()),
               chunk=16)
    b = cross_entropy(torch.from_numpy(hid) @ torch.from_numpy(w),
                      torch.from_numpy(lab.copy()))
    np.testing.assert_allclose(float(a.detach()), float(b), atol=1e-5)


def _as_port(name, arr):
    arr = np.asarray(arr)
    parts = name.split(".")
    if parts[-1] == "weight" and parts[-2] in LINEAR_NAMES:
        return arr.T
    return arr


@pytest.fixture(scope="module")
def fused_run():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (2, 32)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 32)).astype(np.int32)
    labels[0, :4] = -100
    paddle.seed(2024)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config(
        recompute=True, fused_linear_loss=True))
    jnet.train()
    arrays = {n: np.array(p._value, copy=True)
              for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(recompute=True,
                                              fused_linear_loss=True),
                            device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays), strict=True)
    tnet.train()
    jopt = paddle.optimizer.AdamW(
        learning_rate=LR, parameters=jnet.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), multi_precision=True)
    jstep = JTrainStep(jnet, lambda net, t, l: net(t, labels=l)[0], jopt)
    topt = AdamW(learning_rate=LR, parameters=tnet.parameters(),
                 weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0),
                 multi_precision=True)
    tstep = TrainStep(tnet, lambda net, t, l: net(t, labels=l)[0], topt)
    jl, tl = [], []
    for _ in range(STEPS):
        jl.append(float(jstep(paddle.to_tensor(tokens),
                              paddle.to_tensor(labels))))
        tl.append(float(tstep(tokens, labels)))
    return dict(jnet=jnet, tnet=tnet, jl=jl, tl=tl, tokens=tokens,
                labels=labels)


def test_fused_loss_model_steps_match_jax(fused_run):
    r = fused_run
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=1e-5, atol=0)
    assert r["tl"][-1] < r["tl"][0]
    tparams = dict(r["tnet"].named_parameters())
    for name, p in r["jnet"].named_parameters():
        np.testing.assert_allclose(tparams[name].detach().numpy(),
                                   _as_port(name, p._value), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_fused_loss_model_returns_no_logits(fused_run):
    tnet = fused_run["tnet"]
    loss, logits = tnet(torch.from_numpy(fused_run["tokens"]),
                        labels=torch.from_numpy(fused_run["labels"]))
    assert logits is None and loss.shape == ()
    # without labels the model still returns its logits
    assert tnet(torch.from_numpy(fused_run["tokens"])).shape == (2, 32, 256)
