"""The named remat policies of the port held against the JAX package's
on the CPU: ``recompute_policy``, ``recompute_policy_stride``/``_alt``,
``recompute_sequential`` and the unknown-policy error.

Every policy runs three ``TrainStep`` calls (AdamW, ``weight_decay=
0.01``, global-norm clip 1.0) of the tiny Llama on both sides, from the
same weights (the weight bridge) and the same batch.  Tolerances, each
with its reason: losses within ``rtol 1e-5`` and parameters within
``atol 1e-5`` of the JAX package's (float32 summed in other orders, the
bound of ``test_torch_train.py``); against the port's own ``full`` run
bit for bit (a policy only decides what is kept, never how it is
computed, and the CPU's plain versions are deterministic).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.distributed.utils import _resolve_policy as jresolve
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
from paddle_tpu_torch.distributed import recompute, recompute_sequential
from paddle_tpu_torch.distributed import utils as tutils
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaForCausalLM, LlamaPretrainingCriterion,
                                     llama_state_from_jax, tiny_llama_config)
from paddle_tpu_torch.models.convert import LINEAR_NAMES
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW

LR = 3e-3
STEPS = 3
POLICIES = ["full", "dots", "dots_saveable", "nothing_saveable",
            "everything_saveable", "save_attn", "save_attn_mlp"]
# flash forwards per layer per step: a policy that keeps O and LSE (or
# everything) runs the forward once, the others again in the backward
FWD_PER_LAYER = {"full": 2, "dots": 2, "dots_saveable": 2,
                 "nothing_saveable": 2, "everything_saveable": 1,
                 "save_attn": 1, "save_attn_mlp": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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


def _run(policy, tokens, labels):
    paddle.seed(2024)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config(
        recompute=True, recompute_policy=policy))
    jnet.train()
    arrays = {n: np.array(p._value, copy=True)
              for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(recompute=True,
                                              recompute_policy=policy),
                            device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays), strict=True)
    tnet.train()
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
    calls = []
    fwd = tfa.flash_attention_fwd

    def counted(*a, **k):
        calls[-1] += 1
        return fwd(*a, **k)

    jl, tl = [], []
    tfa.flash_attention_fwd = counted
    try:
        for _ in range(STEPS):
            jl.append(float(jstep(paddle.to_tensor(tokens),
                                  paddle.to_tensor(labels))))
            calls.append(0)
            tl.append(float(tstep(tokens, labels)))
    finally:
        tfa.flash_attention_fwd = fwd
    jparams = {n: _as_port(n, p._value) for n, p in jnet.named_parameters()}
    tparams = {n: p.detach().clone() for n, p in tnet.named_parameters()}
    return dict(jl=jl, tl=tl, jparams=jparams, tparams=tparams, calls=calls)


@pytest.fixture(scope="module")
def runs():
    tokens, labels = _batch()
    return {pol: _run(pol, tokens, labels) for pol in POLICIES}


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_train_steps_match_jax(runs, policy):
    r = runs[policy]
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=1e-5, atol=0)
    assert r["tl"][-1] < r["tl"][0]
    for name, p in r["tparams"].items():
        np.testing.assert_allclose(p.numpy(), r["jparams"][name], atol=1e-5,
                                   rtol=0, err_msg=f"{policy} {name}")


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_equals_full_bit_for_bit(runs, policy):
    r, full = runs[policy], runs["full"]
    assert r["tl"] == full["tl"]
    for name, p in r["tparams"].items():
        assert torch.equal(p, full["tparams"][name]), name


@pytest.mark.parametrize("policy", POLICIES)
def test_flash_forwards_per_step(runs, policy):
    nl = tiny_llama_config().num_hidden_layers
    assert runs[policy]["calls"] == [FWD_PER_LAYER[policy] * nl] * STEPS


@pytest.mark.parametrize("stride,policy,alt", [
    (1, "save_attn", None), (2, "save_attn_mlp", "save_attn"),
    (3, "dots", None), (2, None, "dots")])
def test_stride_and_alt_assign_layers_as_the_reference(stride, policy, alt):
    kw = dict(recompute=True, recompute_policy=policy,
              recompute_policy_stride=stride, recompute_policy_alt=alt,
              num_hidden_layers=5)
    jcfg = jmodels.LlamaConfig(**{**jmodels.tiny_llama_config().__dict__,
                                  **kw})
    jnet = jmodels.LlamaForCausalLM(jcfg)
    tcfg = tiny_llama_config()
    tcfg = type(tcfg)(**{**tcfg.__dict__, **kw})
    tnet = LlamaForCausalLM(tcfg, device="cpu")
    want = [layer._recompute_policy for layer in jnet.llama.layers]
    got = [layer._recompute_policy for layer in tnet.llama.layers]
    assert got == want and len(got) == 5


@pytest.mark.parametrize("segments", [1, 2, 3])
def test_recompute_sequential_segments(segments, monkeypatch):
    """Segments as the reference splits them (one ``recompute`` per
    ``ceil(n / segments)`` layers), output and gradients equal to the
    layers run plainly."""
    torch.manual_seed(0)
    layers = [torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Tanh())
              for _ in range(5)]
    x = torch.randn(3, 8)
    seen = []
    real = tutils.recompute

    def spy(fn, *a, **k):
        seen.append(1)
        return real(fn, *a, **k)

    monkeypatch.setattr(tutils, "recompute", spy)
    out = recompute_sequential({"segments": segments}, layers, x)
    grads = torch.autograd.grad(out.sum(), [p for lay in layers
                                            for p in lay.parameters()])
    want = x
    for lay in layers:
        want = lay(want)
    wgrads = torch.autograd.grad(want.sum(), [p for lay in layers
                                              for p in lay.parameters()])
    assert len(seen) == (1 if segments <= 1 else -(-5 // -(-5 // segments)))
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, wgrads))


def test_unknown_policy_error_matches_the_reference():
    with pytest.raises(ValueError) as want:
        jresolve("bogus")
    with pytest.raises(ValueError) as got:
        recompute(lambda t: t * 2, torch.ones(2, requires_grad=True),
                  policy="bogus")
    assert str(got.value) == str(want.value)
